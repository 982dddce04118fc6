"""The weight bridge for every registered backbone, at full width.

- ``BASE_FACTORIES`` holds the JAX registry's 21 names, each with its
  stride and ``out_features``.
- For each name, with cocokp's CIF and CAF heads: the flax variable shapes
  from ``jax.eval_shape`` of ``init`` (nothing compiles), filled from a
  numpy seed, go through ``from_jax_variables`` and
  ``load_state_dict(strict=True)`` into the port's Shell, and back through
  ``to_jax_variables`` to the same keys and values.  ``flax_variables``
  traces every initializer (a few seconds per name), so the names are
  spread over four files that each stay under 30 s alone: ResNet,
  MobileNet and SqueezeNet here, the others in
  ``test_torch_port_backbones_weights_{effnet,swin,hrformer}.py``.
- A JAX-written npz checkpoint of a narrow Swin loads through
  ``models.factory(checkpoint=...)`` and serves the JAX forward.
- A ``t``-prefixed new backbone builds a tracking shell, from the same
  flax variables as the JAX package's tracking model.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu.models import swin as jax_swin
from openpifpaf_tpu_torch import headmeta, models
from openpifpaf_tpu_torch.models import base, swin

from test_torch_port_models import coco_metas, random_variables

# the registered names by the file that holds them
NAMES = {
    'weights': ['resnet50', 'resnet101', 'resnet152', 'mobilenetv2',
                'mobilenetv3large', 'squeezenet'],
    'effnet': ['effnetv2s', 'effnetv2m', 'shufflenetv2x1', 'shufflenetv2x2',
               'shufflenetv2k16', 'shufflenetv2k30', 'shufflenetv2k44'],
    'swin': ['swin_t', 'swin_s', 'swin_b', 'botnet', 'xcit_small_12'],
    'hrformer': ['hrformer_s', 'hrformer_b', 'xcit_medium_24'],
}


def flax_variables(name, metas):
    """Flat flax variables of ``name`` with ``metas``' heads, shapes from
    ``jax.eval_shape``, values uniform in [0, 1) from a numpy seed."""
    model = jax_models.Factory(base_name=name, bf16=False).build_module(
        name, metas)
    abstract = jax.eval_shape(functools.partial(model.module.init,
                                                train=False),
                              jax.random.key(0), jnp.zeros((2, 33, 33, 3)))
    rng = np.random.default_rng(0)
    return jax_checkpoint.flatten_tree(jax.tree.map(
        lambda a: rng.random(a.shape, dtype=np.float32), abstract))


def hold_round_trip(name):
    """Both ways through the bridge, no key unmapped or dropped."""
    flat = flax_variables(name, coco_metas(jax_headmeta))
    state = models.from_jax_variables(flat)
    n_stats = sum(k.endswith('/mean') for k in flat)
    assert len(state) == len(flat) + n_stats    # + num_batches_tracked
    with torch.device('meta'):
        shell, stride = models.build_shell(name, coco_metas())
    shell.load_state_dict(state, strict=True, assign=True)
    assert stride == models.BASE_FACTORIES[name].stride == 16
    back = models.to_jax_variables(shell.state_dict())
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_registry_matches_jax():
    assert set(models.BASE_FACTORIES) == set(jax_models.BASE_FACTORIES)
    assert sorted(sum(NAMES.values(), [])) == sorted(models.BASE_FACTORIES)
    for name, spec in models.BASE_FACTORIES.items():
        want = jax_models.BASE_FACTORIES[name]
        assert (spec.stride, spec.out_features) == \
            (want.stride, want.out_features), name


@pytest.mark.parametrize('name', NAMES['weights'])
def test_round_trip(name):
    hold_round_trip(name)


def test_unmappable_keys_raise():
    """A raw parameter the port does not know and a 3-D kernel raise on
    the way in; a state-dict key without a flax name raises on the way
    out."""
    for key, shape in (('params/basenet/block0/alpha', (3,)),
                       ('params/basenet/block0/conv/kernel', (3, 3, 3))):
        with pytest.raises(ValueError, match='no mapping'):
            models.from_jax_variables({key: np.zeros(shape, np.float32)})
    for key, shape in (('basenet.block0.alpha', (3,)),
                       ('basenet.block0.conv.weight', (3, 3, 3)),
                       ('extra.weight', (3,))):
        with pytest.raises(ValueError, match='no flax mapping'):
            models.to_jax_variables({key: torch.zeros(shape)})


NARROW_SWIN = dict(embed_dim=16, depths=(2, 1, 1, 1), num_heads=(1, 1, 2, 2))
NARROW_SWIN_NAME = 'swin-narrow-test'


def test_swin_checkpoint_through_factory(tmp_path, monkeypatch):
    """A JAX-written npz of a narrow Swin with cocokp heads, registered
    under a test name in both packages: ``models.factory`` loads it and
    the forward equals JAX's within 1e-4 of the output scale (f32)."""
    metas = coco_metas(jax_headmeta)
    for m in metas:
        m.base_stride = 16
    module = jax_shell.Shell(
        basenet=jax_swin.Swin(**NARROW_SWIN),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=128)
                   for m in metas])
    variables = random_variables(module)
    path = str(tmp_path / 'swin.npz')
    jax_checkpoint.save(path, variables=variables, head_metas=metas,
                        basenet_name=NARROW_SWIN_NAME, base_stride=16)
    monkeypatch.setitem(base.BASE_FACTORIES, NARROW_SWIN_NAME,
                        base.BaseNetworkSpec(
                            NARROW_SWIN_NAME,
                            lambda norm='batchnorm': swin.Swin(**NARROW_SWIN),
                            stride=16, out_features=128))
    model = models.factory(checkpoint=path, device='cpu', bf16=False)
    assert model.basenet_name == NARROW_SWIN_NAME
    assert isinstance(model.module.basenet, swin.Swin)
    x = np.random.default_rng(0).normal(size=(1, 49, 49, 3)) \
        .astype(np.float32)
    want = jax.jit(lambda v, xx: module.apply(v, xx, train=False))(
        variables, x)
    got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.shape == tuple(g.shape)
        assert np.abs(w - g.numpy()).max() <= 1e-4 * np.abs(w).max()


def test_t_prefix_builds_tracking_shell():
    """``tsqueezenet`` and ``tswin_t``: a ``TrackingShell`` in both
    packages, the JAX tracking model's variables loading strictly into the
    port's; a ``TrackingModel`` from ``models.factory`` serves a frame
    pair."""
    for name in ('tsqueezenet', 'tswin_t'):
        flat = flax_variables(name, coco_metas(jax_headmeta))
        with torch.device('meta'):
            shell, _ = models.build_shell(name, coco_metas())
        assert isinstance(shell, models.TrackingShell)
        shell.load_state_dict(models.from_jax_variables(flat), strict=True,
                              assign=True)
    model = models.factory('tsqueezenet', coco_metas(headmeta), device='cpu',
                           bf16=False)
    assert isinstance(model, models.TrackingModel)
    fields = model(torch.zeros(2, 3, 33, 33))
    assert [tuple(f.shape) for f in fields] == [(2, 17, 5, 3, 3),
                                                (2, 19, 9, 3, 3)]
