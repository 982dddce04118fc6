"""The port's tracking model (``models/tracking_base.py``) against the JAX
package's ``TrackingShell`` and ``TrackingModel``.

A narrow ShuffleNetV2K (repeats (1, 2, 1)) with the CIF, CAF and TCAF
heads, flax variables drawn from a numpy seed and carried over by
``from_jax_variables``, runs two interleaved frame pairs at 65 x 81 px in
float32: the port's canonical graph (``Model.apply``) and its
``apply_fast`` (the fused backbone, then the tracking heads) must be within
1e-4 of the output scale of the JAX ``TrackingShell`` and of the JAX
``TrackingModel.apply_fast``.  The streamed path — ``backbone_features``
of each frame alone, then ``heads_from_features`` on the cached pair —
must equal the pair forward within 1e-6 of scale.  Checkpoints with a
``Tcaf`` header load both ways (the port reads a JAX-written npz, the JAX
package reads a port-written one) and give the same fields; the TCAF
head takes both frames' features, 2C channels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.models import tracking_base as jax_tracking
from openpifpaf_tpu.plugins.posetrack.cocokpst import \
    tracking_head_metas as jax_tracking_head_metas
from openpifpaf_tpu_torch import models
from openpifpaf_tpu_torch.models import checkpoint
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.plugins.posetrack import tracking_head_metas

from test_torch_port_models import NARROW

HW = (65, 81)
TOL = 1e-4


def head_metas(factory=tracking_head_metas):
    metas = factory('toykpst', keypoints=constants.COCO_KEYPOINTS,
                    sigmas=constants.COCO_PERSON_SIGMAS,
                    pose=constants.COCO_UPRIGHT_POSE,
                    skeleton=constants.COCO_PERSON_SKELETON,
                    score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    for m in metas:
        m.base_stride = 16
    return metas


def random_tracking_variables(module, seed=0):
    """Flax variables of a tracking shell from a numpy seed (shapes from
    ``jax.eval_shape`` over one frame pair), batch norm not the identity,
    as ``test_torch_port_models.random_variables`` draws them."""
    abstract = jax.eval_shape(functools.partial(module.init, train=False),
                              jax.random.key(0), jnp.zeros((2, 33, 33, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        if name.endswith('kernel'):
            value = rng.normal(0.0, 1.0 / np.sqrt(np.prod(leaf.shape[:-1])),
                               leaf.shape)
        elif name.endswith('var'):
            value = rng.uniform(0.5, 1.5, leaf.shape)
        elif name.endswith('scale'):
            value = rng.uniform(0.8, 1.2, leaf.shape)
        else:
            value = rng.normal(0.0, 0.05, leaf.shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, abstract)


@functools.lru_cache(maxsize=None)
def flax_narrow_tracking():
    metas = head_metas(jax_tracking_head_metas)
    module = jax_tracking.TrackingShell(
        basenet=jax_sn.ShuffleNetV2K(*NARROW),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=64)
                   for m in metas],
        head_paired=(False, False, True))
    return module, random_tracking_variables(module, seed=3), metas


def port_narrow_tracking(flat):
    metas = head_metas()
    shell = models.TrackingShell(
        models.ShuffleNetV2K(*NARROW),
        [models.CompositeField4(m, c) for m, c in zip(metas, (64, 64, 128))],
        (False, False, True))
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    return models.TrackingModel(shell, metas, base_stride=16,
                                device=torch.device('cpu'), bf16=False)


def frames(n_pairs=2, seed=0):
    x = np.random.default_rng(seed).normal(size=(2 * n_pairs, *HW, 3))
    return x.astype(np.float32)


def close(got, want, label, tol=TOL):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f'{label}: {err} > {tol} * {scale}'


@pytest.fixture(scope='module', name='narrow')
def fixture_narrow():
    module, variables, _ = flax_narrow_tracking()
    x = frames()
    want = [np.asarray(o) for o in jax.jit(
        lambda v, xx: module.apply(v, xx, train=False))(variables, x)]
    model = port_narrow_tracking(jax_checkpoint.flatten_tree(variables))
    return module, variables, model, x, want


def test_forward_against_jax(narrow):
    module, variables, model, x, want = narrow
    assert [w.shape[0] for w in want] == [4, 4, 2]
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    canonical = [t.numpy() for t in model.apply(xt)]
    fast = [t.numpy() for t in model(xt)]
    jax_model = jax_tracking.TrackingModel(module, head_metas(
        jax_tracking_head_metas), base_stride=16, basenet_name='x',
        variables=variables)
    jax_fast = [np.asarray(o) for o in jax_model.apply_fast(variables, x)]
    for name, g, w, f, jf in zip(('cif', 'caf', 'tcaf'), canonical, want,
                                 fast, jax_fast):
        assert g.shape == w.shape == f.shape == jf.shape, name
        close(g, w, f'{name} canonical')
        close(f, w, f'{name} apply_fast')
        close(f, jf, f'{name} apply_fast against JAX apply_fast')


def test_streamed_equals_pair_forward(narrow):
    *_, model, x, _ = narrow
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    pair = [t.numpy() for t in model(xt[:2])]
    prev = model.backbone_features(xt[:1])
    curr = model.backbone_features(xt[1:2])
    streamed = [t.numpy() for t in
                model.heads_from_features(torch.cat([prev, curr]))]
    for name, s, p in zip(('cif', 'caf', 'tcaf'), streamed, pair):
        assert s.shape == p.shape, name
        close(s, p, f'{name} streamed', tol=1e-6)
    # the first frame of a stream pairs with itself
    self_pair = model.heads_from_features(torch.cat([prev, prev]))
    np.testing.assert_array_equal(self_pair[0][0].numpy(),
                                  self_pair[0][1].numpy())


def test_tcaf_head_takes_both_frames():
    shell, _ = models.build_shell('tshufflenetv2k16', head_metas())
    assert isinstance(shell, models.TrackingShell)
    widths = [h.conv.in_channels for h in shell.head_nets]
    assert widths == [1392, 1392, 2 * 1392]
    assert shell.head_paired == (False, False, True)
    # a Tcaf meta makes a tracking shell whatever the basenet's name
    shell, _ = models.build_shell('shufflenetv2k16', head_metas())
    assert isinstance(shell, models.TrackingShell)
    shell, _ = models.build_shell('tshufflenetv2k16', head_metas()[:2])
    assert isinstance(shell, models.TrackingShell)
    assert shell.head_paired == (False, False)


def test_factory_builds_tracking_model():
    model = models.factory('tshufflenetv2k16', head_metas(), device='cpu',
                           bf16=False)
    assert isinstance(model, models.TrackingModel)
    assert model.basenet_name == 'tshufflenetv2k16'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            models.factory('tshufflenetv2k16', head_metas())


def test_checkpoint_both_ways(narrow, tmp_path):
    """A JAX-written npz with a Tcaf header loads in the port, and the
    port's writes load in the JAX package; both compute the same fields."""
    module, variables, model, x, want = narrow
    jax_path = str(tmp_path / 'jax.npz')
    jax_checkpoint.save(jax_path, variables=variables,
                        head_metas=head_metas(jax_tracking_head_metas),
                        basenet_name='tshufflenetv2k16', base_stride=16)
    header, flat = checkpoint.load(jax_path)
    kinds = [type(m).__name__ for m in header['head_metas']]
    assert kinds == ['Cif', 'Caf', 'Tcaf']
    assert header['head_metas'][2].skeleton[0] == (1, 18)
    loaded = port_narrow_tracking(flat)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    for g, w in zip(loaded(xt), want):
        close(g.numpy(), w, 'JAX checkpoint in the port')

    port_path = str(tmp_path / 'port.npz')
    checkpoint.save(port_path,
                    variables=models.to_jax_variables(
                        model.module.state_dict()),
                    head_metas=model.head_metas,
                    basenet_name='tshufflenetv2k16', base_stride=16)
    jax_header, tree = jax_checkpoint.load(port_path)
    assert [type(m).__name__ for m in jax_header['head_metas']] == kinds
    tcaf, want_tcaf = jax_header['head_metas'][2], head_metas(
        jax_tracking_head_metas)[2]
    for field in ('keypoints_single_frame', 'sigmas_single_frame',
                  'keypoints', 'sigmas', 'skeleton', 'n_fields'):
        assert getattr(tcaf, field) == getattr(want_tcaf, field), field
    np.testing.assert_array_equal(tcaf.pose_single_frame,
                                  want_tcaf.pose_single_frame)
    out = module.apply(jax.tree.map(jnp.asarray, tree), x, train=False)
    for o, w in zip(out, want):
        close(np.asarray(o), w, 'port checkpoint in JAX')
