"""A new backbone served end to end through both packages' ``Predictor``
from one JAX-written checkpoint.

A narrow ResNet (one bottleneck per stage) with cocokp's CIF and CAF
heads, biases shifted so that every cell is a detection, written by the
JAX package as an npz under a test name registered in both packages; both
``Predictor``s load it (f32) and predict two PNGs whose long edge is 65
px: the poses agree within the tolerances of ``test_torch_port_predict.py``
(xyv 1e-3, scores 1e-4).  One training step of a new backbone is in
``test_torch_port_backbones_train.py``.
"""

import jax.numpy as jnp
import numpy as np

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu import predictor as jax_predictor
from openpifpaf_tpu.models import base as jax_base
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import resnet as jax_resnet
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu_torch import image_io
from openpifpaf_tpu_torch.models import base, resnet
from openpifpaf_tpu_torch.predictor import Predictor

from test_torch_port_decode import one_torch_thread  # noqa: F401  (fixture)
from test_torch_port_models import coco_metas, random_variables

LONG_EDGE = 65
LAYERS = (1, 1, 1, 1)
RESNET_NAME = 'resnet-narrow-test'


def shell_variables(basenet, in_features, seed=0):
    """A flax Shell of ``basenet`` with cocokp's CIF and CAF heads and its
    variables from a numpy seed; returns (module, variables, metas)."""
    metas = coco_metas(jax_headmeta)
    for m in metas:
        m.base_stride = 16
    module = jax_shell.Shell(
        basenet=basenet,
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=in_features)
                   for m in metas])
    return module, random_variables(module, seed), metas


def test_resnet_checkpoint_predicts_as_jax(tmp_path, monkeypatch):
    _, variables, metas = shell_variables(jax_resnet.ResNet(LAYERS), 2048)
    flat = jax_checkpoint.flatten_tree(variables)
    for i, meta in enumerate(metas):
        bias = flat[f'params/head_nets_{i}/conv/bias'].reshape(
            meta.n_fields, meta.n_components)
        bias[:, 0] = 2.0
        bias[:, meta.n_components - meta.n_scales:] = 3.0
    path = str(tmp_path / 'resnet.npz')
    jax_checkpoint.save(path, variables=jax_checkpoint.unflatten_tree(flat),
                        head_metas=metas, basenet_name=RESNET_NAME,
                        base_stride=16)
    monkeypatch.setitem(jax_base.BASE_FACTORIES, RESNET_NAME,
                        jax_base.BaseNetworkSpec(
                            RESNET_NAME,
                            lambda norm='batchnorm', dtype=jnp.float32:
                            jax_resnet.ResNet(LAYERS, norm=norm, dtype=dtype),
                            stride=16, out_features=2048))
    monkeypatch.setitem(base.BASE_FACTORIES, RESNET_NAME, base.BaseNetworkSpec(
        RESNET_NAME, lambda norm='batchnorm': resnet.ResNet(LAYERS, norm=norm),
        stride=16, out_features=2048))
    monkeypatch.setattr(jax_models.Factory, 'bf16', False)

    rng = np.random.default_rng(0)
    paths = []
    for i, shape in enumerate([(LONG_EDGE, 48, 3), (40, LONG_EDGE, 3)]):
        paths.append(str(tmp_path / f'image{i}.png'))
        image_io.write_png(paths[-1],
                           rng.integers(0, 256, shape, dtype=np.uint8))
    want_predictor = jax_predictor.Predictor(checkpoint=path)
    got_predictor = Predictor(checkpoint=path, device='cpu', bf16=False)
    assert isinstance(got_predictor.model.module.basenet, resnet.ResNet)
    for p in (want_predictor, got_predictor):
        p.long_edge = LONG_EDGE
        p.batch_size = 2
    want = list(want_predictor.images(paths))
    got = list(got_predictor.images(paths))
    assert len(got) == len(want) == 2
    for (want_anns, _, _), (got_anns, _, _) in zip(want, got):
        assert len(got_anns) == len(want_anns) > 0
        for w, g in zip(want_anns, got_anns):
            np.testing.assert_allclose(g.data, w.data, atol=1e-3, rtol=0)
            assert abs(g.score - w.score) <= 1e-4
