"""Port forward and weight bridge against the flax reference.

The same weights — flax variables drawn from a numpy seed, batch norm not
the identity (as ``test_torch_crossval.py:64-80`` arranges) — run
through the JAX package's ``Shell`` and the port's ``Shell`` after
``from_jax_variables``; the head tensors must agree.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu_torch import headmeta, models
from openpifpaf_tpu_torch.plugins.coco import constants

NARROW = ((1, 2, 1), (8, 16, 32, 64, 64))


def coco_metas(hm=headmeta, upsample_stride=1):
    cif = hm.Cif('cif', 'port', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 pose=constants.COCO_UPRIGHT_POSE,
                 draw_skeleton=constants.COCO_PERSON_SKELETON,
                 score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    caf = hm.Caf('caf', 'port', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 pose=constants.COCO_UPRIGHT_POSE,
                 skeleton=constants.COCO_PERSON_SKELETON)
    for m in (cif, caf):
        m.upsample_stride = upsample_stride
    return [cif, caf]


def random_variables(module, seed=0):
    """Flax variables of ``module`` drawn from a numpy seed, with
    non-trivial batch norm (scale and bias jittered, running statistics
    away from 0/1, as ``test_torch_crossval.py:64-80`` perturbs them).
    Shapes come from ``jax.eval_shape`` of ``module.init``, so no
    initializer runs."""
    abstract = jax.eval_shape(functools.partial(module.init, train=False),
                              jax.random.key(0), jnp.zeros((1, 33, 33, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        shape = leaf.shape
        if name.endswith('kernel'):
            fan_in = int(np.prod(shape[:-1]))
            value = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif name.endswith('var'):
            value = rng.uniform(0.5, 1.5, shape)
        elif name.endswith('scale'):
            value = rng.uniform(0.8, 1.2, shape)
        else:                                   # bias, mean
            value = rng.normal(0.0, 0.05, shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, abstract)


@functools.lru_cache(maxsize=None)
def flax_narrow(upsample_stride=1, dtype=jnp.float32, seed=0):
    """Narrow ShuffleNetV2K (repeats (1, 2, 1)) with CIF and CAF heads in
    flax; returns (module, variables, metas)."""
    metas = coco_metas(jax_headmeta, upsample_stride)
    for m in metas:
        m.base_stride = 16
    module = jax_shell.Shell(
        basenet=jax_sn.ShuffleNetV2K(*NARROW, dtype=dtype),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=64,
                                             dtype=dtype) for m in metas])
    return module, random_variables(module, seed), metas


def port_narrow(flat, upsample_stride=1, bf16=False):
    metas = coco_metas(headmeta, upsample_stride)
    for m in metas:
        m.base_stride = 16
    shell = models.Shell(models.ShuffleNetV2K(*NARROW),
                         [models.CompositeField4(m, 64) for m in metas])
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    return models.Model(shell, metas, base_stride=16,
                        device=torch.device('cpu'), bf16=bf16)


def run_both(module, variables, model, hw, seed=0):
    x = np.random.default_rng(seed).normal(size=(2, *hw, 3)).astype(np.float32)
    ours = [np.asarray(o) for o in
            jax.jit(lambda v, xx: module.apply(v, xx, train=False))(
                variables, x)]
    theirs = [t.numpy() for t in model(torch.from_numpy(
        x.transpose(0, 3, 1, 2)))]
    return ours, theirs


@pytest.fixture(scope='module')
def sn2k16():
    model = jax_models.Factory(base_name='shufflenetv2k16', bf16=False) \
        .from_scratch('shufflenetv2k16', coco_metas(jax_headmeta))
    model.variables = random_variables(model.module, seed=1)
    return model


def test_weights_map_every_leaf_narrow():
    _, variables, _ = flax_narrow()
    flat = jax_checkpoint.flatten_tree(variables)
    sd = models.from_jax_variables(flat)
    n_bn = sum(k.endswith('/mean') for k in flat)
    assert len(sd) == len(flat) + n_bn      # + num_batches_tracked per BN
    k = 'params/basenet/stage2_0/branch1_dwconv/kernel'
    np.testing.assert_array_equal(
        sd['basenet.stage2_0.branch1_dwconv.weight'].numpy(),
        flat[k].transpose(3, 2, 0, 1))
    assert tuple(sd['basenet.stage2_0.branch1_dwconv.weight'].shape) == \
        (8, 1, 5, 5)
    np.testing.assert_array_equal(
        sd['basenet.conv5_norm.running_var'].numpy(),
        flat['batch_stats/basenet/conv5_norm/var'])
    np.testing.assert_array_equal(sd['head_nets.1.conv.bias'].numpy(),
                                  flat['params/head_nets_1/conv/bias'])
    port_narrow(flat)   # strict=True load


def test_weights_map_every_leaf_sn2k16(sn2k16):
    flat = jax_checkpoint.flatten_tree(sn2k16.variables)
    sd = models.from_jax_variables(flat)
    shell, _ = models.build_shell('shufflenetv2k16', coco_metas())
    assert set(sd) == set(shell.state_dict())
    shell.load_state_dict(sd, strict=True)


def test_unmapped_key_raises():
    _, variables, _ = flax_narrow()
    flat = jax_checkpoint.flatten_tree(variables)
    flat['params/basenet/extra_block/gamma'] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match='no mapping'):
        models.from_jax_variables(flat)
    # a key that maps but names no module fails the strict load
    flat = jax_checkpoint.flatten_tree(variables)
    flat['params/basenet/ghost/kernel'] = np.zeros((1, 1, 2, 2), np.float32)
    with pytest.raises(RuntimeError, match='ghost'):
        port_narrow(flat)


@pytest.mark.parametrize('upsample_stride', [1, 2])
def test_forward_f32_narrow(upsample_stride):
    """f32: atol 1e-4 (precedent ``test_torch_crossval.py:110``); the
    upsample case checks the PixelShuffle (c rh rw) order and the crop."""
    module, variables, _ = flax_narrow(upsample_stride)
    model = port_narrow(jax_checkpoint.flatten_tree(variables),
                        upsample_stride)
    ours, theirs = run_both(module, variables, model, (49, 65))
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-4
    if upsample_stride == 2:
        assert ours[0].shape[-2:] == (7, 9)


def test_forward_bf16_narrow():
    """bf16 compute with f32 params in both packages.  The two round to
    bf16 at different places (flax casts conv inputs and BN in bf16, torch
    autocast keeps BN statistics in f32), so the bound is relative to the
    output scale: 3% of max |value|, about three times the 1.0% measured
    on this model — bf16 keeps 8 mantissa bits and the error grows over
    the network's depth."""
    module32, variables, _ = flax_narrow()
    module16, _, _ = flax_narrow(dtype=jnp.bfloat16)
    flat = jax_checkpoint.flatten_tree(variables)
    ours, theirs = run_both(module16, variables, port_narrow(flat, bf16=True),
                            (49, 65))
    ref, _ = run_both(module32, variables, port_narrow(flat), (49, 65))
    for a, b, r in zip(ours, theirs, ref):
        scale = np.abs(r).max()
        assert b.dtype == np.float32
        assert np.abs(a - b).max() <= 0.03 * scale
        # the port's bf16 forward is as close to the f32 one
        assert np.abs(b - r).max() <= 0.03 * scale


def test_forward_f32_sn2k16(sn2k16):
    """Full-width ShuffleNetV2K-16 at 65x65, f32: atol 1e-4."""
    flat = jax_checkpoint.flatten_tree(sn2k16.variables)
    shell, stride = models.build_shell('shufflenetv2k16', coco_metas())
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    model = models.Model(shell, coco_metas(), base_stride=stride,
                         device=torch.device('cpu'), bf16=False)
    ours, theirs = run_both(sn2k16.module, sn2k16.variables, model, (65, 65))
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (2, a.shape[1], a.shape[2], 5, 5)
        assert np.abs(a - b).max() <= 1e-4


def test_factory_loads_jax_checkpoint(tmp_path):
    module, variables, metas = flax_narrow()
    path = str(tmp_path / 'narrow.npz')
    jax_checkpoint.save(path, variables=variables, head_metas=metas,
                        basenet_name='shufflenetv2k16', base_stride=16)
    # the header names sn2k16, the variables are narrow: the strict load
    # must refuse the mismatch
    with pytest.raises(RuntimeError):
        models.factory(checkpoint=path, device='cpu')


def test_factory_seeded_weights_are_reproducible():
    a = models.factory('shufflenetv2k16', coco_metas(), device='cpu', seed=3)
    b = models.factory('shufflenetv2k16', coco_metas(), device='cpu', seed=3)
    c = models.factory('shufflenetv2k16', coco_metas(), device='cpu', seed=4)
    wa = a.module.state_dict()['basenet.stage3_2.branch2_conv1.weight']
    assert torch.equal(wa, b.module.state_dict()[
        'basenet.stage3_2.branch2_conv1.weight'])
    assert not torch.equal(wa, c.module.state_dict()[
        'basenet.stage3_2.branch2_conv1.weight'])
    assert a.bf16 and a.device.type == 'cpu'
    assert [m.head_index for m in a.head_metas] == [0, 1]
