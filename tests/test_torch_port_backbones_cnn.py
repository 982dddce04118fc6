"""The port's convolutional backbones against the JAX package's, on the CPU.

ResNet, MobileNetV2/V3, SqueezeNet, EfficientNetV2, the plain ShuffleNetV2
(3x3 kernels) and ``--basenet-norm`` instancenorm and groupnorm, each at a
narrow configuration: the same flax variables, drawn from a numpy seed
with BatchNorm away from the identity, go through the flax module and,
after ``from_jax_variables``, through the port's.  Each family runs at an
odd input size in f32 (max |d| <= 1e-4 of the output scale) and at an even
one in bf16 with f32 parameters (max |d| <= 3% of the f32 output's scale,
the bound of ``test_torch_port_models.py::test_forward_bf16_narrow``).

``backbone_variables`` and ``hold_backbone`` are shared with
``test_torch_port_backbones_attn.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import effnetv2 as jax_effnetv2
from openpifpaf_tpu.models import mobilenet as jax_mobilenet
from openpifpaf_tpu.models import resnet as jax_resnet
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.models import squeezenet as jax_squeezenet
from openpifpaf_tpu_torch import models
from openpifpaf_tpu_torch.models import effnetv2, fused_shufflenet, mobilenet
from openpifpaf_tpu_torch.models import resnet, shufflenetv2k, squeezenet

F32_TOL = 1e-4      # of the output scale
BF16_TOL = 3e-2     # of the f32 output's scale

# raw parameters away from their initial values, so that each term shows
RAW_FILL = {
    'relative_position_bias_table': lambda rng, s: rng.normal(0.0, 0.5, s),
    'rel_h': lambda rng, s: rng.normal(0.0, 0.5, s),
    'rel_w': lambda rng, s: rng.normal(0.0, 0.5, s),
    'temperature': lambda rng, s: rng.uniform(0.5, 2.0, s),
    'gamma1': lambda rng, s: rng.uniform(0.5, 1.0, s),
    'gamma2': lambda rng, s: rng.uniform(0.5, 1.0, s),
    'gamma3': lambda rng, s: rng.uniform(0.5, 1.0, s),
}


def backbone_variables(module, seed=0, hw=(33, 33), channels=3,
                       call_kwargs=None):
    """Flat flax variables (``params/basenet/...``, ``batch_stats/...``)
    of a flax backbone, shapes from ``jax.eval_shape`` of ``init`` (so
    nothing compiles), values from a numpy seed: kernels of variance
    1/fan_in, norm scales in [0.8, 1.2], biases and means N(0, 0.05),
    variances in [0.5, 1.5], the raw parameters by ``RAW_FILL``.
    ``call_kwargs``: of the module's call (default ``train=False``)."""
    if call_kwargs is None:
        call_kwargs = dict(train=False)
    abstract = jax.eval_shape(functools.partial(module.init, **call_kwargs),
                              jax.random.key(0),
                              jnp.zeros((1, *hw, channels)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], 'key', path[-1]))
        shape = leaf.shape
        if name in RAW_FILL:
            value = RAW_FILL[name](rng, shape)
        elif name == 'kernel':
            value = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == 'var':
            value = rng.uniform(0.5, 1.5, shape)
        elif name == 'scale':
            value = rng.uniform(0.8, 1.2, shape)
        else:                                   # bias, mean
            value = rng.normal(0.0, 0.05, shape)
        return value.astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, abstract)
    return jax_checkpoint.flatten_tree(
        {coll: {'basenet': tree} for coll, tree in filled.items()})


def port_backbone(net, flat):
    """``net`` (a port backbone) with the flax variables ``flat`` loaded
    strictly, in eval mode."""
    holder = models.Shell(net, [])
    holder.load_state_dict(models.from_jax_variables(flat), strict=True)
    return net.eval()


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return {coll: sub['basenet'] for coll, sub in tree.items()}


def jax_forward(module, flat, x):
    """NHWC f32 ``x`` through the flax backbone; NCHW numpy out."""
    y = jax.jit(lambda v, xx: module.apply(v, xx, train=False))(
        unflatten(flat), x)
    return np.asarray(jnp.asarray(y, jnp.float32)).transpose(0, 3, 1, 2)


def port_forward(net, x, bf16=False):
    with torch.no_grad(), torch.autocast('cpu', dtype=torch.bfloat16,
                                         enabled=bf16):
        y = net(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    return y.float().numpy()


def hold_backbone(jax_f32, jax_bf16, net, *, odd, even, seed=0,
                  batch=2, bf16_max=True):
    """The port's ``net`` against the flax modules (f32 and bf16 compute,
    the same variables): f32 at ``odd`` px within 1e-4 of the output
    scale, bf16 at ``even`` px (unless None) within 3% of the f32 output's scale, the
    port's bf16 forward as close to the f32 one.  Without ``bf16_max``
    (instance norm, see ``test_resnet``) the bf16 forward is held in f32
    at ``even`` px instead, and in bf16 by its median difference, within
    1e-3 of the scale.  Returns the f32 output shape at ``odd`` px."""
    flat = backbone_variables(jax_f32, seed)
    net = port_backbone(net, flat)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(batch, odd, odd, 3)).astype(np.float32)
    want, got = jax_forward(jax_f32, flat, x), port_forward(net, x)
    assert want.shape == got.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(want - got).max() <= F32_TOL * scale, \
        np.abs(want - got).max() / scale
    shape = got.shape
    if even is None:
        return shape

    x = rng.normal(size=(batch, even, even, 3)).astype(np.float32)
    want = jax_forward(jax_bf16, flat, x)
    ref = port_forward(net, x)
    got = port_forward(net, x, bf16=True)
    scale = np.abs(ref).max()
    if not bf16_max:
        want32 = jax_forward(jax_f32, flat, x)
        assert np.abs(want32 - ref).max() <= F32_TOL * scale
        assert np.median(np.abs(want - got)) <= 1e-3 * scale
        return shape
    assert np.abs(want - got).max() <= BF16_TOL * scale, \
        np.abs(want - got).max() / scale
    assert np.abs(ref - got).max() <= BF16_TOL * scale
    return shape


@pytest.mark.parametrize('norm', ['batchnorm', 'instancenorm', 'groupnorm'])
def test_resnet(norm):
    """Narrow ResNet (one bottleneck per stage) with each ``--basenet-norm``;
    the ResNet trunk keeps its widths (64 to 2048 channels).  Instance norm
    in bf16 is ill-conditioned here: it normalizes each of stage 4's 2048
    channels over 16 pixels, and the JAX package's own bf16 forward is 3.4%
    of the output scale off its f32 forward at 64 px (the port's 4.0%, the
    two 4.2% apart; median differences below 1e-4 of the scale).  So that
    case is held in f32 at both sizes and by its median in bf16."""
    layers = (1, 1, 1, 1)
    shape = hold_backbone(
        jax_resnet.ResNet(layers, norm=norm),
        jax_resnet.ResNet(layers, norm=norm, dtype=jnp.bfloat16),
        resnet.ResNet(layers, norm=norm), odd=49, even=64,
        bf16_max=norm != 'instancenorm')
    assert shape == (2, 2048, 4, 4)


def test_resnet_pool0_dilation():
    """The max-pool at the input and the dilated last stage
    (``pool0_stride`` 2, ``block5_dilation`` 2): stride 32 -> 16 x 2, in
    f32 (the bf16 path is ``test_resnet``'s)."""
    kw = dict(layers=(1, 1, 1, 1), pool0_stride=2, block5_dilation=2)
    shape = hold_backbone(jax_resnet.ResNet(**kw), None, resnet.ResNet(**kw),
                          odd=65, even=None)
    assert shape == (2, 2048, 5, 5)


# one row per stride and activation of each table
MBV2_CONFIG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 1, 2), (6, 64, 1, 2),
               (6, 96, 1, 1))
MBV3_CONFIG = ((3, 16, 16, False, 'relu6', 1), (3, 64, 24, False, 'relu6', 2),
               (5, 72, 40, True, 'relu6', 2), (5, 120, 40, True, 'relu6', 1),
               (3, 240, 80, False, 'hardswish', 2),
               (5, 672, 160, True, 'hardswish', 1))


@pytest.mark.parametrize('version', ['v2', 'v3'])
def test_mobilenet(version):
    if version == 'v2':
        kw = dict(config=MBV2_CONFIG, out_channels=128)
        cls, port_cls = jax_mobilenet.MobileNetV2, mobilenet.MobileNetV2
    else:
        kw = dict(config=MBV3_CONFIG, out_channels=96)
        cls, port_cls = jax_mobilenet.MobileNetV3, mobilenet.MobileNetV3
    shape = hold_backbone(cls(**kw), cls(**kw, dtype=jnp.bfloat16),
                          port_cls(**kw), odd=49, even=64)
    assert shape == (2, kw['out_channels'], 4, 4)


def test_squeezenet():
    shape = hold_backbone(jax_squeezenet.SqueezeNet(),
                          jax_squeezenet.SqueezeNet(dtype=jnp.bfloat16),
                          squeezenet.SqueezeNet(), odd=49, even=64)
    assert shape == (2, 512, 4, 4)


# one row per block type, and a fused block of expansion 1 whose width
# differs from its input's
EFFNET_CONFIG = (('fused', 1, 24, 2, 1), ('fused', 4, 32, 1, 2),
                 ('fused', 1, 40, 1, 1), ('mbconv', 4, 48, 2, 2),
                 ('mbconv', 6, 64, 1, 2))


def test_effnetv2():
    kw = dict(config=EFFNET_CONFIG, out_channels=96)
    shape = hold_backbone(
        jax_effnetv2.EffNetV2(**kw),
        jax_effnetv2.EffNetV2(**kw, dtype=jnp.bfloat16),
        effnetv2.EffNetV2(**kw), odd=65, even=48)
    assert shape == (2, 96, 5, 5)


X1 = ((1, 2, 1), (24, 116, 232, 464, 1024))


def test_shufflenetv2x1_r3_plan():
    """``shufflenetv2x1``'s widths at repeats (1, 2, 1): 3x3 depthwise
    kernels, so the pair plan (K2's 5x5 stencil) does not apply and the
    served forward is the r3 plan, held to the canonical graph and to
    JAX."""
    repeats, channels = X1
    jax_f32 = jax_sn.ShuffleNetV2K(repeats, channels, kernel_size=3)
    shape = hold_backbone(
        jax_f32,
        jax_sn.ShuffleNetV2K(repeats, channels, kernel_size=3,
                             dtype=jnp.bfloat16),
        shufflenetv2k.ShuffleNetV2K(repeats, channels, 3), odd=49, even=64)
    assert shape == (2, 1024, 4, 4)

    net = port_backbone(shufflenetv2k.ShuffleNetV2K(repeats, channels, 3),
                        backbone_variables(jax_f32))
    assert fused_shufflenet.supports(net)
    assert not fused_shufflenet.supports_pair(net)
    plan = fused_shufflenet.fold(net)
    assert not plan.pair
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, 49, 49)).astype(np.float32))
    with torch.no_grad():
        canonical = net(x)
        fused = fused_shufflenet.backbone_features(net, x, plan)
    scale = float(canonical.abs().max())
    assert float((fused.permute(0, 3, 1, 2) - canonical).abs().max()) \
        <= F32_TOL * scale


def test_norm_kinds_skip_the_fused_plan():
    """Only a batchnorm ShuffleNetV2K takes the fused plans; with another
    norm ``Model`` serves the canonical graph."""
    for norm in ('instancenorm', 'groupnorm'):
        net = shufflenetv2k.ShuffleNetV2K((1, 1, 1), (32, 64, 128, 256, 256),
                                          norm=norm)
        assert not fused_shufflenet.supports(net)
    assert models.norm_layer('instancenorm', 48).num_groups == 48
    assert models.norm_layer('groupnorm', 64).num_groups == 32
    assert isinstance(models.norm_layer('none', 8), torch.nn.Identity)
    with pytest.raises(ValueError, match='norm'):
        models.norm_layer('layernorm', 8)
