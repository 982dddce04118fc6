"""The pair-plan forward and its stride-1 chain (K2) against the JAX package.

The JAX weights come from ``flax init`` with the BatchNorm statistics
perturbed as ``test_pallas_pair_chain.py:32-43`` does, so the BN fold is not
the identity and the folded bias ``relu(o1)`` is nonzero at the image edge;
they reach the port through ``from_jax_variables``.  Inputs are drawn from
numpy seeds.  The chain config has stage half-width 22, so q = 11 is odd,
as sn2k16's q = 87 is.  Tolerances:

- float32: 1e-5 (the JAX package's own interpret-mode gate) for the chain
  and for backbones against the JAX plans, 1e-4 against the port's
  canonical graph and for full-width sn2k16 (``test_torch_port_models``'s
  precedent): the two sum in other orders, and sn2k16 is deep and wide;
- bfloat16: 3% of the largest output, the precedent of
  ``test_fused_shufflenet.py:321``: both round every op to bf16 (8 mantissa
  bits), at other places.

On the CPU the chain runs its plain version; the kernel is held against it
on the card by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import fused_shufflenet as jax_fs
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.ops import pallas_pair_chain as jax_ppc
from openpifpaf_tpu_torch import models
from openpifpaf_tpu_torch.models import fused_shufflenet as fs
from openpifpaf_tpu_torch.ops import pair_chain as pc
from openpifpaf_tpu_torch.predictor import Predictor

from test_torch_port_models import coco_metas, flax_narrow, port_narrow
from test_torch_port_models import random_variables
from test_torch_port_predictor import detecting_variables

CHAIN = ((4,), (24, 44, 44))                     # half 22, q 11
PAIR = ((2, 3, 2), (16, 44, 92, 44, 48))         # q 11, 23, 11
ODD_HALF = ((2, 2, 2), (16, 42, 42, 42, 48))     # half 21: the r3 plan


@functools.lru_cache(maxsize=None)
def jax_backbone(repeats, channels, seed=0):
    """A flax ShuffleNetV2K and its variables under ``basenet``: flax init,
    then the BN statistics perturbed (means + N(0, 0.3), variances times
    U(0.5, 2))."""
    module = jax_sn.ShuffleNetV2K(stages_repeats=repeats,
                                  stages_out_channels=channels)
    variables = module.init(jax.random.key(seed),
                            np.zeros((1, 33, 33, 3), np.float32), False)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = getattr(path[-1], 'key', str(path[-1]))
        x = np.asarray(x)
        if name == 'mean':
            return x + rng.normal(0, 0.3, x.shape).astype(np.float32)
        if name == 'var':
            return (x * rng.uniform(0.5, 2.0, x.shape)).astype(np.float32)
        return x

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    return module, {'params': {'basenet': variables['params']},
                    'batch_stats': {'basenet': variables['batch_stats']}}


def port_backbone(repeats, channels, seed=0):
    """The port's ShuffleNetV2K with the same weights."""
    _, variables = jax_backbone(repeats, channels, seed)
    sd = models.from_jax_variables(jax_checkpoint.flatten_tree(variables))
    net = models.ShuffleNetV2K(repeats, channels)
    net.load_state_dict({k[len('basenet.'):]: v for k, v in sd.items()},
                        strict=True)
    return net.eval()


def chain_blocks():
    """Stage 2's three stride-1 blocks of CHAIN, in both packages."""
    _, variables = jax_backbone(*CHAIN)
    p, s = variables['params']['basenet'], variables['batch_stats']['basenet']
    names = [f'stage2_{i}' for i in range(1, 4)]
    jax_blocks = [jax_ppc.block_params(p[n], s[n]) for n in names]
    net = port_backbone(*CHAIN)
    return jax_blocks, [pc.block_params(getattr(net, n)) for n in names]


def random_pair(seed, b=2, h=17, w=15, half=22):
    """Post-relu activations are nonnegative."""
    rng = np.random.default_rng(seed)
    return tuple(np.abs(rng.normal(size=(b, h, w, half))).astype(np.float32)
                 for _ in range(2))


def images(seed, hw=(65, 49)):
    return np.random.default_rng(seed).normal(
        size=(2, *hw, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def test_block_params_match_jax():
    """The BN fold (float64, returned as float32) and the layout maps:
    1e-7."""
    jax_blocks, blocks = chain_blocks()
    for want, got in zip(jax_blocks, blocks):
        for field in pc.BlockParams._fields:
            w, g = np.asarray(getattr(want, field)), getattr(got, field)
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, \
                field
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-7, atol=1e-7,
                                       err_msg=field)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_matches_jax_reference(dtype):
    jax_blocks, blocks = chain_blocks()
    a, b = random_pair(1)
    want = jax_ppc.pair_chain_reference(jnp.asarray(a), jnp.asarray(b),
                                        jax_blocks, dtype=getattr(jnp, dtype))
    got = pc.pair_chain_plain(torch.from_numpy(a), torch.from_numpy(b),
                              blocks, getattr(torch, dtype))
    for w, g in zip(want, got):
        w = np.asarray(w, np.float32)
        assert g.dtype == getattr(torch, dtype) and g.shape == w.shape
        g = g.float().numpy()
        if dtype == 'float32':
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(g - w).max() <= 3e-2 * np.abs(w).max()


@pytest.mark.parametrize('n_bands', [1, 2, 3])
def test_plain_matches_jax_pallas_interpret(n_bands):
    """The banded Pallas kernel (interpret mode) computes the whole-image
    semantics the port's chain computes: 1e-5."""
    jax_blocks, blocks = chain_blocks()
    a, b = random_pair(2)
    want = jax_ppc.pair_chain_pallas(jnp.asarray(a), jnp.asarray(b),
                                     jax_blocks, n_bands=n_bands,
                                     dtype=jnp.float32, interpret=True)
    got = pc.pair_chain_plain(torch.from_numpy(a), torch.from_numpy(b),
                              blocks, torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def emulate_kernel(a, b, chain: pc.PackedChain):
    """``csrc/pair_chain.cu``'s arithmetic from the packed operands, in
    float32: expand_kernel's operand [a[q - o:], b[q - o:]] (o = q % 2, so
    1 here) against the packed W1, t at pitch Np with zero padding channels,
    the stencil over t padded with zeros, u's columns from C to Kp exact
    zeros, then W2."""
    c = chain.channels
    q, np_, kp = c // 2, chain.w1.shape[1], chain.w1.shape[2]
    o = q % 2
    _, h, w, _ = a.shape
    for i in range(len(chain.blocks)):
        s1, o1, sdw, odw, s2, o2 = chain.vec[i]
        x = torch.cat([a[..., q - o:], b[..., q - o:]], -1)
        w1 = chain.w1[i, :, :c + 2 * o].float()
        assert torch.count_nonzero(w1[:, [0, q + 1]] if o else w1[:, :0]) == 0
        assert torch.count_nonzero(chain.w1[i, :, c + 2 * o:]) == 0
        t = torch.relu(x @ w1.t() * s1 + o1)
        assert t.shape[-1] == np_ and torch.count_nonzero(t[..., c:]) == 0
        taps = chain.dwk[i].reshape(5, 5, np_)
        tp = F.pad(t, (0, 0, 2, 2, 2, 2))
        u = sum(tp[:, dy:dy + h, dx:dx + w] * taps[dy, dx]
                for dy in range(5) for dx in range(5))
        u = F.pad((u * sdw + odw)[..., :c], (0, kp - c))
        v = torch.relu(u @ chain.w2[i].float().t() * s2 + o2)
        a, b = pc.interleave(a[..., :q], b[..., :q]), v[..., :c]
    return a, b


def test_packed_layout_computes_the_chain():
    """The kernel's operand layout (``pack``) reproduces the plain chain:
    1e-5 in float32."""
    _, blocks = chain_blocks()
    chain = pc.pack(blocks, torch.float32)
    assert chain.w1.shape == (3, 2 * pc.N_STEP, pc.K_STEP)
    a, b = (torch.from_numpy(x) for x in random_pair(3))
    want = pc.pair_chain_plain(a, b, blocks, torch.float32)
    for w, g in zip(want, emulate_kernel(a, b, chain)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# every stage half-width of sn2k16 (174, 348, 696) and sn2k30/44 (256, 512,
# 1024), on sn2k16's three stage sides at 641 px and a small odd side
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('c', [174, 348, 696, 256, 512, 1024])
def test_launch_plan_fits_and_covers_every_pixel_once(c, dtype):
    for bsz, side in ((8, 161), (8, 81), (8, 41), (3, 13)):
        plan = pc.launch_plan(c, getattr(torch, dtype), bsz, side, side)
        assert plan.expand_smem <= pc.MAX_SMEM
        assert plan.project_smem <= pc.MAX_SMEM
        assert plan.np % pc.N_STEP == 0 and plan.np - c < pc.N_STEP
        m = bsz * side * side
        for tiles in (pc.expand_tile_pixels(plan, bsz, side, side),
                      pc.project_tile_pixels(plan, bsz, side, side)):
            hits = np.bincount(tiles[tiles >= 0], minlength=m)
            assert hits.shape == (m,) and (hits == 1).all(), (side, plan)
        if dtype == 'bfloat16':
            assert plan.n_tile in pc.GEMM_N
            assert plan.n_tiles * plan.n_tile >= plan.np
            for tiles, grid in ((plan.expand_tiles, plan.expand_grid),
                                (plan.project_tiles, plan.project_grid)):
                units = tiles * plan.n_tiles
                runs = pc.cta_units(units, grid)
                assert grid <= pc.N_SMS and runs[0][0] == 0
                assert runs[-1][1] == units
                assert all(r[1] == s[0] for r, s in zip(runs, runs[1:]))
                assert all(r[1] > r[0] for r in runs)
    # the sn2k16 plans: weight tiles shared by 128 pixels in both GEMMs at
    # stages 2 and 3, wgmma N = 176, and tiles without the 8x8 fringe
    if dtype == 'bfloat16' and c in (174, 348):
        plan = pc.launch_plan(c, torch.bfloat16, 8, 161, 161)
        assert plan.expand_rows == plan.project_rows == 128
        assert plan.n_tile == 176
        assert plan.project_tiles * 128 < 1.03 * 8 * 161 * 161


def test_apply_chain_on_cpu_is_the_plain_version():
    _, blocks = chain_blocks()
    a, b = (torch.from_numpy(x) for x in random_pair(4))
    before = (pc.KERNEL_LAUNCHES, pc.CUDA_LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        got = pc.apply_chain(a.to(dtype), b.to(dtype), pc.pack(blocks, dtype))
        want = pc.pair_chain_plain(a, b, blocks, dtype)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (pc.KERNEL_LAUNCHES, pc.CUDA_LAUNCHES) == before
    # the kernel's wrapper takes CUDA tensors only
    with pytest.raises(ValueError, match='CUDA tensor'):
        pc.pair_chain(a, b, pc.pack(blocks, torch.float32))
    assert (pc.KERNEL_LAUNCHES, pc.CUDA_LAUNCHES) == before


def jax_features(fn, repeats, channels, x):
    module, variables = jax_backbone(repeats, channels)
    return np.asarray(jax.jit(functools.partial(fn, module))(variables, x))


def test_backbone_apply_pair_matches_jax_and_canonical():
    """Against JAX ``backbone_apply_pair`` (1e-5) and the port's canonical
    ``ShuffleNetV2K`` (1e-4), float32."""
    x = images(5)
    net = port_backbone(*PAIR)
    assert fs.supports_pair(net)
    plan = fs.fold(net, torch.float32)
    assert plan.pair and sorted(plan.chains) == [2, 3, 4]
    got = fs.backbone_apply_pair(net, nchw(x), plan)
    want = jax_features(jax_fs.backbone_apply_pair, *PAIR, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        canonical = net(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got.numpy(), canonical, rtol=1e-4, atol=1e-4)


def test_r3_fallback_on_odd_half_widths_matches_jax():
    """Half-width 21 rules out the pair plan; the r3 plan against JAX
    ``backbone_apply``: 1e-5 in float32."""
    x = images(6)
    net = port_backbone(*ODD_HALF)
    assert fs.supports(net) and not fs.supports_pair(net)
    plan = fs.fold(net, torch.float32)
    assert not plan.pair and not plan.chains
    got = fs.backbone_features(net, nchw(x), plan)
    want = jax_features(jax_fs.backbone_apply, *ODD_HALF, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='even stage half-widths'):
        fs.fold(net, torch.float32, pair=True)


def test_apply_fast_sn2k16_matches_jax_apply_fast():
    """Full-width ShuffleNetV2K-16 at 65x65, float32: the port's
    ``Model.apply_fast`` (the pair plan, chains of 3, 7 and 3 blocks at
    q = 87, 174, 348) against the JAX ``Model.apply_fast``, 1e-4."""
    metas = coco_metas()
    model = jax_models.Factory(base_name='shufflenetv2k16', bf16=False) \
        .from_scratch('shufflenetv2k16', metas)
    variables = random_variables(model.module, seed=1)
    x = images(7, (65, 65))
    want = jax.jit(model.apply_fast)(variables, x)

    shell, stride = models.build_shell('shufflenetv2k16', coco_metas())
    shell.load_state_dict(models.from_jax_variables(
        jax_checkpoint.flatten_tree(variables)), strict=True)
    port = models.Model(shell, coco_metas(), base_stride=stride,
                        device=torch.device('cpu'), bf16=False)
    plan = port.inference_plan()
    assert plan.pair and [len(plan.chains[s].blocks) for s in (2, 3, 4)] == \
        [3, 7, 3]
    assert [plan.chains[s].channels for s in (2, 3, 4)] == [174, 348, 696]
    got = port(nchw(x))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, w.shape[1], w.shape[2], 5, 5)
        assert np.abs(g.numpy() - w).max() <= 1e-4


def test_bf16_apply_fast_matches_canonical_narrow():
    """bf16: the pair plan in bf16 against the canonical graph under bf16
    autocast, and against the float32 forward: 3% of the largest field
    value."""
    _, variables, _ = flax_narrow()
    flat = jax_checkpoint.flatten_tree(variables)
    x = nchw(images(8))
    model16, model32 = port_narrow(flat, bf16=True), port_narrow(flat)
    assert model16.inference_plan().dtype == torch.bfloat16
    fast, canonical, ref = model16(x), model16.apply(x), model32.apply(x)
    for f, c, r in zip(fast, canonical, ref):
        assert f.dtype == torch.float32 and f.shape == r.shape
        scale = float(r.abs().max())
        assert float((f - c).abs().max()) <= 0.03 * scale
        assert float((f - r).abs().max()) <= 0.03 * scale


def test_predictor_fused_matches_canonical():
    """A narrow CPU ``Predictor`` through the pair plan (its ``__call__``)
    and through the canonical graph decode the same annotations, within the
    decode tolerances (xyv 1e-3, scores 1e-4)."""
    module, variables, metas = flax_narrow()
    flat = jax_checkpoint.flatten_tree(detecting_variables(variables, metas))
    fused, canonical = port_narrow(flat), port_narrow(flat)
    canonical.fused_inference = False
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (129, 96, 3), dtype=np.uint8),
            rng.integers(0, 256, (86, 129, 3), dtype=np.uint8)]
    results = []
    for model in (fused, canonical):
        predictor = Predictor(model=model, device='cpu')
        predictor.long_edge = 129
        results.append(list(predictor.numpy_images(imgs)))
    assert fused.inference_plan().pair
    for (got, _, _), (want, _, _) in zip(*results):
        assert len(got) == len(want) > 0
        got = sorted(got, key=lambda a: -a.score)
        want = sorted(want, key=lambda a: -a.score)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.data, w.data, atol=1e-3, rtol=0)
            assert abs(g.score - w.score) <= 1e-4
