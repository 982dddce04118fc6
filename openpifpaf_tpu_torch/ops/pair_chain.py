"""A chain of stride-1 ShuffleNetV2K blocks on the parity pair.

Port of ``openpifpaf_tpu/ops/pallas_pair_chain.py``.  The inference pair
plan (``models/fused_shufflenet.py``) carries a stage as a pair ``(a, b)``
with ``logical = interleave(a, b)``.  A stride-1 block with inference
BatchNorm folded to per-channel ``(scale, bias)`` is then, per pixel and
with ``q = C / 2``:

    t  = relu(s1 * (a[q:] @ W1[0::2] + b[q:] @ W1[1::2]) + o1)
    u  = sdw * dw5x5_SAME(t) + odw
    v  = relu(s2 * (u @ W2) + o2)
    x1 = interleave(a[:q], b[:q])

and the state becomes ``(x1, v)``.

On the card a chain runs on the hand-written kernel ``csrc/pair_chain.cu``,
which replaces the TPU kernel
``openpifpaf_tpu/ops/pallas_pair_chain.py::pair_chain_pallas``.  The kernel
is bound as the PyTorch operator ``openpifpaf_tpu_torch::pair_chain``
(``pair_chain_op``), so that ``torch.export`` can trace a forward through
it: its schema holds the packed tensors of ``PackedChain`` and the width,
its CUDA implementation launches the kernel, its CPU implementation is
``pair_chain_plain``'s math on the same packed tensors (``packed_plain``),
and its fake implementation gives the output shapes.  It has no autograd
formula: K2 is inference only, and a backward through it raises.
``register_flop_formula`` gives ``torch.utils.flop_counter`` its products
and taps.  ``pair_chain_plain`` is the plain PyTorch version, the
translation of the whole-image ``_chain_math``
(``pallas_pair_chain.py:94-159``, the ``row0=None`` path).
``apply_chain`` calls the operator, whose dispatch routes by the pair's
device and nothing else: the plain version for CPU tensors, the kernel for
CUDA tensors or an error.  ``pair_chain``, the kernel's wrapper, takes CUDA
tensors only.  The Pallas kernel's row bands and halos are a device of the
TPU's VMEM and are not carried over: the kernel computes the whole-image
SAME semantics that the banded kernel reproduces.  ``launch_plan`` chooses
the kernel's tiles, rings, shared memory and grids in Python, from the
run-time shapes inside the CUDA implementation; ``expand_tile_pixels``,
``project_tile_pixels`` and ``cta_units`` map them to pixels and units as
the kernel does, for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import register_flop_formula

from .. import kernels
from ..models.base import BN_EPSILON

# chain calls of the CUDA kernel, counted by its wrapper; each call launches
# two CUDA kernels per block (CUDA_LAUNCHES)
KERNEL_LAUNCHES = 0
CUDA_LAUNCHES = 0

# the packed layouts: W1, W2 are (Np, Kp) with K padded to the kernel's
# 64-deep K chunks and N to a multiple of 16 (t's row pitch, 32 bytes in
# bf16); vec and dwk are padded to Np
K_STEP = 64
N_STEP = 16


class BlockParams(NamedTuple):
    """Folded parameters of one stride-1 pair-plan block (all float32),
    in the JAX package's layouts."""

    w1a: torch.Tensor   # (q, C)  branch2_conv1 rows 0::2 (the `a` side)
    w1b: torch.Tensor   # (q, C)  rows 1::2 (the `b` side)
    s1: torch.Tensor    # (C,)    folded branch2_norm1 scale
    o1: torch.Tensor    # (C,)    folded branch2_norm1 bias
    dwk: torch.Tensor   # (5, 5, C) depthwise kernel
    sdw: torch.Tensor   # (C,)
    odw: torch.Tensor   # (C,)
    w2: torch.Tensor    # (C, C)  branch2_conv2, (in, out)
    s2: torch.Tensor    # (C,)
    o2: torch.Tensor    # (C,)


def fold_bn(bn: nn.BatchNorm2d):
    """Inference BatchNorm -> (scale, bias) with ``y = x * scale + bias``:
    computed in float64, returned as float32 (``pallas_pair_chain.py:62``)."""
    inv = 1.0 / torch.sqrt(bn.running_var.double() + BN_EPSILON)
    scale = bn.weight.double() * inv
    bias = bn.bias.double() - bn.running_mean.double() * scale
    return scale.float(), bias.float()


def _matrix(conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv's (out, in, 1, 1) weight -> the (in, out) matmul weight."""
    return conv.weight.detach()[:, :, 0, 0].t().float()


@torch.no_grad()
def block_params(block) -> BlockParams:
    """A stride-1 ``InvertedResidualK`` -> its folded parameters."""
    w1 = _matrix(block.branch2_conv1)
    s1, o1 = fold_bn(block.branch2_norm1)
    sdw, odw = fold_bn(block.branch2_dwnorm)
    s2, o2 = fold_bn(block.branch2_norm2)
    dwk = block.branch2_dwconv.weight.detach()[:, 0].permute(1, 2, 0).float()
    return BlockParams(
        w1a=w1[0::2].contiguous(), w1b=w1[1::2].contiguous(), s1=s1, o1=o1,
        dwk=dwk.contiguous(), sdw=sdw, odw=odw,
        w2=_matrix(block.branch2_conv2).contiguous(), s2=s2, o2=o2)


def interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n), (..., n) -> (..., 2n) with a at even and b at odd channels."""
    return torch.stack((a, b), dim=-1).reshape(*a.shape[:-1], 2 * a.shape[-1])


def pair_chain_plain(a: torch.Tensor, b: torch.Tensor,
                     blocks: Sequence[BlockParams],
                     dtype: torch.dtype = torch.bfloat16):
    """Plain PyTorch chain.  a, b: (B, H, W, C) channels-last; returns the
    output pair in ``dtype``.

    Op for op the whole-image ``_chain_math``: each 1x1 conv multiplies
    ``dtype`` operands with float32 accumulation and rounds to ``dtype``
    (``preferred_element_type=f32`` then ``astype``); the elementwise ops and
    the 25 shifted multiply-adds of the depthwise conv round in ``dtype``.
    ``x1`` is built by indexing: the JAX 0/1 interleave matmul gives the
    same values (``v * 1`` plus exact zeros) and exists for the TPU's layout.
    """
    a = a.to(dtype)
    b = b.to(dtype)
    _, h, w, c = a.shape
    q = c // 2

    def mat(x, wt):
        y = torch.matmul(x.float(), wt.to(dtype).float())
        return y.to(dtype)

    def vec(p):
        return p.to(dtype)

    for blk in blocks:
        t = mat(a[..., q:], blk.w1a) + mat(b[..., q:], blk.w1b)
        t = torch.relu(t * vec(blk.s1) + vec(blk.o1))
        tp = F.pad(t, (0, 0, 2, 2, 2, 2))
        u = torch.zeros_like(t)
        for dy in range(5):
            for dx in range(5):
                u = u + tp[:, dy:dy + h, dx:dx + w] * vec(blk.dwk[dy, dx])
        u = u * vec(blk.sdw) + vec(blk.odw)
        v = torch.relu(mat(u, blk.w2) * vec(blk.s2) + vec(blk.o2))
        a, b = interleave(a[..., :q], b[..., :q]), v
    return a, b


class PackedChain(NamedTuple):
    """A chain's parameters in the kernel's layouts, made once per model.

    ``w1``: (n, Np, Kp) — per block ``W1[0::2]`` and ``W1[1::2]``
    transposed to (out, in) and laid out along K as the kernel reads the
    pair: with ``o = q % 2``, column ``o + k`` holds the row of ``a[q + k]``
    and column ``q + 2 o + k`` that of ``b[q + k]`` (the kernel's operand
    is [a[q - o:], b[q - o:]], so that each two-channel word of the pair
    lands on a word of the operand where q is odd; the other columns are
    zero); ``w2``: (n, Np, Kp), W2 transposed; both in the storage type,
    zero-padded to ``Kp`` (``C + 2 o`` rounded up to ``K_STEP``) and
    ``Np`` (``C`` rounded up to ``N_STEP``).  ``vec``:
    (n, 6, Np) float32 rows s1, o1, sdw, odw, s2, o2; ``dwk``: (n, 25, Np)
    float32 depthwise taps, row ``5 * dy + dx``; both zero-padded.
    ``blocks`` keeps the float32 ``BlockParams`` for the plain version."""

    blocks: List[BlockParams]
    w1: torch.Tensor
    w2: torch.Tensor
    vec: torch.Tensor
    dwk: torch.Tensor
    channels: int
    dtype: torch.dtype


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@torch.no_grad()
def pack(blocks: Sequence[BlockParams], dtype: torch.dtype,
         device=None) -> PackedChain:
    """Lay a chain's folded parameters out for the kernel, on ``device``
    (default: where the parameters are)."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError('pack: a chain needs at least one block')
    c = blocks[0].s1.shape[0]
    device = torch.device(device) if device is not None else blocks[0].s1.device
    q = c // 2
    o = q % 2
    kp, np_ = _round_up(c + 2 * o, K_STEP), _round_up(c, N_STEP)
    n = len(blocks)
    w1 = torch.zeros(n, np_, kp, dtype=torch.float32, device=device)
    w2 = torch.zeros_like(w1)
    vec = torch.zeros(n, 6, np_, dtype=torch.float32, device=device)
    dwk = torch.zeros(n, 25, np_, dtype=torch.float32, device=device)
    for i, blk in enumerate(blocks):
        blk = BlockParams(*(p.to(device, torch.float32) for p in blk))
        blocks[i] = blk
        if blk.w2.shape != (c, c) or blk.w1a.shape != (c // 2, c):
            raise ValueError('pack: every block of a chain has one width')
        w1[i, :c, o:o + q] = blk.w1a.t()
        w1[i, :c, q + 2 * o:c + 2 * o] = blk.w1b.t()
        w2[i, :c, :c] = blk.w2.t()
        for j, p in enumerate((blk.s1, blk.o1, blk.sdw, blk.odw, blk.s2,
                               blk.o2)):
            vec[i, j, :c] = p
        dwk[i, :, :c] = blk.dwk.reshape(25, c)
    return PackedChain(blocks=blocks, w1=w1.to(dtype).contiguous(),
                       w2=w2.to(dtype).contiguous(), vec=vec, dwk=dwk,
                       channels=c, dtype=dtype)


# ------------------------------------------------------------ launch plan
MAX_SMEM = 232448     # dynamic shared memory of one block on sm_90
SM_SMEM = 233472      # shared memory of one SM; each block reserves 1 KB
N_SMS = 132           # SMs of an H100 SXM
GEMM_N = (176, 256)   # the bf16 kernels' wgmma N (output channels of a tile)
F32_N = 128           # the f32 kernels' output channels of a tile


class LaunchPlan(NamedTuple):
    """How ``csrc/pair_chain.cu`` runs one chain: tiles, rings, shared
    memory and grids, for one width, storage type and image size.  The C
    entry points take it as an int32 array in this field order and
    validate it.

    bfloat16: one producer warpgroup brings every operand by TMA or bulk
    copy through rings of ``*_stages`` (weights), ``halo_stages`` (t's
    haloed tiles) and ``slab_stages`` (the pair's pixels), and ``*_groups``
    consumer warpgroups of 64 pixels each run ``wgmma``, so a tile has
    ``64 * groups`` pixels; a unit of work is (pixel tile, output tile of
    ``n_tile`` channels), and ``*_grid`` persistent CTAs take contiguous
    runs of units (``cta_units``).  The expand tiles are runs of
    consecutive pixels, whose slabs hold whole rows of a and b, or with
    ``slab_half`` each row from channel q - q % 2 on; the project tiles are
    ``tile_h`` x ``tile_w`` pixels of one image.  float32 (the parity
    check, CUDA-core FMAs): ``*_groups`` and the slab fields are 0, one CTA
    of 256 threads per tile and all output tiles, no units."""

    kp: int
    np: int
    n_tile: int
    n_tiles: int
    expand_groups: int
    expand_rows: int
    expand_stages: int
    expand_tiles: int
    expand_grid: int
    expand_smem: int
    project_groups: int
    project_rows: int
    project_stages: int
    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    halo_stages: int
    project_tiles: int
    project_grid: int
    project_smem: int
    slab_half: int
    slab_stages: int


def _bf16_common_smem(np_, n_tile, stages):
    """Bytes: 1 KB to align the base, the weight ring, the epilogue's scale
    and bias (2 x np float32), the barriers."""
    return 1024 + stages * n_tile * 128 + 8 * np_ + 256


def _slab_from(c, slab_half):
    q = c // 2
    return q - q % 2 if slab_half else 0


def bf16_expand_smem(groups, np_, n_tile, stages, c, slab_half, slab_stages):
    """The common part plus each consumer group's ring of pair slabs: 64
    pixels of a and of b from channel ``_slab_from`` on, 128-byte aligned."""
    slab = _round_up(256 * (c - _slab_from(c, slab_half)), 128)
    return (_bf16_common_smem(np_, n_tile, stages)
            + groups * slab_stages * slab)


def bf16_project_smem(groups, kp, np_, n_tile, stages, tile_h, tile_w,
                      halo_stages):
    """The common part plus the resident operand (64 * groups pixels x kp,
    128-byte swizzled) and the ring of t's haloed tiles (64 channels of
    (tile_h + 4) x (tile_w + 4) pixels each, then the chunk's 25 taps, sdw
    and odw as 27 x 64 float32; 1 KB aligned)."""
    halo = _round_up(128 * (tile_h + 4) * (tile_w + 4) + 27 * 64 * 4, 1024)
    return (_bf16_common_smem(np_, n_tile, stages) + 128 * groups * kp
            + halo_stages * halo)


def f32_smem(rows, kp, stages, tile_w=None):
    """The f32 kernels: the operand (rows x (kp + 4)), then a region for
    the weight ring of ``stages`` 128 x 36 tiles or, in project_kernel
    (``tile_w`` given), the two stencil buffers if larger."""
    ring = stages * F32_N * 36 * 4
    stencil = 0 if tile_w is None else \
        2 * (12 * (tile_w + 4) * 20 * 4 + 25 * 16 * 4 + 2 * 16 * 4)
    return rows * (kp + 4) * 4 + max(ring, stencil)


def _f32_stages(rows, kp, tile_w=None):
    """Three weight tiles in flight, unless that leaves an SM fewer CTAs
    (two at most, the register budget)."""
    def ctas(stages):
        return min(2, SM_SMEM // (f32_smem(rows, kp, stages, tile_w) + 1024))
    return 3 if ctas(3) >= ctas(2) else 2


def _tile_shapes(rows, h, w):
    """Project tile shapes of at most ``rows`` pixels and an even width
    (the bf16 stencil takes pixels in pairs), fewest tiles first, then the
    smallest halo: for each height, the narrowest width that keeps the
    count of tiles across the image."""
    shapes = []
    for th in range(1, min(h, rows) + 1):
        widest = min(_round_up(w, 2), rows // th) // 2 * 2
        if widest == 0:
            break
        nx = -(-w // widest)
        tw = _round_up(-(-w // nx), 2)
        shapes.append(((-(-h // th)) * nx, (th + 4) * (tw + 4), th, tw))
    return [(th, tw) for *_, th, tw in sorted(shapes)]


@functools.lru_cache(maxsize=None)
def launch_plan(c: int, dtype: torch.dtype, batch: int, h: int, w: int,
                n_sms: int = N_SMS) -> LaunchPlan:
    """The kernel's plan for a chain of half-width ``c`` on (batch, h, w)
    in ``dtype``; raises ValueError where no plan fits a block's shared
    memory (no width of sn2k16, sn2k30 or sn2k44)."""
    if c <= 0 or c % 2 or min(batch, h, w) <= 0:
        raise ValueError(f'pair_chain: no plan for width {c} on '
                         f'({batch}, {h}, {w})')
    kp = _round_up(c + 2 * (c // 2 % 2), K_STEP)
    np_ = _round_up(c, N_STEP)
    m = batch * h * w
    if dtype == torch.float32:
        rows = 64 if f32_smem(64, kp, 2, 8) <= MAX_SMEM else 32
        tw = rows // 8
        stages_e, stages_p = _f32_stages(rows, kp), _f32_stages(rows, kp, tw)
        smem_e, smem_p = (f32_smem(rows, kp, stages_e),
                          f32_smem(rows, kp, stages_p, tw))
        if smem_e > MAX_SMEM or smem_p > MAX_SMEM:
            raise ValueError(f'pair_chain: width {c} in float32 does not '
                             f'fit a block')
        ty, tx = -(-h // 8), -(-w // tw)
        return LaunchPlan(kp, np_, F32_N, -(-np_ // F32_N), 0, rows,
                          stages_e, -(-m // rows), -(-m // rows), smem_e,
                          0, rows, stages_p, 8, tw, ty, tx, 0,
                          batch * ty * tx, batch * ty * tx, smem_p, 0, 0)
    if dtype != torch.bfloat16:
        raise ValueError(f'pair_chain: no plan for {dtype}')
    # the wgmma width that pads Np least (ties: the wider) among those whose
    # kernels fit a block
    for n_tile in sorted(GEMM_N, key=lambda n: (-(-np_ // n) * n, -n)):
        # whole rows in the slabs where they fit, else rows' second halves
        # where those start 16-byte aligned
        halves = (0, 1) if (c // 2 - c // 2 % 2) % 8 == 0 and c % 8 == 0 \
            else (0,)
        expand = next(((g, s, half, ss) for half in halves for g in (2, 1)
                       for ss in (2, 1) for s in (4, 3, 2)
                       if bf16_expand_smem(g, np_, n_tile, s, c, half, ss)
                       <= MAX_SMEM), None)
        project = next(((g, s, th, tw, hs) for g in (2, 1)
                        for th, tw in _tile_shapes(64 * g, h, w)
                        for hs in (3, 2, 1) for s in (4, 3, 2)
                        if bf16_project_smem(g, kp, np_, n_tile, s, th, tw, hs)
                        <= MAX_SMEM), None)
        if expand is not None and project is not None:
            break
    else:
        raise ValueError(f'pair_chain: width {c} in bfloat16 does not fit '
                         f'a block')
    n_tiles = -(-np_ // n_tile)
    ge, se, slab_half, slab_stages = expand
    gp, sp, th, tw, hs = project
    tiles_e = -(-m // (64 * ge))
    ty, tx = -(-h // th), -(-w // tw)
    tiles_p = batch * ty * tx
    return LaunchPlan(
        kp, np_, n_tile, n_tiles, ge, 64 * ge, se, tiles_e,
        min(tiles_e * n_tiles, n_sms),
        bf16_expand_smem(ge, np_, n_tile, se, c, slab_half, slab_stages),
        gp, 64 * gp, sp, th, tw, ty, tx, hs, tiles_p,
        min(tiles_p * n_tiles, n_sms),
        bf16_project_smem(gp, kp, np_, n_tile, sp, th, tw, hs), slab_half,
        slab_stages)


def cta_units(units: int, grid: int):
    """The contiguous run of units each persistent CTA takes, as the
    kernels compute it: [b * units // grid, (b + 1) * units // grid)."""
    return [(b * units // grid, (b + 1) * units // grid)
            for b in range(grid)]


def expand_tile_pixels(plan: LaunchPlan, batch: int, h: int, w: int):
    """(expand_tiles, expand_rows) flat pixel index of each GEMM row of
    each expand tile, -1 for rows past the last pixel."""
    m = batch * h * w
    idx = np.arange(plan.expand_tiles * plan.expand_rows).reshape(
        plan.expand_tiles, plan.expand_rows)
    return np.where(idx < m, idx, -1)


def project_tile_pixels(plan: LaunchPlan, batch: int, h: int, w: int):
    """(project_tiles, project_rows) flat pixel index of each GEMM row of
    each project tile, -1 for rows outside the tile or the image.  Tile
    ``(img * tiles_y + ty) * tiles_x + tx``, row ``r`` is pixel
    ``(ty * tile_h + r // tile_w, tx * tile_w + r % tile_w)``."""
    tile = np.arange(plan.project_tiles)[:, None]
    r = np.arange(plan.project_rows)[None, :]
    tx = tile % plan.tiles_x
    ty = tile // plan.tiles_x % plan.tiles_y
    img = tile // (plan.tiles_x * plan.tiles_y)
    y = ty * plan.tile_h + r // plan.tile_w
    x = tx * plan.tile_w + r % plan.tile_w
    inside = (r < plan.tile_h * plan.tile_w) & (y < h) & (x < w)
    return np.where(inside, (img * h + y) * w + x, -1)


# ------------------------------------------------------------------ kernel
_LIB = None
_ENTRY = {torch.bfloat16: 'pair_chain_bf16', torch.float32: 'pair_chain_f32'}


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library('pair_chain')
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'pair_chain: {name} must be a CUDA tensor, got '
                         f'{t.device}')
    if t.dtype not in _ENTRY:
        raise ValueError(f'pair_chain: {name} must be bfloat16 or float32, '
                         f'got {t.dtype}')
    if t.dim() != 4:
        raise ValueError(f'pair_chain: {name} must be (B, H, W, C), got '
                         f'{tuple(t.shape)}')
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f'pair_chain: {name} {tuple(t.shape)} {t.dtype} on '
                         f'{t.device} does not match a')
    if not t.is_contiguous():
        raise ValueError(f'pair_chain: {name} must be contiguous')
    if t.data_ptr() % 16:
        raise ValueError(f'pair_chain: {name} must start on a 16-byte '
                         f'boundary')


def _check_params(a: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  vec: torch.Tensor, dwk: torch.Tensor, channels: int) -> None:
    """The parameters as ``pack`` lays them out for the pair ``a``: on its
    device, ``w1`` and ``w2`` (n, Np, Kp) in its type, ``vec`` (n, 6, Np)
    and ``dwk`` (n, 25, Np) float32, all contiguous, with Np and Kp
    ``pack``'s for ``channels``.  The kernel reads them by pointer, so any
    other layout raises here."""
    c = channels
    if c <= 0 or c % 2:
        raise ValueError(f'pair_chain: chain width {c} must be even and '
                         f'positive')
    kp, np_ = _round_up(c + 2 * (c // 2 % 2), K_STEP), _round_up(c, N_STEP)
    n = w1.shape[0] if w1.dim() == 3 else 0
    want = {'w1': (w1, a.dtype, (n, np_, kp)),
            'w2': (w2, a.dtype, (n, np_, kp)),
            'vec': (vec, torch.float32, (n, 6, np_)),
            'dwk': (dwk, torch.float32, (n, 25, np_))}
    for name, (t, dtype, shape) in want.items():
        if (n == 0 or t.device != a.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f'pair_chain: {name} {tuple(t.shape)} {t.dtype} on '
                f'{t.device} (contiguous: {t.is_contiguous()}) is not '
                f'packed for a chain of width {c} on a {a.dtype} pair on '
                f'{a.device}: want {shape} {dtype}, contiguous, n > 0')


def _launch(a: torch.Tensor, b: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, vec: torch.Tensor, dwk: torch.Tensor,
            channels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: the chain on (B, H, W, C)
    bfloat16 or float32 CUDA tensors, computed in their type with float32
    accumulation, with the parameters ``pack`` laid out for that type and
    device.  Returns the output pair.  Launches two kernels per block on
    the current stream without synchronizing."""
    global KERNEL_LAUNCHES, CUDA_LAUNCHES
    _check_operand('a', a, None)
    _check_operand('b', b, a)
    bsz, h, w, c = a.shape
    if c != channels:
        raise ValueError(f'pair_chain: pair width {c}, chain width '
                         f'{channels} (must be equal)')
    _check_params(a, w1, w2, vec, dwk, channels)
    n = w1.shape[0]
    kp = w1.shape[2]
    if bsz * h * w * kp >= 2 ** 31 or bsz * h * w == 0:
        raise ValueError(f'pair_chain: shape {tuple(a.shape)} out of range')
    with torch.cuda.device(a.device):
        plan = launch_plan(c, a.dtype, bsz, h, w, _sm_count(a.device))
        out_a, out_b = torch.empty_like(a), torch.empty_like(b)
        tmp_a = torch.empty_like(a) if n > 1 else out_a
        tmp_b = torch.empty_like(b) if n > 1 else out_b
        t = torch.empty((bsz * h * w, plan.np), dtype=a.dtype,
                        device=a.device)
        plan_arr = (ctypes.c_int * len(plan))(*plan)
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_lib(), _ENTRY[a.dtype])(
            a.data_ptr(), b.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
            tmp_a.data_ptr(), tmp_b.data_ptr(), t.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), vec.data_ptr(), dwk.data_ptr(),
            n, bsz, h, w, c, ctypes.addressof(plan_arr), stream)
    if rc != 0:
        raise RuntimeError(f'pair_chain: kernel launch failed with code '
                           f'{rc} (plan {plan})')
    KERNEL_LAUNCHES += 1
    CUDA_LAUNCHES += 2 * n
    return out_a, out_b


def unpack(w1: torch.Tensor, w2: torch.Tensor, vec: torch.Tensor,
           dwk: torch.Tensor, channels: int) -> List[BlockParams]:
    """``pack``'s layout read back: the chain's float32 ``BlockParams``
    (the products' weights as rounded to the storage type)."""
    c = channels
    q = c // 2
    o = q % 2
    return [BlockParams(
        w1a=w1[i, :c, o:o + q].t().float().contiguous(),
        w1b=w1[i, :c, q + 2 * o:c + 2 * o].t().float().contiguous(),
        s1=vec[i, 0, :c], o1=vec[i, 1, :c],
        dwk=dwk[i, :, :c].reshape(5, 5, c),
        sdw=vec[i, 2, :c], odw=vec[i, 3, :c],
        w2=w2[i, :c, :c].t().float().contiguous(),
        s2=vec[i, 4, :c], o2=vec[i, 5, :c]) for i in range(w1.shape[0])]


def packed_plain(a: torch.Tensor, b: torch.Tensor, w1: torch.Tensor,
                 w2: torch.Tensor, vec: torch.Tensor, dwk: torch.Tensor,
                 channels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's CPU implementation: ``pair_chain_plain`` on the
    packed tensors, in their storage type (``w1.dtype``)."""
    if (b.dtype != a.dtype or b.device != a.device or a.dim() != 4
            or a.shape[-1] != channels or b.shape != a.shape):
        raise ValueError(f'pair_chain: pair {tuple(a.shape)} {a.dtype} and '
                         f'{tuple(b.shape)} {b.dtype}, chain of width '
                         f'{channels}')
    _check_params(a, w1, w2, vec, dwk, channels)
    return pair_chain_plain(a, b, unpack(w1, w2, vec, dwk, channels),
                            w1.dtype)


pair_chain_op = torch.library.custom_op(
    'openpifpaf_tpu_torch::pair_chain', _launch, mutates_args=(),
    device_types='cuda',
    schema='(Tensor a, Tensor b, Tensor w1, Tensor w2, Tensor vec, '
           'Tensor dwk, int channels) -> (Tensor, Tensor)')
pair_chain_op.register_kernel('cpu', packed_plain)


@pair_chain_op.register_fake
def _fake(a, b, w1, w2, vec, dwk, channels):
    return torch.empty_like(a), torch.empty_like(b)


@register_flop_formula(torch.ops.openpifpaf_tpu_torch.pair_chain)
def chain_flops(a_shape, b_shape, w1_shape, w2_shape, vec_shape, dwk_shape,
                channels, *args, out_shape=None, **kwargs) -> int:
    """Per pixel and block two C x C products and the 25 taps of the 5x5
    depthwise conv, two operations per multiply-add (as
    ``torch.utils.flop_counter`` counts a convolution)."""
    bsz, h, w, c = a_shape
    return 2 * w1_shape[0] * bsz * h * w * (2 * c * c + 25 * c)


def pair_chain(a: torch.Tensor, b: torch.Tensor, chain: PackedChain):
    """The kernel's wrapper: the chain on CUDA tensors through the
    operator (``_launch``), with the parameters ``pack`` laid out for
    their type and device.  A CPU tensor raises."""
    _check_operand('a', a, None)
    return pair_chain_op(a, b, chain.w1, chain.w2, chain.vec, chain.dwk,
                         chain.channels)


def apply_chain(a: torch.Tensor, b: torch.Tensor, chain: PackedChain):
    """The chain through the operator on the pair's device: the plain
    version for CPU tensors, the kernel for CUDA tensors (no other switch,
    no fallback)."""
    return pair_chain_op(a, b, chain.w1, chain.w2, chain.vec, chain.dwk,
                         chain.channels)
