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

On the card a chain runs on the hand-written kernel ``csrc/pair_chain.cu``
(``pair_chain``), which replaces the TPU kernel
``openpifpaf_tpu/ops/pallas_pair_chain.py::pair_chain_pallas``.  Beside it,
``pair_chain_plain`` is the plain PyTorch version, the translation of the
whole-image ``_chain_math`` (``pallas_pair_chain.py:94-159``, the
``row0=None`` path).  ``apply_chain`` takes the plain version for CPU
tensors only; a CUDA tensor launches the kernel or raises.  The Pallas
kernel's row bands and halos are a device of the TPU's VMEM and are not
carried over: the kernel computes the whole-image SAME semantics that the
banded kernel reproduces.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..models.base import BN_EPSILON

# chain calls of the CUDA kernel, counted by its wrapper; each call launches
# three CUDA kernels per block (CUDA_LAUNCHES)
KERNEL_LAUNCHES = 0
CUDA_LAUNCHES = 0

# the kernel's tiles: weights and per-channel vectors are padded to these
K_STEP = 64      # the K padding of W1, W2 (a multiple of the kernel's tiles)
N_TILE = 128     # output channels of one tile


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
    and column ``q + 2 o + k`` that of ``b[q + k]`` (so that the kernel's
    2-channel copies stay aligned where q is odd; the other columns are
    zero); ``w2``: (n, Np, Kp), W2 transposed; both in the storage type,
    zero-padded to ``Kp`` (``C + 2 o`` rounded up to ``K_STEP``) and ``Np``
    (``C`` rounded up to ``N_TILE``).  ``vec``: (n, 6, Np) float32
    rows s1, o1, sdw, odw, s2, o2; ``dwk``: (n, 25, Np) float32 depthwise
    taps, row ``5 * dy + dx``; both zero-padded.  ``blocks`` keeps the
    float32 ``BlockParams`` for the plain version."""

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
    kp, np_ = _round_up(c + 2 * o, K_STEP), _round_up(c, N_TILE)
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


_LIB = None
_ENTRY = {torch.bfloat16: 'pair_chain_bf16', torch.float32: 'pair_chain_f32'}


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library('pair_chain')
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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


def pair_chain(a: torch.Tensor, b: torch.Tensor, chain: PackedChain):
    """The CUDA kernel: the chain on (B, H, W, C) bfloat16 or float32 CUDA
    tensors, computed in their type with float32 accumulation, with the
    parameters ``pack`` laid out for that type and device.  Returns the
    output pair.  Launches three kernels per block on the current stream
    without synchronizing."""
    global KERNEL_LAUNCHES, CUDA_LAUNCHES
    _check_operand('a', a, None)
    _check_operand('b', b, a)
    bsz, h, w, c = a.shape
    if chain.dtype != a.dtype or chain.w1.device != a.device:
        raise ValueError(f'pair_chain: parameters packed for {chain.dtype} on '
                         f'{chain.w1.device}, pair is {a.dtype} on {a.device}')
    if c != chain.channels or c % 2:
        raise ValueError(f'pair_chain: pair width {c}, chain width '
                         f'{chain.channels} (must be equal and even)')
    n = len(chain.blocks)
    kp = chain.w1.shape[2]
    if bsz * h * w * kp >= 2 ** 31 or bsz * h * w == 0:
        raise ValueError(f'pair_chain: shape {tuple(a.shape)} out of range')
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    tmp_a = torch.empty_like(a) if n > 1 else out_a
    tmp_b = torch.empty_like(b) if n > 1 else out_b
    t = torch.empty((bsz * h * w, kp), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_lib(), _ENTRY[a.dtype])(
            a.data_ptr(), b.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
            tmp_a.data_ptr(), tmp_b.data_ptr(), t.data_ptr(),
            chain.w1.data_ptr(), chain.w2.data_ptr(), chain.vec.data_ptr(),
            chain.dwk.data_ptr(), n, bsz, h, w, c, stream)
    if rc == -1:
        raise ValueError(f'pair_chain: width {c} in {a.dtype} needs more '
                         f'shared memory than a block has')
    if rc != 0:
        raise RuntimeError(f'pair_chain: kernel launch failed with CUDA '
                           f'error {rc}')
    KERNEL_LAUNCHES += 1
    CUDA_LAUNCHES += 3 * n
    return out_a, out_b


def apply_chain(a: torch.Tensor, b: torch.Tensor, chain: PackedChain):
    """The chain on the pair's device: the plain version for CPU tensors,
    the kernel for CUDA tensors (no other switch, no fallback)."""
    if a.device.type == 'cpu':
        return pair_chain_plain(a, b, chain.blocks, chain.dtype)
    return pair_chain(a, b, chain)
