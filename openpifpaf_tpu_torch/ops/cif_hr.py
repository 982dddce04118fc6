"""CifHr: high-resolution confidence accumulation.

Port of ``openpifpaf_tpu/ops/cif_hr.py``.  Reference parity:
``src/openpifpaf/csrc/src/decoder/utils/cif_hr.cpp:~20``: every CIF cell
above ``v_threshold`` splats a truncated Gaussian blob, centred at its
regressed target and with width proportional to its predicted scale, into a
high-resolution accumulator clipped at 1.0.  A 2D Gaussian is separable:

    hr[f, Y, X] = clip( sum_c  v_c * gy[c, Y] * gx[c, X], 0, 1 )

On the card the splat runs on the hand-written kernel ``csrc/cif_hr.cu``
(``cif_hr_accumulate``), which replaces the TPU kernel
``openpifpaf_tpu/ops/pallas_cif_hr.py::accumulate_pallas`` with two CUDA
kernels: ``bin_kernel`` bins each field's cells to output tiles (bitmasks,
``tile_bins_plain`` is its plain version) and ``splat_kernel`` splats each
tile from its own cells.  Beside it, ``accumulate_plain`` is the plain
PyTorch version of the output — the profiles and an ``einsum`` over cells,
the translation of ``cif_hr.py:138-161``.  The plain versions serve CPU
tensors only; a CUDA tensor launches the kernel or raises.  The kernel
computes f32 profiles (like the Pallas kernel), so on the card the decode
has ``profile_bf16=False`` semantics.  ``accumulate`` reaches both through
the registered operator ``openpifpaf_tpu_torch::cif_hr_accumulate``
(``cif_hr_op``: CUDA implementation the kernel, CPU implementation
``accumulate_plain``, a fake one for tracing, no autograd), which
``torch.export`` records as one call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List

import torch

from .common import masked_top_k
from .. import kernels

# calls of the kernel's wrapper (KERNEL_LAUNCHES) and the CUDA kernels they
# launch (CUDA_LAUNCHES: bin_kernel and splat_kernel, 2 per call)
KERNEL_LAUNCHES = 0
CUDA_LAUNCHES = 0
# output tile (rows, columns) of the CUDA kernels (TH x TW in
# csrc/cif_hr.cu): of 32 x 32, 32 x 64, 64 x 32 and 64 x 64 the fastest on
# the served inputs (PERF.md)
TILE = (32, 64)


@dataclasses.dataclass(frozen=True)
class CifHrConfig:
    """Static configuration (reference static class attrs, cif_hr.hpp)."""

    v_threshold: float = 0.1     # min cell confidence to splat
    neighbor_factor: float = 1.0 / 16.0  # 1/(#painted cells per keypoint)
    min_sigma_px: float = 2.0    # lower bound on blob sigma (one hires cell)
    sigma_factor: float = 0.5    # sigma = sigma_factor * predicted scale
    truncate: float = 1.0        # truncate blob at truncate * sigma
    spacing: int = 2             # hires grid spacing in px
    min_scale: float = 0.0       # skip cells with predicted scale below this
    # active-cell compaction: splat only the top ``max_active`` cells per
    # field (by confidence); engages when H*W > compaction_ratio*max_active
    max_active: int = 1024
    compaction_ratio: float = 2.0
    # applies on the CPU only: the plain version rounds the Gaussian
    # profiles to bf16 before the f32 contraction, as the JAX einsum path
    # does by default; the CUDA kernel computes f32 profiles, which is
    # ``profile_bf16=False`` (``CifCaf.config_for`` sets it so on the card)
    profile_bf16: bool = True


def accumulate(conf: torch.Tensor, x_px: torch.Tensor, y_px: torch.Tensor,
               scale_px: torch.Tensor, *, out_hw, config: CifHrConfig,
               extra_mask: torch.Tensor = None, y_offset_px: float = 0.0,
               clip: bool = True, return_overflow: bool = False):
    """Accumulate one CIF head into a hires grid.

    :param conf: (B, F, H, W) cell confidences in [0, 1], or (F, H, W)
    :param x_px, y_px: regressed absolute target positions, px (same shape)
    :param scale_px: predicted keypoint scale, px (same shape)
    :param out_hw: (Hh, Wh) hires grid size
    :param y_offset_px: px offset of the grid's first row (banded decode)
    :param clip: apply the final clip-to-1.0
    :param return_overflow: also return the (B,) int32 count of active cells
        dropped by ``max_active`` compaction
    :returns: (B, F, Hh, Wh) accumulated confidence (without a leading B
        when ``conf`` had none)
    """
    single = conf.dim() == 3
    if single:
        conf, x_px, y_px, scale_px = (t[None] for t in
                                      (conf, x_px, y_px, scale_px))
        if extra_mask is not None:
            extra_mask = extra_mask[None]
    b, f, h, w = conf.shape
    n = h * w

    mask = conf > config.v_threshold
    if config.min_scale > 0.0:
        mask = mask & (scale_px >= config.min_scale)
    if extra_mask is not None:
        mask = mask & extra_mask

    v = torch.where(mask, conf * config.neighbor_factor,
                    torch.zeros((), device=conf.device)).reshape(b, f, n)
    x = x_px.reshape(b, f, n)
    y = y_px.reshape(b, f, n)
    sigma = torch.clamp(config.sigma_factor * scale_px,
                        min=config.min_sigma_px).reshape(b, f, n)

    n_dropped = torch.zeros(b, dtype=torch.int32, device=conf.device)
    if config.max_active and n > config.compaction_ratio * config.max_active:
        _, idx, valid = masked_top_k(conf.reshape(b, f, n),
                                     mask.reshape(b, f, n), config.max_active)
        n_dropped = torch.clamp(mask.reshape(b, -1).sum(1)
                                - valid.reshape(b, -1).sum(1), min=0).int()
        v = torch.where(valid, torch.gather(v, 2, idx), 0.0)
        x = torch.gather(x, 2, idx)
        y = torch.gather(y, 2, idx)
        sigma = torch.gather(sigma, 2, idx)

    hr = cif_hr_op(v, x, y, sigma, [int(s) for s in out_hw],
                   float(config.spacing), float(config.truncate),
                   float(y_offset_px), bool(clip), config.profile_bf16)
    if single:
        hr, n_dropped = hr[0], n_dropped[0]
    return (hr, n_dropped) if return_overflow else hr


def accumulate_plain(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     sigma: torch.Tensor, *, out_hw, spacing: float,
                     truncate: float, y_offset_px: float = 0.0,
                     clip: bool = True,
                     profile_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch splat: (B, F, N) cells -> (B, F, Hh, Wh).

    ``profile_bf16`` rounds ``gy``/``gx`` to bf16 and contracts in f32; a
    bf16 x bf16 product is exact in f32, so this reproduces JAX's
    ``preferred_element_type=f32`` contraction up to summation order.
    """
    hh, wh = out_hw
    xs = torch.arange(wh, dtype=torch.float32, device=v.device) * spacing
    ys = torch.arange(hh, dtype=torch.float32, device=v.device) * spacing \
        + y_offset_px
    dx = xs - x[..., None]                                  # (B, F, N, Wh)
    dy = ys - y[..., None]                                  # (B, F, N, Hh)
    inv2s2 = (0.5 / (sigma * sigma))[..., None]
    trunc = (truncate * sigma)[..., None]
    zero = torch.zeros((), device=v.device)
    # inside the window the exponent is >= -truncate^2 / 2; the floor below
    # that changes only values the window zeroes, and spares the CPU's exp
    # its slow path for large negative arguments
    floor = -0.5 * truncate * truncate - 1.0
    gx = torch.where(dx.abs() <= trunc, torch.exp(
        torch.clamp(-dx * dx * inv2s2, min=floor)), zero)
    gy = torch.where(dy.abs() <= trunc, torch.exp(
        torch.clamp(-dy * dy * inv2s2, min=floor)), zero)
    gy = gy * v[..., None]
    if profile_bf16:
        gy = gy.bfloat16().float()
        gx = gx.bfloat16().float()
    hr = torch.einsum('bfny,bfnx->bfyx', gy, gx)
    return torch.clamp(hr, 0.0, 1.0) if clip else hr


def tile_grid(out_hw, tile=TILE):
    """(tiles down, tiles across) of an (Hh, Wh) grid cut into ``tile``."""
    (hh, wh), (th, tw) = out_hw, tile
    return -(-int(hh) // th), -(-int(wh) // tw)


def tile_bins_plain(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    sigma: torch.Tensor, *, out_hw, spacing: float,
                    truncate: float, y_offset_px: float = 0.0,
                    tile=TILE) -> torch.Tensor:
    """Plain version of the kernel's first pass: (B, F, N) cells ->
    (B, F, tiles, ceil(N / 32)) int32 bitmasks (the bits of the kernel's
    uint32 words), tiles row-major.  Bit ``c % 32`` of word ``c // 32`` is
    set when ``v[c] != 0`` and the cell's truncation window, widened by
    1 px, meets the tile.  Every quantity is the f32 expression the kernel
    rounds the same way, so at the kernel's ``TILE`` the masks are equal
    bit for bit; other tiles serve the CPU tests of the binning."""
    hh, wh = (int(s) for s in out_hw)
    th, tw = tile
    ty, tx = tile_grid(out_hw, tile)
    f32 = dict(dtype=torch.float32, device=v.device)
    sp = torch.tensor(spacing, **f32)
    y_off = torch.tensor(y_offset_px, **f32)
    r0 = torch.arange(ty, device=v.device) * th
    q0 = torch.arange(tx, device=v.device) * tw
    r1 = torch.clamp(r0 + th, max=hh) - 1
    q1 = torch.clamp(q0 + tw, max=wh) - 1
    y_lo = (r0.float() * sp + y_off) - 1.0
    y_hi = (r1.float() * sp + y_off) + 1.0
    x_lo = q0.float() * sp - 1.0
    x_hi = q1.float() * sp + 1.0
    ctr = sigma * torch.tensor(truncate, **f32)
    rows = (((y - ctr)[..., None] <= y_hi) & ((y + ctr)[..., None] >= y_lo)
            & (v != 0)[..., None])                         # (B, F, N, ty)
    cols = ((x - ctr)[..., None] <= x_hi) & ((x + ctr)[..., None] >= x_lo)
    keep = rows[..., :, None] & cols[..., None, :]        # (B, F, N, ty, tx)
    b, f, n = v.shape
    words = -(-n // 32)
    keep = keep.reshape(b, f, n, ty * tx).permute(0, 1, 3, 2)
    keep = torch.nn.functional.pad(keep, (0, 32 * words - n))
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=v.device)
    packed = (keep.reshape(b, f, ty * tx, words, 32).long() * weights).sum(-1)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).int()


def _check_operands(who: str, v, x, y, sigma, out_hw) -> None:
    device, shape = v.device, v.shape
    for name, t in (('v', v), ('x', x), ('y', y), ('sigma', sigma)):
        if not t.is_cuda:
            raise ValueError(f'{who}: {name} must be a CUDA tensor, got '
                             f'{t.device}')
        if t.device != device:
            raise ValueError(f'{who}: {name} on {t.device}, v on {device}')
        if t.dtype != torch.float32:
            raise ValueError(f'{who}: {name} must be float32, got {t.dtype}')
        if t.shape != shape or len(shape) != 3:
            raise ValueError(f'{who}: {name} must be (B, F, N) like v, got '
                             f'{tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{who}: {name} must be contiguous')
    if shape[0] * shape[1] > 65535 or tile_grid(out_hw)[0] > 65535:
        raise ValueError(f'{who}: grid too large for {(*shape[:2], *out_hw)}')


_LIB = None


def _lib():
    """The built library, with its entry points typed."""
    global _LIB
    if _LIB is None:
        lib = kernels.library('cif_hr')
        lib.cif_hr_bin_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
            + [ctypes.c_int, ctypes.c_void_p])
        lib.cif_hr_accumulate_f32.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.cif_hr_bin_f32.restype = lib.cif_hr_accumulate_f32.restype = \
            ctypes.c_int
        _LIB = lib
    return _LIB


def _masks_like(v: torch.Tensor, out_hw) -> torch.Tensor:
    """Uninitialized (B, F, tiles, ceil(N / 32)) int32 storage for the
    first pass's uint32 mask words."""
    b, f, n = v.shape
    ty, tx = tile_grid(out_hw)
    return torch.empty((b, f, ty * tx, -(-n // 32)), dtype=torch.int32,
                       device=v.device)


def _raise_on(who: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f'{who}: kernel launch failed with CUDA error {rc}')


def cif_hr_accumulate(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      sigma: torch.Tensor, *, out_hw, spacing: float,
                      truncate: float, y_offset_px: float = 0.0,
                      clip: bool = True) -> torch.Tensor:
    """The CUDA kernel: (B, F, N) float32 cells -> (B, F, Hh, Wh) float32.

    ``v`` carries the neighbour factor and is 0 for masked cells; ``sigma``
    is the blob width in px.  Launches ``bin_kernel`` then ``splat_kernel``
    on the current stream of ``v``'s card without synchronizing.
    """
    global KERNEL_LAUNCHES, CUDA_LAUNCHES
    _check_operands('cif_hr_accumulate', v, x, y, sigma, out_hw)
    b, f, n = v.shape
    hh, wh = int(out_hw[0]), int(out_hw[1])
    masks = _masks_like(v, out_hw)
    out = torch.empty((b, f, hh, wh), dtype=torch.float32, device=v.device)
    rc = _lib().cif_hr_accumulate_f32(
        v.data_ptr(), x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
        masks.data_ptr(), out.data_ptr(), b * f, n, hh, wh, float(spacing),
        float(truncate), float(y_offset_px), int(bool(clip)), v.device.index,
        torch.cuda.current_stream(v.device).cuda_stream)
    _raise_on('cif_hr_accumulate', rc)
    KERNEL_LAUNCHES += 1
    CUDA_LAUNCHES += 2
    return out


def cif_hr_tile_bins(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     sigma: torch.Tensor, *, out_hw, spacing: float,
                     truncate: float, y_offset_px: float = 0.0) -> torch.Tensor:
    """The kernel's first pass alone (``bin_kernel``): the masks that
    ``tile_bins_plain`` computes, from the card.  For checks; the main path
    calls ``cif_hr_accumulate``."""
    global CUDA_LAUNCHES
    _check_operands('cif_hr_tile_bins', v, x, y, sigma, out_hw)
    b, f, n = v.shape
    hh, wh = int(out_hw[0]), int(out_hw[1])
    masks = _masks_like(v, out_hw)
    rc = _lib().cif_hr_bin_f32(
        v.data_ptr(), x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
        masks.data_ptr(), b * f, n, hh, wh, float(spacing), float(truncate),
        float(y_offset_px), v.device.index,
        torch.cuda.current_stream(v.device).cuda_stream)
    _raise_on('cif_hr_tile_bins', rc)
    CUDA_LAUNCHES += 1
    return masks


def _launch(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            sigma: torch.Tensor, out_hw: List[int], spacing: float,
            truncate: float, y_offset_px: float, clip: bool,
            profile_bf16: bool) -> torch.Tensor:
    """The operator's CUDA implementation: the kernel
    (``cif_hr_accumulate``) on contiguous copies where the cells are not
    (a traced program drops the caller's ``contiguous()`` where the
    example was, and its runtime strides may differ).  It computes f32
    profiles whatever ``profile_bf16`` says: on the card the decode has
    ``profile_bf16=False`` semantics."""
    del profile_bf16
    return cif_hr_accumulate(v.contiguous(), x.contiguous(), y.contiguous(),
                             sigma.contiguous(), out_hw=tuple(out_hw),
                             spacing=spacing, truncate=truncate,
                             y_offset_px=y_offset_px, clip=clip)


def _plain(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           sigma: torch.Tensor, out_hw: List[int], spacing: float,
           truncate: float, y_offset_px: float, clip: bool,
           profile_bf16: bool) -> torch.Tensor:
    """The operator's CPU implementation: ``accumulate_plain``."""
    return accumulate_plain(v, x, y, sigma, out_hw=tuple(out_hw),
                            spacing=spacing, truncate=truncate,
                            y_offset_px=y_offset_px, clip=clip,
                            profile_bf16=profile_bf16)


# K1 as a registered operator, so that ``torch.export`` records the splat
# as one call (``export_program --include-decoder``); ``accumulate`` calls
# it on the cells' device: the kernel for CUDA tensors, the plain version
# for CPU tensors, no other switch.  Registered through ``Library`` rather
# than ``torch.library.custom_op``, whose kernels run under
# ``torch._disable_dynamo``: on Python 3.12 that wrapper hides the
# enclosing frames from cProfile, and ``--profile-decoder`` profiles the
# decode that calls K1.
_LIBRARY = torch.library.Library('openpifpaf_tpu_torch', 'FRAGMENT')
_LIBRARY.define(
    'cif_hr_accumulate(Tensor v, Tensor x, Tensor y, Tensor sigma, '
    'int[] out_hw, float spacing, float truncate, float y_offset_px, '
    'bool clip, bool profile_bf16) -> Tensor')
_LIBRARY.impl('cif_hr_accumulate', _launch, 'CUDA')
_LIBRARY.impl('cif_hr_accumulate', _plain, 'CPU')
cif_hr_op = torch.ops.openpifpaf_tpu_torch.cif_hr_accumulate.default


@torch.library.register_fake('openpifpaf_tpu_torch::cif_hr_accumulate')
def _fake(v, x, y, sigma, out_hw, spacing, truncate, y_offset_px, clip,
          profile_bf16):
    b, f, _ = v.shape
    return v.new_empty((b, f, *out_hw), dtype=torch.float32)
