"""Swin Transformer backbones in PyTorch.

Port of ``openpifpaf_tpu/models/swin.py`` (``:26-220``).  Reference
parity: ``src/openpifpaf/network/basenetworks.py:~650``: windowed attention
stages built directly; the last patch merging is replaced with a channel
projection (``merge3_proj``) so the total stride stays 16 (strides 4 -> 8
-> 16 -> 16).

The trunk takes NCHW images and returns NCHW features; between the two
the tokens stay ``(B, H, W, C)``, as in the JAX package.  Feature maps are
padded to window multiples and cropped back.  ``patch_embed`` is a 4x4/4
conv with flax's default ``'SAME'`` padding: at sizes that are not a
multiple of 4 it pads unevenly (1 above and 2 below at 641 px), so the pad
is computed from the input size and applied with ``F.pad``.  In bf16 the
LayerNorms run in float32 and the attention logits and weighted values are
float32 products of bf16 operands, as flax computes them
(``base.LayerNorm``, ``base.dot_f32``).  LayerNorm eps is 1e-5 throughout.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .base import (BaseNetworkSpec, LayerNorm, compute_dtype, device_constant,
                   dot_f32, register_basenet)

SWIN_LN_EPS = 1e-5


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, w*w, C); H, W must be multiples of w."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int,
                   ww: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // w) * (ww // w))
    x = windows.reshape(b, h // w, ww // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, ww, -1)


def relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing='ij')).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]        # (2, w*w, w*w)
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(hp: int, wp: int, win: int, shift: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask separating the regions that the cyclic
    shift rolls together: 0 within a region, -100 across (``_attn_mask``,
    ``swin.py:135-148``)."""
    img_mask = np.zeros((hp, wp), np.float32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(hp // win, win, wp // win, win).transpose(0, 2, 1, 3)
    m = m.reshape(-1, win * win)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0.0, -100.0, 0.0).astype(np.float32)


def pad_to_window(x: torch.Tensor, win: int) -> torch.Tensor:
    """Zero-pad (B, H, W, C) below and right to multiples of ``win``."""
    h, w = x.shape[1:3]
    return F.pad(x, (0, 0, 0, (win - w % win) % win, 0, (win - h % win) % win))


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax's ``padding='SAME'`` of a conv on NCHW ``x``: output
    ceil(size / stride), the pad split with the extra pixel after."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class WindowAttention(nn.Module):
    """Multi-head attention within windows, with a learned relative
    position bias of ``((2w - 1)^2, heads)``."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor = None
                ) -> torch.Tensor:
        """x: (nW*B, w*w, C); mask: (nW, w*w, w*w) additive or None."""
        n, l, _ = x.shape
        head_dim = self.dim // self.num_heads
        dtype = compute_dtype(x)
        qkv = self.qkv(x).reshape(n, l, 3, self.num_heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)   # (n, heads, l, d)
        attn = dot_f32('nhld,nhmd->nhlm', q.to(dtype) * head_dim ** -0.5, k,
                       dtype=dtype)
        idx = device_constant(relative_position_index, self.window,
                              device=x.device)
        bias = self.relative_position_bias_table[idx.reshape(-1)]
        attn = attn + bias.reshape(l, l, -1).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(n // nw, nw, self.num_heads, l, l) \
                + mask[None, :, None]
            attn = attn.view(n, self.num_heads, l, l)
        attn = torch.softmax(attn, dim=-1)
        y = dot_f32('nhlm,nhmd->nhld', attn, v, dtype=dtype)
        y = y.transpose(1, 2).reshape(n, l, self.dim)
        return self.proj(y.to(dtype))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, SWIN_LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm(dim, SWIN_LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C)."""
        _, h, w, _ = x.shape
        win, shift = self.window, self.shift
        y = pad_to_window(self.norm1(x), win)
        hp, wp = y.shape[1:3]
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = device_constant(shift_mask, hp, wp, win, shift,
                                   device=x.device)
        y = window_reverse(self.attn(window_partition(y, win), mask),
                           win, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w]
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + y


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (odd sizes zero-padded), LayerNorm, a
    linear reduction without bias: stride x2."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * in_dim, SWIN_LN_EPS)
        self.reduction = nn.Linear(4 * in_dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class Swin(nn.Module):
    """Swin trunk at total stride 16 (last stage is not downsampled).
    ``norm`` is unused (the transformer uses LayerNorm), kept for the
    factory's uniformity as in the JAX module."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 norm: str = 'batchnorm'):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, 4)
        self.patch_norm = LayerNorm(embed_dim, SWIN_LN_EPS)
        prev = embed_dim
        for stage_i, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * (2 ** min(stage_i, 3))
            if 0 < stage_i < 3:
                self.add_module(f'merge{stage_i}', PatchMerging(prev, dim))
            elif stage_i == 3:
                # keep stride 16: project channels without downsampling
                self.merge3_proj = nn.Linear(prev, dim, bias=False)
            for block_i in range(depth):
                self.add_module(f'stage{stage_i}_block{block_i}', SwinBlock(
                    dim, heads, window,
                    shift=0 if block_i % 2 == 0 else window // 2))
            prev = dim
        self.norm_out = LayerNorm(prev, SWIN_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(same_pad(x, 4, 4)).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        for stage_i, depth in enumerate(self.depths):
            if 0 < stage_i < 3:
                x = getattr(self, f'merge{stage_i}')(x)
            elif stage_i == 3:
                x = self.merge3_proj(x)
            for block_i in range(depth):
                x = getattr(self, f'stage{stage_i}_block{block_i}')(x)
        return self.norm_out(x).permute(0, 3, 1, 2)


def _make_swin(embed_dim, depths, num_heads):
    def factory(norm: str = 'batchnorm'):
        return Swin(embed_dim, depths, num_heads, norm=norm)
    return factory


register_basenet(BaseNetworkSpec(
    'swin_t', _make_swin(96, (2, 2, 6, 2), (3, 6, 12, 24)),
    stride=16, out_features=768))
register_basenet(BaseNetworkSpec(
    'swin_s', _make_swin(96, (2, 2, 18, 2), (3, 6, 12, 24)),
    stride=16, out_features=768))
register_basenet(BaseNetworkSpec(
    'swin_b', _make_swin(128, (2, 2, 18, 2), (4, 8, 16, 32)),
    stride=16, out_features=1024))
