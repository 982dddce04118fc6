"""XCiT backbones (cross-covariance attention) in PyTorch.

Port of ``openpifpaf_tpu/models/xcit.py`` (``:34-229``).  Reference
parity: ``src/openpifpaf/network/basenetworks.py:~750``: a conv stem to
stride 16, Fourier positional encoding, then XCA (attention across
channels), LPI (local patch interaction: depthwise 3x3, GELU, norm,
depthwise 3x3) and MLP sub-blocks at constant resolution, each scaled by a
LayerScale ``gamma``.  The norm slots follow the reference's ordering:
``norm1`` gates XCA, ``norm3`` LPI and ``norm2`` the MLP.

XCA's L2 normalization clamps the norm at 1e-12 (``F.normalize``), and its
``temperature`` is ``(heads, 1, 1)``.  The LayerNorms set no epsilon in
the JAX modules, so flax's default 1e-6 applies (``base.LayerNorm``).  The
tokens run ``(B, N, C)``; the LPI convs see them as NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .base import (BaseNetworkSpec, LayerNorm, compute_dtype, device_constant,
                   dot_f32, norm_layer, register_basenet)
from .resnet import conv


class ConvStem(nn.Module):
    """Four 3x3 stride-2 convs with norms and exact GELU between them ->
    total stride 16 (reference ``ConvPatchEmbed``)."""

    def __init__(self, embed_dim: int, norm: str = 'batchnorm'):
        super().__init__()
        dims = (embed_dim // 8, embed_dim // 4, embed_dim // 2, embed_dim)
        cin = 3
        for i, d in enumerate(dims):
            self.add_module(f'conv{i}', conv(cin, d, 3, 2, 1))
            self.add_module(f'norm{i}', norm_layer(norm, d))
            cin = d
        self.n = len(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f'norm{i}')(getattr(self, f'conv{i}')(x))
            if i < self.n - 1:
                x = F.gelu(x)
        return x


def _fourier_grid(h: int, w: int, hidden_dim: int,
                  temperature: float) -> np.ndarray:
    """(h, w, 2*hidden_dim) sin/cos positional grid, reference semantics
    (``xcit.py:~40``): normalized cumulative row/col coordinates scaled to
    2*pi, per-frequency division, sin on even and cos on odd channels, the
    y-features before the x-features."""
    scale = 2.0 * np.pi
    eps = 1e-6
    y_embed = (np.arange(1, h + 1, dtype=np.float64) / (h + eps) * scale)
    x_embed = (np.arange(1, w + 1, dtype=np.float64) / (w + eps) * scale)
    dim_t = temperature ** (2.0 * (np.arange(hidden_dim) // 2) / hidden_dim)

    def interleave(embed):                      # (n,) -> (n, hidden_dim)
        pos = embed[:, None] / dim_t
        out = np.empty_like(pos)
        out[:, 0::2] = np.sin(pos[:, 0::2])
        out[:, 1::2] = np.cos(pos[:, 1::2])
        return out

    pos_y = np.broadcast_to(interleave(y_embed)[:, None, :],
                            (h, w, hidden_dim))
    pos_x = np.broadcast_to(interleave(x_embed)[None, :, :],
                            (h, w, hidden_dim))
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


def _fourier_grid_nchw(h: int, w: int, hidden_dim: int,
                       temperature: float) -> np.ndarray:
    grid = _fourier_grid(h, w, hidden_dim, temperature)
    return np.ascontiguousarray(grid.transpose(2, 0, 1)[None])


class PositionalEncodingFourier(nn.Module):
    """Fourier positional features + learned 1x1 projection (with bias)."""

    def __init__(self, dim: int, hidden_dim: int = 32,
                 temperature: float = 10000.0):
        super().__init__()
        self.hidden_dim, self.temperature = hidden_dim, temperature
        self.token_projection = conv(2 * hidden_dim, dim, bias=True)

    def forward(self, h: int, w: int, device) -> torch.Tensor:
        """(1, dim, h, w)."""
        grid = device_constant(_fourier_grid_nchw, h, w, self.hidden_dim,
                               self.temperature, device=device)
        return self.token_projection(grid)


class XCA(nn.Module):
    """Cross-covariance attention over the channel dimension."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N, C) tokens."""
        b, n, _ = x.shape
        head_dim = self.dim // self.num_heads
        dtype = compute_dtype(x)
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 4, 1).unbind(0)   # (B, heads, d, N)
        q = F.normalize(q, dim=-1, eps=1e-12)
        k = F.normalize(k, dim=-1, eps=1e-12)
        attn = dot_f32('bhdn,bhen->bhde', q, k, dtype=dtype) \
            * self.temperature
        attn = torch.softmax(attn, dim=-1)
        y = dot_f32('bhde,bhen->bhdn', attn, v, dtype=dtype)
        y = y.permute(0, 3, 1, 2).reshape(b, n, self.dim)
        return self.proj(y.to(dtype))


class XCiTBlock(nn.Module):
    """XCA -> LPI -> MLP, each LayerScale-gated (reference ``XCABlock``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm: str = 'batchnorm'):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim)
        self.xca = XCA(dim, num_heads)
        self.gamma1 = nn.Parameter(torch.ones(dim))
        self.norm3 = LayerNorm(dim)
        self.lpi_conv1 = conv(dim, dim, 3, padding=1, groups=dim, bias=True)
        self.lpi_bn = norm_layer(norm, dim)
        self.lpi_conv2 = conv(dim, dim, 3, padding=1, groups=dim, bias=True)
        self.gamma3 = nn.Parameter(torch.ones(dim))
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)
        self.gamma2 = nn.Parameter(torch.ones(dim))

    def forward(self, tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """tokens: (B, H*W, C)."""
        b, n, c = tokens.shape
        dtype = compute_dtype(tokens)
        tokens = tokens + self.gamma1.to(dtype) * self.xca(self.norm1(tokens))
        y = self.norm3(tokens).transpose(1, 2).reshape(b, c, h, w)
        y = self.lpi_conv2(self.lpi_bn(F.gelu(self.lpi_conv1(y))))
        tokens = tokens + self.gamma3.to(dtype) * y.reshape(b, c, n) \
            .transpose(1, 2)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(tokens))))
        return tokens + self.gamma2.to(dtype) * y


class XCiT(nn.Module):
    def __init__(self, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 8, norm: str = 'batchnorm'):
        super().__init__()
        self.depth = depth
        self.stem = ConvStem(embed_dim, norm)
        self.pos_embed = PositionalEncodingFourier(embed_dim)
        for i in range(depth):
            self.add_module(f'block{i}', XCiTBlock(embed_dim, num_heads,
                                                   norm=norm))
        self.norm_out = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        b, c, h, w = x.shape
        x = x + self.pos_embed(h, w, x.device).to(x.dtype)
        tokens = x.flatten(2).transpose(1, 2)
        for i in range(self.depth):
            tokens = getattr(self, f'block{i}')(tokens, h, w)
        return self.norm_out(tokens).transpose(1, 2).reshape(b, c, h, w)


def _make_xcit(embed_dim, depth, num_heads):
    def factory(norm: str = 'batchnorm'):
        return XCiT(embed_dim, depth, num_heads, norm=norm)
    return factory


register_basenet(BaseNetworkSpec(
    'xcit_small_12', _make_xcit(384, 12, 8),
    stride=16, out_features=384))
register_basenet(BaseNetworkSpec(
    'xcit_medium_24', _make_xcit(512, 24, 8),
    stride=16, out_features=512))
