"""BoTNet backbone in PyTorch: ResNet with self-attention in the last stage.

Port of ``openpifpaf_tpu/models/botnet.py`` (``:27-154``).  Reference
parity: ``src/openpifpaf/network/basenetworks.py`` (``BotNet``): the 3x3
convs of the last ResNet stage become multi-head self-attention over the
feature map with decomposed 2D relative position embeddings.

The embeddings ``rel_h`` and ``rel_w`` are stored at a base length of 32
and resized to the feature map as ``jax.image.resize(..., 'linear')`` does
it: a triangle kernel that antialiases (widens with the inverse scale)
when it shrinks, so below 32 it is not ``F.interpolate``'s linear
resampling.  ``linear_resize_matrix`` builds those weights in numpy, an
``(in, out)`` matrix applied with a matmul.  The stage-4 entry is a 2x2/2
average pool padded by one below and right, the padding counted.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .base import (BaseNetworkSpec, compute_dtype, device_constant, dot_f32,
                   norm_layer, register_basenet)
from .resnet import Bottleneck, conv

REL_BASE = 32


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(method='linear')``
    (antialiased) along one axis: ``out = in @ W``.  The weights of
    ``jax.image.scale_and_translate``'s ``compute_weight_mat`` with scale
    ``n_out / n_in`` and no translation, in float32."""
    f32 = np.float32
    inv_scale = f32(n_in) / f32(n_out)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                       weights / np.where(total != 0, total, f32(1.0)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0.0).astype(f32)


class MHSA2D(nn.Module):
    """Multi-head self-attention over a 2D feature map with relative
    position embeddings (BoTNet's all2all attention); NCHW in and out."""

    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        head_dim = dim // num_heads
        self.q = conv(dim, dim)
        self.k = conv(dim, dim)
        self.v = conv(dim, dim)
        self.rel_h = nn.Parameter(torch.zeros(num_heads, head_dim, REL_BASE))
        self.rel_w = nn.Parameter(torch.zeros(num_heads, head_dim, REL_BASE))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        heads, head_dim = self.num_heads, self.dim // self.num_heads
        scale = head_dim ** -0.5
        dtype = compute_dtype(x)

        def split(t):       # (B, C, H, W) -> (B, heads, H*W, d)
            return t.reshape(b, heads, head_dim, h * w).transpose(2, 3) \
                .to(dtype)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        # content-content
        logits = dot_f32('bhnd,bhmd->bhnm', q * scale, k, dtype=dtype)
        # content-position: the float32 embeddings resized to the map
        rel_h = dot_f32('hdi,iY->hdY', self.rel_h, device_constant(
            linear_resize_matrix, REL_BASE, h, device=x.device),
            dtype=torch.float32)
        rel_w = dot_f32('hdi,iX->hdX', self.rel_w, device_constant(
            linear_resize_matrix, REL_BASE, w, device=x.device),
            dtype=torch.float32)
        qh = q.reshape(b, heads, h, w, head_dim)
        ph = dot_f32('bhywd,hdY->bhywY', qh, rel_h, dtype=torch.float32)
        pw = dot_f32('bhywd,hdX->bhywX', qh, rel_w, dtype=torch.float32)
        pos = (ph[..., :, None] + pw[..., None, :]).reshape(
            b, heads, h * w, h * w) * scale
        attn = torch.softmax(logits + pos, dim=-1)
        y = dot_f32('bhnm,bhmd->bhnd', attn, v, dtype=dtype)
        return y.transpose(2, 3).reshape(b, self.dim, h, w).to(dtype)


class BotBlock(nn.Module):
    """Bottleneck block with MHSA instead of the 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_heads: int = 4, norm: str = 'batchnorm'):
        super().__init__()
        width = out_channels // 4
        self.conv1 = conv(in_channels, width)
        self.bn1 = norm_layer(norm, width)
        self.mhsa = MHSA2D(width, num_heads)
        self.bn2 = norm_layer(norm, width)
        self.conv3 = conv(width, out_channels)
        self.bn3 = norm_layer(norm, out_channels)
        self.downsample = in_channels != out_channels
        if self.downsample:
            self.downsample_conv = conv(in_channels, out_channels)
            self.downsample_bn = norm_layer(norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.mhsa(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + x)


class BotNet(nn.Module):
    """ResNet-50 trunk with the last stage as BoT blocks (stride 16)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 norm: str = 'batchnorm'):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = norm_layer(norm, 64)
        self.block_names = []
        cin = 64
        for stage_i, (n_blocks, ch, s) in enumerate(
                zip(layers[:3], (256, 512, 1024), (1, 2, 2)), start=1):
            for block_i in range(n_blocks):
                name = f'layer{stage_i}_{block_i}'
                self.add_module(name, Bottleneck(
                    cin, ch, s if block_i == 0 else 1, 1, norm))
                self.block_names.append(name)
                cin = ch
        self.bot_names = []
        for block_i in range(layers[3]):
            name = f'layer4_{block_i}'
            self.add_module(name, BotBlock(cin, 2048, norm=norm))
            self.bot_names.append(name)
            cin = 2048

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        # stage 4 entry: 2x2 average pool, padded below and right, the
        # padding counted (flax's avg_pool) -> total stride 16
        x = F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 2)
        for name in self.bot_names:
            x = getattr(self, name)(x)
        return x


register_basenet(BaseNetworkSpec(
    'botnet', lambda norm='batchnorm': BotNet(norm=norm),
    stride=16, out_features=2048))
