"""HRFormer backbone in PyTorch: a high-resolution multi-branch transformer.

Port of ``openpifpaf_tpu/models/hrformer.py`` (``:34-243``), an
HRNet-style multi-resolution trunk whose blocks are local-window attention
plus a depthwise-conv MLP (Yuan et al. 2021):

- stem: two 3x3 stride-2 convs -> stride 4;
- stage 1: bottleneck conv blocks at stride 4;
- stages 2-4: parallel branches at strides (4, 8), (4, 8, 16),
  (4, 8, 16, 32); each module runs HRFormer blocks per branch, then fuses
  across resolutions (strided 3x3 convs down, 1x1 and a nearest resize up);
- output: every branch brought to stride 16 and concatenated,
  ``C * 4 * 3 + C * 8`` channels.

Branches run NCHW; the attention and its LayerNorm see them as
``(B, H, W, C)`` and reuse the Swin port's ``WindowAttention`` and window
helpers.  The upsamples are ``jax.image.resize(..., 'nearest')``:
source index ``floor((o + 0.5) * in / out)`` (``nearest_resize``), which
is torch's ``'nearest-exact'``, not ``'nearest'``.  LayerNorm eps is
flax's default, 1e-6.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .base import (BaseNetworkSpec, LayerNorm, device_constant, norm_layer,
                   register_basenet)
from .resnet import conv
from .swin import (WindowAttention, pad_to_window, window_partition,
                   window_reverse)


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize(method='nearest')``'s source index per output
    index along one axis."""
    offsets = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(n_in) / np.float32(n_out)
    return np.floor(offsets).astype(np.int64)


def nearest_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """NCHW ``x`` resized to ``hw`` by jax's nearest rule."""
    for dim, n_out in ((2, hw[0]), (3, hw[1])):
        if x.shape[dim] != n_out:
            x = x.index_select(dim, device_constant(
                nearest_index, x.shape[dim], n_out, device=x.device))
    return x


class HRFormerBlock(nn.Module):
    """Local-window MHSA + depthwise-conv FFN, pre-norm residual; NCHW."""

    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.window = window
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = conv(dim, hidden, bias=True)
        self.mlp_dwconv = conv(hidden, hidden, 3, padding=1, groups=hidden,
                               bias=True)
        self.mlp_fc2 = conv(hidden, dim, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        win = self.window
        y = pad_to_window(self.norm1(x.permute(0, 2, 3, 1)), win)
        hp, wp = y.shape[1:3]
        y = window_reverse(self.attn(window_partition(y, win)), win, hp, wp)
        x = x + y[:, :h, :w].permute(0, 3, 1, 2)
        y = self.norm2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        y = F.gelu(self.mlp_dwconv(F.gelu(self.mlp_fc1(y))))
        return x + self.mlp_fc2(y)


class Bottleneck(nn.Module):
    """HRNet stage-1 conv bottleneck (1x1 -> 3x3 -> 1x1, expansion 4)."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm: str = 'batchnorm'):
        super().__init__()
        mid = out_channels // 4
        self.conv1 = conv(in_channels, mid)
        self.norm1 = norm_layer(norm, mid)
        self.conv2 = conv(mid, mid, 3, padding=1)
        self.norm2 = norm_layer(norm, mid)
        self.conv3 = conv(mid, out_channels)
        self.norm3 = norm_layer(norm, out_channels)
        self.project = in_channels != out_channels
        if self.project:
            self.down = conv(in_channels, out_channels)
            self.down_norm = norm_layer(norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        if self.project:
            x = self.down_norm(self.down(x))
        return torch.relu(x + y)


class FuseLayer(nn.Module):
    """Cross-resolution fusion: every branch receives every other branch."""

    def __init__(self, channels: Sequence[int], norm: str = 'batchnorm'):
        super().__init__()
        self.channels = tuple(channels)
        for i, ci in enumerate(channels):
            for j, cj in enumerate(channels):
                if j < i:                      # downsample j -> i
                    for step in range(i - j):
                        ch = ci if step == i - j - 1 else cj
                        self.add_module(f'down{j}to{i}_{step}',
                                        conv(cj, ch, 3, 2, 1))
                        self.add_module(f'down{j}to{i}_{step}_norm',
                                        norm_layer(norm, ch))
                elif j > i:                    # upsample j -> i
                    self.add_module(f'up{j}to{i}', conv(cj, ci))
                    self.add_module(f'up{j}to{i}_norm', norm_layer(norm, ci))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i in range(len(self.channels)):
            acc = xs[i]
            for j, y in enumerate(xs):
                if j < i:
                    for step in range(i - j):
                        name = f'down{j}to{i}_{step}'
                        y = getattr(self, f'{name}_norm')(
                            getattr(self, name)(y))
                        if step < i - j - 1:
                            y = torch.relu(y)
                elif j > i:
                    y = getattr(self, f'up{j}to{i}_norm')(
                        getattr(self, f'up{j}to{i}')(y))
                    y = nearest_resize(y, acc.shape[2:])
                else:
                    continue
                acc = acc + y
            outs.append(torch.relu(acc))
        return outs


class HRFormer(nn.Module):
    """Multi-resolution transformer trunk; output at stride 16."""

    def __init__(self, base_channels: int = 32,
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 num_modules: Sequence[int] = (1, 3, 2),
                 blocks_per_module: int = 2, window: int = 7,
                 mlp_ratio: float = 4.0, norm: str = 'batchnorm'):
        super().__init__()
        c = base_channels
        self.num_modules = tuple(num_modules)
        self.blocks_per_module = blocks_per_module
        self.stem1 = conv(3, 64, 3, 2, 1)
        self.stem1_norm = norm_layer(norm, 64)
        self.stem2 = conv(64, 64, 3, 2, 1)
        self.stem2_norm = norm_layer(norm, 64)
        self.stage1_block0 = Bottleneck(64, 256, norm)
        self.stage1_block1 = Bottleneck(256, 256, norm)

        chans_in = [256]
        for stage_i, n_modules in enumerate(self.num_modules, start=2):
            chans = [c * (2 ** i) for i in range(stage_i)]
            # transition: project existing branches, create the new one
            for i, ch in enumerate(chans):
                if i < len(chans_in):
                    if chans_in[i] != ch:
                        self.add_module(f't{stage_i}_proj{i}',
                                        conv(chans_in[i], ch, 3, padding=1))
                        self.add_module(f't{stage_i}_proj{i}_norm',
                                        norm_layer(norm, ch))
                else:
                    self.add_module(f't{stage_i}_new{i}',
                                    conv(chans_in[-1], ch, 3, 2, 1))
                    self.add_module(f't{stage_i}_new{i}_norm',
                                    norm_layer(norm, ch))
            for module_i in range(n_modules):
                for i, ch in enumerate(chans):
                    for block_i in range(blocks_per_module):
                        self.add_module(
                            f's{stage_i}_m{module_i}_b{i}_blk{block_i}',
                            HRFormerBlock(ch, num_heads[i], window, mlp_ratio))
                self.add_module(f's{stage_i}_m{module_i}_fuse',
                                FuseLayer(chans, norm))
            chans_in = chans

        # gather to stride 16 (branch 2): the higher resolutions by strided
        # convs that double the channels
        for i in range(2):
            ch = chans_in[i]
            for step in range(2 - i):
                self.add_module(f'out_down{i}_{step}',
                                conv(ch, 2 * ch, 3, 2, 1))
                self.add_module(f'out_down{i}_{step}_norm',
                                norm_layer(norm, 2 * ch))
                ch *= 2

    def _conv_norm_relu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, f'{name}_norm')(
            getattr(self, name)(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._conv_norm_relu('stem1', x)
        x = self._conv_norm_relu('stem2', x)
        x = self.stage1_block1(self.stage1_block0(x))

        branches = [x]
        for stage_i, n_modules in enumerate(self.num_modules, start=2):
            new_branches = []
            for i in range(stage_i):
                if i < len(branches):
                    y = branches[i]
                    if hasattr(self, f't{stage_i}_proj{i}'):
                        y = self._conv_norm_relu(f't{stage_i}_proj{i}', y)
                else:
                    y = self._conv_norm_relu(f't{stage_i}_new{i}',
                                             branches[-1])
                new_branches.append(y)
            branches = new_branches
            for module_i in range(n_modules):
                for i in range(stage_i):
                    for block_i in range(self.blocks_per_module):
                        branches[i] = getattr(
                            self, f's{stage_i}_m{module_i}_b{i}_blk{block_i}'
                        )(branches[i])
                branches = getattr(self, f's{stage_i}_m{module_i}_fuse')(
                    branches)

        target = branches[2].shape[2:]
        outs = []
        for i, y in enumerate(branches):
            if i < 2:
                for step in range(2 - i):
                    y = self._conv_norm_relu(f'out_down{i}_{step}', y)
            elif i > 2:
                y = nearest_resize(y, target)
            outs.append(y)
        return torch.cat(outs, dim=1)


def _make_hrformer(base_channels, num_heads, num_modules, blocks):
    def factory(norm: str = 'batchnorm'):
        return HRFormer(base_channels, num_heads, num_modules, blocks,
                        norm=norm)
    return factory


# out_features: branches (C, 2C, 4C, 8C) gathered at stride 16 as
# (4C, 4C, 4C, 8C)
register_basenet(BaseNetworkSpec(
    'hrformer_s', _make_hrformer(32, (1, 2, 4, 8), (1, 3, 2), 2),
    stride=16, out_features=32 * 4 * 3 + 32 * 8))
register_basenet(BaseNetworkSpec(
    'hrformer_b', _make_hrformer(78, (2, 4, 8, 16), (1, 3, 2), 2),
    stride=16, out_features=78 * 4 * 3 + 78 * 8))
