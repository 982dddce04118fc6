"""MobileNetV2 / MobileNetV3 backbones in PyTorch (NCHW).

Port of ``openpifpaf_tpu/models/mobilenet.py`` (``:24-186``).  Reference
parity: ``src/openpifpaf/network/basenetworks.py:~420``: the
inverted-residual stacks built directly, the last downsampling stage at
stride 1 so the trunk's total stride is 16.  ``hard_sigmoid`` is
``relu6(x + 3) / 6``; MobileNetV3's per-block activation and
squeeze-excitation come from its config table.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .base import BaseNetworkSpec, norm_layer, register_basenet
from .resnet import conv


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


ACTIVATIONS = {'relu6': F.relu6, 'hardswish': hard_swish, 'silu': F.silu}


class SqueezeExcite(nn.Module):
    """Global mean -> 1x1 (bias) -> relu -> 1x1 (bias) -> hard-sigmoid
    gate."""

    def __init__(self, channels: int, reduce_channels: int):
        super().__init__()
        self.fc1 = conv(channels, reduce_channels, bias=True)
        self.fc2 = conv(reduce_channels, channels, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(torch.relu(self.fc1(s)))
        return x * hard_sigmoid(s)


class InvertedResidual(nn.Module):
    """MBConv block: 1x1 expand -> k x k depthwise -> SE? -> 1x1 project."""

    def __init__(self, in_channels: int, out_channels: int,
                 expand_channels: int, kernel_size: int = 3, stride: int = 1,
                 use_se: bool = False, activation: str = 'relu6',
                 norm: str = 'batchnorm'):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.expand_on = expand_channels != in_channels
        if self.expand_on:
            self.expand = conv(in_channels, expand_channels)
            self.expand_norm = norm_layer(norm, expand_channels)
        self.dwconv = conv(expand_channels, expand_channels, kernel_size,
                           stride, kernel_size // 2, groups=expand_channels)
        self.dw_norm = norm_layer(norm, expand_channels)
        if use_se:
            self.se = SqueezeExcite(expand_channels,
                                    max(8, expand_channels // 4))
        self.project = conv(expand_channels, out_channels)
        self.project_norm = norm_layer(norm, out_channels)
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand_on:
            y = self.act(self.expand_norm(self.expand(y)))
        y = self.act(self.dw_norm(self.dwconv(y)))
        if hasattr(self, 'se'):
            y = self.se(y)
        y = self.project_norm(self.project(y))
        return y + x if self.residual else y


class _Trunk(nn.Module):
    """conv_stem (3x3/2) -> numbered blocks -> conv_head (1x1), each conv
    with its norm and the trunk's stem and head activation."""

    def __init__(self, stem_channels: int, blocks: Sequence[nn.Module],
                 head_in: int, out_channels: int, activation: str, norm: str):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.conv_stem = conv(3, stem_channels, 3, 2, 1)
        self.stem_norm = norm_layer(norm, stem_channels)
        self.n_blocks = len(blocks)
        for i, block in enumerate(blocks):
            self.add_module(f'block{i}', block)
        self.conv_head = conv(head_in, out_channels)
        self.head_norm = norm_layer(norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.stem_norm(self.conv_stem(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f'block{i}')(x)
        return self.act(self.head_norm(self.conv_head(x)))


class MobileNetV2(_Trunk):
    """(t, c, n, s) config; the last stride-2 stage runs at stride 1."""

    # (expansion, channels, repeats, stride)
    CONFIG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 1), (6, 320, 1, 1))

    def __init__(self, config: Sequence[Tuple[int, int, int, int]] = CONFIG,
                 out_channels: int = 1280, norm: str = 'batchnorm'):
        blocks, cin = [], 32
        for t, c, n, s in config:
            for i in range(n):
                blocks.append(InvertedResidual(
                    cin, c, t * cin, stride=s if i == 0 else 1, norm=norm))
                cin = c
        super().__init__(32, blocks, cin, out_channels, 'relu6', norm)


class MobileNetV3(_Trunk):
    """MobileNetV3-Large feature trunk at total stride 16."""

    # (kernel, expand, out, se, activation, stride)
    CONFIG = (
        (3, 16, 16, False, 'relu6', 1),
        (3, 64, 24, False, 'relu6', 2),
        (3, 72, 24, False, 'relu6', 1),
        (5, 72, 40, True, 'relu6', 2),
        (5, 120, 40, True, 'relu6', 1),
        (5, 120, 40, True, 'relu6', 1),
        (3, 240, 80, False, 'hardswish', 2),
        (3, 200, 80, False, 'hardswish', 1),
        (3, 184, 80, False, 'hardswish', 1),
        (3, 184, 80, False, 'hardswish', 1),
        (3, 480, 112, True, 'hardswish', 1),
        (3, 672, 112, True, 'hardswish', 1),
        (5, 672, 160, True, 'hardswish', 1),  # torchvision stride 2
        (5, 960, 160, True, 'hardswish', 1),
        (5, 960, 160, True, 'hardswish', 1),
    )

    def __init__(self, config: Sequence[tuple] = CONFIG,
                 out_channels: int = 960, norm: str = 'batchnorm'):
        blocks, cin = [], 16
        for k, e, c, se, act, s in config:
            blocks.append(InvertedResidual(cin, c, e, k, s, se, act, norm))
            cin = c
        super().__init__(16, blocks, cin, out_channels, 'hardswish', norm)


register_basenet(BaseNetworkSpec(
    'mobilenetv2', lambda norm='batchnorm': MobileNetV2(norm=norm),
    stride=16, out_features=1280))
register_basenet(BaseNetworkSpec(
    'mobilenetv3large', lambda norm='batchnorm': MobileNetV3(norm=norm),
    stride=16, out_features=960))
