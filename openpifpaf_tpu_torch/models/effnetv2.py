"""EfficientNetV2 backbones in PyTorch (NCHW).

Port of ``openpifpaf_tpu/models/effnetv2.py`` (``:20-142``).  Reference
parity: ``src/openpifpaf/network/basenetworks.py:~540``: fused-MBConv
early stages, MBConv (SiLU, squeeze-excitation on a quarter of the input
channels) later ones, the last downsampling stage at stride 1 so the total
stride is 16.  ``effnetv2s`` and ``effnetv2m`` differ in the config table.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .base import BaseNetworkSpec, norm_layer, register_basenet
from .mobilenet import SqueezeExcite, _Trunk
from .resnet import conv


class FusedMBConv(nn.Module):
    """Fused-MBConv: single k x k conv expand -> 1x1 project.  With
    ``expand_ratio`` 1 there is no projection and the block keeps its
    input's width."""

    def __init__(self, in_channels: int, out_channels: int,
                 expand_ratio: int, kernel_size: int = 3, stride: int = 1,
                 norm: str = 'batchnorm'):
        super().__init__()
        expand = expand_ratio * in_channels
        self.expand = conv(in_channels, expand, kernel_size, stride,
                           kernel_size // 2)
        self.expand_norm = norm_layer(norm, expand)
        self.project_on = expand_ratio != 1
        if self.project_on:
            self.project = conv(expand, out_channels)
            self.project_norm = norm_layer(norm, out_channels)
        self.out_channels = out_channels if self.project_on else expand
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.expand_norm(self.expand(x)))
        if self.project_on:
            y = self.project_norm(self.project(y))
        return y + x if self.residual else y


class MBConvV2(nn.Module):
    """EfficientNetV2 MBConv (SiLU + SE with 1/4 of input channels)."""

    def __init__(self, in_channels: int, out_channels: int,
                 expand_ratio: int, kernel_size: int = 3, stride: int = 1,
                 norm: str = 'batchnorm'):
        super().__init__()
        expand = expand_ratio * in_channels
        self.expand = conv(in_channels, expand)
        self.expand_norm = norm_layer(norm, expand)
        self.dwconv = conv(expand, expand, kernel_size, stride,
                           kernel_size // 2, groups=expand)
        self.dw_norm = norm_layer(norm, expand)
        self.se = SqueezeExcite(expand, max(8, in_channels // 4))
        self.project = conv(expand, out_channels)
        self.project_norm = norm_layer(norm, out_channels)
        self.out_channels = out_channels
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.expand_norm(self.expand(x)))
        y = F.silu(self.dw_norm(self.dwconv(y)))
        y = self.project_norm(self.project(self.se(y)))
        return y + x if self.residual else y


class EffNetV2(_Trunk):
    """EfficientNetV2 trunk; config rows: (block, expand, c, n, s)."""

    # EfficientNetV2-S with the last stage at stride 1 (total stride 16)
    CONFIG = (
        ('fused', 1, 24, 2, 1),
        ('fused', 4, 48, 4, 2),
        ('fused', 4, 64, 4, 2),
        ('mbconv', 4, 128, 6, 2),
        ('mbconv', 6, 160, 9, 1),
        ('mbconv', 6, 256, 15, 1),   # reference stride 2 -> 1 here
    )

    def __init__(self, config: Sequence[Tuple[str, int, int, int, int]] = CONFIG,
                 out_channels: int = 1280, norm: str = 'batchnorm'):
        blocks, cin = [], 24
        for kind, e, c, n, s in config:
            cls = FusedMBConv if kind == 'fused' else MBConvV2
            for i in range(n):
                blocks.append(cls(cin, c, e, stride=s if i == 0 else 1,
                                  norm=norm))
                cin = blocks[-1].out_channels
        super().__init__(24, blocks, cin, out_channels, 'silu', norm)


M_CONFIG = (
    ('fused', 1, 24, 3, 1),
    ('fused', 4, 48, 5, 2),
    ('fused', 4, 80, 5, 2),
    ('mbconv', 4, 160, 7, 2),
    ('mbconv', 6, 176, 14, 1),
    ('mbconv', 6, 304, 18, 1),
    ('mbconv', 6, 512, 5, 1),
)

register_basenet(BaseNetworkSpec(
    'effnetv2s', lambda norm='batchnorm': EffNetV2(norm=norm),
    stride=16, out_features=1280))
register_basenet(BaseNetworkSpec(
    'effnetv2m', lambda norm='batchnorm': EffNetV2(M_CONFIG, norm=norm),
    stride=16, out_features=1280))
