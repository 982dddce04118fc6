"""ResNet backbones in PyTorch (NCHW).

Port of ``openpifpaf_tpu/models/resnet.py`` (``:21-102``).  Reference
parity: ``src/openpifpaf/network/basenetworks.py:~320``: the ResNet trunk
without avgpool and fc, the input max-pool removed by default
(``pool0_stride`` 0, total stride 16), the input conv's stride and the
last stage's dilation configurable.  Submodule names follow the flax
module names (``conv1``, ``layer3_0.downsample_bn``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .base import BaseNetworkSpec, norm_layer, register_basenet


def conv(cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
         padding: int = 0, dilation: int = 1, groups: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """``nn.Conv2d`` with the JAX modules' defaults: no bias unless asked."""
    return nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                     dilation=dilation, groups=groups, bias=bias)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided, dilated) -> 1x1 (expansion 4), projected
    shortcut where the width or the stride changes."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilation: int = 1, norm: str = 'batchnorm'):
        super().__init__()
        width = out_channels // 4
        self.conv1 = conv(in_channels, width)
        self.bn1 = norm_layer(norm, width)
        self.conv2 = conv(width, width, 3, stride, dilation, dilation)
        self.bn2 = norm_layer(norm, width)
        self.conv3 = conv(width, out_channels)
        self.bn3 = norm_layer(norm, out_channels)
        self.downsample = in_channels != out_channels or stride != 1
        if self.downsample:
            self.downsample_conv = conv(in_channels, out_channels, 1, stride)
            self.downsample_bn = norm_layer(norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + x)


class ResNet(nn.Module):
    """ResNet-{50,101,152} trunk without avgpool/fc."""

    def __init__(self, layers: Sequence[int], input_conv_stride: int = 2,
                 pool0_stride: int = 0, block5_dilation: int = 1,
                 norm: str = 'batchnorm'):
        super().__init__()
        self.pool0_stride = pool0_stride
        self.conv1 = conv(3, 64, 7, input_conv_stride, 3)
        self.bn1 = norm_layer(norm, 64)
        channels = (256, 512, 1024, 2048)
        strides = (1, 2, 2, 2 if block5_dilation == 1 else 1)
        dilations = (1, 1, 1, block5_dilation)
        self.block_names = []
        cin = 64
        for stage_i, (n_blocks, ch, s, d) in enumerate(
                zip(layers, channels, strides, dilations), start=1):
            for block_i in range(n_blocks):
                name = f'layer{stage_i}_{block_i}'
                self.add_module(name, Bottleneck(
                    cin, ch, s if block_i == 0 else 1, d, norm))
                self.block_names.append(name)
                cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        if self.pool0_stride > 1:
            x = F.max_pool2d(x, 3, self.pool0_stride, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


def _make(layers):
    def factory(norm: str = 'batchnorm'):
        return ResNet(layers, norm=norm)
    return factory


register_basenet(BaseNetworkSpec('resnet50', _make((3, 4, 6, 3)),
                                 stride=16, out_features=2048))
register_basenet(BaseNetworkSpec('resnet101', _make((3, 4, 23, 3)),
                                 stride=16, out_features=2048))
register_basenet(BaseNetworkSpec('resnet152', _make((3, 8, 36, 3)),
                                 stride=16, out_features=2048))
