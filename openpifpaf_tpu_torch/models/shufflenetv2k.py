"""ShuffleNetV2K backbone in PyTorch (NCHW).

Port of ``openpifpaf_tpu/models/shufflenetv2k.py``.  Reference parity:
``src/openpifpaf/network/basenetworks.py:~200`` (``ShuffleNetV2K``): a
ShuffleNetV2 variant with 5x5 depthwise kernels, no max-pool (total stride
16), with the backbone's normalization configurable (``norm``,
``base.norm_layer``).  ``shufflenetv2x1``/``x2`` are the same network with
3x3 depthwise kernels, the plain ShuffleNetV2 of
``openpifpaf_tpu/models/shufflenetv2k.py:142-156``.  Submodule names follow the flax module names (``conv1``,
``stage2_0.branch1_dwconv``, ...) so ``models/from_jax.py`` maps a flax
variable path to a state-dict key by replacing ``/`` with ``.``.

Convolutions run through ``torch.nn.Conv2d`` (cuDNN, or PyTorch's own
depthwise kernel, on the card), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from .base import BaseNetworkSpec, norm_layer, register_basenet


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Interleave channel groups on dim 1 (NCHW).

    The JAX version acts on NHWC's last axis; both view C as
    ``(groups, C // groups)`` and transpose.
    """
    b, c, h, w = x.shape
    return (x.view(b, groups, c // groups, h, w).transpose(1, 2)
            .reshape(b, c, h, w))


def _conv(cin: int, cout: int, kernel_size: int = 1, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel_size, stride=stride,
                     padding=kernel_size // 2, groups=groups, bias=False)


class InvertedResidualK(nn.Module):
    """ShuffleNetV2 block with a configurable (large) depthwise kernel."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 kernel_size: int = 5, norm: str = 'batchnorm'):
        super().__init__()
        norm_of = functools.partial(norm_layer, norm)
        self.stride = stride
        bf = out_channels // 2
        k = kernel_size
        if stride > 1:
            # branch1: depthwise kxk stride s -> norm -> 1x1 -> norm -> relu
            self.branch1_dwconv = _conv(in_channels, in_channels, k, stride,
                                        groups=in_channels)
            self.branch1_dwnorm = norm_of(in_channels)
            self.branch1_conv = _conv(in_channels, bf)
            self.branch1_norm = norm_of(bf)
            in2 = in_channels
        else:
            in2 = in_channels // 2
        # branch2: 1x1 -> norm -> relu -> dw kxk -> norm -> 1x1 -> norm -> relu
        self.branch2_conv1 = _conv(in2, bf)
        self.branch2_norm1 = norm_of(bf)
        self.branch2_dwconv = _conv(bf, bf, k, stride, groups=bf)
        self.branch2_dwnorm = norm_of(bf)
        self.branch2_conv2 = _conv(bf, bf)
        self.branch2_norm2 = norm_of(bf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            half = x.shape[1] // 2
            x1, x2 = x[:, :half], x[:, half:]
            b1 = x1
        else:
            x2 = x
            b1 = self.branch1_dwnorm(self.branch1_dwconv(x))
            b1 = torch.relu(self.branch1_norm(self.branch1_conv(b1)))
        b2 = torch.relu(self.branch2_norm1(self.branch2_conv1(x2)))
        b2 = self.branch2_dwnorm(self.branch2_dwconv(b2))
        b2 = torch.relu(self.branch2_norm2(self.branch2_conv2(b2)))
        return channel_shuffle(torch.cat([b1, b2], dim=1), 2)


class ShuffleNetV2K(nn.Module):
    """conv1 (stride 2) + 3 stages (stride 2 each) + conv5; NCHW in/out."""

    def __init__(self, stages_repeats: Sequence[int],
                 stages_out_channels: Sequence[int], kernel_size: int = 5,
                 norm: str = 'batchnorm'):
        super().__init__()
        norm_of = functools.partial(norm_layer, norm)
        c = list(stages_out_channels)
        self.stages_repeats = tuple(stages_repeats)
        self.stages_out_channels = tuple(c)
        self.kernel_size = kernel_size
        self.norm = norm
        self.conv1 = nn.Conv2d(3, c[0], 3, stride=2, padding=1, bias=False)
        self.conv1_norm = norm_of(c[0])
        self.block_names = []
        cin = c[0]
        for stage_i, (repeats, cout) in enumerate(
                zip(stages_repeats, c[1:4]), start=2):
            for block_i in range(repeats):
                name = f'stage{stage_i}_{block_i}'
                self.add_module(name, InvertedResidualK(
                    cin, cout, 2 if block_i == 0 else 1, kernel_size, norm))
                self.block_names.append(name)
                cin = cout
        self.conv5 = nn.Conv2d(cin, c[-1], 1, bias=False)
        self.conv5_norm = norm_of(c[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1_norm(self.conv1(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return torch.relu(self.conv5_norm(self.conv5(x)))


def _make(repeats, channels, kernel_size=5):
    def factory(norm: str = 'batchnorm'):
        return ShuffleNetV2K(repeats, channels, kernel_size, norm)
    return factory


register_basenet(BaseNetworkSpec(
    'shufflenetv2x1', _make((4, 8, 4), (24, 116, 232, 464, 1024), 3),
    stride=16, out_features=1024))
register_basenet(BaseNetworkSpec(
    'shufflenetv2x2', _make((4, 8, 4), (24, 244, 488, 976, 2048), 3),
    stride=16, out_features=2048))

register_basenet(BaseNetworkSpec(
    'shufflenetv2k16', _make((4, 8, 4), (24, 348, 696, 1392, 1392)),
    stride=16, out_features=1392))
register_basenet(BaseNetworkSpec(
    'shufflenetv2k30', _make((8, 16, 6), (32, 512, 1024, 2048, 2048)),
    stride=16, out_features=2048))
register_basenet(BaseNetworkSpec(
    'shufflenetv2k44', _make((12, 24, 8), (32, 512, 1024, 2048, 2048)),
    stride=16, out_features=2048))
