"""SqueezeNet backbone in PyTorch (NCHW).

Port of ``openpifpaf_tpu/models/squeezenet.py`` (``:16-72``).  Reference
parity: ``src/openpifpaf/network/basenetworks.py:~480``: SqueezeNet 1.1's
Fire modules, with explicitly padded 3x3/2 max pools (pad 1 each side,
``:47-49``) so the pools give a total stride of 16.  Every conv has a bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .base import BaseNetworkSpec, norm_layer, register_basenet
from .resnet import conv


class Fire(nn.Module):
    def __init__(self, in_channels: int, squeeze_channels: int,
                 expand1x1_channels: int, expand3x3_channels: int,
                 norm: str = 'batchnorm'):
        super().__init__()
        self.squeeze = conv(in_channels, squeeze_channels, bias=True)
        self.expand1x1 = conv(squeeze_channels, expand1x1_channels,
                              bias=True)
        self.expand3x3 = conv(squeeze_channels, expand3x3_channels, 3,
                              padding=1, bias=True)
        self.norm = norm_layer(norm, expand1x1_channels + expand3x3_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.squeeze(x))
        out = torch.cat([torch.relu(self.expand1x1(s)),
                         torch.relu(self.expand3x3(s))], dim=1)
        return self.norm(out)


class SqueezeNet(nn.Module):
    """SqueezeNet 1.1 trunk at total stride 16 (pools at 2, 4, 8, 16)."""

    # name, squeeze, expand (1x1 and 3x3), max-pool before
    FIRES = (('fire2', 16, 64, True), ('fire3', 16, 64, False),
             ('fire4', 32, 128, True), ('fire5', 32, 128, False),
             ('fire6', 48, 192, True), ('fire7', 48, 192, False),
             ('fire8', 64, 256, False), ('fire9', 64, 256, False))

    def __init__(self, norm: str = 'batchnorm'):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 2, 1, bias=True)
        cin = 64
        for name, squeeze, expand, _ in self.FIRES:
            self.add_module(name, Fire(cin, squeeze, expand, expand, norm))
            cin = 2 * expand

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1(x))
        for name, _, _, pool in self.FIRES:
            if pool:
                x = F.max_pool2d(x, 3, 2, 1)
            x = getattr(self, name)(x)
        return x


register_basenet(BaseNetworkSpec(
    'squeezenet', lambda norm='batchnorm': SqueezeNet(norm=norm),
    stride=16, out_features=512))
