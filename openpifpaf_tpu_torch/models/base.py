"""Backbone base definitions and registry.

Port of ``openpifpaf_tpu/models/base.py``: a ``BaseNetworkSpec`` carries
``stride`` and ``out_features`` so heads and decoders can do stride
arithmetic.  Modules are ``torch.nn`` and run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

# BatchNorm numerics of the JAX package (``models/base.py:45-46``): flax's
# momentum is the weight of the running average, ra = 0.9 ra + 0.1 batch
BN_EPSILON = 1e-5
BN_MOMENTUM = 0.9


@dataclasses.dataclass
class BaseNetworkSpec:
    """Static description of a backbone: how to build it and its geometry."""

    name: str
    factory: Callable[..., nn.Module]
    stride: int
    out_features: int

    def build(self, **kwargs) -> nn.Module:
        return self.factory(**kwargs)


# name -> BaseNetworkSpec; populated by the model modules at import time
BASE_FACTORIES: Dict[str, BaseNetworkSpec] = {}


def register_basenet(spec: BaseNetworkSpec) -> BaseNetworkSpec:
    BASE_FACTORIES[spec.name] = spec
    return spec


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running statistics follow flax.

    In train mode both normalize with the biased batch variance, but
    ``nn.BatchNorm2d`` updates ``running_var`` with the unbiased one and
    weighs the batch by ``momentum`` = 0.1 in torch's sense; flax
    (``nn.BatchNorm(momentum=0.9)``) keeps ``0.9 * ra + 0.1 * batch`` with
    the biased variance.  The two differ by n / (n - 1), large at small
    batches on stage 4's grid.  So train mode normalizes without touching
    the statistics and updates them here in f32, flax's way; eval mode is
    ``nn.BatchNorm2d``'s.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def batch_norm(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=BN_EPSILON)
