"""Backbone base definitions and registry.

Port of ``openpifpaf_tpu/models/base.py``: a ``BaseNetworkSpec`` carries
``stride`` and ``out_features`` so heads and decoders can do stride
arithmetic.  Modules are ``torch.nn`` and run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from torch import nn

# BatchNorm epsilon of the JAX package (``models/base.py:45``)
BN_EPSILON = 1e-5


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


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPSILON)
