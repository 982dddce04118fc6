"""Backbone base definitions and registry.

Port of ``openpifpaf_tpu/models/base.py``: a ``BaseNetworkSpec`` carries
``stride`` and ``out_features`` so heads and decoders can do stride
arithmetic.  Modules are ``torch.nn`` and run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
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

    ``update_stats`` False normalizes with the batch statistics and leaves
    the running ones as they are: the trainer sets it while ``--remat``
    recomputes the forward, so that a step updates them once.

    ``process_group`` set (``--ddp`` sets it) and of more than one rank:
    the batch statistics are those of the global batch, as JAX's sharded
    step computes them, from per-channel sums summed over the group by an
    all-reduce that autograd differentiates (its backward sums the
    gradients over the group): first the mean, then the squared deviations
    from it (E[x^2] - E[x]^2 in f32 cancels where |mean| >> std, and
    would part from the one-process step).
    """

    update_stats = True
    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return self.batch_forward(x)

    def batch_forward(self, x: torch.Tensor,
                      channels: slice = slice(None)) -> torch.Tensor:
        """Train mode on NCHW ``x`` that holds the layer's ``channels``
        (all of them, or one parity of them in the fused training plan):
        normalized by the batch statistics, and those channels' running
        statistics updated."""
        group = self.process_group
        if group is not None and dist.get_world_size(group) > 1:
            return self._synced_forward(x, channels, group)
        if x.device.type == 'cpu':
            # the CPU's channels-last batch_norm (the training plan's
            # layout) splits each channel's sums across threads, so its
            # bf16 rounding moves with the thread count; the NCHW kernel
            # sums a channel on one thread
            x = x.contiguous()
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
                self.running_mean[channels].mul_(BN_MOMENTUM).add_(
                    mean, alpha=1 - BN_MOMENTUM)
                self.running_var[channels].mul_(BN_MOMENTUM).add_(
                    var, alpha=1 - BN_MOMENTUM)
        # contiguous: the CPU's channels-last batch_norm backward gets the
        # input's gradient wrong for a strided weight (torch 2.13)
        return F.batch_norm(x, None, None, self.weight[channels].contiguous(),
                            self.bias[channels].contiguous(), True, 0.0,
                            self.eps)

    def _synced_forward(self, x: torch.Tensor, channels: slice,
                        group) -> torch.Tensor:
        xf = x.float()
        c = x.shape[1]
        count = torch.full((1,), float(x.numel() // c), device=x.device)
        sums = dist_nn.all_reduce(torch.cat([xf.sum((0, 2, 3)), count]),
                                  group=group)
        mean = sums[:c] / sums[c]
        centered = xf - mean[:, None, None]
        var = dist_nn.all_reduce((centered * centered).sum((0, 2, 3)),
                                 group=group) / sums[c]
        if self.update_stats:
            with torch.no_grad():
                self.running_mean[channels].mul_(BN_MOMENTUM).add_(
                    mean, alpha=1 - BN_MOMENTUM)
                self.running_var[channels].mul_(BN_MOMENTUM).add_(
                    var, alpha=1 - BN_MOMENTUM)
        scale = torch.rsqrt(var + self.eps) * self.weight[channels]
        return (centered * scale[:, None, None]
                + self.bias[channels][:, None, None]).to(x.dtype)


def batch_norm(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=BN_EPSILON)


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm(dtype=x.dtype)``: the statistics and the
    normalization in float32 from the input as it is, the output in the
    input's dtype (bf16 in a bf16 forward), inside an autocast region as
    outside it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return F.group_norm(x.float(), self.num_groups, self.weight,
                                self.bias, self.eps).to(x.dtype)


NORM_KINDS = ('batchnorm', 'instancenorm', 'groupnorm', 'none')


def norm_layer(kind: str, channels: int) -> nn.Module:
    """The backbone's normalization layer, ``NormFactory`` of
    ``openpifpaf_tpu/models/base.py:49-79``: ``batchnorm`` (flax's
    statistics, ``BatchNorm``), ``instancenorm`` (affine, one channel per
    group, as flax's ``GroupNorm(group_size=1)``), ``groupnorm`` (32
    groups) or ``none`` (the identity).  eps 1e-5 throughout."""
    if kind == 'batchnorm':
        return batch_norm(channels)
    if kind == 'instancenorm':
        return GroupNorm(channels, channels, eps=BN_EPSILON)
    if kind == 'groupnorm':
        return GroupNorm(32, channels, eps=BN_EPSILON)
    if kind == 'none':
        return nn.Identity()
    raise ValueError(f'unknown norm kind {kind!r}')


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm(param_dtype=float32)`` with no ``dtype``: the
    statistics and the output are float32 whatever the input's dtype (flax
    promotes to the parameters' dtype), inside a bf16 autocast region as
    outside it.  ``eps`` is flax's default, 1e-6, unless given: Swin sets
    1e-5, XCiT and HRFormer keep the default."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                                self.bias, self.eps)


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the library's matmuls and convs run in here: autocast's
    inside an autocast region, else ``x``'s (the JAX modules' ``dtype``)."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def dot_f32(equation: str, *operands: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``jnp.einsum(equation, ..., preferred_element_type=float32)`` on
    operands in the compute ``dtype``: each operand is rounded to ``dtype``
    and the products are summed and returned in float32, as the JAX
    attention computes its logits and its weighted values."""
    with torch.autocast(operands[0].device.type, enabled=False):
        return torch.einsum(equation,
                            *[t.to(dtype).float() for t in operands])


# constants on the device, by (what, arguments, device)
_DEVICE_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def device_constant(fn, *args, device) -> torch.Tensor:
    """``fn(*args)`` (a numpy constant of static shapes) on ``device``,
    copied there once."""
    key = (fn.__name__, args, str(device))
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = torch.from_numpy(fn(*args)).to(device)
    return _DEVICE_CONSTANTS[key]


# raw parameters (``self.param`` outside Dense/Conv/norm layers) of the
# backbones, by name: flax's initializer in kind (``factory.init_weights``)
# and carried by ``from_jax`` under the same name
RAW_PARAMETERS = {
    'relative_position_bias_table': 'truncated_normal_0.02',   # Swin
    'rel_h': 'normal_0.02', 'rel_w': 'normal_0.02',             # BoTNet
    'temperature': 'ones',                                       # XCiT
    'gamma1': 'ones', 'gamma2': 'ones', 'gamma3': 'ones',        # XCiT
}
