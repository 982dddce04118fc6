"""Model factory: build a fresh model or load a JAX-package checkpoint.

Port of the predict-path subset of ``openpifpaf_tpu/models/factory.py``
(``Factory.factory`` / ``build_module`` / ``from_checkpoint``).  A fresh
model draws its weights from a seeded ``torch.Generator``; a checkpoint is
the JAX package's npz, carried over by ``from_jax.from_jax_variables``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from . import checkpoint as checkpoint_mod
from . import shufflenetv2k  # noqa: F401  registers the backbones
from .base import BASE_FACTORIES
from .from_jax import from_jax_variables
from .heads import CompositeField4
from .shell import Model, Shell
from .. import headmeta as headmeta_mod
from ..device import resolve_device


def build_shell(basenet_name: str, head_metas: Sequence[headmeta_mod.Base]):
    """Construct the (uninitialized) Shell; returns (shell, base stride)."""
    spec = BASE_FACTORIES[basenet_name]
    for meta in head_metas:
        meta.base_stride = spec.stride
    heads = [CompositeField4(meta, spec.out_features) for meta in head_metas]
    return Shell(spec.build(), heads), spec.stride


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator``, flax's defaults in kind:
    lecun-normal conv kernels (variance 1/fan_in), zero biases, identity
    BatchNorm (scale 1, bias 0, mean 0, var 1)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def factory(base_name: Optional[str] = None,
            head_metas: Optional[Sequence[headmeta_mod.Base]] = None, *,
            checkpoint: Optional[str] = None, bf16: bool = True,
            device=None, seed: int = 0) -> Model:
    """Build a Model on ``device`` (``None``: the card, raising without
    CUDA).  ``checkpoint`` (a JAX-package npz) wins over ``base_name``;
    a fresh model draws its weights from ``torch.Generator().manual_seed(seed)``.
    """
    device = resolve_device(device)
    if checkpoint is not None:
        header, flat = checkpoint_mod.load(checkpoint)
        base_name = header['basenet']
        head_metas = header['head_metas']
        shell, stride = build_shell(base_name, head_metas)
        shell.load_state_dict(from_jax_variables(flat), strict=True)
    else:
        if not base_name or head_metas is None:
            raise ValueError('either checkpoint or base_name and head_metas '
                             'must be given')
        shell, stride = build_shell(base_name, head_metas)
        init_weights(shell, torch.Generator().manual_seed(seed))
    model = Model(shell, head_metas, base_stride=stride,
                  basenet_name=base_name, device=device, bf16=bf16)
    if checkpoint is not None:
        model.epoch = header.get('epoch', 0)
    return model
