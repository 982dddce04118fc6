"""Shell: backbone + head networks, and the Model wrapper.

Port of ``openpifpaf_tpu/models/shell.py``.  Reference parity:
``src/openpifpaf/network/nets.py:~20``.  ``Shell`` is an ``nn.Module`` whose
forward returns the list of head field tensors.  ``Model`` holds the Shell
with its head metas, device and compute precision; its ``__call__`` is the
inference forward (``Model.apply_fast`` of the JAX package, which computes
the same math as ``apply(train=False)`` through a TPU execution plan — the
port runs the canonical graph).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from .. import headmeta as headmeta_mod


class Shell(nn.Module):
    def __init__(self, basenet: nn.Module, head_nets: Sequence[nn.Module]):
        super().__init__()
        self.basenet = basenet
        self.head_nets = nn.ModuleList(head_nets)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = self.basenet(x)
        return [head(features) for head in self.head_nets]


class Model:
    """A Shell with its head metas, device and compute precision.

    ``bf16``: compute in bfloat16 with float32 parameters (autocast), like
    the JAX ``Factory(bf16=True)``; heads cast their output to float32.
    """

    def __init__(self, module: Shell, head_metas: Sequence[headmeta_mod.Base],
                 *, base_stride: int, basenet_name: str = '',
                 device: torch.device, bf16: bool = True):
        self.module = module.to(device).eval()
        self.head_metas = list(head_metas)
        self.base_stride = base_stride
        self.basenet_name = basenet_name
        self.device = device
        self.bf16 = bf16
        for i, meta in enumerate(self.head_metas):
            meta.head_index = i
            meta.base_stride = base_stride

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Inference forward: NCHW float32 images -> head fields."""
        x = x.to(self.device, torch.float32)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
            return self.module(x)
