"""Shell: backbone + head networks, and the Model wrapper.

Port of ``openpifpaf_tpu/models/shell.py``.  Reference parity:
``src/openpifpaf/network/nets.py:~20``.  ``Shell`` is an ``nn.Module`` whose
forward returns the list of head field tensors; it holds the weights.
``Model`` holds the Shell with its head metas, device and compute
precision.  Its ``__call__`` is ``apply_fast``, the inference forward
through the fused execution plan of ``fused_shufflenet.py`` (the pair plan,
with the stride-1 chains on the CUDA kernel K2 on the card), as the JAX
``Predictor`` runs ``Model.apply_fast``.  ``apply`` is the canonical graph
of the same math, the plain forward that the tests compare against.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from . import fused_shufflenet
from .. import headmeta as headmeta_mod


class Shell(nn.Module):
    """``cross_talk`` (``--cross-talk``): in train mode only, the input
    batch gets ``cross_talk`` times itself rolled by one image added, as
    the JAX ``Shell`` does (``shell.py:26-33``)."""

    def __init__(self, basenet: nn.Module, head_nets: Sequence[nn.Module],
                 cross_talk: float = 0.0):
        super().__init__()
        self.basenet = basenet
        self.head_nets = nn.ModuleList(head_nets)
        self.cross_talk = cross_talk

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.training and self.cross_talk > 0.0:
            x = x + self.cross_talk * torch.roll(x, 1, 0)
        features = self.basenet(x)
        return [head(features) for head in self.head_nets]


class Model:
    """A Shell with its head metas, device and compute precision.

    ``bf16``: compute in bfloat16 with float32 parameters, like the JAX
    ``Factory(bf16=True)``; heads cast their output to float32.
    """

    # the fused execution plan (models/fused_shufflenet.py); set to False to
    # run the canonical graph in __call__
    fused_inference = True

    def __init__(self, module: Shell, head_metas: Sequence[headmeta_mod.Base],
                 *, base_stride: int, basenet_name: str = '',
                 device: torch.device, bf16: bool = True):
        self.module = module.to(device).eval()
        self.head_metas = list(head_metas)
        self.base_stride = base_stride
        self.basenet_name = basenet_name
        self.device = device
        self.bf16 = bf16
        self.epoch = 0   # the training epochs behind the weights
        self._plan = None
        for i, meta in enumerate(self.head_metas):
            meta.head_index = i
            meta.base_stride = base_stride

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.bf16 else torch.float32

    def inference_plan(self) -> fused_shufflenet.Plan:
        """The backbone's folded inference parameters, folded at the first
        call; ``refold()`` after changing the backbone's weights."""
        if self._plan is None:
            self._plan = fused_shufflenet.fold(self.module.basenet, self.dtype)
        return self._plan

    def refold(self) -> None:
        self._plan = None

    @torch.no_grad()
    def apply(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The canonical graph: NCHW float32 images -> head fields, bf16
        through autocast when ``bf16``."""
        x = x.to(self.device, torch.float32)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
            return self.module(x)

    @torch.no_grad()
    def apply_fast(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Inference forward through the fused plan: the same math as
        ``apply``.  Batchnorm ShuffleNetV2K backbones take
        ``fused_shufflenet``'s plan, anything else the canonical graph."""
        if not (self.fused_inference
                and fused_shufflenet.supports(self.module.basenet)):
            return self.apply(x)
        return fused_shufflenet.shell_apply(
            self, x.to(self.device, torch.float32))

    def __call__(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Inference forward: NCHW float32 images -> head fields."""
        return self.apply_fast(x)
