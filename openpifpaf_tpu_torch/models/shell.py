"""Shell: backbone + head networks, and the Model wrapper.

Port of ``openpifpaf_tpu/models/shell.py``.  Reference parity:
``src/openpifpaf/network/nets.py:~20``.  ``Shell`` is an ``nn.Module`` whose
forward returns the list of head field tensors; it holds the weights.
``Model`` holds the Shell with its head metas, device and compute
precision.  Its ``__call__`` is ``apply_fast``, the inference forward
through the fused execution plan of ``fused_shufflenet.py`` (the pair plan,
with the stride-1 chains on the CUDA kernel K2 on the card), as the JAX
``Predictor`` runs ``Model.apply_fast``.  ``apply_fast`` runs
``ServedForward``, the module that ``export_program`` traces, so serving
and export are one code path.  ``apply`` is the canonical graph of the
same math, the plain forward that the tests compare against.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from . import fused_shufflenet
from .. import headmeta as headmeta_mod


def apply_heads(head_nets: Sequence[nn.Module], feats: torch.Tensor,
                head_paired: Optional[Sequence[bool]] = None
                ) -> List[torch.Tensor]:
    """The heads on NCHW features.  With ``head_paired`` (a tracking
    shell's) the features are of interleaved frame pairs (2B, C, h, w), and
    a paired head sees the two frames' features side by side."""
    if head_paired is None:
        return [head(feats) for head in head_nets]
    paired = torch.cat([feats[0::2], feats[1::2]], dim=1)
    return [head(paired if is_paired else feats)
            for head, is_paired in zip(head_nets, head_paired)]


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
        return apply_heads(self.head_nets, self.basenet(x))


class _Slot(NamedTuple):
    """Where a tensor of the plan sits among the module's buffers."""

    buffer: str


class ServedForward(nn.Module):
    """What ``Model.__call__`` serves, as one module whose state is
    buffers and parameters only: NCHW float32 images (interleaved frame
    pairs for a tracking model) on the model's device -> the head fields.

    - A batchnorm ShuffleNetV2K takes the fused plan (the pair plan, its
      stride-1 chains through the operator
      ``openpifpaf_tpu_torch::pair_chain``, K2 on the card), then the heads
      under bf16 autocast when the model computes in bf16.  The folded
      plan (``Model.inference_plan()``) is held as registered buffers, so
      that ``torch.export.save`` stores it with the heads' parameters; the
      chains keep only their packed tensors (the float32 ``BlockParams``
      do not cross the operator), and the backbone's own weights are not
      held: the plan is them, folded.
    - Any other backbone takes ``Model.apply``'s canonical graph under the
      same autocast.

    It shares the heads (and, off the fused path, the Shell) with the
    model; ``Model.served_forward()`` builds it once per fold."""

    def __init__(self, model: 'Model'):
        super().__init__()
        self.bf16 = model.bf16
        self.device_type = model.device.type
        basenet = model.module.basenet
        self.fused = (model.fused_inference
                      and fused_shufflenet.supports(basenet))
        if not self.fused:
            self.shell = model.module
            return
        self.head_nets = model.module.head_nets
        self.head_paired = getattr(model.module, 'head_paired', None)
        # the fused plans read only the backbone's stage repeats
        self.stages = SimpleNamespace(stages_repeats=basenet.stages_repeats)
        plan = model.inference_plan()
        plan = plan._replace(chains={
            stage: chain._replace(blocks=[])
            for stage, chain in plan.chains.items()})
        self.plan_slots = self._register(plan, 'plan')

    def _register(self, value, name: str):
        """The plan with each tensor registered as a buffer and replaced by
        its ``_Slot``."""
        if isinstance(value, torch.Tensor):
            self.register_buffer(name, value)
            return _Slot(name)
        if isinstance(value, dict):
            return {k: self._register(v, f'{name}_{k}')
                    for k, v in value.items()}
        if isinstance(value, tuple) and hasattr(value, '_fields'):
            return type(value)(*(self._register(v, f'{name}_{field}')
                                 for field, v in zip(value._fields, value)))
        if isinstance(value, (tuple, list)):
            return type(value)(self._register(v, f'{name}_{i}')
                               for i, v in enumerate(value))
        return value

    def _plan(self, value):
        """The plan rebuilt from the buffers (``_register`` undone)."""
        if isinstance(value, _Slot):
            return getattr(self, value.buffer)
        if isinstance(value, dict):
            return {k: self._plan(v) for k, v in value.items()}
        if isinstance(value, tuple) and hasattr(value, '_fields'):
            return type(value)(*(self._plan(v) for v in value))
        if isinstance(value, (tuple, list)):
            return type(value)(self._plan(v) for v in value)
        return value

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        autocast = torch.autocast(self.device_type, dtype=torch.bfloat16,
                                  enabled=self.bf16)
        if not self.fused:
            with autocast:
                return self.shell(x)
        features = fused_shufflenet.backbone_features(
            self.stages, x, self._plan(self.plan_slots))
        features = features.permute(0, 3, 1, 2)   # NCHW view, channels-last
        with autocast:
            return apply_heads(self.head_nets, features, self.head_paired)


class Model:
    """A Shell with its head metas, device and compute precision.

    ``bf16``: compute in bfloat16 with float32 parameters, like the JAX
    ``Factory(bf16=True)``; heads cast their output to float32.
    """

    # the fused execution plan (models/fused_shufflenet.py); set to False
    # (before the first call, or then refold()) to run the canonical graph
    # in __call__
    fused_inference = True
    # True: the trainer takes the folded-routing training plan
    # (fused_shufflenet.shell_apply_train) where supports_train, as the
    # JAX Model's default does.  Off by default here: on an H100 the plan's
    # step is slower than the canonical graph's (PERF.md)
    fused_train = False

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
        self._served = None
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

    def served_forward(self) -> ServedForward:
        """``apply_fast`` as a module, built at the first call: the module
        ``export_program`` traces."""
        if self._served is None:
            self._served = ServedForward(self)
        return self._served

    def refold(self) -> None:
        self._plan = None
        self._served = None

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
        ``fused_shufflenet``'s plan, anything else the canonical graph
        (``ServedForward``)."""
        return self.served_forward()(x.to(self.device, torch.float32))

    def __call__(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Inference forward: NCHW float32 images -> head fields."""
        return self.apply_fast(x)
