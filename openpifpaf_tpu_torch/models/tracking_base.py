"""Tracking networks: shared-weight frame-pair processing.

Port of ``openpifpaf_tpu/models/tracking_base.py`` (``:29-117``).
Reference parity: ``src/openpifpaf/network/tracking_base.py:~20``.  The
frame pair is folded into the batch axis for the backbone: frames come
interleaved, ``(2B, 3, H, W)`` (previous, current, previous, current,
...), as ``datasets.collate_tracking_images_targets_meta`` lays them out.
Single-frame heads (CIF, CAF) return ``(2B, F, C, h, w)``; paired heads
(TCAF) see the two frames' features concatenated on the channel axis,
``cat([feats[0::2], feats[1::2]], 1)``, and return ``(B, F, C, h, w)``.

``backbone_features`` and ``heads_from_features`` are the two halves of the
forward, so that a video stream runs the backbone on the new frame only
and the heads on the cached pair (``video.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from . import fused_shufflenet
from .shell import Model, Shell, apply_heads
from .. import headmeta as headmeta_mod


class TrackingShell(Shell):
    """Backbone and heads over interleaved frame pairs.  It takes no
    ``cross_talk``: the JAX factory builds its ``TrackingShell`` without
    one (``factory.py:155-160``), so ``--cross-talk`` leaves a tracking
    model as it is."""

    def __init__(self, basenet: nn.Module, head_nets: Sequence[nn.Module],
                 head_paired: Sequence[bool]):
        super().__init__(basenet, head_nets)
        self.head_paired = tuple(head_paired)

    def backbone_features(self, x: torch.Tensor) -> torch.Tensor:
        """Single-frame features: (N, 3, H, W) -> (N, C, h, w)."""
        return self.basenet(x)

    def heads_from_features(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """The heads on the features of interleaved pairs (2B, C, h, w)."""
        return apply_heads(self.head_nets, feats, self.head_paired)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.heads_from_features(self.backbone_features(x))


class TrackingModel(Model):
    """Model over frame pairs.

    ``apply_fast`` (and so ``__call__``) is ``Model``'s: ``ServedForward``
    runs the fused backbone (the pair plan, with the stride-1 chains on K2
    on the card) on the interleaved frames and dispatches the heads by the
    shell's ``head_paired``, as ``TrackingShell.heads_from_features``.
    ``backbone_features`` and ``heads_from_features`` are the two halves
    for a video stream."""

    def _fused(self) -> bool:
        return (self.fused_inference
                and fused_shufflenet.supports(self.module.basenet))

    @torch.no_grad()
    def backbone_features(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW float32 frames -> NCHW features (a channels-last view on
        the fused path)."""
        x = x.to(self.device, torch.float32)
        if self._fused():
            return fused_shufflenet.backbone_features(
                self.module.basenet, x, self.inference_plan()
            ).permute(0, 3, 1, 2)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
            return self.module.backbone_features(x)

    @torch.no_grad()
    def heads_from_features(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """The heads on interleaved pair features (2B, C, h, w)."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
            return self.module.heads_from_features(feats)


def is_tracking_metas(head_metas) -> bool:
    return any(isinstance(m, headmeta_mod.Tcaf) for m in head_metas)
