"""Seed selection: candidate starting keypoints for pose growth.

Port of ``openpifpaf_tpu/ops/seeds.py``.  Reference parity:
``src/openpifpaf/csrc/src/decoder/utils/cif_seeds.cpp:~20``: every CIF cell
whose confidence — blended with the CifHr value at its regressed target —
exceeds ``seed_threshold`` becomes a candidate ``(v, field, x, y, scale)``;
candidates are sorted descending by value into a fixed ``max_seeds`` budget.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import gather_field_grouped, masked_top_k


@dataclasses.dataclass(frozen=True)
class SeedsConfig:
    threshold: float = 0.2       # reference CifSeeds::threshold
    min_conf: float = 0.1        # cell confidence gate (CifHr v_threshold)
    score_scale: float = 1.0
    cifhr_blend: float = 0.9     # v = blend*cifhr(target) + (1-blend)*conf
    max_seeds: int = 512         # candidate budget per image
    local_max: bool = True       # keep 3x3 local maxima of the blend only


class Seeds(NamedTuple):
    """Seed set per image, sorted descending by value.  All (B, S)."""

    v: torch.Tensor
    f: torch.Tensor        # int64 field (keypoint type) index
    x: torch.Tensor        # px
    y: torch.Tensor        # px
    s: torch.Tensor        # scale px
    valid: torch.Tensor    # bool


def select(conf: torch.Tensor, x_px: torch.Tensor, y_px: torch.Tensor,
           scale_px: torch.Tensor, cifhr: torch.Tensor, *,
           hr_spacing: float, config: SeedsConfig) -> Seeds:
    """conf/x_px/y_px/scale_px: (B, F, H, W); cifhr: (B, F, Hh, Wh)."""
    b, f, h, w = conf.shape
    fields = torch.arange(f, device=conf.device)
    hr_v = gather_field_grouped(cifhr, fields, x_px, y_px, hr_spacing)
    v = (config.cifhr_blend * hr_v
         + (1.0 - config.cifhr_blend) * conf) * config.score_scale

    mask = (v > config.threshold) & (conf > config.min_conf)
    if config.local_max:
        # 3x3 SAME window; max_pool2d pads with -inf like reduce_window
        vmax = F.max_pool2d(v, 3, stride=1, padding=1)
        mask = mask & (v >= vmax)
    vals, idx, valid = masked_top_k(v.reshape(b, -1), mask.reshape(b, -1),
                                    config.max_seeds)
    packed = torch.stack([x_px, y_px, scale_px], dim=-1).reshape(b, -1, 3)
    packed_sel = torch.gather(packed, 1, idx[..., None].expand(-1, -1, 3))
    return Seeds(
        v=torch.where(valid, vals, 0.0),
        f=idx // (h * w),
        x=packed_sel[..., 0],
        y=packed_sel[..., 1],
        s=packed_sel[..., 2],
        valid=valid,
    )
