"""CAF candidate scoring: directed association candidates per skeleton edge.

Port of ``openpifpaf_tpu/ops/caf_scored.py``.  Reference parity:
``src/openpifpaf/csrc/src/decoder/utils/caf_scored.cpp:~20``: CAF cells
above ``score_th`` (raw confidence — the threshold comes *before*
rescoring) are rescored with the CifHr value at their target endpoint and
stored once per traversal direction.  One top-C on raw confidence per edge
selects the cells for both directions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .common import gather_field_grouped, masked_top_k


@dataclasses.dataclass(frozen=True)
class CafScoredConfig:
    score_th: float = 0.2        # reference CafScored::score_th
    cif_floor: float = 0.1       # rescore = c*(floor + (1-floor)*cifhr(tgt))
    max_candidates: int = 256    # per-(edge, direction) budget


class CafCandidates(NamedTuple):
    """Directed candidates, all (B, E, 2, C); direction 0 walks the edge
    from endpoint 1 to endpoint 2, direction 1 the reverse."""

    score: torch.Tensor
    x_src: torch.Tensor
    y_src: torch.Tensor
    x_tgt: torch.Tensor
    y_tgt: torch.Tensor
    s_tgt: torch.Tensor
    valid: torch.Tensor
    n_dropped: torch.Tensor  # (B,) int32: candidates above th that didn't fit


def score(components, cifhr: torch.Tensor, skeleton: np.ndarray, *,
          stride: int, hr_spacing: float, config: CafScoredConfig,
          confidence_scales: np.ndarray = None) -> CafCandidates:
    """Build directed association candidates.

    :param components: CAF FieldComponents — conf (B, E, H, W),
        vec (B, E, 2, 2, H, W), scale (B, E, 2, H, W), cell units
    :param cifhr: (B, K, Hh, Wh) accumulated CIF confidences
    :param skeleton: (E, 2) 0-based keypoint indices per edge
    """
    conf = components.conf
    b, e, h, w = conf.shape
    n = h * w
    dev = conf.device
    jj = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    ii = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    if confidence_scales is not None:
        conf = conf * torch.as_tensor(confidence_scales, dtype=torch.float32,
                                      device=dev)[:, None, None]

    vec, scale = components.vec, components.scale
    x1 = (ii + vec[:, :, 0, 0]) * stride     # (B, E, H, W) px
    y1 = (jj + vec[:, :, 0, 1]) * stride
    x2 = (ii + vec[:, :, 1, 0]) * stride
    y2 = (jj + vec[:, :, 1, 1]) * stride
    s1 = scale[:, :, 0] * stride
    s2 = scale[:, :, 1] * stride

    flat_conf = conf.reshape(b, e, n)
    mask = flat_conf > config.score_th
    vals, idx, valid = masked_top_k(flat_conf, mask, config.max_candidates)
    conf_sel = torch.where(valid, vals, 0.0)
    n_dropped = torch.clamp(mask.sum((1, 2)) - valid.sum((1, 2)), min=0).int()

    packed = torch.stack([x1, y1, x2, y2, s1, s2], dim=-1).reshape(b, e, n, 6)
    packed_sel = torch.gather(packed, 2, idx[..., None].expand(-1, -1, -1, 6))
    x1s, y1s, x2s, y2s, s1s, s2s = packed_sel.unbind(-1)

    skeleton = torch.as_tensor(np.asarray(skeleton), dtype=torch.int64,
                               device=dev)
    hr1 = gather_field_grouped(cifhr, skeleton[:, 0], x1s, y1s, hr_spacing)
    hr2 = gather_field_grouped(cifhr, skeleton[:, 1], x2s, y2s, hr_spacing)

    floor = config.cif_floor
    score_fwd = conf_sel * (floor + (1.0 - floor) * hr2)   # walk 1 -> 2
    score_bwd = conf_sel * (floor + (1.0 - floor) * hr1)   # walk 2 -> 1

    def stack(fwd, bwd):
        return torch.stack([fwd, bwd], dim=2)              # (B, E, 2, C)

    return CafCandidates(
        score=stack(score_fwd, score_bwd),
        x_src=stack(x1s, x2s), y_src=stack(y1s, y2s),
        x_tgt=stack(x2s, x1s), y_tgt=stack(y2s, y1s),
        s_tgt=stack(s2s, s1s),
        valid=stack(valid, valid),
        n_dropped=n_dropped)
