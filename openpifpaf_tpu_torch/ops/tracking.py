"""Temporal association on the device: TCAF candidates, association scores
and greedy track matching.

Port of ``openpifpaf_tpu/ops/tracking.py`` (``:25-173``).  Reference
parity: ``src/openpifpaf/decoder/tracking_pose.py:~30``.  Candidates are a
masked top-C per keypoint type (``common.masked_top_k``, ``lax.top_k``'s
tie order), the (previous pose x current pose) scores one reduction over a
(P, Q, K, C) product, and the greedy one-to-one match a fixed-depth loop
of min(P, Q) rounds, each claiming the global best remaining pair
(``torch.argmax`` takes the first of equal values, as ``jnp.argmax``
does).  Everything runs on the caller's device and reads nothing back to
the host: ``associate_on_device`` has no ``.item()``, no ``bool(tensor)``
and no host branch on a tensor, and the previous frame's poses, which the
tracker keeps on the host, go to the card by asynchronous copies from
pinned memory.  ``associate`` adds the one readback, the match
(``common.HOST_SYNCS`` counts it).  The association is plain PyTorch
tensor code, as the JAX package's is plain ``jnp`` under ``jit``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import common
from .common import masked_top_k
from ..models.heads import split_fields


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    score_th: float = 0.2          # min TCAF cell confidence
    max_candidates: int = 128      # static per-keypoint-type budget
    radius_factor: float = 1.0     # match radius = factor * joint scale
    min_radius_px: float = 4.0
    min_match_score: float = 0.05  # minimum association score to link tracks
    max_tracks: int = 96           # static track budget


class TcafCandidates(NamedTuple):
    """Per-keypoint-type temporal association candidates; all (K, C)."""

    score: torch.Tensor
    x1: torch.Tensor     # px, previous frame
    y1: torch.Tensor
    x2: torch.Tensor     # px, current frame
    y2: torch.Tensor
    s: torch.Tensor      # px, joint scale at candidate
    valid: torch.Tensor
    n_dropped: torch.Tensor


def tcaf_candidates(components, *, stride: int,
                    config: TrackingConfig) -> TcafCandidates:
    """Top-C temporal association candidates per keypoint type.

    :param components: TCAF ``FieldComponents`` — conf (K, H, W),
        vec (K, 2, 2, H, W) (vector 0: previous frame, vector 1: current),
        scale (K, 2, H, W), all in cell units.
    """
    k, h, w = components.conf.shape
    n = h * w
    device = components.conf.device
    jj = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    ii = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]

    vec = components.vec
    x1 = (ii + vec[:, 0, 0]) * stride
    y1 = (jj + vec[:, 0, 1]) * stride
    x2 = (ii + vec[:, 1, 0]) * stride
    y2 = (jj + vec[:, 1, 1]) * stride
    s = torch.maximum(components.scale[:, 0], components.scale[:, 1]) * stride

    flat = components.conf.reshape(k, n)
    mask = flat > config.score_th
    vals, idx, valid = masked_top_k(flat, mask, config.max_candidates)

    def take(a):
        return torch.gather(a.reshape(k, n), 1, idx)

    dropped = torch.clamp(mask.sum() - valid.sum(), min=0).to(torch.int32)
    return TcafCandidates(
        score=torch.where(valid, vals, 0.0), x1=take(x1), y1=take(y1),
        x2=take(x2), y2=take(y2), s=take(s), valid=valid, n_dropped=dropped)


def association_scores(cands: TcafCandidates, prev_xyv: torch.Tensor,
                       prev_valid: torch.Tensor, curr_xyv: torch.Tensor,
                       curr_valid: torch.Tensor,
                       config: TrackingConfig) -> torch.Tensor:
    """Score every (previous pose, current pose) pair via TCAF candidates.

    :param prev_xyv: (P, K, 3) poses in the previous frame (px)
    :param curr_xyv: (Q, K, 3) poses in the current frame (px)
    :returns: (P, Q) association scores in [0, 1]

    A candidate supports pair (p, q) at keypoint type k when its frame-1
    endpoint lands near prev_xyv[p, k] and its frame-2 endpoint near
    curr_xyv[q, k]; per (pair, k) the best candidate counts, and scores
    average over the keypoint types visible in both poses.
    """
    radius2 = torch.clamp(config.radius_factor * cands.s,
                          min=config.min_radius_px) ** 2      # (K, C)

    def near(px, py, cx, cy):
        # px/py (N, K); cx/cy (K, C) -> (N, K, C) inside-radius indicator
        d2 = ((px[:, :, None] - cx[None]) ** 2
              + (py[:, :, None] - cy[None]) ** 2)
        return d2 <= radius2[None]

    prev_vis = prev_xyv[..., 2] > 0.0        # (P, K)
    curr_vis = curr_xyv[..., 2] > 0.0        # (Q, K)
    near1 = near(prev_xyv[..., 0], prev_xyv[..., 1],
                 cands.x1, cands.y1) & prev_vis[:, :, None]    # (P, K, C)
    near2 = near(curr_xyv[..., 0], curr_xyv[..., 1],
                 cands.x2, cands.y2) & curr_vis[:, :, None]    # (Q, K, C)

    sc = torch.where(cands.valid, cands.score, 0.0)            # (K, C)
    # best supporting candidate per (p, q, k): max_c sc * near1 * near2
    per_k = (sc[None, None] * near1[:, None] * near2[None]).amax(-1)

    both_vis = prev_vis[:, None] & curr_vis[None]               # (P, Q, K)
    denom = torch.clamp(both_vis.sum(-1).to(torch.float32), min=1.0)
    scores = per_k.sum(-1) / denom
    return scores * prev_valid[:, None] * curr_valid[None]


def greedy_match(scores: torch.Tensor, min_score: float) -> torch.Tensor:
    """Greedy one-to-one assignment on a (P, Q) score matrix.

    Returns (Q,) int32: for each current pose the matched previous pose
    index, or -1.  min(P, Q) rounds of tensor ops, none of which reads a
    value back to the host: each round takes the global argmax (the first
    index of equal values), keeps it when it reaches ``min_score`` and
    masks its row and column.
    """
    p, q = scores.shape
    device = scores.device
    s = scores.to(torch.float32)
    match = torch.full((q,), -1, dtype=torch.int32, device=device)
    rows = torch.arange(p, device=device)
    cols = torch.arange(q, device=device)
    for _ in range(min(p, q)):
        flat_idx = torch.argmax(s.reshape(-1)).view(1)
        pi, qi = flat_idx // q, flat_idx % q
        ok = s.reshape(-1).gather(0, flat_idx) >= min_score        # (1,)
        match = torch.where(ok & (cols == qi), pi.to(torch.int32), match)
        claimed = (rows == pi)[:, None] | (cols == qi)[None]
        s = torch.where(ok & claimed, -1.0, s)
    return match


def _on_device(a, device: torch.device) -> torch.Tensor:
    """``a`` as a float32 tensor on ``device``; host arrays go to the card
    by an asynchronous copy from pinned memory, which waits for nothing."""
    if isinstance(a, torch.Tensor) and a.device == device:
        return a.to(torch.float32)
    a = torch.as_tensor(np.asarray(a, np.float32))
    if device.type == 'cuda':
        return a.pin_memory().to(device, non_blocking=True)
    return a


def associate_on_device(tcaf_field, prev_xyv, prev_valid, curr_xyv,
                        curr_valid, *, tcaf_meta,
                        config: TrackingConfig) -> torch.Tensor:
    """One frame pair's association on ``tcaf_field``'s device, with no
    host synchronization: (Q + 1,) int32, the match (``greedy_match``)
    followed by the candidates dropped beyond the budget.

    ``tcaf_field``: the raw (K, 9, H, W) head output; the poses as
    ``association_scores`` takes them, tensors or host arrays."""
    device = tcaf_field.device
    components = split_fields(tcaf_field.to(torch.float32), tcaf_meta)
    cands = tcaf_candidates(components, stride=tcaf_meta.stride,
                            config=config)
    prev_xyv, prev_valid, curr_xyv, curr_valid = (
        _on_device(a, device)
        for a in (prev_xyv, prev_valid, curr_xyv, curr_valid))
    scores = association_scores(cands, prev_xyv, prev_valid, curr_xyv,
                                curr_valid, config)
    match = greedy_match(scores, config.min_match_score)
    return torch.cat([match, cands.n_dropped.view(1)])


@torch.no_grad()
def associate(tcaf_field, prev_xyv, prev_valid, curr_xyv, curr_valid, *,
              tcaf_meta, config: TrackingConfig) -> Tuple[np.ndarray, int]:
    """``associate_on_device`` and its one readback: (match (Q,) int numpy,
    n_dropped int)."""
    out = associate_on_device(
        torch.as_tensor(tcaf_field), prev_xyv, prev_valid, curr_xyv,
        curr_valid, tcaf_meta=tcaf_meta, config=config)
    common.HOST_SYNCS += 1
    out = out.cpu().numpy()
    return out[:-1], int(out[-1])
