"""Keypoint NMS, seed-claim suppression and pose scoring.

Port of ``openpifpaf_tpu/ops/nms.py``.  Reference parity:
``src/openpifpaf/csrc/src/decoder/utils/nms_keypoints.cpp`` and the
seed-time occupancy check (``cifcaf.cpp:~140``, ``occupancy.cpp:~15``).
The JAX package's fixpoints (``jax.lax.while_loop``, ``nms.py:139, 237``)
run here as batched Python loops to the same convergence test or cap
(``common.while_loop``; traced under ``torch.export``).  ``round`` is half-to-even in both frameworks, so
the occupancy quantization matches bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import while_loop


@dataclasses.dataclass(frozen=True)
class NMSConfig:
    suppression_radius: float = 4.0   # px floor (occupancy min cell)
    scale_factor: float = 0.5         # radius = max(floor, f * joint scale)
    instance_threshold: float = 0.15
    keypoint_threshold: float = 0.15  # joints below are zeroed pre-scoring
    iterations: int = 0               # max rounds; 0 = run to convergence
    min_joints: int = 1
    dedup_fraction: float = 1.0       # whole-pose suppression (off at 1.0)
    seed_suppression: bool = True
    occupancy_reduction: float = 2.0  # reference Occupancy grid reduction
    occupancy_min_scale: float = 4.0  # reference Occupancy minimum radius


def pose_scores(joint_v: torch.Tensor,
                score_weights: torch.Tensor) -> torch.Tensor:
    """Weighted sorted-descending pose score: (B, P, K), (K,) -> (B, P)."""
    v_sorted = torch.sort(joint_v, dim=-1, descending=True).values
    w = score_weights / torch.clamp(score_weights.sum(), min=1e-8)
    return v_sorted @ w


def _grid_hw(image_hw, red: float):
    return (int(np.ceil(image_hw[0] / red)) + 1,
            int(np.ceil(image_hw[1] / red)) + 1)


def _claim_boxes(cx, cy, cs, *, gh: int, gw: int, config: NMSConfig):
    """Occupancy squares of claimant joints, quantized as the oracle's
    ``Occupancy.set``: (x0, x1, y0, y1) grid cells."""
    red = config.occupancy_reduction
    r = torch.clamp(cs, min=config.occupancy_min_scale) / red
    xg = cx / red
    yg = cy / red
    return (torch.clamp(torch.round(xg - r), 0, gw - 1),
            torch.clamp(torch.round(xg + r), 0, gw - 1),
            torch.clamp(torch.round(yg - r), 0, gh - 1),
            torch.clamp(torch.round(yg + r), 0, gh - 1))


def seed_claim_suppression(poses: torch.Tensor, placed: torch.Tensor,
                           pose_valid: torch.Tensor, seed_f: torch.Tensor, *,
                           image_hw, config: NMSConfig,
                           rank: torch.Tensor = None,
                           active: torch.Tensor = None) -> torch.Tensor:
    """Exact seed-time occupancy suppression, computed after growth.

    ``alive(p) = valid(p) and no earlier alive pose q claimed field(p) at
    seed(p)``: a fixpoint over the strict seed-order DAG, solved by restart
    rounds (see the JAX version for the argument).

    poses (B, P, K, 4); placed (B, P, K); pose_valid (B, P); seed_f (B, P)
    int (out of range for invalid slots); rank (B, P) seed consumption
    rank per slot (default: slot index).  Returns (B, P) bool.
    """
    b, p, k = placed.shape
    red = config.occupancy_reduction
    gh, gw = _grid_hw(image_hw, red)
    sf = torch.clamp(seed_f, 0, k - 1)
    # seed positions: the seed joint never moves during growth
    sx = torch.gather(poses[..., 0], 2, sf[..., None])[..., 0]
    sy = torch.gather(poses[..., 1], 2, sf[..., None])[..., 0]
    qx = torch.clamp(torch.round(sx / red), 0, gw - 1)
    qy = torch.clamp(torch.round(sy / red), 0, gh - 1)

    # claimant geometry: [b, q, p] = pose q's joint of field sf[b, p]
    idx = sf[:, None, :].expand(b, p, p)
    cx = torch.gather(poses[..., 0], 2, idx)
    cy = torch.gather(poses[..., 1], 2, idx)
    cs = torch.gather(poses[..., 3], 2, idx)
    c_placed = torch.gather(placed, 2, idx)
    x0, x1, y0, y1 = _claim_boxes(cx, cy, cs, gh=gh, gw=gw, config=config)
    inside = ((x0 <= qx[:, None, :]) & (qx[:, None, :] <= x1)
              & (y0 <= qy[:, None, :]) & (qy[:, None, :] <= y1))
    order = (torch.arange(p, device=poses.device).expand(b, p)
             if rank is None else rank)
    earlier = order[:, :, None] < order[:, None, :]
    claims = (inside & c_placed & earlier
              & pose_valid[:, :, None] & pose_valid[:, None, :])  # (b, q, p)

    zeros = torch.zeros(b, dtype=torch.int64, device=poses.device)
    # the round cap P as a tensor: under ``torch.export`` this loop runs
    # inside the waves' loop, whose P is symbolic and cannot be captured
    cap = zeros + p

    def cond(state):
        i, _, converged = state
        return (i < cap) & ~converged

    def body(state, _):
        i, alive, _ = state
        new = pose_valid & ~torch.any(claims & alive[:, :, None], dim=1)
        return i + 1, new, torch.all(new == alive, dim=1)

    _, alive, _ = while_loop(cond, body, (zeros, pose_valid, zeros.bool()),
                             active=active)
    return alive


def points_claimed(poses: torch.Tensor, placed: torch.Tensor,
                   pose_alive: torch.Tensor, f: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor, *, image_hw,
                   config: NMSConfig) -> torch.Tensor:
    """Occupancy query of (f, x, y) points against alive grown poses.

    poses (B, P, K, 4); placed (B, P, K); pose_alive (B, P); f/x/y (B, N).
    Returns (B, N) bool.
    """
    b, p, k = placed.shape
    n = f.shape[1]
    red = config.occupancy_reduction
    gh, gw = _grid_hw(image_hw, red)
    fq = torch.clamp(f, 0, k - 1)
    qx = torch.clamp(torch.round(x / red), 0, gw - 1)        # (B, N)
    qy = torch.clamp(torch.round(y / red), 0, gh - 1)

    idx = fq[:, None, :].expand(b, p, n)
    cx = torch.gather(poses[..., 0], 2, idx)                 # (B, P, N)
    cy = torch.gather(poses[..., 1], 2, idx)
    cs = torch.gather(poses[..., 3], 2, idx)
    c_placed = torch.gather(placed, 2, idx)
    x0, x1, y0, y1 = _claim_boxes(cx, cy, cs, gh=gh, gw=gw, config=config)
    inside = ((x0 <= qx[:, None, :]) & (qx[:, None, :] <= x1)
              & (y0 <= qy[:, None, :]) & (qy[:, None, :] <= y1))
    return torch.any(inside & c_placed & pose_alive[:, :, None], dim=1)


def keypoint_nms(poses: torch.Tensor, pose_valid: torch.Tensor,
                 joint_scales: torch.Tensor, score_weights: torch.Tensor,
                 config: NMSConfig):
    """poses: (B, P, K, 4) [x, y, v, s]; joint_scales: (B, P, K) px.

    Returns (poses with suppressed joint v zeroed, scores (B, P),
    valid (B, P)).
    """
    b, p, k, _ = poses.shape
    x = poses[..., 0]
    y = poses[..., 1]
    zero = torch.zeros((), device=poses.device)
    v0 = torch.where(poses[..., 2] >= config.keypoint_threshold,
                     poses[..., 2], zero)
    v0 = torch.where(pose_valid[..., None], v0, zero)

    radius = torch.clamp(config.scale_factor * joint_scales,
                         min=config.suppression_radius)      # (B, P, K)
    # pairwise same-joint distances [b, p, q, k]; the reach is the
    # CLAIMANT's (q) radius
    dx = x[:, :, None, :] - x[:, None, :, :]
    dy = y[:, :, None, :] - y[:, None, :, :]
    d2 = dx * dx + dy * dy
    rr = radius[:, None, :, :]
    near = d2 < rr * rr

    n_before = torch.sum(v0 > 0.0, dim=-1)
    idx = torch.arange(p, device=poses.device)
    # fixed priority from the pre-NMS scores: q beats p lexicographically
    scores0 = pose_scores(v0, score_weights)
    sq = scores0[:, None, :]
    sp = scores0[:, :, None]
    beats = (sq > sp) | ((sq == sp) & (idx[None, None, :] < idx[None, :, None]))
    near_beats = near & beats[..., None]                     # (B, P, P, K)

    max_rounds = config.iterations if config.iterations else p

    def cond(state):
        i, _, converged = state
        return (i < max_rounds) & ~converged

    def body(state, _):
        i, v, _ = state
        claim = v > 0.0                                      # claimants
        suppressed = torch.any(near_beats & claim[:, None, :, :], dim=2)
        v_new = torch.where(suppressed, zero, v0)            # restart from v0
        return i + 1, v_new, torch.all((v_new == v).flatten(1), dim=1)

    zeros = torch.zeros(b, dtype=torch.int64, device=poses.device)
    _, v, _ = while_loop(cond, body, (zeros, v0, zeros.bool()))

    scores = pose_scores(v, score_weights)
    n_joints = torch.sum(v > 0.0, dim=-1)
    claimed_frac = 1.0 - n_joints / torch.clamp(n_before, min=1)
    valid = (pose_valid & (scores >= config.instance_threshold)
             & (n_joints >= config.min_joints)
             & (claimed_frac < config.dedup_fraction))
    out = poses.clone()
    out[..., 2] = v
    return out, scores, valid
