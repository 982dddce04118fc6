"""Loss components: focal BCE, Laplace regression NLL, log-scale L1.

Port of ``openpifpaf_tpu/losses/components.py``.  All functions act on raw
(pre-activation) head outputs and return per-element losses; masking and
normalization happen in the composite loss.  ``F.softplus`` returns ``x``
itself above 20 where ``jax.nn.softplus`` keeps the ``log1p(exp(-x))`` term
(below f32 resolution there).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BceConfig:
    focal_gamma: float = 1.0        # reference --focal-gamma default
    background_weight: float = 1.0  # weight of negative cells
    min_bce: float = 0.0            # soft threshold: ignore tiny losses
    clamp: float = 5.0              # logit clamp (background clamp analogue)


def focal_bce(logits: torch.Tensor, targets: torch.Tensor,
              config: BceConfig) -> torch.Tensor:
    """Per-cell focal binary cross-entropy on logits; targets in {0, 1}."""
    x = torch.clamp(logits, -config.clamp, config.clamp)
    # numerically stable bce-with-logits
    bce = torch.relu(x) - x * targets + torch.log1p(torch.exp(-x.abs()))
    if config.min_bce > 0.0:
        bce = torch.relu(bce - config.min_bce)
    if config.focal_gamma != 0.0:
        p = torch.sigmoid(x)
        pt = p * targets + (1.0 - p) * (1.0 - targets)
        bce = (1.0 - pt) ** config.focal_gamma * bce
    if config.background_weight != 1.0:
        bce = bce * torch.where(targets < 0.5, config.background_weight, 1.0)
    return bce


@dataclasses.dataclass(frozen=True)
class LaplaceConfig:
    b_min: float = 0.1   # lower bound on the predicted spread (cell units)
    norm_clip: float = 0.0  # optional clipping of the distance (0 = off)


def _norm(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-8)


def laplace_regression(vec_raw: torch.Tensor, spread_raw: torch.Tensor,
                       vec_target: torch.Tensor,
                       config: LaplaceConfig) -> torch.Tensor:
    """Laplace NLL for offset regression.

    vec_raw, vec_target: (..., 2); spread_raw: (...,)
    loss = |d| / b + log(2 b), with b = softplus(raw) + b_min.
    """
    b = F.softplus(spread_raw) + config.b_min
    norm = _norm(vec_raw - vec_target)
    if config.norm_clip > 0.0:
        norm = torch.clamp(norm, max=config.norm_clip)
    return norm / b + torch.log(2.0 * b)


@dataclasses.dataclass(frozen=True)
class SmoothL1Config:
    r_smooth: float = 0.0   # quadratic-to-linear transition radius (cells)


def smooth_l1_regression(vec_raw: torch.Tensor, vec_target: torch.Tensor,
                         config: SmoothL1Config) -> torch.Tensor:
    """Smooth-L1 (Huber) offset regression: quadratic below ``r_smooth``,
    linear above; r_smooth == 0 is plain L1."""
    norm = _norm(vec_raw - vec_target)
    r = config.r_smooth
    if r <= 0.0:
        return norm
    return torch.where(norm < r, 0.5 / r * norm ** 2, norm - 0.5 * r)


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    log_space: bool = True
    b: float = 1.0


def scale_loss(scale_raw: torch.Tensor, scale_target: torch.Tensor,
               config: ScaleConfig) -> torch.Tensor:
    """L1 between predicted (softplus) and target scales, in log space."""
    s = F.softplus(scale_raw) + 1e-4
    t = torch.clamp(scale_target, min=1e-4)
    if config.log_space:
        return (torch.log(s) - torch.log(t)).abs() / config.b
    return (s - t).abs() / config.b
