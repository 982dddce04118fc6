"""CompositeLoss: slice a head tensor into components and apply the losses.

Port of ``openpifpaf_tpu/losses/composite.py``: slices the head output
into confidence / vector / scale parts, masks by target validity (explicit
boolean masks, where the reference uses NaNs) and returns the
per-component losses (confidence, regression, scale), each normalized by
its count of valid cells; a head without vectors or scales gives 0 for
that component (``composite.py:77-98``).  Single-frame targets of a
tracking batch come as (B, 2, ...) frame pairs while the head output
interleaves the frames, (2B, ...): the pair axis is folded into the batch
(``composite.py:62-66``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from . import components
from .. import headmeta


@dataclasses.dataclass(frozen=True)
class CompositeLossConfig:
    bce: components.BceConfig = components.BceConfig()
    laplace: components.LaplaceConfig = components.LaplaceConfig()
    smooth_l1: components.SmoothL1Config = components.SmoothL1Config()
    scale: components.ScaleConfig = components.ScaleConfig()
    regression_loss: str = 'laplace'  # 'laplace' | 'smoothl1'


def _mean_where(values: torch.Tensor, mask: torch.Tensor,
                group=None) -> torch.Tensor:
    """The mean of ``values`` where ``mask``; with a ``group`` of more than
    one rank, over the global batch: the sum and the count summed over the
    group (an all-reduce that autograd differentiates), as JAX divides
    over its sharded global batch."""
    total = torch.sum(torch.where(mask, values, 0.0))
    count = mask.sum().to(values.dtype)
    if group is not None and dist.get_world_size(group) > 1:
        total, count = dist_nn.all_reduce(torch.stack([total, count]),
                                          group=group)
    return total / torch.clamp(count, min=1)


class CompositeLoss:
    """Loss for one composite-field head.

    ``__call__(field, target)`` with field (B, F, C, H, W) raw head output
    and target dict of tensors (see ``encoder``) returns a list of scalar
    losses ``[conf, reg, scale]``.
    """

    n_components = 3

    def __init__(self, meta: headmeta.Base,
                 config: CompositeLossConfig = CompositeLossConfig()):
        self.meta = meta
        self.config = config
        # the group whose global batch the means run over (``--ddp``)
        self.process_group = None

    @property
    def field_names(self) -> List[str]:
        prefix = f'{self.meta.dataset}.{self.meta.name}'
        return [f'{prefix}.c', f'{prefix}.vec', f'{prefix}.scales']

    def __call__(self, field: torch.Tensor, target: dict) -> List[torch.Tensor]:
        meta = self.meta
        nc, nv, ns = meta.n_confidences, meta.n_vectors, meta.n_scales
        field = field.float()

        if target['conf'].dim() == field.dim():
            # tracking: (B, 2, ...) frame-pair targets of an interleaved
            # (2B, ...) head output
            target = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                      for k, v in target.items()}

        conf_raw = field[:, :, 0] if nc == 1 else field[:, :, 0:nc]
        b, f, _, h, w = field.shape
        # (B, F, V, 2, H, W) -> (B, F, V, H, W, 2), targets alike
        vec_raw = field[:, :, nc:nc + 2 * nv].reshape(b, f, nv, 2, h, w) \
            .movedim(3, -1)
        spread_raw = field[:, :, nc + 2 * nv:nc + 3 * nv]
        scale_raw = field[:, :, nc + 3 * nv:nc + 3 * nv + ns]

        conf_l = components.focal_bce(conf_raw, target['conf'],
                                      self.config.bce)
        conf_loss = _mean_where(conf_l, target['conf_mask'],
                                self.process_group)

        reg_loss = scale_loss_ = field.new_zeros(())
        if nv > 0:
            vec_target = target['vec'].movedim(3, -1)
            if self.config.regression_loss == 'smoothl1':
                vec_l = components.smooth_l1_regression(
                    vec_raw, vec_target, self.config.smooth_l1)
            else:
                vec_l = components.laplace_regression(
                    vec_raw, spread_raw, vec_target, self.config.laplace)
            reg_loss = _mean_where(vec_l, target['vec_mask'],
                                   self.process_group)

        if ns > 0:
            scale_l = components.scale_loss(scale_raw, target['scale'],
                                            self.config.scale)
            scale_loss_ = _mean_where(scale_l, target['scale_mask'],
                                      self.process_group)
        return [conf_loss, reg_loss, scale_loss_]
