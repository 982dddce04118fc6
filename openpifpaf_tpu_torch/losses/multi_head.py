"""MultiHeadLoss: weighted sum over all heads' loss components.

Port of ``openpifpaf_tpu/losses/multi_head.py``: weighted sum with
``--lambdas``; with ``--auto-tune-mtl`` the trainer holds learnable
log-sigmas (an ``nn.Parameter``, Kendall et al. task-uncertainty
weighting) and passes them in.  A head whose target is ``None`` (a
multi-dataset batch from another data module) gives zero components.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .composite import CompositeLoss


class MultiHeadLoss:
    def __init__(self, losses: Sequence[CompositeLoss],
                 lambdas: Optional[Sequence[float]] = None):
        self.losses = list(losses)
        n = sum(l.n_components for l in self.losses)
        if lambdas is None:
            lambdas = [1.0] * n
        if len(lambdas) != n:
            raise ValueError(f'need {n} lambdas, got {len(lambdas)}')
        self.lambdas = list(lambdas)

    @property
    def field_names(self) -> List[str]:
        return [name for l in self.losses for name in l.field_names]

    def __call__(self, fields: Sequence[torch.Tensor],
                 targets: Sequence[dict],
                 log_sigmas: Optional[torch.Tensor] = None):
        """Returns (total_loss, component_losses list).

        ``log_sigmas``: optional (n_components,) learnable task-uncertainty
        parameters; when given, each component i contributes
        ``exp(-2 s_i) * l_i + s_i`` (Kendall MTL weighting).
        """
        comps = []
        for loss_fn, field, target in zip(self.losses, fields, targets):
            if target is None:
                # multi-dataset training: this batch carries no targets for
                # this head (datasets/multimodule.py pads with None)
                comps.extend([torch.zeros((), device=field.device)]
                             * loss_fn.n_components)
            else:
                comps.extend(loss_fn(field, target))
        weighted = [lam * c for lam, c in zip(self.lambdas, comps)]
        if log_sigmas is not None:
            weighted = [torch.exp(-2.0 * s) * wl + s
                        for s, wl in zip(log_sigmas, weighted)]
        return torch.sum(torch.stack(weighted)), comps
