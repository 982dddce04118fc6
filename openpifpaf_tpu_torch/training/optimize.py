"""Optimizer and LR schedule factories.

Port of ``openpifpaf_tpu/training/optimize.py``: SGD (nesterov default) /
Adam / AMSGrad, LR warm-up, multi-step decay and optional cosine
annealing, with the same flags.  The JAX package chains optax transforms:
global-norm clip, value clip, ``add_decayed_weights``, then the optimizer,
with the schedule read at the update count before the step.  Here:

- ``clip_gradients`` clips in optax's form (no ``+1e-6`` in the norm, as
  ``torch.nn.utils.clip_grad_norm_`` has);
- the decay is the optimizers' ``weight_decay`` (added to the gradient
  before the moments, on every parameter, as ``add_decayed_weights``);
- SGD is ``torch.optim.SGD(nesterov=True, dampening=0)``, which equals
  ``optax.sgd(momentum, nesterov)``; Adam is ``torch.optim.Adam`` with
  optax's ``eps`` 1e-6; AMSGrad is ``AmsGrad`` below, because optax takes
  the max of the bias-corrected second moment where
  ``torch.optim.Adam(amsgrad=True)`` takes it of the raw one;
- the schedule is a ``LambdaLR`` of ``lr_at`` over a base lr of 1, stepped
  after ``optimizer.step()``, so that step k runs at ``lr_at(k)``.
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, List, Optional, Sequence

import torch


class AmsGrad(torch.optim.Optimizer):
    """optax's ``amsgrad``: ``m̂ / (sqrt(max_t v̂_t) + eps)`` with the max
    over the bias-corrected second moments v̂; ``weight_decay`` adds
    ``wd * p`` to the gradient first."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):  # pylint: disable=arguments-differ
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                if group['weight_decay']:
                    g = g.add(p, alpha=group['weight_decay'])
                state = self.state[p]
                if not state:
                    state['step'] = 0
                    for key in ('mu', 'nu', 'nu_max'):
                        state[key] = torch.zeros_like(p)
                state['step'] += 1
                t = state['step']
                mu, nu, nu_max = state['mu'], state['nu'], state['nu_max']
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                torch.maximum(nu_max, nu / (1 - b2 ** t), out=nu_max)
                p.addcdiv_(mu / (1 - b1 ** t), nu_max.sqrt().add_(group['eps']),
                           value=-group['lr'])


class OptimizeFactory:
    lr = 1e-3
    momentum = 0.95
    beta2 = 0.999
    adam_eps = 1e-6
    nesterov = True
    weight_decay = 0.0
    adam = False
    amsgrad = False

    lr_warm_up_start_epoch = 0
    lr_warm_up_epochs = 1
    lr_warm_up_factor = 1e-3
    lr_decay: List[float] = []
    lr_decay_factor = 0.1
    lr_decay_epochs = 1.0
    cosine = False

    clip_grad_norm = 0.0
    clip_grad_value = 0.0

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('optimizer')
        group.add_argument('--lr', type=float, default=cls.lr,
                           help='learning rate')
        group.add_argument('--momentum', type=float, default=cls.momentum,
                           help='SGD momentum, beta1 in Adam')
        group.add_argument('--beta2', type=float, default=cls.beta2)
        group.add_argument('--adam-eps', type=float, default=cls.adam_eps)
        group.add_argument('--no-nesterov', dest='nesterov',
                           default=True, action='store_false')
        group.add_argument('--weight-decay', type=float,
                           default=cls.weight_decay)
        group.add_argument('--adam', default=False, action='store_true')
        group.add_argument('--amsgrad', default=False, action='store_true')

        group = parser.add_argument_group('learning rate schedule')
        group.add_argument('--lr-warm-up-start-epoch', type=float,
                           default=cls.lr_warm_up_start_epoch)
        group.add_argument('--lr-warm-up-epochs', type=float,
                           default=cls.lr_warm_up_epochs)
        group.add_argument('--lr-warm-up-factor', type=float,
                           default=cls.lr_warm_up_factor)
        group.add_argument('--lr-decay', type=float, nargs='+',
                           default=cls.lr_decay,
                           help='epochs at which to decay the lr')
        group.add_argument('--lr-decay-factor', type=float,
                           default=cls.lr_decay_factor)
        group.add_argument('--lr-decay-epochs', type=float,
                           default=cls.lr_decay_epochs,
                           help='length of each decay ramp in epochs')
        group.add_argument('--cosine', default=cls.cosine, action='store_true',
                           help='cosine annealing after warm-up')
        group.add_argument('--clip-grad-norm', type=float,
                           default=cls.clip_grad_norm)
        group.add_argument('--clip-grad-value', type=float,
                           default=cls.clip_grad_value)

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        for key in ('lr', 'momentum', 'beta2', 'adam_eps', 'nesterov',
                    'weight_decay', 'adam', 'amsgrad',
                    'lr_warm_up_start_epoch', 'lr_warm_up_epochs',
                    'lr_warm_up_factor', 'lr_decay', 'lr_decay_factor',
                    'lr_decay_epochs', 'cosine', 'clip_grad_norm',
                    'clip_grad_value'):
            setattr(cls, key, getattr(args, key))

    # ------------------------------------------------------------------
    def schedule(self, *, steps_per_epoch: int,
                 total_epochs: Optional[int] = None) -> Callable[[int], float]:
        """The per-step LR schedule (warm-up + multistep or cosine)."""
        warm_start = int(self.lr_warm_up_start_epoch * steps_per_epoch)
        warm_steps = max(1, int(self.lr_warm_up_epochs * steps_per_epoch))

        def clip01(v):
            return min(1.0, max(0.0, v))

        def lr_at(step: int) -> float:
            lam = clip01((step - warm_start) / warm_steps)
            # exponential ramp from warm_up_factor to 1 (reference ramp)
            warm = self.lr_warm_up_factor ** (1.0 - lam)
            decay = 1.0
            for decay_epoch in self.lr_decay:
                d_start = decay_epoch * steps_per_epoch
                d_len = max(1.0, self.lr_decay_epochs * steps_per_epoch)
                decay *= self.lr_decay_factor ** clip01((step - d_start) / d_len)
            if self.cosine and total_epochs:
                total = total_epochs * steps_per_epoch
                prog = clip01((step - warm_start - warm_steps)
                              / max(1, total - warm_start - warm_steps))
                decay *= 0.5 * (1.0 + math.cos(math.pi * prog))
            return self.lr * warm * decay

        return lr_at

    def optimizer(self, params: Sequence[torch.Tensor],
                  schedule: Callable[[int], float], start_step: int = 0):
        """(optimizer, LambdaLR) over ``params``; the first step runs at
        ``schedule(start_step)``."""
        params = list(params)
        wd = self.weight_decay
        if self.amsgrad:
            opt = AmsGrad(params, lr=1.0, betas=(self.momentum, self.beta2),
                          eps=self.adam_eps, weight_decay=wd)
        elif self.adam:
            opt = torch.optim.Adam(params, lr=1.0,
                                   betas=(self.momentum, self.beta2),
                                   eps=self.adam_eps, weight_decay=wd)
        else:
            # optax's trace with momentum 0 is the identity, nesterov or not
            opt = torch.optim.SGD(params, lr=1.0, momentum=self.momentum,
                                  dampening=0.0, weight_decay=wd,
                                  nesterov=self.nesterov and self.momentum > 0)
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda k: schedule(k + start_step))
        return opt, scheduler

    def clip_gradients(self, params: Sequence[torch.Tensor]) -> None:
        """optax's ``clip_by_global_norm`` then ``clip``, in place."""
        grads = [p.grad for p in params if p.grad is not None]
        if self.clip_grad_norm > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_grad_norm, 1.0,
                                self.clip_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        if self.clip_grad_value > 0:
            torch._foreach_clamp_min_(grads, -self.clip_grad_value)
            torch._foreach_clamp_max_(grads, self.clip_grad_value)
