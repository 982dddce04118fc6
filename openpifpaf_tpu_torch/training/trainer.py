"""Trainer: the training loop.

Port of ``openpifpaf_tpu/training/trainer.py``: per batch forward, loss,
backward, gradient clipping, optimizer step and an EMA of the parameters;
per epoch a val pass and the checkpoint files; json-lines log; SIGTERM
checkpoints at the next epoch boundary.

The train forward is autograd in train mode, bf16 through autocast with
f32 parameters when the model is ``bf16``, as the JAX
``Factory(bf16=True)`` trains.  By default it runs the canonical graph
(``Shell``).  The folded-routing training plan
(``fused_shufflenet.shell_apply_train``: the pair plan where the widths
allow it, the r3 plan otherwise) is taken under the JAX trainer's
conditions (``trainer.py:163-170``) once the model's ``fused_train`` is
set: ``fused_shufflenet.supports_train``, that is a batchnorm
ShuffleNetV2K without ``--cross-talk`` or ``--head-dropout``, and not
``--fix-batch-norm``.  ``fused_train`` is off by default, where JAX's is
on: on the card the plan's step is slower than the canonical graph's.
The val forward is the canonical graph in eval mode.  BatchNorm updates
its running statistics flax's way (``models/base.BatchNorm``).  The served
forward folds BatchNorm once (``Model.inference_plan``), so every step
calls ``Model.refold()``: a ``Predictor`` on the same model then serves the
trained weights.

``--remat`` (``trainer.py:179-184``) runs both forwards under
``torch.utils.checkpoint`` with a selective policy that keeps the outputs
of the matmuls and convolutions and recomputes the rest in the backward
(JAX's ``dots_with_no_batch_dims_saveable``).  The recomputation replays
dropout's draws (the checkpoint restores the generator) and leaves the
BatchNorm running statistics alone (``BatchNorm.update_stats``), so a step
under ``--remat`` gives the loss, gradients and statistics of one without.

With ``--ddp`` (a process group, ``parallel.initialize_distributed``)
each rank trains on its shard of the data (``DataModule
.distributed_sampler``), the BatchNorm statistics and the loss means run
over the global batch, and the gradients are averaged over the group
before the clip, so that every rank takes the step of JAX's sharded step
(``trainer.py:99-101,341-357``) on the global batch; EMA and the
optimizer run the same on every rank, and only rank 0 writes the log and
the checkpoints.

Checkpoints, in the JAX package's npz format (``models/checkpoint.py``):
``<out>.npz`` and ``<out>.epochNNN.npz`` hold the EMA parameters with the
current batch statistics; ``<out>.train.npz`` holds the raw parameters,
the EMA (``ema/...``) and the statistics, for ``--resume``.  With
``--orbax`` (the JAX flag's name, ``trainer.py:282-300``) each checkpoint
also writes the full train state to ``<out>.orbax/epoch_NNN.pt``
(``torch.save``, written to a temporary file and renamed): the step, the
raw parameters, the batch statistics, the EMA, the optimizer's state
(momentum, Adam moments), the scheduler's and ``log_sigmas``.  Like JAX's,
``--resume`` reads ``.train.npz`` only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import signal
import time
from typing import List

import numpy as np
import torch
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.utils import checkpoint as checkpoint_util

from .optimize import OptimizeFactory
from .. import debug_checks, parallel
from ..models import checkpoint as checkpoint_mod
from ..models import fused_shufflenet
from ..models.base import BatchNorm
from ..models.from_jax import from_jax_variables, to_jax_variables

LOG = logging.getLogger(__name__)

# the ops whose outputs ``--remat`` keeps: the products (JAX's policy keeps
# its dots without batch axes); everything else is recomputed
_REMAT_SAVED = frozenset((
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default, torch.ops.aten.convolution.default))


# the gradients' all-reduce under ``--ddp`` goes in buckets of this size
# (DDP's default bucket)
BUCKET_BYTES = 25 * 2 ** 20


def _remat_policy(ctx, op, *args, **kwargs):  # pylint: disable=unused-argument
    return (checkpoint_util.CheckpointPolicy.MUST_SAVE if op in _REMAT_SAVED
            else checkpoint_util.CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _frozen_statistics(module: nn.Module, inner):
    """``inner`` entered with every ``BatchNorm`` of ``module`` leaving its
    running statistics alone."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for layer in layers:
        layer.update_stats = False
    try:
        with inner:
            yield
    finally:
        for layer in layers:
            del layer.update_stats


class Trainer:
    epochs = 1
    ema_decay = 0.99          # reference --ema (update factor 0.01)
    checkpoint_interval = 1   # epochs between checkpoint files
    log_interval = 10         # batches between log lines
    val_interval = 1
    fix_batch_norm = False
    remat = False             # recompute the forward in the backward
    orbax = False             # also write the full train state

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('trainer')
        group.add_argument('--epochs', default=cls.epochs, type=int)
        group.add_argument('--ema', default=1.0 - cls.ema_decay, type=float,
                           help='EMA update factor (0: checkpoints hold the '
                                'raw parameters)')
        group.add_argument('--checkpoint-interval',
                           default=cls.checkpoint_interval, type=int)
        group.add_argument('--log-interval', default=cls.log_interval,
                           type=int)
        group.add_argument('--val-interval', default=cls.val_interval,
                           type=int)
        group.add_argument('--fix-batch-norm', default=cls.fix_batch_norm,
                           action='store_true',
                           help='freeze batch norm statistics')
        group.add_argument('--remat', default=cls.remat, action='store_true',
                           help='recompute the forward in the backward, '
                                'keeping the matmul and convolution outputs '
                                '(less activation memory, more compute)')
        group.add_argument('--orbax', default=cls.orbax, action='store_true',
                           help='also write the full train state (optimizer '
                                'and scheduler included) to '
                                '<output>.orbax/epoch_NNN.pt')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.epochs = args.epochs
        cls.ema_decay = 1.0 - args.ema
        cls.checkpoint_interval = args.checkpoint_interval
        cls.log_interval = args.log_interval
        cls.val_interval = args.val_interval
        cls.fix_batch_norm = args.fix_batch_norm
        cls.remat = args.remat
        cls.orbax = args.orbax

    # ------------------------------------------------------------------
    def __init__(self, model, loss_fn, optimize_factory: OptimizeFactory,
                 out: str, *, auto_tune_mtl: bool = False):
        self.model = model
        self.shell = model.module
        self.device = model.device
        self.loss_fn = loss_fn
        # data parallel (``--ddp``): the process group, if there is one
        self.group = parallel.data_group()
        self.is_main = parallel.rank(self.group) == 0
        if self.group is not None:
            self._join_group()
        self.optimize_factory = optimize_factory
        self.out = out
        self.step = 0
        self.params = list(self.shell.parameters())
        self.ema = [p.detach().clone() for p in self.params]
        # Kendall task-uncertainty weights, optimized with the parameters
        self.log_sigmas = (nn.Parameter(torch.zeros(
            len(loss_fn.field_names), device=self.device))
            if auto_tune_mtl else None)
        self.optimizer = self.scheduler = self.schedule = None
        self._log_file = None
        self._preempted = False

    def _join_group(self) -> None:
        """Rank 0's weights on every rank; the BatchNorm statistics and the
        loss means over the global batch.  With the gradients averaged
        over the group (``_average_gradients``) every rank then takes the
        step that JAX's sharded step takes on the global batch."""
        parallel.replicate(self.shell, self.group)
        self.model.refold()
        for m in self.shell.modules():
            if isinstance(m, BatchNorm):
                m.process_group = self.group
        for loss in getattr(self.loss_fn, 'losses', []):
            loss.process_group = self.group
        LOG.info('data parallel: rank %d of %d', parallel.rank(self.group),
                 parallel.world(self.group))

    def _average_gradients(self) -> None:
        """Every rank computes the global loss, so the sum of the ranks'
        gradients is the world size times the global gradient (each
        all-reduce's backward sums over the group): average them, in
        buckets of at most ``BUCKET_BYTES``, one all-reduce each."""
        world = parallel.world(self.group)
        bucket, size = [], 0
        for grad in [p.grad for p in self.opt_params] + [None]:
            if grad is not None and (not bucket or (
                    size + grad.numel() * grad.element_size() <= BUCKET_BYTES
                    and grad.dtype == bucket[0].dtype)):
                bucket.append(grad)
                size += grad.numel() * grad.element_size()
                continue
            if bucket:
                flat = parallel.all_reduce(_flatten_dense_tensors(bucket),
                                           self.group).div_(world)
                for g, reduced in zip(bucket, _unflatten_dense_tensors(
                        flat, bucket)):
                    g.copy_(reduced)
            bucket = [] if grad is None else [grad]
            size = 0 if grad is None else grad.numel() * grad.element_size()

    @property
    def opt_params(self) -> List[torch.Tensor]:
        extra = [self.log_sigmas] if self.log_sigmas is not None else []
        return self.params + extra

    def setup(self, steps_per_epoch: int) -> None:
        """Schedule and optimizer, continuing the schedule at ``step``."""
        self.schedule = self.optimize_factory.schedule(
            steps_per_epoch=steps_per_epoch, total_epochs=self.epochs)
        self.optimizer, self.scheduler = self.optimize_factory.optimizer(
            self.opt_params, self.schedule, start_step=self.step)

    def _install_preemption_handler(self) -> None:
        """SIGTERM -> finish the current epoch, checkpoint, exit cleanly."""
        def handler(signum, frame):  # pylint: disable=unused-argument
            LOG.warning('received signal %d: will checkpoint and stop at '
                        'the next epoch boundary', signum)
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:  # pragma: no cover - non-main thread
            pass

    # -- steps ----------------------------------------------------------
    def _to_device(self, images, targets):
        """The batch on the device; a ``None`` target (a head that this
        multi-dataset batch has no data for) stays ``None``."""
        images = images.to(self.device, torch.float32, non_blocking=True)
        targets = [None if t is None else
                   {k: v.to(self.device, non_blocking=True)
                    for k, v in t.items()} for t in targets]
        return images, targets

    def uses_train_plan(self) -> bool:
        """Whether the train forward takes the folded-routing plan."""
        return (getattr(self.model, 'fused_train', False)
                and not self.fix_batch_norm
                and fused_shufflenet.supports_train(self.shell))

    def _forward(self, images, train: bool = False):
        plan = train and self.uses_train_plan()

        def forward(x):
            with torch.autocast(self.device.type, dtype=torch.bfloat16,
                                enabled=self.model.bf16):
                if plan:
                    return fused_shufflenet.shell_apply_train(self.shell, x)
                return self.shell(x)

        if not self.remat:
            return forward(images)

        def contexts():
            saving, recomputing = \
                checkpoint_util.create_selective_checkpoint_contexts(
                    _remat_policy)
            return saving, _frozen_statistics(self.shell, recomputing)

        return checkpoint_util.checkpoint(forward, images, use_reentrant=False,
                                          context_fn=contexts)

    def train_step(self, images, targets):
        """One optimizer step; returns (total, components) as tensors."""
        images, targets = self._to_device(images, targets)
        self.shell.train()
        if self.fix_batch_norm:
            for m in self.shell.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        total, comps = self.loss_fn(self._forward(images, train=True),
                                    targets, log_sigmas=self.log_sigmas)
        debug_checks.check_finite(total, 'non-finite training loss')
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in self.opt_params:
            # a head without targets in this batch has zero gradients, as
            # in JAX, so weight decay and momentum still update it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.group is not None:
            self._average_gradients()
        self.optimize_factory.clip_gradients(self.opt_params)
        self.optimizer.step()
        self.scheduler.step()
        with torch.no_grad():
            # ema = d * ema + (1 - d) * p, over the parameters only
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, self.params,
                                alpha=1.0 - self.ema_decay)
        self.step += 1
        # served forwards (Model.apply, the folded plan) expect eval mode
        # and the new weights
        self.shell.eval()
        self.model.refold()
        return total.detach(), torch.stack(comps).detach()

    @torch.no_grad()
    def val_step(self, images, targets):
        images, targets = self._to_device(images, targets)
        total, comps = self.loss_fn(self._forward(images), targets,
                                    log_sigmas=self.log_sigmas)
        debug_checks.check_finite(total, 'non-finite validation loss')
        return total, torch.stack(comps)

    # -- logging --------------------------------------------------------
    def log_line(self, data: dict) -> None:
        """A json line in ``<out>.log``, on rank 0 only."""
        if not self.is_main:
            return
        if self._log_file is None:
            self._log_file = open(self.out + '.log', 'a')  # pylint: disable=consider-using-with
        self._log_file.write(json.dumps(data) + '\n')
        self._log_file.flush()

    def close(self) -> None:
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None

    # -- checkpointing --------------------------------------------------
    def served_params(self) -> List[torch.Tensor]:
        """The parameters the checkpoints serve: the EMA, or the raw
        parameters with ``--ema 0``."""
        return self.ema if self.ema_decay < 1.0 else self.params

    def _state_dict(self, params) -> dict:
        state = self.shell.state_dict()
        for (name, _), value in zip(self.shell.named_parameters(), params):
            state[name] = value
        return state

    def write_checkpoint(self, epoch: int) -> None:
        """The checkpoint files of ``epoch``, on rank 0 only (the ranks
        hold the same state)."""
        if not self.is_main:
            return
        served = to_jax_variables(self._state_dict(self.served_params()))
        kw = dict(head_metas=self.model.head_metas,
                  basenet_name=self.model.basenet_name,
                  base_stride=self.model.base_stride, epoch=epoch)
        name = f'{self.out}.epoch{epoch:03d}.npz'
        checkpoint_mod.save(name, variables=served, **kw)
        checkpoint_mod.save(self.out + '.npz', variables=served, **kw)
        # training copy (raw params and the EMA) for resume
        train_vars = to_jax_variables(self.shell.state_dict())
        ema = to_jax_variables(self._state_dict(self.ema))
        train_vars.update({'ema/' + k[len('params/'):]: v
                           for k, v in ema.items() if k.startswith('params/')})
        checkpoint_mod.save(self.out + '.train.npz', variables=train_vars, **kw)
        LOG.info('checkpoint written: %s', name)
        if self.orbax:
            self.write_train_state(epoch)

    def train_state(self, epoch: int) -> dict:
        """The full train state, as ``--orbax`` writes it (tensors on the
        CPU): parameters, EMA and ``log_sigmas`` as trained, the buffers
        (batch statistics), the optimizer's and the scheduler's states."""
        names = [name for name, _ in self.shell.named_parameters()]
        buffers = dict(self.shell.named_buffers())

        def on_cpu(tensors):
            return {k: v.detach().cpu() for k, v in tensors}

        optimizer = self.optimizer.state_dict()
        optimizer['state'] = {
            k: {n: v.cpu() if torch.is_tensor(v) else v
                for n, v in state.items()}
            for k, state in optimizer['state'].items()}
        return {
            'step': self.step, 'epoch': epoch,
            'params': on_cpu(zip(names, self.params)),
            'batch_stats': on_cpu(buffers.items()),
            'ema': on_cpu(zip(names, self.ema)),
            'optimizer': optimizer,
            'scheduler': self.scheduler.state_dict(),
            'log_sigmas': (None if self.log_sigmas is None
                           else self.log_sigmas.detach().cpu()),
        }

    def write_train_state(self, epoch: int) -> str:
        """``<out>.orbax/epoch_NNN.pt``, written to a temporary file and
        renamed, so that a reader never sees a partial file."""
        path = f'{self.out}.orbax/epoch_{epoch:03d}.pt'
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f'{path}.{os.getpid()}.tmp'
        torch.save(self.train_state(epoch), tmp)
        os.replace(tmp, path)
        LOG.info('train state written: %s', path)
        return path

    def load_train_checkpoint(self, path: str, steps_per_epoch: int) -> int:
        """Restores the parameters, the EMA, the batch statistics and the
        step from ``<out>.train.npz``; returns its epoch.  The optimizer
        state (momentum, Adam moments) is not restored, as in the JAX
        trainer: it starts anew, while the schedule goes on at the
        restored step."""
        header, flat = checkpoint_mod.load(path)
        model_vars = {k: v for k, v in flat.items() if not k.startswith('ema/')}
        self.shell.load_state_dict(from_jax_variables(model_vars), strict=True)
        ema = from_jax_variables({'params/' + k[len('ema/'):]: v
                                  for k, v in flat.items()
                                  if k.startswith('ema/')})
        with torch.no_grad():
            for (name, _), e in zip(self.shell.named_parameters(), self.ema):
                e.copy_(ema[name])
        self.model.refold()
        self.step = header['epoch'] * steps_per_epoch
        return header['epoch']

    # -- the loop -------------------------------------------------------
    def loop(self, train_loader, val_loader=None, *, start_epoch: int = 0):
        steps_per_epoch = len(train_loader)
        self.setup(steps_per_epoch)
        self._install_preemption_handler()
        try:
            for epoch in range(start_epoch, self.epochs):
                if self._preempted:
                    LOG.warning('preemption: checkpointing at epoch %d and '
                                'stopping', epoch)
                    self.write_checkpoint(epoch)
                    break
                self.train_epoch(train_loader, epoch, steps_per_epoch)
                if val_loader is not None and \
                        (epoch + 1) % self.val_interval == 0:
                    self.val_epoch(val_loader, epoch)
                if ((epoch + 1) % self.checkpoint_interval == 0
                        or epoch + 1 == self.epochs):
                    self.write_checkpoint(epoch + 1)
        finally:
            self.close()

    def train_epoch(self, loader, epoch: int, steps_per_epoch: int) -> None:
        epoch_start = time.perf_counter()
        last_log = epoch_start
        loss_acc = []
        for batch_i, (images, targets, _) in enumerate(loader):
            step = self.step
            total, comps = self.train_step(images, targets)
            if (batch_i % self.log_interval == 0
                    or batch_i + 1 == steps_per_epoch):
                total = float(total)
                now = time.perf_counter()
                self.log_line({
                    'type': 'train', 'epoch': epoch, 'batch': batch_i,
                    'n_batches': steps_per_epoch,
                    'time': round(now - last_log, 3),
                    'lr': float(self.schedule(step)),
                    'loss': round(total, 6),
                    'head_losses': [round(c, 6) for c in comps.tolist()],
                })
                last_log = now
                loss_acc.append(total)
                if not np.isfinite(total):
                    raise RuntimeError(f'loss is {total} at epoch {epoch} '
                                       f'batch {batch_i}')
        self.log_line({
            'type': 'train-epoch', 'epoch': epoch + 1,
            'loss': round(float(np.mean(loss_acc)), 6) if loss_acc else None,
            'time': round(time.perf_counter() - epoch_start, 1),
        })

    def val_epoch(self, loader, epoch: int) -> None:
        start = time.perf_counter()
        totals, comps_acc = [], []
        for images, targets, _ in loader:
            total, comps = self.val_step(images, targets)
            totals.append(float(total))
            comps_acc.append(comps.cpu().numpy())
        self.log_line({
            'type': 'val-epoch', 'epoch': epoch + 1,
            'loss': round(float(np.mean(totals)), 6) if totals else None,
            'head_losses': [round(float(c), 6)
                            for c in np.mean(comps_acc, axis=0)] if comps_acc
            else [],
            'time': round(time.perf_counter() - start, 1),
        })
