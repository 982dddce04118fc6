"""The port's data-parallel training and eval against the JAX package.

Each multi-rank case runs a gloo group of fresh processes on the CPU
(``parallel.run_group``: the ``spawn`` start method, one thread per rank,
every wait bounded), whose bodies live in ``torch_port_dist.py``.

- ``--ddp``'s step: two SGD steps of the narrow ShuffleNetV2K at 65 px,
  the global batch of 4 toykp images split 2 + 2 over 2 ranks, held to the
  JAX trainer's default step on the global batch and to the port's
  one-process step with ``test_torch_port_train_default.py``'s f32 bounds;
  the same with unequal mask counts on the two ranks (the loss means are
  the global batch's).  Either step without its synchronized BatchNorm or
  with per-rank loss means fails those bounds.

``test_torch_port_ddp_cli.py`` holds ``train --ddp``,
``test_torch_port_dp_eval.py`` ``eval --dp-eval``.
"""

import concurrent.futures
import copy

import jax
import jax.numpy as jnp
import pytest
import torch

from openpifpaf_tpu import losses as jax_losses
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.training import OptimizeFactory as JaxOptimizeFactory
from openpifpaf_tpu.training import Trainer as JaxTrainer
from openpifpaf_tpu_torch import models, parallel

import torch_port_dist as dist_bodies
from test_torch_port_losses import toykp_batch
from test_torch_port_models import flax_narrow
from test_torch_port_train import F32_EPS, configured

GROUP_TIMEOUT = 240


def jax_steps(batches, module, variables, metas):
    """JAX's default step (the plan), f32, two steps on each global batch
    from the same weights: (losses, state dict, EMA) per batch."""
    model = jax_models.Model(module, metas, base_stride=16,
                             basenet_name='shufflenetv2k16',
                             variables=jax.tree.map(jnp.copy, variables))
    trainer = JaxTrainer(model, jax_losses.Factory().factory(metas),
                         configured(JaxOptimizeFactory(), dist_bodies.SGD),
                         '/dev/null', ema_decay=0.9)
    trainer.init_state(dist_bodies.STEPS_PER_EPOCH)
    trainer._build_steps()  # pylint: disable=protected-access
    trainer.n_devices = 1
    out = []
    for images, targets in batches:
        # the step donates its state: fresh copies for each batch
        model.variables = jax.tree.map(jnp.copy, variables)
        state = trainer.init_state(dist_bodies.STEPS_PER_EPOCH)
        x, t = trainer._place(  # pylint: disable=protected-access
            images.permute(0, 2, 3, 1).numpy(),
            [{k: v.numpy() for k, v in d.items()} for d in targets])
        totals = []
        for _ in range(2):
            state, total, _ = trainer._train_step(state, x, t)  # pylint: disable=protected-access
            totals.append(float(total))
        flat = jax_checkpoint.flatten_tree({
            'params': state.params, 'batch_stats': state.batch_stats})
        ema = jax_checkpoint.flatten_tree({'params': state.ema_params})
        out.append((totals, models.from_jax_variables(flat),
                    models.from_jax_variables(ema)))
    return out


def f32_gaps(got, want, before):
    """The worst excess over ``test_torch_port_train_default.py``'s f32
    bounds (<= 0 within them): the losses 1e-5 relative, the running
    statistics 1e-5 of their scale, per parameter the change (and the
    EMA's) 1e-4 of its largest value plus 2 ulps."""
    totals, state, ema = got
    want_totals, want_state, want_ema = want
    worst = max(abs(a - b) / abs(b) - 1e-5
                for a, b in zip(totals, want_totals))
    for key, value in want_state.items():
        if key.endswith('num_batches_tracked'):
            continue
        if key.endswith(('running_mean', 'running_var')):
            scale = max(1.0, float(value.abs().max()))
            worst = max(worst, float((state[key] - value).abs().max())
                        - 1e-5 * scale)
            continue
        for g, w in ((state[key], value), (ema[key], want_ema[key])):
            delta, want_delta = g - before[key], w - before[key]
            ulps = 2 * F32_EPS * float(before[key].abs().max())
            worst = max(worst, float((delta - want_delta).abs().max())
                        - 1e-4 * float(want_delta.abs().max()) - ulps)
    return worst


@pytest.fixture(scope='module')
def steps():
    """The global batches (4 toykp images at 65 px; then with masks that
    differ between the two halves), JAX's steps on them, the port's
    one-process steps and its 2-rank steps (also with each ablation)."""
    images, targets = toykp_batch(65, n=4)
    unequal = []
    for t in targets:
        t = {k: v.clone() for k, v in t.items()}
        t['conf_mask'][:2, :, :3] = False       # rank 0: fewer cells
        t['vec_mask'][0] = False
        t['scale_mask'][1, :, :, 1:] = False
        unequal.append(t)
    batches = [(images, targets), (images, unequal)]
    assert all(int(t['conf_mask'][:2].sum()) != int(t['conf_mask'][2:].sum())
               for t in unequal)
    module, variables, metas = flax_narrow()
    before = models.from_jax_variables(jax_checkpoint.flatten_tree(variables))
    runs = [(*batches[0], None), (*batches[1], None),
            (*batches[1], 'batch_norm'), (*batches[1], 'loss_means')]
    # the ranks run while JAX compiles; they get copies: starting a process
    # moves the tensors it is handed to shared memory, under JAX's reads
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        group = pool.submit(parallel.run_group, dist_bodies.sgd_steps, 2,
                            copy.deepcopy((before, runs)),
                            timeout=GROUP_TIMEOUT)
        want = jax_steps(batches, module, variables, metas)
        one_rank = dist_bodies.sgd_steps(
            'cpu', before, [(*batch, None) for batch in batches])
        ranks = group.result()
    two_ranks = {None: [r[:2] for r in ranks],
                 'batch_norm': [r[2] for r in ranks],
                 'loss_means': [r[3] for r in ranks]}
    return want, before, one_rank, two_ranks


@pytest.mark.parametrize('masks', ['equal', 'unequal'])
def test_two_rank_step_equals_global_batch(steps, masks):
    want, before, one_rank, two_ranks = steps
    i = ['equal', 'unequal'].index(masks)
    rank0, rank1 = (r[i] for r in two_ranks[None])
    assert f32_gaps(rank0, want[i], before) <= 0
    assert f32_gaps(rank0, one_rank[i], before) <= 0
    # every rank holds the same weights after the step
    assert rank1[0] == rank0[0]
    for key, value in rank0[1].items():
        assert torch.equal(rank1[1][key], value), key


@pytest.mark.parametrize('ablate', ['batch_norm', 'loss_means'])
def test_per_rank_statistics_fail_the_bounds(steps, ablate):
    """Per-rank BatchNorm statistics, or per-rank loss means (over the
    unequal masks), give another step: the bounds refuse it."""
    want, before, _, two_ranks = steps
    assert f32_gaps(two_ranks[ablate][0], want[1], before) > 0
