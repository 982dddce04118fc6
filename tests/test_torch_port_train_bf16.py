"""The port's train steps in bf16 against the JAX trainer's.

``test_torch_port_train_default.py``'s two SGD steps in bf16 (the JAX
module's ``dtype``, the port's autocast), each package through the same
forward: the port's default (the canonical graph) against JAX's canonical
graph, and the port's plan against JAX's default (its plan).  The bounds
are the test's own, stated in ``BF16_BOUNDS`` beside the values measured
when they were set: the losses, the running statistics, and the
parameter change by relative L2 over all parameters and per parameter
that holds at least 1% of it.  bf16 rounds every product's inputs to 8
bits and the BatchNorm backward cancels heavily, so two correct bf16
steps part widely: JAX's own bf16 plan and bf16 canonical graph differ by
0.179 (global relative L2 of the change), and either differs from JAX's
f32 step by 0.24.  The port's f32 step must fail the bounds.

The port's bf16 plan step once moved with torch's CPU thread count: the
CPU's channels-last ``batch_norm`` splits each channel's sums across
threads, and the plan runs its BatchNorms channels-last.
``BatchNorm.batch_forward`` now hands the CPU kernel an NCHW-contiguous
tensor, and ``test_plan_steps_bf16`` holds the step at 1, 2, 4 and 8
threads.  The file runs on ``TORCH_THREADS`` threads whatever count an
earlier file in the worker left behind, and restores that count.
"""

import jax.numpy as jnp
import pytest
import torch

from test_torch_port_train_default import (  # noqa: F401  (fixture)
    batch, jax_default_steps, port_default_steps)

# measured when set (x86 CPU, torch 2.13), the port's step against JAX's
# bf16 step through the same forward -- losses, parameter change rel L2
# over all (at the worst parameter holding 1% of it), running statistics:
#   bf16, canonical: 3.5e-4, 0.185 (0.253), 2.4e-3
#   bf16, plan:      1.5e-4, 0.218 (0.286), 2.8e-3 (on 1, 2, 4 and 8
#                    threads alike)
#   f32, canonical:  1.7e-4, 0.237 (0.307), 3.8e-3
#   f32, plan:       1.1e-4, 0.244 (0.320), 3.6e-3
# `total` and `leaf` sit between the bf16 and the f32 readings, so a step
# that lost its autocast fails them; the losses cannot tell the two apart
BF16_BOUNDS = dict(loss=1e-3, total=0.22, leaf=0.3, stats=1e-2)
# the readings above were taken on this many threads, and read the same on
# 1, 2 and 4 (``tests/torch_port_bf16_threads.py``); before the NCHW
# BatchNorm the bf16 plan step read 0.203 (0.284) on 8 threads and 0.238
# (0.356) on 1
TORCH_THREADS = 8


@pytest.fixture(scope='module', autouse=True)
def pinned_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jax_bf16_steps(batch):
    """JAX's bf16 steps by ``fused_train``, each run once."""
    runs = {}

    def steps(fused_train):
        if fused_train not in runs:
            runs[fused_train] = jax_default_steps(jnp.bfloat16, *batch,
                                                  fused_train=fused_train)
        return runs[fused_train]
    return steps


def bf16_gaps(batch, jax_steps, fused_train, port_bf16=True):
    """Two SGD steps of the JAX trainer in bf16 through the plan
    (``fused_train``) or the canonical graph, and the port's through the
    same forward: the losses' relative gap, the parameter change's
    relative L2 over all parameters and at the worst parameter holding 1%
    of it, and the running statistics' gap over their scale."""
    images, targets = batch
    want_totals, want, _, variables = jax_steps(fused_train)
    totals, state, _, before = port_default_steps(
        variables, port_bf16, images, targets, fused_train=fused_train)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(totals, want_totals))
    deltas = {key: ((state[key] - before[key]).double(),
                    (value - before[key]).double())
              for key, value in want.items()
              if key.endswith(('weight', 'bias'))}
    den = sum(float((w ** 2).sum()) for _, w in deltas.values())
    num = worst = 0.0
    for key, (delta, want_delta) in deltas.items():
        d2 = float(((delta - want_delta) ** 2).sum())
        n2 = float((want_delta ** 2).sum())
        num += d2
        if n2 >= 1e-2 * den:
            worst = max(worst, (d2 / n2) ** 0.5)
    total = (num / den) ** 0.5
    stats = max(float((state[key] - value).abs().max())
                / max(1.0, float(value.abs().max()))
                for key, value in want.items()
                if key.endswith(('running_mean', 'running_var')))
    print(f'{"bf16" if port_bf16 else "f32"} step '
          f'({"plan" if fused_train else "canonical"}) against JAX bf16: '
          f'losses {loss_err:.3e}, change rel L2 {total:.4f} (worst '
          f'parameter {worst:.4f}), statistics {stats:.3e}')
    return dict(loss=loss_err, total=total, leaf=worst, stats=stats)


def within(gaps, bounds):
    return all(gaps[key] <= bounds[key] for key in bounds)


def test_default_steps_bf16(batch, jax_bf16_steps):
    """The port's default step (the canonical graph) against JAX's
    canonical graph."""
    gaps = bf16_gaps(batch, jax_bf16_steps, False)
    assert within(gaps, BF16_BOUNDS), gaps


@pytest.mark.parametrize('threads', [1, 2, 4, 8])
def test_plan_steps_bf16(batch, jax_bf16_steps, threads):
    """The port's plan against JAX's default step, its plan, on each of
    several torch CPU thread counts."""
    torch.set_num_threads(threads)
    try:
        gaps = bf16_gaps(batch, jax_bf16_steps, True)
    finally:
        torch.set_num_threads(TORCH_THREADS)
    assert within(gaps, BF16_BOUNDS), gaps


@pytest.mark.parametrize('fused_train', [False, True],
                         ids=['canonical', 'plan'])
def test_f32_step_fails_bf16_bounds(batch, jax_bf16_steps, fused_train):
    """The bounds tell a bf16 step from an f32 one: the port's step in f32
    lies outside them from JAX's bf16 step."""
    gaps = bf16_gaps(batch, jax_bf16_steps, fused_train,
                     port_bf16=False)
    assert not within(gaps, BF16_BOUNDS), gaps
