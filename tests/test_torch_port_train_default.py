"""The port's default train step against the JAX trainer's default step.

The JAX trainer's default is its folded-routing plan; the port's is the
canonical graph (``Model.fused_train`` off), and with ``fused_train`` on
the port's plan.  Both of the port's steps are held to JAX's default.
Two steps of SGD nesterov with a norm clip and weight decay on a narrow
ShuffleNetV2K (the pair plan) at 65 px, weights carried by
``from_jax_variables``:

f32 with ``test_torch_port_train.py``'s bounds: the losses within 1e-5
relative, per parameter the change within 1e-4 of its largest value plus
2 ulps, the EMA's change alike, the BatchNorm running statistics within
1e-5 relative.  ``test_torch_port_train_bf16.py`` holds the same steps in
bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpifpaf_tpu import losses as jax_losses
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.training import OptimizeFactory as JaxOptimizeFactory
from openpifpaf_tpu.training import Trainer as JaxTrainer
from openpifpaf_tpu_torch import losses, models
from openpifpaf_tpu_torch.training import OptimizeFactory, Trainer

from test_torch_port_losses import toykp_batch
from test_torch_port_models import flax_narrow, port_narrow
from test_torch_port_train import (F32_EPS, OPTIMIZERS, STEPS_PER_EPOCH,
                                   configured)

SETTINGS = OPTIMIZERS['sgd_nesterov_clip_norm']


def jax_default_steps(dtype, images, targets, fused_train=True):
    """Two steps of the JAX trainer: its default (the plan), or the
    canonical graph with ``fused_train=False``."""
    module, variables, metas = flax_narrow(dtype=dtype)
    model = jax_models.Model(module, metas, base_stride=16,
                             basenet_name='shufflenetv2k16',
                             variables=jax.tree.map(jnp.copy, variables))
    model.fused_train = fused_train
    trainer = JaxTrainer(model, jax_losses.Factory().factory(metas),
                         configured(JaxOptimizeFactory(), SETTINGS),
                         '/dev/null', ema_decay=0.9)
    state = trainer.init_state(STEPS_PER_EPOCH)
    trainer._build_steps()  # pylint: disable=protected-access
    trainer.n_devices = 1
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
    return (totals, models.from_jax_variables(flat),
            models.from_jax_variables(ema), variables)


def port_default_steps(variables, bf16, images, targets, fused_train=None):
    """Two steps of the port's trainer: its default (the canonical graph),
    or with ``fused_train`` set to True the plan."""
    model = port_narrow(jax_checkpoint.flatten_tree(variables), bf16=bf16)
    if fused_train is not None:
        model.fused_train = fused_train
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    trainer = Trainer(model, losses.Factory().factory(model.head_metas),
                      configured(OptimizeFactory(), SETTINGS), '/dev/null')
    assert trainer.uses_train_plan() == bool(fused_train)
    trainer.ema_decay = 0.9
    trainer.setup(STEPS_PER_EPOCH)
    totals = [float(trainer.train_step(images, targets)[0])
              for _ in range(2)]
    ema = dict(zip([n for n, _ in model.module.named_parameters()],
                   trainer.ema))
    return totals, model.module.state_dict(), ema, before


@pytest.fixture(scope='module')
def batch():
    return toykp_batch(65)


@pytest.fixture(scope='module')
def jax_f32_steps(batch):
    return jax_default_steps(jnp.float32, *batch)


def test_default_steps_f32(batch, jax_f32_steps):
    """The port's default step: the canonical graph."""
    hold_f32_steps(batch, jax_f32_steps, None)


def test_plan_steps_f32(batch, jax_f32_steps):
    """The port's plan (``fused_train`` on), as JAX's default step."""
    hold_f32_steps(batch, jax_f32_steps, True)


def hold_f32_steps(batch, jax_f32_steps, fused_train):
    images, targets = batch
    want_totals, want, want_ema, variables = jax_f32_steps
    totals, state, ema, before = port_default_steps(
        variables, False, images, targets, fused_train=fused_train)
    np.testing.assert_allclose(totals, want_totals, rtol=1e-5)
    for key, value in want.items():
        if key.endswith('num_batches_tracked'):
            continue
        if key.endswith(('running_mean', 'running_var')):
            scale = max(1.0, float(value.abs().max()))
            assert float((state[key] - value).abs().max()) <= 1e-5 * scale, \
                key
            continue
        for got, ref in ((state[key], value), (ema[key], want_ema[key])):
            delta, want_delta = got - before[key], ref - before[key]
            scale = float(want_delta.abs().max())
            assert scale > 0, key
            ulps = 2 * F32_EPS * float(before[key].abs().max())
            assert float((delta - want_delta).abs().max()) <= \
                1e-4 * scale + ulps, key
