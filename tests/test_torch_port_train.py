"""The port's training path against the JAX trainer: optimizer steps, batch
norm statistics, EMA, the schedule, checkpoints and the train CLI.

- Two train steps of the port's ``Trainer`` on a narrow ShuffleNetV2K at
  65 px (weights carried by ``from_jax_variables``) against two of the JAX
  ``Trainer._train_step`` on the same batch, f32: the parameter change
  within 1e-4 of its largest value per parameter (plus 2 ulps of the
  parameter, the rounding of the parameters it is read off), the BatchNorm running
  statistics within 1e-5 relative (flax's momentum 0.9 with the biased
  variance: ``nn.BatchNorm2d``'s defaults miss by n / (n - 1), 2% at stage
  4 here) and the EMA change as the parameter change.  Each optimizer runs
  with one of the clips and weight decay.
- ``lr_at`` against the JAX schedule within 1e-6 relative.

The CLI and the checkpoint round trip are in ``test_torch_port_train_cli.py``
(each file stays under a minute alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import losses as jax_losses
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.training import OptimizeFactory as JaxOptimizeFactory
from openpifpaf_tpu.training import Trainer as JaxTrainer
from openpifpaf_tpu_torch import losses, models
from openpifpaf_tpu_torch.training import OptimizeFactory, Trainer

from test_torch_port_losses import toykp_batch
from test_torch_port_models import flax_narrow, port_narrow

STEPS_PER_EPOCH = 2
F32_EPS = float(np.finfo(np.float32).eps)

# Adam's update m / (sqrt(v) + eps) turns an O(eps) gradient into an
# O(lr) change, so the rounding of gradients near 0 shows at eps 1e-6; the
# Adam cases take eps 1e-3 (test_adam_eps_default checks the 1e-6 default)
OPTIMIZERS = {
    'sgd_nesterov_clip_norm': dict(lr=0.05, momentum=0.9, clip_grad_norm=0.5,
                                   weight_decay=1e-3),
    'adam_clip_value_fix_bn': dict(adam=True, lr=1e-3, momentum=0.9,
                                   adam_eps=1e-3, clip_grad_value=0.01,
                                   weight_decay=1e-3, fix_batch_norm=True),
    'amsgrad_clip_both': dict(amsgrad=True, lr=1e-3, momentum=0.8,
                              adam_eps=1e-3, clip_grad_norm=0.2,
                              clip_grad_value=0.02, weight_decay=1e-4),
}


def configured(factory, settings):
    factory.lr_warm_up_factor = 0.1
    factory.lr_warm_up_epochs = 1
    for key, value in settings.items():
        if key != 'fix_batch_norm':
            setattr(factory, key, value)
    return factory


def jax_two_steps(settings, images, targets):
    module, variables, metas = flax_narrow()
    model = jax_models.Model(module, metas, base_stride=16,
                             basenet_name='shufflenetv2k16',
                             variables=jax.tree.map(jnp.copy, variables))
    # the canonical training graph, the one the port runs (the fused plan
    # has the same gradients, test_fused_shufflenet.py::TestTrainPlan, and
    # compiles slower)
    model.fused_train = False
    trainer = JaxTrainer(model, jax_losses.Factory().factory(metas),
                         configured(JaxOptimizeFactory(), settings),
                         '/dev/null', ema_decay=0.9,
                         fix_batch_norm=settings.get('fix_batch_norm', False))
    state = trainer.init_state(STEPS_PER_EPOCH)
    trainer._build_steps()  # pylint: disable=protected-access
    trainer.n_devices = 1   # one device: no SPMD partitioning to compile
    x = images.permute(0, 2, 3, 1).numpy()
    t = [{k: v.numpy() for k, v in d.items()} for d in targets]
    x, t = trainer._place(x, t)  # pylint: disable=protected-access
    totals = []
    for _ in range(2):
        state, total, _ = trainer._train_step(state, x, t)  # pylint: disable=protected-access
        totals.append(float(total))
    flat = jax_checkpoint.flatten_tree({
        'params': state.params, 'batch_stats': state.batch_stats})
    ema = jax_checkpoint.flatten_tree({'params': state.ema_params})
    return (totals, models.from_jax_variables(flat),
            models.from_jax_variables(ema))


@pytest.mark.parametrize('name', list(OPTIMIZERS))
def test_two_train_steps(name, tmp_path):
    settings = OPTIMIZERS[name]
    images, targets = toykp_batch(65)
    want_totals, want, want_ema = jax_two_steps(settings, images, targets)

    _, variables, _ = flax_narrow()
    model = port_narrow(jax_checkpoint.flatten_tree(variables))
    model.fused_train = False   # canonical against canonical, as JAX's
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    trainer = Trainer(model, losses.Factory().factory(model.head_metas),
                      configured(OptimizeFactory(), settings),
                      str(tmp_path / 'model'))
    trainer.ema_decay = 0.9
    trainer.fix_batch_norm = settings.get('fix_batch_norm', False)
    trainer.setup(STEPS_PER_EPOCH)
    totals = [float(trainer.train_step(images, targets)[0])
              for _ in range(2)]
    np.testing.assert_allclose(totals, want_totals, rtol=1e-5)

    state = model.module.state_dict()
    ema = dict(zip([n for n, _ in model.module.named_parameters()],
                   trainer.ema))
    for key, value in want.items():
        if key.endswith(('running_mean', 'running_var')):
            scale = max(1.0, float(value.abs().max()))
            assert float((state[key] - value).abs().max()) <= 1e-5 * scale, key
            if trainer.fix_batch_norm:
                assert torch.equal(state[key], before[key]), key
            continue
        if key.endswith('num_batches_tracked'):
            continue
        for got, ref in ((state[key], value), (ema[key], want_ema[key])):
            delta, want_delta = got - before[key], ref - before[key]
            scale = float(want_delta.abs().max())
            assert scale > 0, key
            # the change is read off parameters rounded to f32
            ulps = 2 * F32_EPS * float(before[key].abs().max())
            assert float((delta - want_delta).abs().max()) <= \
                1e-4 * scale + ulps, key


def test_adam_eps_default():
    assert OptimizeFactory.adam_eps == JaxOptimizeFactory.adam_eps == 1e-6
    factory = OptimizeFactory()
    for flag in ('adam', 'amsgrad'):
        setattr(factory, flag, True)
        opt, _ = factory.optimizer([torch.zeros(3, requires_grad=True)],
                                   factory.schedule(steps_per_epoch=1))
        assert opt.param_groups[0]['eps'] == 1e-6


def test_trained_weights_are_served():
    """After a step the fused inference plan folds the new weights: the
    served forward equals the canonical graph's."""
    _, variables, _ = flax_narrow()
    model = port_narrow(jax_checkpoint.flatten_tree(variables))
    images, targets = toykp_batch(65)
    model(images)                        # folds the plan
    trainer = Trainer(model, losses.Factory().factory(model.head_metas),
                      configured(OptimizeFactory(), dict(lr=0.5)), '/dev/null')
    trainer.setup(STEPS_PER_EPOCH)
    trainer.train_step(images, targets)
    for fast, canonical in zip(model(images), model.apply(images)):
        assert float((fast - canonical).abs().max()) <= 1e-4


@pytest.mark.parametrize('config', [
    dict(lr_decay=[1.0, 2.5], lr_decay_epochs=0.5),
    dict(cosine=True, lr_warm_up_start_epoch=0.5, lr_warm_up_factor=0.01),
    dict(lr_decay=[2.0], cosine=True, lr_warm_up_epochs=0.25)],
    ids=['multistep', 'cosine', 'both'])
def test_schedule(config):
    """``lr_at`` at 12 steps across warm-up, decay and cosine."""
    ours, theirs = OptimizeFactory(), JaxOptimizeFactory()
    for f in (ours, theirs):
        f.lr = 0.03
        for key, value in config.items():
            setattr(f, key, value)
    steps = [0, 1, 2, 3, 4, 5, 6, 8, 10, 13, 15, 17]
    got = [ours.schedule(steps_per_epoch=4, total_epochs=4)(s) for s in steps]
    want = [float(theirs.schedule(steps_per_epoch=4, total_epochs=4)(s))
            for s in steps]
    # 1e-6 relative, or 1e-6 of lr where the cosine's 1 + cos cancels in
    # the JAX package's f32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 0.03)
    assert len(set(np.round(got, 12))) > 6
