"""``--remat`` and ``--orbax`` of the port's trainer.

- A train step under ``--remat`` (the forward recomputed in the backward,
  matmul and convolution outputs kept) gives the loss, the gradients and
  the BatchNorm running statistics of the step without it, through the
  training plan, the canonical graph (the default) and the canonical
  graph with head dropout (whose draws the recomputation must replay); the statistics are updated once
  although every BatchNorm runs twice.  The val step alike.
- ``--orbax`` writes the full train state to ``<out>.orbax/epoch_NNN.pt``:
  it loads, its parameters equal ``.train.npz``'s raw parameters, and its
  optimizer and scheduler states restore a fresh optimizer.
- The train CLI takes ``--remat --orbax`` (one epoch in a subprocess).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import losses, models
from openpifpaf_tpu_torch.models.base import BatchNorm
from openpifpaf_tpu_torch.training import OptimizeFactory, Trainer

from test_torch_port_losses import toykp_batch
from test_torch_port_models import NARROW, coco_metas, flax_narrow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def narrow_model(dropout: float = 0.0, fused_train: bool = False):
    _, variables, _ = flax_narrow()
    metas = coco_metas()
    for m in metas:
        m.base_stride = 16
    shell = models.Shell(models.ShuffleNetV2K(*NARROW),
                         [models.CompositeField4(m, 64, dropout_rate=dropout)
                          for m in metas])
    shell.load_state_dict(models.from_jax_variables(
        jax_checkpoint.flatten_tree(variables)), strict=True)
    model = models.Model(shell, metas, base_stride=16,
                         device=torch.device('cpu'), bf16=False)
    model.fused_train = fused_train
    return model


def trainer_for(model, out='/dev/null', **settings):
    opt = OptimizeFactory()
    opt.lr = 0.05
    opt.momentum = 0.9
    trainer = Trainer(model, losses.Factory().factory(model.head_metas), opt,
                      out)
    for key, value in settings.items():
        setattr(trainer, key, value)
    trainer.setup(2)
    return trainer


def raw_state(path):
    """``.train.npz``'s raw parameters and statistics (not its EMA) by the
    port's names."""
    _, flat = models.checkpoint.load(path)
    return models.from_jax_variables({k: v for k, v in flat.items()
                                      if not k.startswith('ema/')})


def counting_batch_norms(module):
    """Count each BatchNorm's train-mode calls (``batch_forward``)."""
    counts = {}
    for name, layer in module.named_modules():
        if isinstance(layer, BatchNorm):
            def counted(x, channels=slice(None), _layer=layer, _name=name,
                        _call=layer.batch_forward):
                counts[_name] = counts.get(_name, 0) + 1
                return _call(x, channels)
            layer.batch_forward = counted
    return counts


@pytest.mark.parametrize('path', ['plan', 'canonical',
                                  'canonical with dropout'])
def test_remat_step_equals_the_step(path):
    images, targets = toykp_batch(65)
    runs = {}
    for remat in (False, True):
        model = narrow_model(dropout=0.2 if 'dropout' in path else 0.0,
                             fused_train=path == 'plan')
        trainer = trainer_for(model, remat=remat)
        assert trainer.uses_train_plan() == (path == 'plan')
        counts = counting_batch_norms(model.module)
        torch.manual_seed(7)
        totals = []
        for _ in range(2):
            totals.append(float(trainer.train_step(images, targets)[0]))
            grads = {n: p.grad.clone()
                     for n, p in model.module.named_parameters()}
        runs[remat] = (totals, grads, model.module.state_dict(), counts)
    (totals, grads, state, counts), (r_totals, r_grads, r_state, r_counts) = \
        runs[False], runs[True]
    assert r_totals == totals
    for name, grad in grads.items():
        assert torch.equal(r_grads[name], grad), name
    for key, value in state.items():
        assert torch.equal(r_state[key], value), key
    # every BatchNorm ran again in the recomputation: twice per step, with
    # the statistics (equal above) updated once
    assert set(r_counts) == set(counts) and len(counts) > 10
    assert all(r_counts[k] == 2 * counts[k] for k in counts)
    assert min(counts.values()) == 2


def test_remat_val_step():
    images, targets = toykp_batch(65)
    want = trainer_for(narrow_model()).val_step(images, targets)
    got = trainer_for(narrow_model(), remat=True).val_step(images, targets)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_orbax_full_state(tmp_path):
    images, targets = toykp_batch(65)
    model = narrow_model()
    out = str(tmp_path / 'model')
    trainer = trainer_for(model, out=out, orbax=True)
    trainer.log_sigmas = torch.nn.Parameter(torch.full((6,), 0.1))
    trainer.setup(2)
    for _ in range(2):
        trainer.train_step(images, targets)
    trainer.write_checkpoint(1)
    assert sorted(os.listdir(out + '.orbax')) == ['epoch_001.pt']

    state = torch.load(out + '.orbax/epoch_001.pt', weights_only=True)
    assert state['step'] == 2 and state['epoch'] == 1
    raw = raw_state(out + '.train.npz')
    assert set(state['params']) == {n for n, _ in
                                    model.module.named_parameters()}
    for name, value in state['params'].items():
        assert torch.equal(value, raw[name]), name
    for name, value in state['batch_stats'].items():
        assert torch.equal(value, raw[name]), name
    ema = dict(zip(state['params'], trainer.ema))
    assert all(torch.equal(state['ema'][n], ema[n]) for n in ema)
    assert torch.equal(state['log_sigmas'], trainer.log_sigmas.detach())
    # momentum buffers of every parameter and log_sigmas
    assert len(state['optimizer']['state']) == len(trainer.opt_params)

    fresh = trainer_for(narrow_model(), orbax=True)
    fresh.log_sigmas = torch.nn.Parameter(state['log_sigmas'].clone())
    fresh.setup(2)
    fresh.optimizer.load_state_dict(state['optimizer'])
    fresh.scheduler.load_state_dict(state['scheduler'])
    assert fresh.scheduler.last_epoch == trainer.scheduler.last_epoch
    for (k, want), got in zip(trainer.optimizer.state.items(),
                              fresh.optimizer.state.values()):
        assert torch.equal(got['momentum_buffer'], want['momentum_buffer'])
        del k


def test_cli_remat_orbax(tmp_path):
    out = str(tmp_path / 'model')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    result = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.train', '--device=cpu',
         '--dataset=toykp', '--basenet=shufflenetv2k16', '--batch-size=2',
         '--toykp-n-images=2', '--toykp-image-size=65', '--no-bf16',
         '--epochs=1', '--remat', '--orbax', '--output', out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    state = torch.load(out + '.orbax/epoch_001.pt', weights_only=True)
    raw = raw_state(out + '.train.npz')
    assert state['step'] == 1
    for name, value in state['params'].items():
        assert torch.equal(value, raw[name]), name
    assert np.isfinite([float(v.abs().sum())
                        for v in state['params'].values()]).all()
