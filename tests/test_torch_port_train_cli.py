"""The port's train CLI and its checkpoints against the JAX package.

- The CLI trains one epoch and resumes for a second as a subprocess on the
  CPU (``tests/test_train.py:31-53``): the three checkpoint files, the
  json log with ``train``, ``train-epoch`` and ``val-epoch`` lines.
- Its checkpoint loads into the JAX ``models.Factory(checkpoint=...)`` and
  gives the same fields within 1e-5 (f32, both canonical graphs); saved
  again by the JAX package, it loads into the port with the same weights.
- Without ``--device`` and without CUDA the CLI raises; ``--ddp`` parses.
- Its json log through both packages' ``logs`` plots: the parsed series
  equal, the PNGs byte-equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openpifpaf_tpu import logs as jax_logs
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import logs, models, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.train'] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


TRAIN_ARGS = ['--device=cpu', '--dataset=toykp', '--basenet=shufflenetv2k16',
              '--batch-size=4', '--toykp-n-images=8', '--toykp-image-size=81',
              '--no-bf16', '--log-interval=1']


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """One epoch of the CLI, then a second by ``--resume``."""
    out = str(tmp_path_factory.mktemp('train') / 'model')
    first = run_cli(TRAIN_ARGS + ['--epochs=1', '--output', out])
    second = run_cli(TRAIN_ARGS + ['--epochs=2', '--output', out, '--resume'])
    return out, first, second


def test_cli_train_and_resume(trained):
    out, first, second = trained
    assert first.returncode == 0, first.stderr
    assert second.returncode == 0, second.stderr
    for suffix in ('.npz', '.epoch001.npz', '.epoch002.npz', '.train.npz'):
        assert os.path.exists(out + suffix), suffix
    with open(out + '.log') as f:
        lines = [json.loads(l) for l in f]
    train_lines = [l for l in lines if l['type'] == 'train']
    assert len(train_lines) == 4
    assert all(np.isfinite(l['loss']) for l in train_lines)
    assert [l['epoch'] for l in lines if l['type'] == 'train-epoch'] == [1, 2]
    assert [l['epoch'] for l in lines if l['type'] == 'val-epoch'] == [1, 2]
    # the schedule goes on at the restored step: warm-up spans epoch 1
    assert train_lines[0]['lr'] < train_lines[1]['lr'] < train_lines[2]['lr']
    header, flat = models.checkpoint.load(out + '.train.npz')
    assert header['epoch'] == 2
    assert {k.split('/')[0] for k in flat} == {'params', 'batch_stats', 'ema'}


def test_cli_refuses_unported_flags_and_defaults_to_the_card():
    """No flag of the JAX CLI is refused any more: ``--ddp`` parses, and
    without torchrun's variables it trains in one process (here it stops
    at the missing card)."""
    assert train.cli(['--basenet=shufflenetv2k16', '--ddp']).ddp
    result = run_cli(['--basenet=shufflenetv2k16', '--ddp'])
    assert result.returncode != 0 and 'not ported' not in result.stderr
    if torch.cuda.is_available():
        pytest.skip('checks the default device without CUDA')
    with pytest.raises(RuntimeError, match='CUDA'):
        train.main(['--basenet=shufflenetv2k16', '--output', '/dev/null/x'])


def test_checkpoint_round_trip(trained, tmp_path):
    """The CLI's checkpoint (the EMA weights) in the JAX package and in the
    port: the same fields within 1e-5; saved again by the JAX package, the
    port reads the same weights back."""
    out, first, _ = trained
    assert first.returncode == 0, first.stderr
    x = np.random.default_rng(0).normal(size=(1, 33, 33, 3)).astype(np.float32)
    jax_model = jax_models.Factory(checkpoint=out + '.npz', bf16=False) \
        .factory()
    assert jax_model.epoch == 2
    want = jax_model.module.apply(jax_model.variables, x, train=False)
    model = models.factory(checkpoint=out + '.npz', device='cpu', bf16=False)
    assert model.epoch == 2
    got = model.apply(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w) - g.numpy()).max() <= 1e-5

    back = str(tmp_path / 'back.npz')
    jax_checkpoint.save(back, variables=jax_model.variables,
                        head_metas=jax_model.head_metas,
                        basenet_name=jax_model.basenet_name,
                        base_stride=jax_model.base_stride, epoch=2)
    again = models.factory(checkpoint=back, device='cpu', bf16=False)
    for key, value in model.module.state_dict().items():
        assert torch.equal(again.module.state_dict()[key], value), key



def test_cli_log_plots_match_jax(trained, tmp_path):
    import matplotlib
    matplotlib.use('Agg')

    out, first, second = trained
    assert first.returncode == second.returncode == 0, second.stderr
    log = out + '.log'
    assert logs.Plots([log]).datas == jax_logs.Plots([log]).datas
    paths = [str(tmp_path / f'{name}.png') for name in ('jax', 'port')]
    assert jax_logs.main([log, '-o', paths[0]]) == 0
    assert logs.main([log, '-o', paths[1]]) == 0
    with open(paths[0], 'rb') as f_jax, open(paths[1], 'rb') as f_port:
        assert f_port.read() == f_jax.read()
