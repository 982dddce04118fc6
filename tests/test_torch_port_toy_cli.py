"""The port's train and eval CLIs on the data modules that render their own
data beside toykp: ``toywb`` (133 keypoints), ``toycrowd`` and toykp with
``--toykp-with-dense`` (three heads, decoded with ``--dense-connections``).

Each trains one epoch on the CPU as a subprocess (sn2k16 at 65 px, two
images); the checkpoint has the data module's heads, loads into the JAX
``models.Factory(checkpoint=...)`` with the same fields within 1e-5 (f32,
both canonical graphs), and saved again by the JAX package loads back into
the port with the same weights.  The eval CLI then scores it (the stats
json's keys and the metric's ten labels).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import models

from test_torch_port_train_cli import run_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS_KEYS = ['n_images', 'total_time', 'nn_time', 'decoder_time',
              'images_per_second', 'stats', 'text_labels']

# dataset: (train flags, eval flags, head names)
CASES = {
    'toywb': (['--dataset=toywb', '--toywb-n-images=2',
               '--toywb-image-size=65'],
              ['--dataset=toywb', '--toywb-image-size=65'],
              ['cif', 'caf'], 133),
    'toycrowd': (['--dataset=toycrowd', '--toycrowd-n-images=2',
                  '--toycrowd-image-size=65'],
                 ['--dataset=toycrowd', '--toycrowd-image-size=65'],
                 ['cif', 'caf'], 17),
    'toykp-with-dense': (['--dataset=toykp', '--toykp-with-dense',
                          '--toykp-n-images=2', '--toykp-image-size=65'],
                         ['--dataset=toykp', '--toykp-with-dense',
                          '--toykp-image-size=65', '--dense-connections'],
                         ['cif', 'caf', 'caf25'], 17),
}


def run_eval(args):
    return subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.eval', '--device=cpu',
         '--batch-size=4', '--no-bf16'] + args,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1'),
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize('name', list(CASES))
def test_train_and_eval_cli(name, tmp_path):
    train_args, eval_args, heads, n_keypoints = CASES[name]
    out = str(tmp_path / 'model')
    result = run_cli(['--device=cpu', '--basenet=shufflenetv2k16',
                      '--batch-size=2', '--no-bf16', '--epochs=1',
                      '--output', out] + train_args)
    assert result.returncode == 0, result.stderr[-3000:]

    model = models.factory(checkpoint=out + '.npz', device='cpu', bf16=False)
    assert [m.name for m in model.head_metas] == heads
    assert model.head_metas[0].n_fields == n_keypoints
    jax_model = jax_models.Factory(checkpoint=out + '.npz', bf16=False) \
        .factory()
    x = np.random.default_rng(0).normal(size=(1, 33, 33, 3)).astype(np.float32)
    want = jax_model.module.apply(jax_model.variables, x, train=False)
    got = model.apply(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert len(want) == len(got) == len(heads)
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w) - g.numpy()).max() <= 1e-5
    back = str(tmp_path / 'back.npz')
    jax_checkpoint.save(back, variables=jax_model.variables,
                        head_metas=jax_model.head_metas,
                        basenet_name=jax_model.basenet_name,
                        base_stride=jax_model.base_stride, epoch=1)
    again = models.factory(checkpoint=back, device='cpu', bf16=False)
    for key, value in model.module.state_dict().items():
        assert torch.equal(again.module.state_dict()[key], value), key

    proc = run_eval([f'--checkpoint={out}.npz', '-o', out] + eval_args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    assert list(stats) == STATS_KEYS
    assert stats['text_labels'][:3] == ['AP', 'AP0.5', 'AP0.75']
    assert len(stats['stats']) == 10
    assert all(-1.0 <= v <= 1.0 for v in stats['stats'])
