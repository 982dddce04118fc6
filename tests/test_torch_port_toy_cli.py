"""The port's train and eval CLIs on the data modules that render their own
data beside toykp: ``toywb`` (133 keypoints), ``toycrowd`` and toykp with
``--toykp-with-dense`` (three heads, decoded with ``--dense-connections``).

Each trains one epoch on the CPU (sn2k16 at 65 px, two images), and the
eval CLI then scores its checkpoint (the stats json's keys and the
metric's ten labels): both CLIs in one subprocess per data module, the
three subprocesses side by side.  The checkpoint has the data module's
heads, loads into the JAX ``models.Factory(checkpoint=...)`` with the
same fields within 1e-5 (f32, both canonical graphs), and saved again by
the JAX package loads back into the port with the same weights.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import models

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


TRAIN_FLAGS = ['--device=cpu', '--basenet=shufflenetv2k16', '--batch-size=2',
               '--no-bf16', '--epochs=1']
EVAL_FLAGS = ['--device=cpu', '--batch-size=4', '--no-bf16']
# ``train.main`` then ``eval.main`` in one fresh interpreter, each exiting
# on a non-zero status
CLIS = """
import json, sys
from openpifpaf_tpu_torch import eval as eval_cli, train
train_args, eval_args = json.loads(sys.argv[1])
if train.main(train_args) != 0:
    sys.exit('train exited non-zero')
sys.exit(eval_cli.main(eval_args))
"""


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """Per case the output basename and the finished subprocess of its
    train and eval CLIs; the cases run side by side."""
    procs = {}
    for name, (train_args, eval_args, _, _) in CASES.items():
        out = str(tmp_path_factory.mktemp(name) / 'model')
        argv = [TRAIN_FLAGS + ['--output', out] + train_args,
                EVAL_FLAGS + [f'--checkpoint={out}.npz', '-o', out]
                + eval_args]
        procs[name] = out, subprocess.Popen(
            [sys.executable, '-c', CLIS, json.dumps(argv)], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1'),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = {}
    try:
        for name, (out, proc) in procs.items():
            _, err = proc.communicate(timeout=300)
            runs[name] = out, proc.returncode, err
    finally:
        for _, proc in procs.values():
            proc.kill()
    return runs


@pytest.mark.parametrize('name', list(CASES))
def test_train_and_eval_cli(name, cli_runs, tmp_path):
    _, _, heads, n_keypoints = CASES[name]
    out, returncode, err = cli_runs[name]
    assert returncode == 0, err[-3000:]

    model = models.factory(checkpoint=out + '.npz', device='cpu', bf16=False)
    assert [m.name for m in model.head_metas] == heads
    assert model.head_metas[0].n_fields == n_keypoints
    jax_model = jax_models.Factory(checkpoint=out + '.npz', bf16=False) \
        .factory()
    x = np.random.default_rng(0).normal(size=(1, 33, 33, 3)).astype(np.float32)
    want = jax.jit(functools.partial(jax_model.module.apply, train=False))(
        jax_model.variables, x)
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

    with open(out + '.stats.json') as f:
        stats = json.load(f)
    assert list(stats) == STATS_KEYS
    assert stats['text_labels'][:3] == ['AP', 'AP0.5', 'AP0.75']
    assert len(stats['stats']) == 10
    assert all(-1.0 <= v <= 1.0 for v in stats['stats'])
