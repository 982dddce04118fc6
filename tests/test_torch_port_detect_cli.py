"""The train and eval CLIs on the detection data: ``--dataset
toykp,cifar10`` trains one model with pose and detection heads, and
``--dataset cifar10`` scores a checkpoint with the COCO bbox metric.

Both CLIs run as subprocesses on the CPU (``--device cpu``, one thread,
as the other CLI tests run theirs), sn2k16 at full width on 65 px toykp
and 33 px cifar10 images.  Required: exit 0;
the log's nine head losses per step finite, the padded heads' exactly 0
(toykp batches have no cifdet target, cifar10 batches no cif and caf
targets); a checkpoint with the cif, caf and cifdet heads that the JAX
package loads; the eval stats json with the 12 bbox labels, finite
values, 16 images.
"""

import json
import os
import subprocess
import sys

import numpy as np

from openpifpaf_tpu.models import checkpoint as jax_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BBOX_LABELS = ['AP', 'AP0.5', 'AP0.75', 'APS', 'APM', 'APL', 'AR', 'AR0.5',
               'AR0.75', 'ARS', 'ARM', 'ARL']


def run_cli(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', f'openpifpaf_tpu_torch.{module}', *args],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_multidataset_train_and_cifar10_eval_cli(tmp_path):
    out = str(tmp_path / 'model')
    run_cli('train', [
        '--device=cpu', '--dataset=toykp,cifar10',
        '--basenet=shufflenetv2k16', '--toykp-image-size=65',
        '--toykp-n-images=4', '--toykp-no-augmentation',
        '--cifar10-n-synthetic=4', '--cifar10-root=' + str(tmp_path),
        '--batch-size=2', '--epochs=1', '--no-bf16', '--log-interval=1',
        '--output', out], tmp_path)
    with open(out + '.log') as f:
        lines = [json.loads(line) for line in f]
    train = [line['head_losses'] for line in lines
             if line['type'] == 'train']
    assert len(train) == 4
    for losses in train:
        assert len(losses) == 9 and np.isfinite(losses).all()
    # round robin: toykp, cifar10, toykp, cifar10
    for i, losses in enumerate(train):
        padded = losses[6:] if i % 2 == 0 else losses[:6]
        assert padded == [0.0] * len(padded)
        kept = losses[:2] if i % 2 == 0 else losses[6:8]
        assert min(kept) > 0
    header, _ = jax_checkpoint.load(out + '.npz')
    assert [(type(m).__name__, m.name) for m in header['head_metas']] == \
        [('Cif', 'cif'), ('Caf', 'caf'), ('CifDet', 'cifdet')]
    assert header['head_metas'][2].upsample_stride == 2

    proc = run_cli('eval', [
        '--device=cpu', '--dataset=cifar10', f'--checkpoint={out}.npz',
        '--cifar10-root=' + str(tmp_path), '--batch-size=8', '-o',
        str(tmp_path / 'cifar10'), '--cifdet-seed-threshold=0.1'], tmp_path)
    with open(tmp_path / 'cifar10.stats.json') as f:
        stats = json.load(f)
    assert stats['text_labels'] == BBOX_LABELS
    assert stats['n_images'] == 16
    assert all(np.isfinite(stats['stats']))
    assert all(-1.0 <= v <= 1.0 for v in stats['stats'])
    assert 'ARL' in proc.stdout and 'images/s' in proc.stdout
