"""The port's train CLI with ``--ddp`` in a gloo group of 2 processes on
the CPU, started as torchrun starts them (its ``env://`` variables):
each rank trains on its shard of every epoch, and only rank 0 writes the
log and the checkpoints."""

import json
import os
import subprocess
import sys

import numpy as np

from openpifpaf_tpu_torch import parallel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_cli(module, args, env):
    return subprocess.Popen(
        [sys.executable, '-m', f'openpifpaf_tpu_torch.{module}'] + args,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_train_cli_ddp_two_ranks(tmp_path):
    """Two ranks of ``train --ddp``: 8 images, 4 per rank, batch 2 per
    rank, so 2 steps an epoch; one log and one set of checkpoints."""
    out = str(tmp_path / 'model')
    port = parallel.mesh.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
                   RANK=str(rank), WORLD_SIZE='2', LOCAL_RANK=str(rank),
                   MASTER_ADDR='localhost', MASTER_PORT=str(port))
        procs.append(start_cli('train', [
            '--ddp', '--device=cpu', '--dataset=toykp',
            '--basenet=shufflenetv2k16', '--toykp-n-images=8',
            '--toykp-image-size=65', '--batch-size=2', '--epochs=1',
            '--no-bf16', '--log-interval=1', '-o', out], env))
    outputs = []
    for proc in procs:
        try:
            outputs.append(proc.communicate(timeout=300)[0])
        finally:
            proc.kill()
    for proc, output in zip(procs, outputs):
        assert proc.returncode == 0, output[-3000:]
    assert 'rank 1 of 2' in outputs[1]
    assert sorted(os.listdir(tmp_path)) == [
        'model.epoch001.npz', 'model.log', 'model.npz', 'model.train.npz']
    with open(out + '.log') as f:
        lines = [json.loads(l) for l in f]
    assert [(l['type'], l.get('batch')) for l in lines] == [
        ('train', 0), ('train', 1), ('train-epoch', None),
        ('val-epoch', None)]
    assert all(np.isfinite(l['loss']) for l in lines)
