"""The port's drift CLIs (``drift_report.py``, ``trained_drift.py``)
against the JAX repository's ``tools/drift_report.py`` and
``tools/trained_drift.py``, on the CPU.

- ``drift_report.main`` at 3 scenes: the same table layout as JAX's report
  (headers, rows and their labels, the worst-10 table) with the same
  values, and the aggregate JSON within 1e-3 (pose counts equal).
- ``trained_drift.main`` on a narrow checkpoint written by the port and
  read by both packages (a narrow ShuffleNetV2K registered under a test
  name, the heads' confidence and scale biases shifted so that poses are
  found), on 2 images: the same JSON keys, equal pose counts and overflow
  counters, APs, F1 and mean OKS within 1e-3.

The JAX tools run in subprocesses started before the first test (eager
JAX, ~25 s for the trained drift), beside the port's runs in this process,
which imports no JAX.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from openpifpaf_tpu_torch import drift_report, models, trained_drift
from openpifpaf_tpu_torch.datasets import DataModule
from openpifpaf_tpu_torch.decoder import CifCaf, Decoder
from openpifpaf_tpu_torch.models import base, checkpoint, shufflenetv2k
from openpifpaf_tpu_torch.plugins.toykp import ToyKp, coco_head_metas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW_NAME = 'shufflenetv2k-narrow-test'
REPORT_SCENES = 3
TRAINED_IMAGES = 2
TOL = 1e-3
NARROW = ((1, 2, 1), (8, 16, 32, 64, 64))   # test_torch_port_models.NARROW


def class_settings(*classes):
    """(class, name, value) of the class attributes that the CLIs'
    ``configure`` set, as they are now."""
    return [(cls, name, value) for cls in classes
            for name, value in vars(cls).items()
            if not name.startswith('__') and not callable(value)
            and not isinstance(value, (classmethod, staticmethod, property))]


# the data module's and the decoder's configuration as this module is
# collected: before any test in this process runs a CLI in process, whose
# ``configure`` sets them (the JAX tool runs in a fresh interpreter)
COLLECTED = class_settings(ToyKp, DataModule, CifCaf, Decoder)

JAX_TOOL = """
import runpy, sys
from openpifpaf_tpu.models import base, shufflenetv2k
base.register_basenet(base.BaseNetworkSpec(
    {name!r}, shufflenetv2k._make(*{narrow!r}), stride=16, out_features=64))
tool = sys.argv[1]
sys.argv = [tool] + sys.argv[2:]
runpy.run_path(tool, run_name='__main__')
"""


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The CPU decode is many small ops: one intra-op thread for the whole
    module, the count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def narrow_checkpoint(path):
    """A narrow ShuffleNetV2K with toykp's CIF and CAF heads, weights
    seeded by torch, the heads' confidence biases raised by 2 and their
    scale biases set to 3 (cells detect, scales are a few cells): written
    by the port, read by both packages."""
    metas = coco_head_metas()
    for m in metas:
        m.base_stride = 16
    shell = models.Shell(models.ShuffleNetV2K(*NARROW),
                         [models.CompositeField4(m, 64) for m in metas])
    models.init_weights(shell, torch.Generator().manual_seed(11))
    with torch.no_grad():
        for head, meta in zip(shell.head_nets, metas):
            bias = head.conv.bias.view(meta.n_fields, meta.n_components)
            bias[:, 0] += 2.0
            bias[:, meta.n_components - meta.n_scales:] = 3.0
    checkpoint.save(path, variables=models.to_jax_variables(
        shell.state_dict()), head_metas=metas, basenet_name=NARROW_NAME,
        base_stride=16)


@pytest.fixture(scope='module', autouse=True)
def jax_tools(tmp_path_factory):
    """The JAX report at ``REPORT_SCENES`` scenes and JAX's trained drift
    on ``TRAINED_IMAGES`` images, started in subprocesses; the fixture
    yields the paths and the processes (``finish`` waits for one)."""
    tmp = tmp_path_factory.mktemp('drift_tools')
    checkpoint = str(tmp / 'narrow.npz')
    narrow_checkpoint(checkpoint)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.path.join(
        REPO, 'tests'), JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1',
        XLA_FLAGS='--xla_cpu_multi_thread_eigen=false '
                  'intra_op_parallelism_threads=1')
    code = JAX_TOOL.format(name=NARROW_NAME, narrow=NARROW)
    runs = {
        'report': [os.path.join(REPO, 'tools', 'drift_report.py'),
                   '--scenes', str(REPORT_SCENES), '--out',
                   str(tmp / 'jax.md')],
        'trained': [os.path.join(REPO, 'tools', 'trained_drift.py'),
                    '--checkpoint', checkpoint, '--n-images',
                    str(TRAINED_IMAGES)]}
    procs = {name: subprocess.Popen(
        [sys.executable, '-c', code, *args], cwd=str(tmp), env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, args in runs.items()}
    outputs = {}

    def finish(name):
        if name not in outputs:
            out, err = procs[name].communicate(timeout=600)
            assert procs[name].returncode == 0, err[-3000:]
            outputs[name] = out
        return outputs[name]

    try:
        yield dict(tmp=tmp, checkpoint=checkpoint, finish=finish)
    finally:
        for proc in procs.values():
            proc.kill()
            proc.communicate()


# ----------------------------------------------------------------- CLIs
def table_layout(text):
    """(line kind, first cell, cell count) per table line, the other lines
    as they are but the methodology and run lines."""
    layout = []
    for line in text.splitlines():
        if line.startswith('|'):
            cells = line.strip('|').split('|')
            layout.append(('row', cells[0].strip(), len(cells)))
        elif line.startswith('#') or line.startswith('- spec'):
            layout.append(('text', line))
    return layout


def test_drift_report_matches_jax(jax_tools, tmp_path, capsys):
    out = str(tmp_path / 'port.md')
    assert drift_report.main(['--scenes', str(REPORT_SCENES), '--out', out,
                              '--device', 'cpu']) == 0
    port_json = json.loads(capsys.readouterr().out.splitlines()[-1])
    jax_json = json.loads(jax_tools['finish']('report').splitlines()[-1])
    with open(out) as f:
        port_md = f.read()
    with open(jax_tools['tmp'] / 'jax.md') as f:
        jax_md = f.read()
    assert table_layout(port_md) == table_layout(jax_md)
    port_rows = [l for l in port_md.splitlines() if l.startswith('| ')]
    jax_rows = [l for l in jax_md.splitlines() if l.startswith('| ')]
    assert port_rows == jax_rows
    assert port_json.keys() == jax_json.keys()
    assert port_json['n_scenes'] == REPORT_SCENES
    for key in ('n_oracle', 'n_parallel', 'n_matched'):
        assert port_json[key] == jax_json[key]
    for key, value in jax_json.items():
        assert abs(port_json[key] - value) <= TOL, key


def test_trained_drift_matches_jax(jax_tools, monkeypatch, capsys):
    for cls, name, value in COLLECTED:
        monkeypatch.setattr(cls, name, value)
    monkeypatch.setitem(base.BASE_FACTORIES, NARROW_NAME,
                        base.BaseNetworkSpec(NARROW_NAME,
                                             shufflenetv2k._make(*NARROW),  # pylint: disable=protected-access
                                             stride=16, out_features=64))
    assert trained_drift.main(['--checkpoint', jax_tools['checkpoint'],
                               '--n-images', str(TRAINED_IMAGES),
                               '--device', 'cpu']) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    want = json.loads(jax_tools['finish']('trained').splitlines()[-1])
    assert list(got) == list(want)
    assert got['n_images'] == want['n_images'] == TRAINED_IMAGES
    for key in ('poses_parallel', 'poses_oracle', 'matched',
                'n_dropped_poses', 'n_dropped_caf', 'n_dropped_cif',
                'checkpoint', 'dataset', 'force_complete',
                'dense_connections', 'instance_threshold', 'seed_threshold',
                'keypoint_threshold'):
        assert got[key] == want[key], key
    assert got['poses_oracle'] > 0
    for key in ('AP_parallel', 'AP_oracle', 'AP_delta', 'detection_f1',
                'mean_oks'):
        assert abs(got[key] - want[key]) <= TOL, key
