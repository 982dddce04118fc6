"""The port's debug visualizers, decoder hooks, train flags and log plots
against the JAX package's, under matplotlib's Agg backend.

- Every visualizer's ``targets``/``predicted`` on the same arrays in both
  packages, following JAX's ``tests/test_visualizer.py``: with
  ``--save-all`` both write the same file names (``NNNN-<head>.jpeg``),
  byte for byte equal.
- The CifCaf hook: JAX's ``test_decoder_debug_hook`` fields with ``cif:0
  caf:0 cifhr:0 seeds`` through the port's single-image ``__call__`` and
  JAX's hook (``_debug_visualize``, the first thing JAX's ``__call__``
  does with the fields; its decode is JAX's own test's): the arrays each
  visualizer is handed agree (``cif_act`` and ``caf_act`` within 1e-6,
  the CifHr map within 1e-4 with bf16 profiles as the CPU decodes, the
  seeds within 1e-4), and each package saves 6 files.  The TCAF hook:
  the port's ``TrackingPose.__call__`` with ``tcaf:0`` hands the TCAF
  visualizer JAX's hook's array within 1e-6, 2 files each.
- With no index set, the hooks add no CifHr call and no host sync
  (``common.HOST_SYNCS``); with an index, one CifHr call and one sync per
  array read back.  Reference quirk: ``CifCaf.batch_fields``
  (``Predictor``'s path) has no hook.
- Log lines of the trainer's kinds (a line that is not json among them)
  through both packages' ``Plots`` and ``logs`` CLI: the parsed series
  are equal and the PNGs byte-equal (the port trainer's own log:
  ``test_torch_port_train_cli.py``).
- Without matplotlib, ``logs`` raises before it reads a log and writes
  nothing.
"""

import json
import os
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use('Agg')

from openpifpaf_tpu import decoder as jax_decoder  # noqa: E402
from openpifpaf_tpu import headmeta as jax_headmeta  # noqa: E402
from openpifpaf_tpu import logs as jax_logs  # noqa: E402
from openpifpaf_tpu import visualizer as jax_visualizer  # noqa: E402
from openpifpaf_tpu_torch import decoder, headmeta, logs, visualizer  # noqa: E402
from openpifpaf_tpu_torch.ops import cif_hr, common  # noqa: E402
from openpifpaf_tpu_torch.plugins.coco import constants  # noqa: E402

from test_decoder import build_fields, synthetic_pose  # noqa: E402
from test_torch_port_decode import metas as cifcaf_metas  # noqa: E402
from test_torch_port_tracking_decode import metas as tracking_metas  # noqa: E402
from test_torch_port_tracking_decode import pair_fields  # noqa: E402

HOOK_TOL = {'Cif': 1e-6, 'Caf': 1e-6, 'CifHr': 1e-4, 'Seeds': 1e-4,
            'Tcaf': 1e-6}


@pytest.fixture(autouse=True)
def clean_visualizers():
    for module in (jax_visualizer, visualizer):
        module.Base._save_counter = 0
    yield
    for module in (jax_visualizer, visualizer):
        module.Base.save_dir = None
        module.Base.set_all_indices([])
        module.Base.reset()


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def save_dirs(tmp_path):
    dirs = []
    for module in (jax_visualizer, visualizer):
        path = tmp_path / module.__name__.split('.')[0]
        module.Base.save_dir = str(path)
        dirs.append(path)
    return dirs


def files(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())} \
        if path.exists() else {}


def field_metas(hm):
    cif = hm.Cif('cif', 'cocokp', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS)
    caf = hm.Caf('caf', 'cocokp', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 skeleton=constants.COCO_PERSON_SKELETON)
    tcaf = hm.Tcaf('tcaf', 'cocokp', keypoints=constants.COCO_KEYPOINTS,
                   sigmas=constants.COCO_PERSON_SIGMAS)
    cifdet = hm.CifDet('cifdet', 'cocodet', categories=['person', 'car'])
    for m in (cif, caf, tcaf, cifdet):
        m.base_stride = 16
    return {'cif': cif, 'caf': caf, 'tcaf': tcaf, 'cifdet': cifdet}


def uniform(*shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def targets(n, vec_shape, with_scale=False):
    rng = np.random.default_rng(3)
    out = {'conf': (rng.uniform(0, 1, (n, 9, 9)) > 0.6).astype(np.float32),
           'vec': rng.normal(0, 0.5, (n, *vec_shape, 9, 9)).astype(
               np.float32)}
    if with_scale:
        out['scale'] = rng.uniform(0.5, 2, (n, 1, 9, 9)).astype(np.float32)
    return out


def render_cif_predicted(v, hm):
    v.Cif(field_metas(hm)['cif']).predicted(uniform(17, 5, 9, 9))


def render_cif_targets(v, hm):
    v.Cif(field_metas(hm)['cif']).targets(targets(17, (1, 2), True))


def render_caf_predicted(v, hm):
    v.Caf(field_metas(hm)['caf']).predicted(uniform(19, 9, 9, 9))


def render_caf_targets(v, hm):
    v.Caf(field_metas(hm)['caf']).targets(targets(19, (2, 2)))


def render_tcaf_predicted(v, hm):
    v.Tcaf(field_metas(hm)['tcaf']).predicted(uniform(17, 9, 9, 9))


def render_tcaf_targets(v, hm):
    v.Tcaf(field_metas(hm)['tcaf']).targets(targets(17, (2, 2)))


def render_cifdet_predicted(v, hm):
    v.CifDet(field_metas(hm)['cifdet']).predicted(uniform(2, 7, 9, 9))


def render_cifdet_targets(v, hm):
    v.CifDet(field_metas(hm)['cifdet']).targets(targets(2, (2, 2)))


def render_cifhr_seeds_occupancy(v, hm):
    v.Base.processed_image(np.random.default_rng(4).normal(
        0, 1, (3, 129, 129)).astype(np.float32))
    v.CifHr(field_metas(hm)['cif']).predicted(uniform(17, 33, 33))
    v.Seeds(field_names=constants.COCO_KEYPOINTS).predicted(np.array(
        [[0.9, 0, 10.0, 12.0, 3.0], [0.5, 3, 40.0, 70.0, 5.0],
         [0.0, 1, 0.0, 0.0, 0.0]], np.float32))
    v.Occupancy(reduction=2).predicted(uniform(17, 16, 16) > 0.5)


# (indices, render, files saved): JAX's test_visualizer.py cases and the
# targets of every field visualizer
CASES = {
    'cif_predicted': (['cif:1'], render_cif_predicted, 2),
    'cif_targets': (['cif:0'], render_cif_targets, 2),
    'caf_predicted': (['caf:2'], render_caf_predicted, 2),
    'caf_targets': (['caf:2:confidence'], render_caf_targets, 1),
    'tcaf_predicted': (['tcaf:2'], render_tcaf_predicted, 2),
    'tcaf_targets': (['tcaf:0:regression'], render_tcaf_targets, 1),
    'cifdet_predicted': (['cifdet:1'], render_cifdet_predicted, 2),
    'cifdet_targets': (['cifdet:0'], render_cifdet_targets, 2),
    'cifhr_seeds_occupancy': (['cifhr:0', 'seeds', 'occupancy:0'],
                              render_cifhr_seeds_occupancy, 3),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_visualizer_files_equal(case, tmp_path):
    indices, render, n_files = CASES[case]
    jax_dir, port_dir = save_dirs(tmp_path)
    for v, hm in ((jax_visualizer, jax_headmeta), (visualizer, headmeta)):
        v.Base.set_all_indices(indices)
        render(v, hm)
    want, got = files(jax_dir), files(port_dir)
    assert len(got) == n_files
    assert list(got) == list(want)
    for name in got:
        assert got[name] == want[name], name


def test_indices_and_processed_image():
    for v in (jax_visualizer, visualizer):
        v.Base.set_all_indices(['cif:5', 'caf:3:confidence', 'seeds'])
    assert visualizer.Base.all_indices == jax_visualizer.Base.all_indices
    port = visualizer.Cif(field_metas(headmeta)['cif'])
    want = jax_visualizer.Cif(field_metas(jax_headmeta)['cif'])
    assert port.indices == want.indices == [5]
    for f, t in ((5, 'confidence'), (5, 'regression'), (4, 'all')):
        assert port.wanted(f, t) == want.wanted(f, t)
    image = np.random.default_rng(0).normal(0, 1, (3, 32, 24))
    for v in (jax_visualizer, visualizer):
        v.Base.processed_image(image)
    # pylint: disable=protected-access
    np.testing.assert_array_equal(visualizer.Base._processed_image,
                                  jax_visualizer.Base._processed_image)
    visualizer.Base.reset()
    assert visualizer.Base._processed_image is None
    field = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(visualizer.Base.scale_scalar(field, 4),
                                  jax_visualizer.Base.scale_scalar(field, 4))


def record_views(monkeypatch, module, log):
    """Wrap each view's ``predicted`` to keep the array it is handed."""
    for name in HOOK_TOL:
        cls = getattr(module, name)

        def predicted(self, array, *args, _orig=cls.predicted, _name=name,
                      **kwargs):
            log[_name] = np.array(array)
            return _orig(self, array, *args, **kwargs)
        monkeypatch.setattr(cls, 'predicted', predicted)


def hook_fields(side=21, scale=30.0):
    """One pose, on JAX's ``test_decoder_debug_hook`` fields by default."""
    offset = (side - 21) * 8.0
    cif, caf = build_fields([synthetic_pose((offset, offset), scale)],
                            h=side, w=side)
    return cif, caf


def test_cifcaf_hook_matches_jax(tmp_path, monkeypatch):
    jax_dir, port_dir = save_dirs(tmp_path)
    want, got = {}, {}
    record_views(monkeypatch, jax_visualizer, want)
    record_views(monkeypatch, visualizer, got)
    indices = ['cif:0', 'caf:0', 'cifhr:0', 'seeds']
    jax_visualizer.Base.set_all_indices(indices)
    visualizer.Base.set_all_indices(indices)
    cif, caf = hook_fields()
    jax_cifcaf = jax_decoder.CifCaf(*cifcaf_metas(jax_headmeta))
    jax_cifcaf._debug_visualize(cif, caf, (321, 321))  # pylint: disable=protected-access
    anns = decoder.CifCaf(*cifcaf_metas(headmeta), device='cpu')([cif, caf])
    assert len(anns) >= 1
    assert sorted(got) == sorted(want) == ['Caf', 'Cif', 'CifHr', 'Seeds']
    for name, tol in HOOK_TOL.items():
        if name in want:
            assert got[name].shape == want[name].shape, name
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=tol, err_msg=name)
    assert (got['Seeds'][:, 0] > 0).sum() >= 17
    assert len(files(port_dir)) == len(files(jax_dir)) == 6
    assert sorted(n.split('-', 1)[1] for n in files(port_dir)) == sorted(
        n.split('-', 1)[1] for n in files(jax_dir))


def test_tcaf_hook_matches_jax(tmp_path, monkeypatch):
    """The port's ``TrackingPose.__call__`` against JAX's hook on the same
    TCAF field (the hook is the first thing JAX's ``__call__`` does with
    it)."""
    jax_dir, port_dir = save_dirs(tmp_path)
    want, got = {}, {}
    record_views(monkeypatch, jax_visualizer, want)
    record_views(monkeypatch, visualizer, got)
    for v in (jax_visualizer, visualizer):
        v.Base.set_all_indices(['tcaf:0'])
    fields = pair_fields(1)
    jax_decoder.TrackingPose(*tracking_metas(jax_headmeta)) \
        ._debug_visualize_tcaf(fields[2])  # pylint: disable=protected-access
    anns = decoder.TrackingPose(*tracking_metas(headmeta),
                                device='cpu')(fields)
    assert anns
    assert list(got) == list(want) == ['Tcaf']
    assert got['Tcaf'].shape == (17, 9) + fields[2].shape[-2:]
    np.testing.assert_allclose(got['Tcaf'], want['Tcaf'], rtol=0,
                               atol=HOOK_TOL['Tcaf'])
    assert list(files(port_dir)) == list(files(jax_dir))
    assert len(files(port_dir)) == 2


def counted(monkeypatch, fn):
    """(CifHr calls, host syncs) of ``fn()``."""
    calls = []
    accumulate = cif_hr.accumulate

    def spy(*args, **kwargs):
        calls.append(1)
        return accumulate(*args, **kwargs)
    monkeypatch.setattr(cif_hr, 'accumulate', spy)
    syncs = common.HOST_SYNCS
    fn()
    monkeypatch.setattr(cif_hr, 'accumulate', accumulate)
    return len(calls), common.HOST_SYNCS - syncs


def test_hooks_cost_nothing_without_indices(tmp_path, monkeypatch):
    """Per decode: with no index set, ``__call__`` makes the plain batched
    decode's CifHr calls and host syncs; with one, the CifCaf hook adds one
    CifHr call and four read-backs (cif, caf, CifHr, seeds), the TCAF hook
    one read-back.  Each hook computes whenever any index is set, as
    JAX's do: here only ``tcaf:0``."""
    visualizer.Base.save_dir = str(tmp_path)
    monkeypatch.setattr(visualizer.Base, 'image_canvas',
                        lambda self, *a, **kw: pytest.fail('rendered'))
    for name in HOOK_TOL:
        monkeypatch.setattr(getattr(visualizer, name), 'predicted',
                            lambda self, *a, **kw: None)
    cifcaf = decoder.CifCaf(*cifcaf_metas(headmeta), device='cpu')
    cif, caf = (torch.from_numpy(f) for f in hook_fields(13, 15.0))
    plain = counted(monkeypatch,
                    lambda: cifcaf.batch_fields([cif[None], caf[None]]))
    assert plain[0] == 1
    assert counted(monkeypatch, lambda: cifcaf([cif, caf])) == plain
    visualizer.Base.set_all_indices(['tcaf:0'])
    assert counted(monkeypatch, lambda: cifcaf([cif, caf])) == \
        (plain[0] + 1, plain[1] + 4)
    # reference quirk: the batched path has no hook
    assert counted(monkeypatch, lambda: cifcaf.batch_fields(
        [cif[None], caf[None]])) == plain

    # TrackingPose: after the first pair, one frame's decode per pair
    visualizer.Base.set_all_indices([])
    tracker = decoder.TrackingPose(*tracking_metas(headmeta), device='cpu')
    fields = pair_fields(1)
    tracker(fields)
    plain = counted(monkeypatch, lambda: tracker(fields))
    assert plain[0] == 1
    visualizer.Base.set_all_indices(['tcaf:0'])
    assert counted(monkeypatch, lambda: tracker(fields)) == \
        (plain[0], plain[1] + 1)
    assert not list(tmp_path.iterdir())


LOG_LINES = [
    {'type': 'train', 'epoch': 0, 'batch': 0, 'n_batches': 4, 'time': 0.5,
     'lr': 1e-3, 'loss': 3.2, 'head_losses': [1.0, 0.5, 0.2, 0.1]},
    {'type': 'train', 'epoch': 0, 'batch': 2, 'n_batches': 4, 'time': 0.4,
     'lr': 5e-4, 'loss': 2.9, 'head_losses': [0.9, 0.4, 0.3, 0.2]},
    {'type': 'train-epoch', 'epoch': 1, 'loss': 3.0, 'time': 1.2},
    {'type': 'val-epoch', 'epoch': 1, 'loss': 2.7, 'head_losses': [1.0],
     'time': 0.3},
    {'type': 'train', 'epoch': 1, 'batch': 0, 'n_batches': 4, 'time': 0.3,
     'lr': 2e-4, 'loss': 2.5, 'head_losses': [0.8, 0.3, 0.2, 0.1]},
]


def write_log(path, lines=LOG_LINES):
    with open(path, 'w') as f:
        f.write('not json\n')
        for line in lines:
            f.write(json.dumps(line) + '\n')
    return str(path)


def test_logs_match_jax(tmp_path):
    log = write_log(tmp_path / 'a.log')
    second = write_log(tmp_path / 'b.log', LOG_LINES[1:4])
    for logs_ in ([log], [log, second]):
        want, got = jax_logs.Plots(logs_), logs.Plots(logs_)
        assert got.datas == want.datas
        for w, g in zip(want.datas, got.datas):
            assert g['train'] and g['train-epoch'] and g['val-epoch']
            np.testing.assert_array_equal(got.process(g)[0],
                                          want.process(w)[0])
    # two logs in one figure; the port's at the default output name
    argv = [log, second, '--label', 'first', 'second']
    assert jax_logs.main(argv + ['-o', str(tmp_path / 'jax.png')]) == 0
    assert logs.main(argv) == 0
    with open(str(tmp_path / 'jax.png'), 'rb') as f_jax, \
            open(log + '.png', 'rb') as f_port:
        assert f_port.read() == f_jax.read()


def test_logs_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib cannot be imported, ``logs`` raises naming it
    before it reads the log: no file."""
    log = write_log(tmp_path / 'a.log')
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    monkeypatch.setattr(logs.Plots, 'read_log',
                        lambda path: pytest.fail('read the log'))
    with pytest.raises(ImportError, match='matplotlib'):
        logs.main([log])
    assert sorted(os.listdir(tmp_path)) == ['a.log']
