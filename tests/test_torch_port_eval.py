"""The port's eval slice against ``openpifpaf_tpu``'s.

- **toykp eval loader**: the port's ``ToyKp.eval_loader`` and the JAX one,
  with and without hflip, at the rendered size and rescaled: ground-truth
  keypoints and metas equal exactly; images within one grey level
  (``1 / (255 * min std)`` in normalized units), equal where no rescale
  happens.  The Compose path of eval and the ``Predictor.batch``
  preprocess give the same tensor and meta.
- **Evaluator on trained fields**: a model stub replays
  ``tests/fixtures/golden_toykp_fields.npz`` (the first four toykp eval
  images at 161 px) in both packages, so the decodes see identical fields;
  the ten keypoint stats must agree within 1e-6 and the port's AP must be
  above 0.9, with and without ``--force-complete-pose``.
- **Evaluator end to end**: a JAX-written sn2k16 checkpoint with its
  heads' confidence and scale biases shifted (every cell a detection) runs
  through both packages' ``Evaluator`` at 81 px, batch 4, f32, single-
  scale and multi-scale (factors 0.75 and 1.0: 65 and 81 px, each with its
  hflip).  Both evaluators see the JAX loader's pixels (the loader test
  holds the port's within a grey level); per-image predictions match
  within the decode tolerances (xyv 1e-3, scores 1e-4) and the stats
  within 1e-6.
- **The CLI**: ``python -m openpifpaf_tpu_torch.eval --device=cpu``
  writes the stats json with the JAX package's keys, the predictions and
  the decode's cProfile (``--profile-decoder``); without ``--device`` and
  without CUDA it raises; ``--dp-eval`` without a group changes nothing.
"""

import json
import os
import pstats
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu import eval as jax_eval
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu import predictor as jax_predictor
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.plugins.toykp import datamodule as jax_toykp
from openpifpaf_tpu_torch import decoder, eval as port_eval, transforms
from openpifpaf_tpu_torch.plugins import toykp
from openpifpaf_tpu_torch.predictor import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, 'tests', 'fixtures')
# one grey level after ImageNet normalization, the largest of the channels
GREY_LEVEL = 1.0 / (255.0 * min(transforms.IMAGENET_STD)) + 1e-6
STATS_KEYS = ['n_images', 'total_time', 'nn_time', 'decoder_time',
              'images_per_second', 'stats', 'text_labels']


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU decode is many small ops: one intra-op thread costs
    a sixth of the CPU time of the default and leaves the cores to the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def toykp_eval(monkeypatch):
    """Both packages' toykp at ``size`` with ``n`` eval images, batch 4,
    the COCO CIF/CAF heads.  Set on the ToyKp classes themselves: a value
    another test left on a class shadows the base class's."""
    def configure(size, n, batch_size=4):
        monkeypatch.setattr(jax_toykp.ToyKp, 'with_dense', False)
        for cls in (jax_toykp.ToyKp, toykp.ToyKp):
            monkeypatch.setattr(cls, 'image_size', size)
            monkeypatch.setattr(cls, 'n_val_images', n)
            monkeypatch.setattr(cls, 'batch_size', batch_size)
        return jax_toykp.ToyKp(), toykp.ToyKp()
    return configure


def assert_same_batch(jax_batch, port_batch, *, exact_images):
    images_j, anns_j, metas_j = jax_batch
    images_p, anns_p, metas_p = port_batch
    assert images_p.dtype == torch.float32
    got = images_p.permute(0, 2, 3, 1).numpy()
    assert got.shape == images_j.shape
    diff = np.abs(got - images_j).max()
    assert diff <= (1e-6 if exact_images else GREY_LEVEL), diff
    for aj, ap, mj, mp in zip(anns_j, anns_p, metas_j, metas_p):
        assert len(ap) == len(aj) > 0
        for a, b in zip(aj, ap):
            np.testing.assert_array_equal(b.data, a.data)
            np.testing.assert_array_equal(b.fixed_bbox, a.fixed_bbox)
        for key in ('offset', 'scale', 'valid_area', 'width_height',
                    'original_width_height'):
            np.testing.assert_array_equal(mp[key], mj[key], err_msg=key)
        for key in ('hflip', 'dataset_index', 'image_id', 'file_name'):
            assert mp[key] == mj[key], key
        if mj['hflip']:
            np.testing.assert_array_equal(mp['horizontal_swap'].perm,
                                          mj['horizontal_swap'].perm)


@pytest.mark.parametrize('long_edge', [None, 65])
@pytest.mark.parametrize('hflip', [False, True])
def test_eval_loader_matches_jax(toykp_eval, long_edge, hflip):
    jax_dm, port_dm = toykp_eval(81, 5)
    want = list(jax_dm.eval_loader(long_edge=long_edge, hflip=hflip))
    got = list(port_dm.eval_loader(long_edge=long_edge, hflip=hflip))
    # no shuffle, the last batch kept: 4 + 1 images
    assert [len(m) for _, _, m in got] == [len(m) for _, _, m in want] \
        == [4, 1]
    for w, g in zip(want, got):
        assert_same_batch(w, g, exact_images=long_edge is None)
    # the ground truth maps back to the rendered canvas in both
    (_, anns_j, metas_j), (_, anns_p, metas_p) = want[0], got[0]
    for aj, ap, mj, mp in zip(anns_j[0], anns_p[0], metas_j, metas_p):
        np.testing.assert_allclose(ap.inverse_transform(mp).data,
                                   aj.inverse_transform(mj).data,
                                   atol=1e-4, rtol=0)


def test_eval_transforms_equal_predictor_preprocess(toykp_eval):
    """Eval's Compose(NormalizeAnnotations, [HFlip], RescaleAbsolute,
    CenterPad, EVAL_TRANSFORM), ``Predictor.preprocess_factory`` and
    ``Predictor.batch``'s ``transforms.preprocess`` give the same tensor
    and the same transform meta."""
    _, port_dm = toykp_eval(81, 2)
    predictor = Predictor(model=PortReplay(replay_metas(port_dm), []),
                          device='cpu')
    ds = toykp.ToyKpDataset(2, 81, None, seed=1000)
    for i, long_edge in ((0, 65), (1, 97)):
        image = ds.render(i, ds.ground_truth(i))
        tensor = torch.from_numpy(image).permute(2, 0, 1).float()
        got, _, meta = port_dm._eval_preprocess(long_edge)(tensor, [], None)
        want, want_meta = transforms.preprocess(image, long_edge,
                                                torch.device('cpu'))
        assert torch.equal(got, want)
        for key, value in want_meta.items():
            if key != 'rotation':
                np.testing.assert_array_equal(meta[key], value, err_msg=key)
        for hflip in (False, True):
            want, _, want_meta = port_dm._eval_preprocess(long_edge, hflip)(
                tensor, [], None)
            got, _, meta = predictor.preprocess_factory(
                long_edge=long_edge, hflip=hflip)(tensor, [], None)
            assert torch.equal(got, want)
            assert meta['hflip'] == want_meta['hflip'] == hflip
            np.testing.assert_array_equal(meta['valid_area'],
                                          want_meta['valid_area'])


# -------------------------------------------------- golden fields replayed
class JaxReplay:
    """A JAX model whose forward returns the golden fields."""

    def __init__(self, metas, fields):
        self.head_metas = metas
        self.variables = {}
        self.fields = [jax.numpy.asarray(f) for f in fields]

    def apply_fast(self, variables, x):  # pylint: disable=unused-argument
        return self.fields


class PortReplay:
    """The port's counterpart: a callable model on the CPU."""

    device = torch.device('cpu')

    def __init__(self, metas, fields):
        self.head_metas = metas
        self.fields = [torch.from_numpy(f) for f in fields]

    def __call__(self, x):
        assert x.shape[0] == self.fields[0].shape[0]
        return self.fields


def replay_metas(dm):
    metas = dm.head_metas
    for i, meta in enumerate(metas):
        meta.head_index, meta.base_stride = i, 16
    return metas


@pytest.mark.parametrize('force_complete', [False, True],
                         ids=['default', 'force_complete'])
def test_evaluator_on_golden_fields(toykp_eval, monkeypatch, force_complete):
    monkeypatch.setattr(jax_decoder.CifCaf, 'force_complete', force_complete)
    monkeypatch.setattr(decoder.CifCaf, 'force_complete', force_complete)
    jax_dm, port_dm = toykp_eval(161, 4)
    data = np.load(os.path.join(FIXTURES, 'golden_toykp_fields.npz'))
    fields = [data['cif'], data['caf']]
    want = jax_eval.Evaluator(jax_dm, jax_predictor.Predictor(
        model=JaxReplay(replay_metas(jax_dm), fields))).run()
    predictor = Predictor(model=PortReplay(replay_metas(port_dm), fields),
                          device='cpu')
    evaluator = port_eval.Evaluator(port_dm, predictor)
    got = evaluator.run()
    assert list(got) == list(want) == STATS_KEYS
    assert got['n_images'] == want['n_images'] == 4
    assert got['text_labels'] == want['text_labels']
    np.testing.assert_allclose(got['stats'], want['stats'], atol=1e-6,
                               rtol=0)
    assert got['stats'][0] > 0.9
    # ``Predictor.dataset`` batches a dataset itself, to the same poses
    if not force_complete:
        monkeypatch.setattr(predictor, 'batch_size', 4)
        by_dataset = [dict(a, image_id=meta['image_id'])
                      for preds, _, meta in predictor.dataset(
                          port_dm.eval_loader().dataset, json_data=True)
                      for a in preds]
        assert by_dataset == evaluator.metrics[0].predictions
        assert len(by_dataset) == 6


# ------------------------------------------------------------- end to end
@pytest.fixture(scope='module')
def detecting_checkpoint(tmp_path_factory):
    """A JAX-written sn2k16 checkpoint: the JAX module's variable tree
    filled from a numpy seed (kernels N(0, 1/fan_in), BatchNorm identity,
    biases 0), its heads' confidence and scale biases shifted so that
    every cell is a detection."""
    dm = jax_toykp.ToyKp()
    model = jax_models.Factory(base_name='shufflenetv2k16', bf16=False) \
        .from_scratch('shufflenetv2k16', dm.head_metas)
    shapes = jax.eval_shape(
        lambda rng, x: model.module.init(rng, x, train=False),
        jax.random.key(0), jax.numpy.zeros((1, 81, 81, 3)))
    rng = np.random.default_rng(0)
    flat = {}
    for name, leaf in jax_checkpoint.flatten_tree(
            jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                         shapes)).items():
        if name.endswith('/kernel'):
            fan_in = int(np.prod(leaf.shape[:-1]))
            leaf = rng.normal(0, 1 / np.sqrt(fan_in), leaf.shape)
        elif name.endswith(('/scale', '/var')):
            leaf = np.ones(leaf.shape)
        flat[name] = leaf.astype(np.float32)
    variables = jax_checkpoint.unflatten_tree(flat)
    for i, meta in enumerate(model.head_metas):
        bias = variables['params'][f'head_nets_{i}']['conv']['bias']
        bias = bias.reshape(meta.n_fields, meta.n_components)
        bias[:, 0] = 2.0
        bias[:, meta.n_components - meta.n_scales:] = 3.0
    path = str(tmp_path_factory.mktemp('eval') / 'model.npz')
    jax_checkpoint.save(path, variables=variables,
                        head_metas=model.head_metas,
                        basenet_name='shufflenetv2k16', base_stride=16)
    return path


@pytest.fixture(scope='module')
def predictors(detecting_checkpoint):
    """The checkpoint in both packages' predictors, f32 (one JAX compile
    per image size for both end-to-end tests)."""
    return (jax_predictor.Predictor(model=jax_models.Factory(
                checkpoint=detecting_checkpoint, bf16=False).factory()),
            Predictor(checkpoint=detecting_checkpoint, device='cpu',
                      bf16=False))


class JaxPixels:
    """The port's toykp eval loader with the JAX loader's pixels: the
    port's ground truth and metas (equal to the JAX ones, above), the JAX
    package's PIL-rescaled images."""

    def __init__(self, port_dm, jax_dm):
        self.port_dm, self.jax_dm = port_dm, jax_dm
        self.image_size = port_dm.image_size

    def metrics(self):
        return self.port_dm.metrics()

    def eval_loader(self, **kw):
        for (images, _, _), (_, anns, metas) in zip(
                self.jax_dm.eval_loader(**kw), self.port_dm.eval_loader(**kw)):
            yield torch.from_numpy(images).permute(0, 3, 1, 2), anns, metas


@pytest.mark.parametrize('multi_scale', [False, True],
                         ids=['single_scale', 'multi_scale'])
def test_evaluator_end_to_end(toykp_eval, monkeypatch, predictors,
                              multi_scale):
    jax_pred, port_pred = predictors
    for pred in predictors:
        monkeypatch.setattr(pred, 'multi_scale', multi_scale)
        monkeypatch.setattr(pred, 'multi_scale_factors', (0.75, 1.0))
        monkeypatch.setattr(pred, 'total_nn_time', 0.0)
        monkeypatch.setattr(pred, 'total_decoder_time', 0.0)
        monkeypatch.setattr(pred, 'total_images', 0)
    jax_dm, port_dm = toykp_eval(81, 4)
    if multi_scale:
        assert port_pred.multiscale_variants(81)[0] == [
            (65, False), (65, True), (81, False), (81, True)]

    predictions = {}
    for name, pred in (('jax', jax_pred), ('port', port_pred)):
        merge = pred.merge_annotations
        kept = predictions[name] = []

        def keep(lists, merge=merge, kept=kept, **kw):
            kept.append(merge(lists, **kw))
            return kept[-1]
        if multi_scale:
            monkeypatch.setattr(pred, 'merge_annotations', keep)
        else:
            loader = pred.dataset_loader

            def keep_all(*a, loader=loader, kept=kept, **kw):
                for item in loader(*a, **kw):
                    kept.append(item[0])
                    yield item
            monkeypatch.setattr(pred, 'dataset_loader', keep_all)

    want = jax_eval.Evaluator(jax_dm, jax_pred).run()
    got = port_eval.Evaluator(JaxPixels(port_dm, jax_dm), port_pred).run()
    assert list(got) == list(want) == STATS_KEYS
    assert got['n_images'] == want['n_images'] == 4
    np.testing.assert_allclose(got['stats'], want['stats'], atol=1e-6,
                               rtol=0)
    assert len(predictions['port']) == len(predictions['jax']) == 4
    for want_anns, got_anns in zip(predictions['jax'], predictions['port']):
        assert len(got_anns) == len(want_anns) > 0
        for g, w in zip(got_anns, want_anns):
            np.testing.assert_allclose(g.data, w.data, atol=1e-3, rtol=0)
            assert abs(g.score - w.score) <= 1e-4
    assert port_pred.total_images == 4 * (4 if multi_scale else 1)
    assert port_pred.total_nn_time > 0 and port_pred.total_decoder_time > 0


# -------------------------------------------------------------------- CLI
def run_cli(args, **env):
    return subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.eval', '--dataset=toykp',
         '--toykp-image-size=81', '--batch-size=4'] + args,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
                           **env),
        capture_output=True, text=True, timeout=300)


def test_eval_cli(detecting_checkpoint, tmp_path):
    out = str(tmp_path / 'run')
    profile = str(tmp_path / 'decode.prof')
    proc = run_cli([f'--checkpoint={detecting_checkpoint}', '--device=cpu',
                    '--no-bf16', '--force-complete-pose', '-o', out,
                    '--write-predictions', f'--profile-decoder={profile}'])
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    assert list(stats) == STATS_KEYS
    assert stats['n_images'] == 8
    assert stats['text_labels'] == ['AP', 'AP0.5', 'AP0.75', 'APM', 'APL',
                                    'AR', 'AR0.5', 'AR0.75', 'ARM', 'ARL']
    assert all(-1.0 <= v <= 1.0 for v in stats['stats'])
    with open(out + '.pred.json') as f:
        preds = json.load(f)
    assert preds and {p['image_id'] for p in preds} <= set(range(8))
    assert os.path.exists(out + '.zip')
    assert 'AP' in proc.stdout and 'images/s' in proc.stdout
    # --profile-decoder: a cProfile of the decode, readable by pstats
    assert pstats.Stats(profile).total_calls > 0


def test_eval_cli_refusals(detecting_checkpoint):
    """Without ``--device`` it needs the card (hidden from the process);
    ``--dp-eval`` is not refused: without torchrun's variables there is no
    group and it changes nothing (``test_torch_port_dp_eval.py`` runs it in
    a group).  Both in one interpreter."""
    code = (
        'from openpifpaf_tpu_torch import eval as e, parallel\n'
        'for flags in ([], ["--device=cpu", "--dp-eval", "-o", "/dev/null/x"]):\n'
        '    try:\n'
        '        e.main(["--dataset=toykp", "--toykp-image-size=81",\n'
        f'                "--checkpoint={detecting_checkpoint}"] + flags)\n'
        '    except (RuntimeError, OSError) as err:\n'
        '        print("refused:", type(err).__name__, err)\n'
        '    else:\n'
        '        raise AssertionError(f"{flags} ran")\n'
        'assert parallel.data_group() is None\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   CUDA_VISIBLE_DEVICES='',
                                   OMP_NUM_THREADS='1'),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    refused = [line for line in proc.stdout.splitlines()
               if line.startswith('refused:')]
    assert len(refused) == 2
    assert 'CUDA is not available' in refused[0]
    # the eval ran and only writing its stats failed
    assert "File exists: '/dev/null'" in refused[1]
