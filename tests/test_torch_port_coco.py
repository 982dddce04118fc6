"""The COCO-format data path of the port against the JAX package, on a
synthesized tree (``chip_smoke.write_coco_tree``: a few PNG images of
97 x 129 and 129 x 97 px, the person_keypoints, instances and CrowdPose
jsons; the repository holds none of the datasets).

- ``CocoDataset``: the same ids under every filter, the same raw samples
  (pixels read without PIL equal PIL's), the same meta.
- cocokp and cocodet: the training samples without augmentation (image
  within 1 grey level, masks equal, float targets within 1e-6, as
  ``test_torch_port_encoder.py``), the eval samples with and without
  hflip, the augmented chain's steps (types and parameters) in JAX's
  order, every flag's default, and ``metrics()`` read from the annotation
  file: the same stats on the same predictions.
- The repaired keywords: ``Annotation(categories=...,
  suppress_score_index=...)`` and ``NormalizeAnnotations(categories=...)``,
  which cocodet's normalize and ``ToKpAnnotations`` pass (both raised
  ``TypeError`` before).
- One epoch of ``python -m openpifpaf_tpu_torch.train --dataset cocokp``
  on the CPU, then the eval CLI on its checkpoint.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest
import torch

import chip_smoke
from openpifpaf_tpu import annotation as jax_annotation
from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.plugins.coco.cocodet import CocoDet as JaxCocoDet
from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu.plugins.coco.dataset import CocoDataset as JaxCocoDataset
from openpifpaf_tpu_torch import annotation, transforms
from openpifpaf_tpu_torch.plugins.coco import (CocoDataset, CocoDet, CocoKp,
                                               constants)

from test_torch_port_encoder import assert_targets_equal
from test_torch_port_encoder import numpy_painters  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((129, 97), (97, 129)) * 3
SQUARE_EDGE = 65
LONG_EDGE = 81
# 1 grey level after the ImageNet normalization
NORMALIZED_LEVEL = 1.0 / (255 * 0.224) + 1e-6


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return chip_smoke.write_coco_tree(
        str(tmp_path_factory.mktemp('coco')), sizes=SIZES)


def configure(monkeypatch, tree, classes, **attrs):
    """Point the JAX and port data modules at the tree."""
    for cls in classes:
        ann = tree['instances' if 'Det' in cls.__name__
                   else 'person_keypoints']
        for key in ('train', 'val', 'eval'):
            monkeypatch.setattr(cls, f'{key}_annotations', ann)
            monkeypatch.setattr(cls, f'{key}_image_dir', tree['images'])
        for key, value in attrs.items():
            monkeypatch.setattr(cls, key, value)


def with_stride(dm):
    for meta in dm.head_metas:
        meta.base_stride = 16
    return dm


def numpy_encoders(metas):
    """The JAX encoders on their numpy path (the one the port copies)."""
    out = []
    for meta in metas:
        kind = type(meta).__name__
        if kind == 'CifDet':
            out.append(jax_encoder.CifDetEncoder(meta))
        else:
            cls = jax_encoder.CifEncoder if kind == 'Cif' else \
                jax_encoder.CafEncoder
            out.append(cls(meta, use_native=False))
    return jax_encoder.Encoders(out)


def assert_images_close(image, want, atol):
    got = image.permute(1, 2, 0).numpy() if isinstance(image, torch.Tensor) \
        else np.asarray(image, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= atol


def assert_meta_close(want, got):
    for key in ('dataset_index', 'image_id', 'file_name', 'hflip'):
        assert got[key] == want[key], key
    for key in ('offset', 'scale', 'valid_area', 'width_height',
                'original_width_height'):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize('kind', ['person_keypoints', 'instances',
                                  'crowdpose'])
def test_dataset_ids_filters_and_raw_samples(tree, kind):
    for kw in (dict(), dict(annotation_filter=True),
               dict(annotation_filter=True, min_kp_anns=1,
                    category_ids=[1]),
               dict(category_ids=[17, 18])):
        ours = JaxCocoDataset(tree['images'], tree[kind], **kw)
        port = CocoDataset(tree['images'], tree[kind], **kw)
        assert port.ids == ours.ids == sorted(ours.ids)
        assert len(port) == len(ours)
    assert len(JaxCocoDataset(tree['images'], tree[kind],
                              annotation_filter=True, min_kp_anns=1).ids) \
        < len(SIZES)
    for index in range(len(port)):
        want_image, want_anns, want_meta = ours[index]
        image, anns, meta = port[index]
        assert_images_close(image, want_image, 0.0)
        assert anns == want_anns and meta == want_meta


def test_cocokp_train_samples(tree, monkeypatch):
    """cocokp without augmentation: the train samples of both packages."""
    configure(monkeypatch, tree, (JaxCocoKp, CocoKp),
              square_edge=SQUARE_EDGE, augmentation=False)
    jax_dm, dm = with_stride(JaxCocoKp()), with_stride(CocoKp())
    steps = jax_dm._preprocess().transforms[:-1]  # pylint: disable=protected-access
    ours = JaxCocoDataset(
        tree['images'], tree['person_keypoints'],
        preprocess=jax_transforms.Compose(
            steps + [numpy_encoders(jax_dm.head_metas)]),
        annotation_filter=True, min_kp_anns=1, category_ids=[1])
    port = dm.train_loader().dataset
    assert port.ids == ours.ids and len(port) >= 3
    for index in range(len(port)):
        (want_image, want_targets, want_meta), (image, targets, meta) = \
            ours[index], port[index]
        assert image.shape == (3, SQUARE_EDGE, SQUARE_EDGE)
        assert_images_close(image, want_image, NORMALIZED_LEVEL)
        for want, got in zip(want_targets, targets):
            assert_targets_equal(want, got)
        assert_meta_close(want_meta, meta)
    assert any(t['vec_mask'].any() for t in port[0][1])


def test_cocodet_train_samples(tree, monkeypatch):
    """cocodet without augmentation (its normalize passes ``categories``):
    the CifDet targets of both packages."""
    configure(monkeypatch, tree, (JaxCocoDet, CocoDet),
              square_edge=SQUARE_EDGE, augmentation=False)
    jax_dm, dm = with_stride(JaxCocoDet()), with_stride(CocoDet())
    steps = jax_dm._preprocess().transforms[:-1]  # pylint: disable=protected-access
    ours = JaxCocoDataset(
        tree['images'], tree['instances'],
        preprocess=jax_transforms.Compose(
            steps + [numpy_encoders(jax_dm.head_metas)]),
        annotation_filter=True)
    port = dm.train_loader().dataset
    assert port.ids == ours.ids
    n_positive = 0
    for index in range(len(port)):
        (want_image, want_targets, want_meta), (image, targets, meta) = \
            ours[index], port[index]
        assert_images_close(image, want_image, NORMALIZED_LEVEL)
        (want,), (got,) = want_targets, targets
        assert_targets_equal(want, got)
        assert_meta_close(want_meta, meta)
        n_positive += int(np.asarray(got['conf']).sum() > 0)
    assert n_positive >= 3


@pytest.mark.parametrize('hflip', [False, True])
def test_cocokp_eval_samples(tree, monkeypatch, hflip):
    configure(monkeypatch, tree, (JaxCocoKp, CocoKp), eval_long_edge=LONG_EDGE)
    ours = JaxCocoKp().eval_loader(hflip=hflip).dataset
    port = CocoKp().eval_loader(hflip=hflip).dataset
    assert port.ids == ours.ids
    for index in range(len(port)):
        (want_image, want_anns, want_meta), (image, anns, meta) = \
            ours[index], port[index]
        assert image.shape[1:] == (LONG_EDGE, LONG_EDGE)
        assert_images_close(image, want_image, NORMALIZED_LEVEL)
        assert len(anns) == len(want_anns)
        for a, b in zip(want_anns, anns):
            np.testing.assert_allclose(b.data, a.data, atol=1e-4)
            np.testing.assert_allclose(b.fixed_bbox, a.fixed_bbox, atol=1e-4)
            assert b.iscrowd == a.iscrowd
        assert_meta_close(want_meta, meta)


def test_cocodet_eval_samples(tree, monkeypatch):
    configure(monkeypatch, tree, (JaxCocoDet, CocoDet),
              eval_long_edge=LONG_EDGE)
    ours = JaxCocoDet().eval_loader().dataset
    port = CocoDet().eval_loader().dataset
    assert port.ids == ours.ids
    for index in range(len(port)):
        (want_image, want_anns, want_meta), (image, anns, meta) = \
            ours[index], port[index]
        assert_images_close(image, want_image, NORMALIZED_LEVEL)
        assert [(a.category_id, a.categories) for a in anns] == \
            [(a.category_id, a.categories) for a in want_anns]
        for a, b in zip(want_anns, anns):
            np.testing.assert_allclose(b.fixed_bbox, a.fixed_bbox, atol=1e-4)
            assert b.data.shape == a.data.shape == (0, 3)
        assert_meta_close(want_meta, meta)
    with pytest.raises(ValueError, match='one scale'):
        CocoDet().eval_loader(hflip=True)


def step_signature(step):
    """A transform's type (JAX's tensor boundary named as the port's) and
    its parameters, nested transforms included."""
    name = type(step).__name__
    if name == 'ImageToNumpy':
        name = 'ImageToTensor'
    params = {}
    for key, value in sorted(vars(step).items()):
        if key in ('rng', 'mean', 'std'):
            continue
        if key == 'transform':
            value = step_signature(value)
        elif key == 'transforms':
            value = [step_signature(v) for v in value]
        elif key == 'swap':
            value = value.perm.tolist()
        elif key == 'encoders':
            value = [(type(e).__name__, e.meta.name) for e in value]
        elif isinstance(value, tuple):
            value = list(value)
        params[key] = value
    return name, params


@pytest.mark.parametrize('options', [
    dict(),
    dict(orientation_invariant=0.6, blur=0.5),
    dict(orientation_invariant=0.6, extended_scale=True, rescale_images=0.5),
], ids=['default', 'rotate-blur', 'extended'])
def test_cocokp_augmented_chain_steps(monkeypatch, options):
    for cls in (JaxCocoKp, CocoKp):
        for key, value in options.items():
            monkeypatch.setattr(cls, key, value)
    want = JaxCocoKp()._preprocess()  # pylint: disable=protected-access
    rng = np.random.default_rng(0)
    got = CocoKp()._preprocess(rng)  # pylint: disable=protected-access
    assert [step_signature(s) for s in got.transforms] == \
        [step_signature(s) for s in want.transforms]
    random_steps = [s for s in got.transforms if hasattr(s, 'rng')]
    assert random_steps and all(s.rng is rng for s in random_steps)


def test_cocokp_augmented_samples_run(tree, monkeypatch):
    """The full augmentation chain (both rotations and blur on) runs on
    the tree and gives square images and finite targets; its samples
    repeat from the same seed."""
    configure(monkeypatch, tree, (CocoKp,), square_edge=SQUARE_EDGE,
              orientation_invariant=0.6, blur=0.5)
    dm = with_stride(CocoKp())
    first = [dm.train_loader().dataset[i] for i in range(3)]
    again = [dm.train_loader().dataset[i] for i in range(3)]
    for (image, targets, meta), (image2, _, _) in zip(first, again):
        assert image.shape == (3, SQUARE_EDGE, SQUARE_EDGE)
        assert torch.equal(image, image2)
        assert all(np.isfinite(np.asarray(t['vec'])).all() for t in targets)
        assert 'rotation' in meta


def parser_defaults(cls):
    parser = argparse.ArgumentParser()
    cls.cli(parser)
    return {a.dest: (a.option_strings, a.default) for a in parser._actions  # pylint: disable=protected-access
            if a.dest != 'help'}


@pytest.mark.parametrize('pair', [(JaxCocoKp, CocoKp), (JaxCocoDet, CocoDet)],
                         ids=['cocokp', 'cocodet'])
def test_flag_defaults(pair):
    want, got = (parser_defaults(cls) for cls in pair)
    assert got == want and len(got) >= 6
    for key in ('square_edge', 'eval_long_edge', 'augmentation'):
        assert getattr(pair[1], key) == getattr(pair[0], key)


def test_dataset_default_and_registry():
    from openpifpaf_tpu_torch import datasets, plugins

    plugins.register()
    parser = argparse.ArgumentParser()
    datasets.cli(parser)
    args = parser.parse_args([])
    assert args.dataset == 'cocokp'
    assert datasets.DATAMODULES['cocokp'] is CocoKp
    assert datasets.DATAMODULES['cocodet'] is CocoDet


def noisy_predictions(pkg, anns, rng, kind):
    """Predictions near the ground truth: jittered keypoints or boxes."""
    out = []
    for raw in anns:
        if raw.get('iscrowd'):
            continue
        jitter = rng.normal(0.0, 0.5 if kind == 'keypoints' else 2.0, 4)
        if kind == 'keypoints':
            kps = np.asarray(raw['keypoints'], np.float32).reshape(-1, 3)
            if not (kps[:, 2] > 0).any():
                continue
            ann = pkg.Annotation(constants.COCO_KEYPOINTS,
                                 constants.COCO_PERSON_SKELETON)
            ann.data[:, :2] = kps[:, :2] + jitter[:2]
            ann.data[:, 2] = np.where(kps[:, 2] > 0, 0.9, 0.0)
        else:
            ann = pkg.AnnotationDet(constants.COCO_CATEGORIES).set(
                raw['category_id'], 0.8, np.asarray(raw['bbox']) + jitter)
        out.append(ann)
    return out


@pytest.mark.parametrize('pair', [(JaxCocoKp, CocoKp), (JaxCocoDet, CocoDet)],
                         ids=['cocokp', 'cocodet'])
def test_metrics_from_the_annotation_file(tree, monkeypatch, pair):
    configure(monkeypatch, tree, pair)
    kind = 'keypoints' if pair[0] is JaxCocoKp else 'bbox'
    with open(tree['person_keypoints' if kind == 'keypoints'
                   else 'instances']) as f:
        data = json.load(f)
    results = []
    for cls, pkg in zip(pair, (jax_annotation, annotation)):
        metric, = cls().metrics()
        assert metric.gt_by_image and not metric.ground_truth_from_loader
        rng = np.random.default_rng(3)
        for image in data['images']:
            anns = [a for a in data['annotations']
                    if a['image_id'] == image['id']]
            metric.accumulate(noisy_predictions(pkg, anns, rng, kind),
                              {'image_id': image['id']})
        results.append(metric.stats())
    want, got = results
    assert got['text_labels'] == want['text_labels']
    np.testing.assert_allclose(got['stats'], want['stats'], atol=1e-6)
    assert 0.2 < got['stats'][0] <= 1.0


def test_repaired_annotation_keywords():
    """``categories`` and ``suppress_score_index`` as in the JAX package:
    kept by ``copy`` and ``inverse_transform``, the suppressed keypoint
    left out of the score."""
    kw = dict(categories=['person'], category_id=1, suppress_score_index=0,
              score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    anns = [pkg.Annotation(constants.COCO_KEYPOINTS,
                           constants.COCO_PERSON_SKELETON, **kw)
            for pkg in (jax_annotation, annotation)]
    data = np.random.default_rng(0).uniform(0.1, 1.0, (17, 3))
    meta = dict(transforms.init_meta(50, 40), hflip=True)
    for ann in anns:
        ann.data[:] = data
    (want, got) = anns
    assert got.score == pytest.approx(want.score, abs=1e-6)
    for ann in (got.copy(), got.inverse_transform(meta)):
        assert ann.categories == ['person'] and ann.suppress_score_index == 0
        assert ann.score == pytest.approx(want.score, abs=1e-6)
    raw = [{'keypoints': [], 'bbox': [1.0, 2.0, 3.0, 4.0], 'category_id': 3,
            'iscrowd': 0}]
    _, normalized, _ = CocoDet._normalize()(  # pylint: disable=protected-access
        torch.zeros(3, 8, 8), [dict(r) for r in raw], None)
    _, jax_normalized, _ = JaxCocoDet()._normalize()(  # pylint: disable=protected-access
        PIL.Image.new('RGB', (8, 8)), [dict(r) for r in raw], None)
    assert normalized[0].categories == jax_normalized[0].categories == \
        constants.COCO_CATEGORIES
    converted = transforms.ToKpAnnotations(
        ['person'], {1: constants.COCO_KEYPOINTS},
        {1: constants.COCO_PERSON_SKELETON})(
            [{'keypoints': [1.0, 2.0, 2.0] * 17, 'category_id': 1}])
    assert converted[0].categories == ['person']


def run_cli(module, args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-m', module] + args, cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_train_and_eval_cli(tree, tmp_path):
    """``--dataset cocokp`` through the CLIs on the CPU: one epoch on the
    tree, then the eval of its checkpoint with the file's ground truth."""
    out = str(tmp_path / 'model')
    data = [f'--cocokp-{split}-{kind}={tree[key]}'
            for split in ('train', 'val')
            for kind, key in (('annotations', 'person_keypoints'),
                              ('image-dir', 'images'))]
    result = run_cli('openpifpaf_tpu_torch.train', [
        '--device=cpu', '--dataset=cocokp', '--basenet=shufflenetv2k16',
        f'--cocokp-square-edge={SQUARE_EDGE}', '--cocokp-blur=0.5',
        '--cocokp-orientation-invariant=0.6', '--batch-size=2',
        '--epochs=1', '--no-bf16', '--log-interval=1', '--output', out]
        + data)
    assert result.returncode == 0, result.stderr[-3000:]
    with open(out + '.log') as f:
        lines = [json.loads(line) for line in f]
    train = [line for line in lines if line['type'] == 'train']
    assert train and all(np.isfinite(line['loss']) for line in train)
    result = run_cli('openpifpaf_tpu_torch.eval', [
        '--device=cpu', '--dataset=cocokp', f'--checkpoint={out}.npz',
        f'--coco-eval-long-edge={LONG_EDGE}', '--batch-size=2',
        f'--cocokp-val-annotations={tree["person_keypoints"]}',
        f'--cocokp-val-image-dir={tree["images"]}', '-o', out + '.eval'])
    assert result.returncode == 0, result.stderr[-3000:]
    with open(out + '.eval.stats.json') as f:
        stats = json.load(f)
    assert stats['text_labels'][:3] == ['AP', 'AP0.5', 'AP0.75']
    assert stats['n_images'] == len(CocoDataset(
        tree['images'], tree['person_keypoints'], annotation_filter=True,
        min_kp_anns=1, category_ids=[1]))
