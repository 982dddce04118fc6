"""The port's COCO metric and multi-scale merge against ``openpifpaf_tpu``'s.

- ``metric/cocoeval.py`` and ``metric/coco.py`` are numpy in both packages,
  so on the same seeded scenes every summary statistic must be equal to
  1e-12: keypoint (OKS) and bbox (IoU) scenes, with crowd ground truth,
  unlabeled ground truth (no visible keypoint), more detections than
  ``max_dets`` and tied scores; ``Coco`` with ground truth from the loader,
  from an ``ann_file`` written to ``tmp_path`` (category filter, crowd
  flags, CrowdPose crowd-index bands) and its written predictions.
- ``Predictor.merge_annotations`` keeps the same poses in the same order
  as the JAX one on seeded annotation lists (ties included);
  ``Predictor.multiscale_variants``, ``hflip_map_from_keypoints`` and
  ``oks_matrix`` are equal.
"""

import json
import os
import zipfile

import numpy as np
import pytest

from openpifpaf_tpu import annotation as jax_annotation
from openpifpaf_tpu import metric as jax_metric
from openpifpaf_tpu import predictor as jax_predictor
from openpifpaf_tpu.decoder import pose_similarity as jax_pose_similarity
from openpifpaf_tpu.transforms import hflip as jax_hflip
from openpifpaf_tpu_torch import annotation, metric, transforms
from openpifpaf_tpu_torch.decoder import pose_similarity
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.predictor import Predictor

K = 17
SIGMAS = np.asarray(constants.COCO_PERSON_SIGMAS)
TOL = 1e-12

# scene features: crowd ground truth, unlabeled ground truth, more
# detections than max_dets, tied scores
FEATURES = {
    'plain': {},
    'crowd': {'crowd': True},
    'unlabeled': {'unlabeled': True},
    'max_dets': {'extra_dets': 30},
    'ties': {'ties': True},
    'all': {'crowd': True, 'unlabeled': True, 'extra_dets': 30,
            'ties': True},
}


def scene(seed, *, crowd=False, unlabeled=False, extra_dets=0, ties=False,
          n_images=6):
    """Per image ``(gts, dts)`` as plain dicts: gt keypoints (K, 3), bbox
    xywh, area, iscrowd; dt keypoints, bbox, score.  Areas span the small,
    medium and large ranges; detections are jittered ground truth plus
    false positives."""
    rng = np.random.default_rng(seed)
    images = []
    for _ in range(n_images):
        gts, dts = [], []
        for g in range(int(rng.integers(0, 5))):
            side = float(rng.choice([20.0, 60.0, 150.0])
                         * rng.uniform(0.7, 1.3))
            x0, y0 = rng.uniform(0, 400, 2)
            kps = np.zeros((K, 3), np.float32)
            kps[:, 0] = x0 + rng.uniform(0, side, K)
            kps[:, 1] = y0 + rng.uniform(0, side, K)
            kps[:, 2] = np.where(rng.uniform(size=K) < 0.8, 2.0, 0.0)
            if unlabeled and g == 1:
                kps[:, 2] = 0.0
            gts.append(dict(keypoints=kps,
                            bbox=np.array([x0, y0, side, side], np.float32),
                            area=side * side * float(rng.uniform(0.5, 1.0)),
                            iscrowd=bool(crowd and g == 2)))
            for _ in range(int(rng.integers(0, 3))):
                jit = rng.normal(0, side * rng.uniform(0.01, 0.3), (K, 2))
                dk = kps.copy()
                dk[:, :2] += jit
                dk[:, 2] = rng.uniform(0.1, 1.0, K)
                dts.append(dict(keypoints=dk, bbox=np.array(
                    [x0 + jit[0, 0], y0 + jit[0, 1],
                     side * rng.uniform(0.7, 1.3),
                     side * rng.uniform(0.7, 1.3)], np.float32)))
        for _ in range(int(rng.integers(0, 3)) + extra_dets):
            dk = np.zeros((K, 3), np.float32)
            dk[:, :2] = rng.uniform(0, 500, (K, 2))
            dk[:, 2] = rng.uniform(0.1, 1.0, K)
            dts.append(dict(keypoints=dk, bbox=np.array(
                [*rng.uniform(0, 400, 2), *rng.uniform(10, 200, 2)],
                np.float32)))
        for dt in dts:
            score = float(rng.uniform(0.05, 1.0))
            dt['score'] = round(score, 1) if ties else score
        images.append((gts, dts))
    return images


def summarize(pkg, images, iou_type):
    ev = pkg.CocoEval(iou_type=iou_type, sigmas=SIGMAS, max_dets=20)
    for image_id, (gts, dts) in enumerate(images):
        ev.add_image(image_id, [pkg.DtInstance(**d) for d in dts],
                     [pkg.GtInstance(**g) for g in gts],
                     group='EMH'[image_id % 3])
    return ev.summarize()


def assert_same_results(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= TOL, key


@pytest.mark.parametrize('iou_type', ['keypoints', 'bbox'])
@pytest.mark.parametrize('features', sorted(FEATURES))
def test_cocoeval_matches_jax(iou_type, features):
    images = scene(sorted(FEATURES).index(features), **FEATURES[features])
    want = summarize(jax_metric, images, iou_type)
    got = summarize(metric, images, iou_type)
    assert_same_results(got, want)
    # the scenes are not trivial: some detections match
    assert want['AP0.5'] > 0.0


def gt_annotation(pkg, g):
    ann = pkg.Annotation(constants.COCO_KEYPOINTS,
                         constants.COCO_PERSON_SKELETON,
                         sigmas=constants.COCO_PERSON_SIGMAS)
    ann.data = g['keypoints'].copy()
    ann.fixed_bbox = g['bbox'].copy()
    if g['iscrowd']:
        ann.iscrowd = True
    return ann


def pred_annotation(pkg, d):
    ann = pkg.Annotation(constants.COCO_KEYPOINTS,
                         constants.COCO_PERSON_SKELETON,
                         sigmas=constants.COCO_PERSON_SIGMAS,
                         score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    ann.data[:] = d['keypoints']
    ann.joint_scales[:] = 4.0
    ann.fixed_score = d['score']
    return ann


@pytest.mark.parametrize('seed', [0, 1])
def test_coco_ground_truth_from_loader(seed, tmp_path):
    """``Coco(ground_truth_from_loader=True)`` with Annotation objects as
    the eval loader gives them; its predictions written as the JAX
    package writes them."""
    images = scene(seed, crowd=True, unlabeled=True, ties=True)
    results = {}
    for name, pkg, ann_pkg in (('jax', jax_metric, jax_annotation),
                               ('port', metric, annotation)):
        coco = pkg.Coco(ground_truth_from_loader=True,
                        keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS)
        for image_id, (gts, dts) in enumerate(images):
            coco.accumulate([pred_annotation(ann_pkg, d) for d in dts],
                            {'image_id': image_id},
                            ground_truth=[gt_annotation(ann_pkg, g)
                                          for g in gts])
        out = str(tmp_path / name)
        coco.write_predictions(out)
        with open(out + '.pred.json') as f:
            written = json.load(f)
        with zipfile.ZipFile(out + '.zip') as z:
            zipped = json.loads(z.read('predictions.json'))
        assert zipped == written
        results[name] = (coco.stats(), written)
    (want, want_json), (got, got_json) = results['jax'], results['port']
    assert got['text_labels'] == want['text_labels']
    assert got['n_images'] == want['n_images'] == len(images)
    np.testing.assert_allclose(got['stats'], want['stats'], atol=TOL, rtol=0)
    assert got_json == want_json
    assert want['stats'][0] > 0.0


def write_ann_file(path, images, seed):
    """A COCO keypoint json of ``images``; a category-2 annotation per
    image that ``category_ids=(1,)`` filters out; crowd indices."""
    rng = np.random.default_rng(seed)
    data = {'images': [], 'annotations': []}
    for image_id, (gts, _) in enumerate(images):
        data['images'].append({'id': image_id,
                               'crowdIndex': float(rng.uniform(0, 1))})
        other = [dict(gts[0], category_id=2)] if gts else []
        for g in gts + other:
            data['annotations'].append({
                'image_id': image_id,
                'category_id': g.get('category_id', 1),
                'keypoints': g['keypoints'].reshape(-1).tolist(),
                'bbox': g['bbox'].tolist(),
                'area': g['area'],
                'iscrowd': int(g['iscrowd']),
            })
    with open(path, 'w') as f:
        json.dump(data, f)


@pytest.mark.parametrize('crowd_index_groups', [False, True],
                         ids=['areas', 'crowd_index'])
@pytest.mark.parametrize('iou_type', ['keypoints', 'bbox'])
def test_coco_ann_file(tmp_path, iou_type, crowd_index_groups):
    images = scene(7, crowd=True, unlabeled=True, extra_dets=25)
    ann_file = str(tmp_path / 'gt.json')
    write_ann_file(ann_file, images, 7)
    stats = []
    for pkg in (jax_metric, metric):
        coco = pkg.Coco(ann_file=ann_file, iou_type=iou_type,
                        keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS,
                        crowd_index_groups=crowd_index_groups)
        for image_id, (_, dts) in enumerate(images):
            coco.accumulate(
                [{'keypoints': d['keypoints'].reshape(-1).tolist(),
                  'bbox': d['bbox'].tolist(), 'score': d['score'],
                  'category_id': 1} for d in dts],
                {'image_id': image_id})
        stats.append(coco.stats())
    want, got = stats
    assert got['text_labels'] == want['text_labels']
    assert len(got['stats']) == len(got['text_labels'])
    np.testing.assert_allclose(got['stats'], want['stats'], atol=TOL, rtol=0)
    assert want['stats'][1] > 0.0


# ------------------------------------------------------------ multi-scale
def random_annotations(pkg, rng, n, *, ties):
    """``n`` Annotations in original image coordinates: poses around a
    few centres (so some overlap by OKS), scores possibly tied."""
    anns = []
    centres = rng.uniform(50, 300, (3, 2))
    for _ in range(n):
        ann = pkg.Annotation(constants.COCO_KEYPOINTS,
                             constants.COCO_PERSON_SKELETON,
                             sigmas=constants.COCO_PERSON_SIGMAS,
                             score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
        c = centres[rng.integers(0, 3)]
        noise = rng.choice([1.0, 15.0], p=[0.7, 0.3])
        pose = np.asarray(constants.COCO_UPRIGHT_POSE)[:, :2]
        ann.data[:, :2] = (c + pose * 10
                           + rng.normal(0, noise, (K, 2)))
        ann.data[:, 2] = np.where(rng.uniform(size=K) < 0.85,
                                  rng.uniform(0.2, 1.0, K), 0.0)
        score = float(rng.uniform(0.1, 1.0))
        ann.fixed_score = round(score, 1) if ties else score
        anns.append(ann)
    return anns


@pytest.mark.parametrize('sigmas', ['coco', 'none'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_merge_annotations_matches_jax(seed, sigmas):
    rng_state = np.random.default_rng(seed).bit_generator.state
    lists = {}
    for name, pkg in (('jax', jax_annotation), ('port', annotation)):
        rng = np.random.default_rng()
        rng.bit_generator.state = rng_state
        lists[name] = [random_annotations(pkg, rng, int(n), ties=seed > 0)
                       for n in rng.integers(0, 8, 6)]
    sig = constants.COCO_PERSON_SIGMAS if sigmas == 'coco' else None
    want = jax_predictor.Predictor.merge_annotations(
        lists['jax'], sigmas=sig, reference_index=4)
    got = Predictor.merge_annotations(lists['port'], sigmas=sig,
                                      reference_index=4)
    flat_jax = [a for anns in lists['jax'] for a in anns]
    flat_port = [a for anns in lists['port'] for a in anns]
    assert [flat_port.index(a) for a in got] \
        == [flat_jax.index(a) for a in want]
    assert 0 < len(got) < len(flat_port)


class _Factors:
    """Stands in for a predictor: ``multiscale_variants`` reads only
    these class attributes."""

    def __init__(self, factors, hflip):
        self.long_edge = 641
        self.multi_scale_factors = factors
        self.multi_scale_hflip = hflip


@pytest.mark.parametrize('factors', [(0.75, 1.0, 1.25), (0.5, 1.0),
                                     (1.0,), (2.0, 0.25, 1.0, 1.0)])
@pytest.mark.parametrize('hflip', [True, False])
def test_multiscale_variants_match_jax(factors, hflip):
    for base in (None, 97, 161, 385, 641, 40):
        holder = _Factors(factors, hflip)
        want = jax_predictor.Predictor.multiscale_variants(holder, base)
        got = Predictor.multiscale_variants(holder, base)
        assert got == want
    assert Predictor.multiscale_variants(
        _Factors((0.75, 1.0, 1.25), True), 385) == (
        [(289, False), (289, True), (385, False), (385, True),
         (481, False), (481, True)], 4)


def test_hflip_map_and_oks_matrix_match_jax():
    for keypoints in (constants.COCO_KEYPOINTS,
                      ['l_eye', 'r_eye', 'nose', 'LeftHand', 'RightHand',
                       'L_foot', 'R_foot', 'hip_left', 'hip_right', 'left']):
        assert (transforms.hflip_map_from_keypoints(keypoints)
                == jax_hflip.hflip_map_from_keypoints(keypoints))
    assert (transforms.hflip_map_from_keypoints(constants.COCO_KEYPOINTS)
            == constants.HFLIP)
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 100, (4, K, 3)).astype(np.float32)
    b = rng.uniform(0, 100, (5, K, 3)).astype(np.float32)
    a[..., 2] = (a[..., 2] > 30).astype(np.float32)
    b[..., 2] = (b[..., 2] > 30).astype(np.float32)
    a[0, 1:, 2] = 0.0      # fewer than two visible joints: unit area
    b[1] = a[1]            # the same pose: OKS 1
    want = jax_pose_similarity.oks_matrix(a, b, SIGMAS)
    got = pose_similarity.oks_matrix(a, b, SIGMAS)
    np.testing.assert_array_equal(got, want)
    assert abs(got[1, 1] - 1.0) < 1e-6


def test_metric_modules_are_copies():
    """The port's metric modules are the JAX package's below their
    docstrings (the numpy code is copied, not imported)."""
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ('base.py', 'cocoeval.py', 'coco.py'):
        texts = []
        for pkg in ('openpifpaf_tpu', 'openpifpaf_tpu_torch'):
            with open(os.path.join(here, '..', pkg, 'metric', name)) as f:
                text = f.read()
            texts.append(text[text.index('"""', 3) + 3:])
        assert texts[0] == texts[1], name
