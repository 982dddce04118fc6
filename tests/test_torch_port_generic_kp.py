"""The COCO-format keypoint modules built on ``generic_kp`` against the JAX
package: crowdpose, wholebody, animal and apollo.

For each: the head metas and the hflip table, the flags generated from the
slug (names and defaults), and one training sample without augmentation
and one eval sample on a synthesized tree (``chip_smoke.write_coco_tree``'s
images; crowdpose's own json with 14 keypoints and a crowd index per
image, the others' jsons with their keypoint counts drawn inside each
person's box), at the tolerances of ``test_torch_port_coco.py``.
crowdpose's metric reads the crowd index bands from the file: the same
APE/APM/APH stats on the same predictions.  Every name the JAX registry
holds, but ``cocokpst`` and ``posetrack2018``, is in the port's.
"""

import argparse
import json

import numpy as np
import pytest

import chip_smoke
from openpifpaf_tpu import annotation as jax_annotation
from openpifpaf_tpu import datasets as jax_datasets
from openpifpaf_tpu import plugin as jax_plugin
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.plugins.animalpose import AnimalPose as JaxAnimal
from openpifpaf_tpu.plugins.apollocar3d import ApolloCar3D as JaxApollo
from openpifpaf_tpu.plugins.coco.dataset import CocoDataset as JaxCocoDataset
from openpifpaf_tpu.plugins.crowdpose import CrowdPose as JaxCrowdPose
from openpifpaf_tpu.plugins.wholebody import WholeBody as JaxWholeBody
from openpifpaf_tpu_torch import annotation, datasets, plugins, transforms
from openpifpaf_tpu_torch.plugins.animalpose import AnimalPose
from openpifpaf_tpu_torch.plugins.apollocar3d import ApolloCar3D
from openpifpaf_tpu_torch.plugins.crowdpose import CrowdPose
from openpifpaf_tpu_torch.plugins.wholebody import WholeBody

from test_torch_port_coco import (NORMALIZED_LEVEL, assert_images_close,
                                  assert_meta_close, numpy_encoders,
                                  parser_defaults, with_stride)
from test_torch_port_encoder import assert_targets_equal

SIZES = ((129, 97), (97, 129)) * 3
SQUARE_EDGE = 65
LONG_EDGE = 81
PAIRS = {'crowdpose': (JaxCrowdPose, CrowdPose),
         'wholebody': (JaxWholeBody, WholeBody),
         'animal': (JaxAnimal, AnimalPose),
         'apollo': (JaxApollo, ApolloCar3D)}


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """The tree's images with a json per module: crowdpose's own, the
    others with their keypoint count drawn inside each person's box."""
    root = tmp_path_factory.mktemp('generic_kp')
    paths = chip_smoke.write_coco_tree(str(root), sizes=SIZES, seed=1)
    with open(paths['person_keypoints']) as f:
        coco = json.load(f)
    rng = np.random.default_rng(0)
    for name in ('wholebody', 'animal', 'apollo'):
        n = len(PAIRS[name][1].keypoints)
        anns = []
        for ann in coco['annotations']:
            ann = dict(ann)
            if not ann['iscrowd'] and ann['num_keypoints']:
                x, y, w, h = ann['bbox']
                kps = np.stack([rng.uniform(x, x + w, n),
                                rng.uniform(y, y + h, n),
                                rng.choice([0.0, 1.0, 2.0], n,
                                           p=[0.2, 0.1, 0.7])], 1)
                kps[kps[:, 2] == 0, :2] = 0.0
                ann['keypoints'] = [round(float(v), 2)
                                    for v in kps.reshape(-1)]
                ann['num_keypoints'] = int((kps[:, 2] > 0).sum())
            else:
                ann['keypoints'] = [0] * (3 * n)
                ann['num_keypoints'] = 0
            anns.append(ann)
        paths[name] = str(root / f'{name}.json')
        with open(paths[name], 'w') as f:
            json.dump(dict(coco, annotations=anns), f)
    return paths


def configure(monkeypatch, tree, name, **attrs):
    for cls in PAIRS[name]:
        for key in ('train', 'val', 'eval'):
            monkeypatch.setattr(cls, f'{key}_annotations', tree[name])
            monkeypatch.setattr(cls, f'{key}_image_dir', tree['images'])
        for key, value in attrs.items():
            monkeypatch.setattr(cls, key, value)


@pytest.mark.parametrize('name', list(PAIRS))
def test_head_metas_hflip_and_flags(name):
    jax_cls, cls = PAIRS[name]
    for want, got in zip(jax_cls().head_metas, cls().head_metas):
        assert type(got).__name__ == type(want).__name__
        for key in ('name', 'dataset', 'keypoints', 'sigmas', 'skeleton',
                    'draw_skeleton', 'score_weights', 'upsample_stride',
                    'n_fields'):
            assert getattr(got, key, None) == getattr(want, key, None), key
        np.testing.assert_array_equal(got.pose, want.pose)
    assert cls.hflip == jax_cls.hflip
    np.testing.assert_array_equal(
        transforms.HFlip(cls.keypoints, cls.hflip).swap.perm,
        jax_transforms.HFlip(jax_cls.keypoints, jax_cls.hflip).swap.perm)
    assert parser_defaults(cls) == parser_defaults(jax_cls)
    assert len(parser_defaults(cls)) == 7
    for key in ('train_annotations', 'val_annotations', 'eval_annotations',
                'train_image_dir', 'val_image_dir', 'eval_image_dir',
                'square_edge', 'eval_long_edge', 'min_kp_anns',
                'categories'):
        assert getattr(cls, key) == getattr(jax_cls, key), key


@pytest.mark.parametrize('name', list(PAIRS))
def test_train_and_eval_samples(tree, monkeypatch, name):
    configure(monkeypatch, tree, name, square_edge=SQUARE_EDGE,
              eval_long_edge=LONG_EDGE, augmentation=False)
    jax_cls, cls = PAIRS[name]
    jax_dm, dm = with_stride(jax_cls()), with_stride(cls())
    steps = jax_dm._preprocess().transforms[:-1]  # pylint: disable=protected-access
    ours = JaxCocoDataset(
        tree['images'], tree[name],
        preprocess=jax_transforms.Compose(
            steps + [numpy_encoders(jax_dm.head_metas)]),
        annotation_filter=True, min_kp_anns=1, category_ids=[1])
    port = dm.train_loader().dataset
    assert port.ids == ours.ids and len(port) >= 2
    (want_image, want_targets, want_meta), (image, targets, meta) = \
        ours[1], port[1]
    assert_images_close(image, want_image, NORMALIZED_LEVEL)
    for want, got in zip(want_targets, targets):
        assert_targets_equal(want, got)
    assert targets[1]['vec_mask'].any()
    assert_meta_close(want_meta, meta)

    ours = jax_dm.eval_loader(hflip=True).dataset
    port = dm.eval_loader(hflip=True).dataset
    assert port.ids == ours.ids
    (want_image, want_anns, want_meta), (image, anns, meta) = \
        ours[0], port[0]
    assert image.shape[1:] == (LONG_EDGE, LONG_EDGE)
    assert_images_close(image, want_image, NORMALIZED_LEVEL)
    assert len(anns) == len(want_anns)
    for a, b in zip(want_anns, anns):
        np.testing.assert_allclose(b.data, a.data, atol=1e-4)
    assert_meta_close(want_meta, meta)


def test_crowdpose_bands(tree, monkeypatch):
    """AP by crowd-index band from the file's ``crowdIndex``: the nine
    crowdposetools stats of both packages on the same predictions."""
    configure(monkeypatch, tree, 'crowdpose')
    with open(tree['crowdpose']) as f:
        data = json.load(f)
    results = []
    for cls, pkg in zip(PAIRS['crowdpose'], (jax_annotation, annotation)):
        metric, = cls().metrics()
        assert metric.crowd_index_groups
        rng = np.random.default_rng(5)
        for image in data['images']:
            preds = []
            for raw in data['annotations']:
                kps = np.asarray(raw['keypoints'], np.float32).reshape(-1, 3)
                if raw['image_id'] != image['id'] or raw['iscrowd'] \
                        or not (kps[:, 2] > 0).any():
                    continue
                ann = pkg.Annotation(cls.keypoints, cls.skeleton)
                ann.data[:, :2] = kps[:, :2] + rng.normal(0.0, 0.5, 2)
                ann.data[:, 2] = np.where(kps[:, 2] > 0, 0.9, 0.0)
                preds.append(ann)
            metric.accumulate(preds, {'image_id': image['id']})
        results.append(metric.stats())
    want, got = results
    assert got['text_labels'] == want['text_labels'] == \
        ['AP', 'AP0.5', 'AP0.75', 'APE', 'APM', 'APH', 'AR', 'AR0.5', 'AR0.75']
    np.testing.assert_allclose(got['stats'], want['stats'], atol=1e-6)
    assert sum(v >= 0 for v in got['stats'][3:6]) >= 2


def test_registry_covers_the_jax_data_modules():
    jax_plugin.register()
    plugins.register()
    missing = set(jax_datasets.DATAMODULES) - set(datasets.DATAMODULES)
    assert missing == set()
    for name in ('cocokp', 'cocodet', 'crowdpose', 'wholebody', 'animal',
                 'apollo', 'cocokpst', 'posetrack2018'):
        assert name in datasets.DATAMODULES
    parser = argparse.ArgumentParser()
    datasets.cli(parser)     # every module's flags in one parser
    parser.parse_args([])
