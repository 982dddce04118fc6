"""Synthetic keypoint datamodule — the training and eval paths' workload.

Port of ``openpifpaf_tpu/plugins/toykp/datamodule.py`` (``ToyKpDataset``,
``ToyKp``): person-like keypoint constellations rendered as distinctive
blobs, with the full COCO CIF (17 × 5) and CAF (19 × 9) heads and, with
``--toykp-with-dense``, the dense ``caf25`` head (18 × 9, cocokp's), so
training and eval at full width need no download.  The eval loader (the
val images, seed 1000) takes multi-scale variants (``long_edge``,
``hflip``) and ``metrics`` scores it with the COCO keypoint metric.  The
crowd and WholeBody variants (``crowd.py``, ``toywb.py``) swap
``dataset_cls``.  ``ground_truth`` and ``render`` do the
same numpy arithmetic; the image is a (3, H, W) tensor in uint8 levels
instead of a PIL image.  The augmentations draw from one generator seeded
from the data module's ``seed``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ... import encoder, headmeta, metric, transforms
from ...datasets import DataModule
from ..coco import constants


class ToyKpDataset(torch.utils.data.Dataset):
    """Renders 1-3 synthetic 'people' per image.

    Each keypoint type gets a unique (deterministic) color so a small
    network can actually learn localization.  ``rng`` is the generator the
    preprocess draws from (reseeded per loader worker).
    """

    KEYPOINTS = constants.COCO_KEYPOINTS
    POSE = constants.COCO_UPRIGHT_POSE
    BLOB_VAR = 4.0     # rendered blob sigma^2, px^2

    def __init__(self, n_images: int, image_size: int, preprocess,
                 seed: int = 0, rng: np.random.Generator = None):
        self.n_images = n_images
        self.image_size = image_size
        self.preprocess = preprocess
        self.seed = seed
        self.rng = rng
        k = len(self.KEYPOINTS)
        self.n_keypoints = k
        self.colors = np.random.default_rng(12345).integers(64, 255, (k, 3))
        # rendering is deterministic per index; cache across epochs
        self._cache = {}

    def __len__(self):
        return self.n_images

    def ground_truth(self, index: int):
        rng = np.random.default_rng(self.seed + index)
        n_people = int(rng.integers(1, 3))
        size = self.image_size
        anns = []
        centers = []
        for _ in range(n_people):
            scale = rng.uniform(size / 18.0, size / 9.0)
            # separated instances: the additive renderer saturates where
            # blobs overlap, which destroys the keypoint signal itself
            for _attempt in range(10):
                cx = rng.uniform(min(3 * scale, size / 2),
                                 max(size - 3 * scale, size / 2))
                cy = rng.uniform(min(5 * scale, size / 2),
                                 max(size - 5 * scale, size / 2))
                if all(np.hypot(cx - px, cy - py) > 4.0 * scale
                       for px, py in centers):
                    break
            else:
                continue
            centers.append((cx, cy))
            pose = np.asarray(self.POSE, np.float32)
            kp = np.zeros((self.n_keypoints, 3), np.float32)
            kp[:, 0] = pose[:, 0] * scale / 3.0 + cx
            kp[:, 1] = (5.0 - pose[:, 1] / 2.0) * scale / 3.0 + cy
            kp[:, 2] = 2.0
            anns.append(kp)
        return anns

    def render(self, index: int, gt) -> np.ndarray:
        """(H, W, 3) uint8."""
        rng = np.random.default_rng(self.seed + index + 99)
        size = self.image_size
        img = rng.integers(0, 60, (size, size, 3)).astype(np.float32)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        for kp in gt:
            for f in range(self.n_keypoints):
                x, y, _ = kp[f]
                d2 = (xx - x) ** 2 + (yy - y) ** 2
                blob = np.exp(-0.5 * d2 / self.BLOB_VAR)
                img += blob[:, :, None] * self.colors[f][None, None, :]
        return np.clip(img, 0, 255).astype(np.uint8)

    def __getitem__(self, index: int):
        if index not in self._cache:
            gt = self.ground_truth(index)
            image = torch.from_numpy(self.render(index, gt)).permute(2, 0, 1)
            self._cache[index] = (gt, image.float())
        gt, image = self._cache[index]
        # copies: downstream transforms mutate keypoints in place and the
        # ground truth is cached across epochs
        anns = [{'keypoints': kp.copy(), 'iscrowd': 0,
                 'bbox': _bbox_from_kp(kp), 'category_id': 1}
                for kp in gt]
        meta = {'dataset_index': index,
                'image_id': index,
                'file_name': f'synthetic_{index}.jpg'}
        return self.preprocess(image, anns, meta)


def _bbox_from_kp(kp):
    x0, y0 = kp[:, 0].min(), kp[:, 1].min()
    return [float(x0), float(y0), float(kp[:, 0].max() - x0),
            float(kp[:, 1].max() - y0)]


def coco_head_metas():
    """The COCO person CIF and CAF heads of ``toykp``."""
    cif = headmeta.Cif('cif', 'toykp',
                       keypoints=constants.COCO_KEYPOINTS,
                       sigmas=constants.COCO_PERSON_SIGMAS,
                       pose=constants.COCO_UPRIGHT_POSE,
                       draw_skeleton=constants.COCO_PERSON_SKELETON,
                       score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    caf = headmeta.Caf('caf', 'toykp',
                       keypoints=constants.COCO_KEYPOINTS,
                       sigmas=constants.COCO_PERSON_SIGMAS,
                       pose=constants.COCO_UPRIGHT_POSE,
                       skeleton=constants.COCO_PERSON_SKELETON)
    return [cif, caf]


def dense_head_meta():
    """The dense ``caf25`` head of ``--toykp-with-dense``: cocokp's
    construction, over ``DENSER_COCO_PERSON_CONNECTIONS``."""
    return headmeta.Caf('caf25', 'toykp',
                        keypoints=constants.COCO_KEYPOINTS,
                        sigmas=constants.COCO_PERSON_SIGMAS,
                        pose=constants.COCO_UPRIGHT_POSE,
                        skeleton=constants.DENSER_COCO_PERSON_CONNECTIONS,
                        sparse_skeleton=constants.COCO_PERSON_SKELETON,
                        only_in_field_of_view=True)


class ToyKp(DataModule):
    n_images = 32
    n_val_images = 8
    image_size = 161
    augmentation = True
    with_dense = False    # add the caf25 dense head (cocokp parity)
    dataset_cls = ToyKpDataset    # the crowd and WholeBody variants swap it

    def __init__(self):
        self.head_metas = coco_head_metas()
        if self.with_dense:
            self.head_metas.append(dense_head_meta())

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('data module ToyKp')
        group.add_argument('--toykp-n-images', default=cls.n_images, type=int)
        group.add_argument('--toykp-image-size', default=cls.image_size,
                           type=int)
        group.add_argument('--toykp-no-augmentation', dest='toykp_augmentation',
                           default=cls.augmentation, action='store_false')
        group.add_argument('--toykp-with-dense', dest='toykp_with_dense',
                           default=cls.with_dense, action='store_true',
                           help='add the caf25-style dense head')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.n_images = args.toykp_n_images
        cls.image_size = args.toykp_image_size
        cls.augmentation = args.toykp_augmentation
        cls.with_dense = args.toykp_with_dense

    @staticmethod
    def _normalize():
        return transforms.NormalizeAnnotations(
            keypoints=constants.COCO_KEYPOINTS,
            skeleton=constants.COCO_PERSON_SKELETON,
            sigmas=constants.COCO_PERSON_SIGMAS,
            score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)

    def preprocess(self, rng: np.random.Generator):
        steps = [self._normalize()]
        if self.augmentation:
            steps += [
                transforms.RandomApply(
                    transforms.HFlip(constants.COCO_KEYPOINTS,
                                     constants.HFLIP), 0.5, rng=rng),
                transforms.RescaleRelative((0.8, 1.25), rng=rng),
                transforms.Crop(self.image_size, rng=rng),
                transforms.CenterPad(self.image_size),
            ]
        else:
            steps += [
                transforms.RescaleAbsolute(self.image_size),
                transforms.CenterPad(self.image_size),
            ]
        steps += [
            transforms.TRAIN_TRANSFORM,
            encoder.Encoders(encoder.factory(self.head_metas)),
        ]
        return transforms.Compose(steps)

    def _eval_preprocess(self, long_edge=None, hflip=False):
        long_edge = long_edge or self.image_size
        steps = [self._normalize()]
        if hflip:
            steps.append(transforms.HFlip(constants.COCO_KEYPOINTS,
                                          constants.HFLIP))
        steps += [
            transforms.RescaleAbsolute(long_edge),
            transforms.CenterPad(long_edge),
            transforms.EVAL_TRANSFORM,
        ]
        return transforms.Compose(steps)

    def _dataset(self, n_images: int, seed: int, rng_seed: int):
        rng = np.random.default_rng(rng_seed)
        return self.dataset_cls(n_images, self.image_size,
                                self.preprocess(rng), seed=seed, rng=rng)

    def train_loader(self):
        return self.loader(self._dataset(self.n_images, 0, self.seed),
                           shuffle=True, seed=self.seed)

    def val_loader(self):
        return self.loader(self._dataset(self.n_val_images, 1000,
                                         self.seed + 1),
                           shuffle=False, seed=self.seed + 1)

    def eval_loader(self, *, long_edge=None, hflip=False):
        """The ``n_val_images`` images of seed 1000 (the val set), rendered
        at ``image_size``, rescaled and padded to ``long_edge`` (default
        ``image_size``), mirrored with ``hflip``."""
        return self.eval_batches(self.dataset_cls(
            self.n_val_images, self.image_size,
            self._eval_preprocess(long_edge, hflip), seed=1000))

    def metrics(self):
        return [metric.Coco(
            ground_truth_from_loader=True,
            keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS)]
