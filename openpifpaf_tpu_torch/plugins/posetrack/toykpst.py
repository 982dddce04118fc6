"""Synthetic tracking data module: toykp frame pairs with the CIF, CAF and
TCAF heads.

Port of ``openpifpaf_tpu/plugins/posetrack/toykpst.py`` (``:22-122``): the
toykp renders (``plugins/toykp``) become (previous, current) frame pairs
by a simulated camera pan (``transforms.ImageToTracking``, seeded 7 for
training, 8 for validation and 123 for eval, as in the JAX package), so
tracking trains and evaluates with no files from outside the repository.
The spatial augmentations draw from one generator seeded from the data
module's ``seed`` (the JAX module's draw from unseeded ones).  The eval
loader keeps the current frame's ground truth; ``metrics`` scores it with
the COCO keypoint metric and the CLEAR-MOT ``PoseTrack`` metric.
"""

from __future__ import annotations

import argparse

import numpy as np

from .pairs import PairEval, tracking_head_metas
from ..coco import constants
from ..toykp.datamodule import ToyKpDataset
from ... import encoder, metric, transforms
from ...datasets import (DataModule, collate_tracking_images_anns_meta,
                         collate_tracking_images_targets_meta)

# the seeds of ImageToTracking's generator per loader (toykpst.py:89-119)
PAIR_SEEDS = {'train': 7, 'val': 8, 'eval': 123}


class ToyKpSt(DataModule):
    n_images = 32
    n_val_images = 8
    image_size = 161
    max_shift = 12.0
    augmentation = True   # toykp's spatial augmentation: without it the 32
    # fixed renders are memorized

    def __init__(self):
        self.head_metas = tracking_head_metas(
            'toykpst',
            keypoints=constants.COCO_KEYPOINTS,
            sigmas=constants.COCO_PERSON_SIGMAS,
            pose=constants.COCO_UPRIGHT_POSE,
            skeleton=constants.COCO_PERSON_SKELETON,
            score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('data module ToyKpSt')
        group.add_argument('--toykpst-n-images', default=cls.n_images,
                           type=int)
        group.add_argument('--toykpst-image-size', default=cls.image_size,
                           type=int)
        group.add_argument('--toykpst-max-shift', default=cls.max_shift,
                           type=float)

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.n_images = args.toykpst_n_images
        cls.image_size = args.toykpst_image_size
        cls.max_shift = args.toykpst_max_shift

    @staticmethod
    def _normalize():
        return transforms.NormalizeAnnotations(
            keypoints=constants.COCO_KEYPOINTS,
            skeleton=constants.COCO_PERSON_SKELETON,
            sigmas=constants.COCO_PERSON_SIGMAS,
            score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)

    def preprocess(self, rng: np.random.Generator, pair_seed: int):
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
            transforms.ImageToTracking(max_shift_px=self.max_shift,
                                       seed=pair_seed),
            encoder.TrackingEncoders(encoder.factory(self.head_metas)),
        ]
        return transforms.Compose(steps)

    def _eval_preprocess(self):
        return transforms.Compose([
            self._normalize(),
            transforms.RescaleAbsolute(self.image_size),
            transforms.CenterPad(self.image_size),
            transforms.EVAL_TRANSFORM,
            PairEval(transforms.ImageToTracking(
                max_shift_px=self.max_shift, seed=PAIR_SEEDS['eval'])),
        ])

    def _loader(self, n_images: int, seed: int, split: str, rng_seed: int,
                shuffle: bool):
        rng = np.random.default_rng(rng_seed)
        dataset = ToyKpDataset(n_images, self.image_size,
                               self.preprocess(rng, PAIR_SEEDS[split]),
                               seed=seed, rng=rng)
        return self.loader(dataset, shuffle=shuffle, seed=rng_seed,
                           collate_fn=collate_tracking_images_targets_meta)

    def train_loader(self):
        return self._loader(self.n_images, 0, 'train', self.seed, True)

    def val_loader(self):
        return self._loader(self.n_val_images, 1000, 'val', self.seed + 1,
                            False)

    def eval_loader(self):
        """The ``n_val_images`` val images (seed 1000) as frame pairs, in
        interleaved batches, with the current frame's ground truth."""
        return self.eval_batches(
            ToyKpDataset(self.n_val_images, self.image_size,
                         self._eval_preprocess(), seed=1000),
            collate_fn=collate_tracking_images_anns_meta)

    def metrics(self):
        return [
            metric.Coco(ground_truth_from_loader=True,
                        keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS),
            metric.PoseTrack(
                keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS),
        ]
