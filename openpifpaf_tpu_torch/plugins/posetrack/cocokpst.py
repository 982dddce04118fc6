"""CocoKpSt data module: COCO person keypoints as pseudo-tracking pairs.

Port of ``openpifpaf_tpu/plugins/posetrack/cocokpst.py`` (``:55-143``):
each COCO image of the ``cocokp`` files (``CocoKp``'s class attributes,
set by the ``--cocokp-*`` flags) is rescaled to ``square_edge``, padded,
and becomes a (previous, current) frame pair by a simulated camera pan
(``transforms.ImageToTracking``, at most ``max_shift`` px), with the CIF,
CAF and TCAF heads.  The eval loader keeps the current frame's ground
truth (``PairEval``, its pan seeded 123 as in the JAX package); the
metrics are the COCO keypoint metric and the CLEAR-MOT ``PoseTrack``
metric.  The training pan draws from the dataset's generator, seeded from
the data module's ``seed`` (the JAX module's from an unseeded one).
"""

from __future__ import annotations

import argparse

import numpy as np

from .pairs import PairEval, tracking_head_metas
from ..coco import constants
from ..coco.cocokp import CocoKp
from ..coco.dataset import CocoDataset
from ... import encoder, metric, transforms
from ...datasets import (DataModule, collate_tracking_images_anns_meta,
                         collate_tracking_images_targets_meta)

# the seed of the eval loader's pan (cocokpst.py:111)
EVAL_PAIR_SEED = 123


class CocoKpSt(DataModule):
    square_edge = 385
    max_shift = 30.0

    def __init__(self):
        self.head_metas = tracking_head_metas(
            'cocokpst',
            keypoints=constants.COCO_KEYPOINTS,
            sigmas=constants.COCO_PERSON_SIGMAS,
            pose=constants.COCO_UPRIGHT_POSE,
            skeleton=constants.COCO_PERSON_SKELETON,
            score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('data module CocoKpSt')
        group.add_argument('--cocokpst-square-edge', default=cls.square_edge,
                           type=int)
        group.add_argument('--cocokpst-max-shift', default=cls.max_shift,
                           type=float, help='simulated camera shift in px')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.square_edge = args.cocokpst_square_edge
        cls.max_shift = args.cocokpst_max_shift

    @staticmethod
    def _normalize():
        return transforms.NormalizeAnnotations(
            keypoints=constants.COCO_KEYPOINTS,
            skeleton=constants.COCO_PERSON_SKELETON,
            sigmas=constants.COCO_PERSON_SIGMAS,
            score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)

    def _preprocess(self, rng: np.random.Generator):
        return transforms.Compose([
            self._normalize(),
            transforms.RescaleAbsolute(self.square_edge),
            transforms.CenterPad(self.square_edge),
            transforms.TRAIN_TRANSFORM,
            # default_rng(rng) is rng itself: the pan draws from the
            # dataset's generator, which loader workers reseed
            transforms.ImageToTracking(max_shift_px=self.max_shift, seed=rng),
            encoder.TrackingEncoders(encoder.factory(self.head_metas)),
        ])

    def _eval_preprocess(self):
        return transforms.Compose([
            self._normalize(),
            transforms.RescaleAbsolute(self.square_edge),
            transforms.CenterPad(self.square_edge),
            transforms.EVAL_TRANSFORM,
            PairEval(transforms.ImageToTracking(max_shift_px=self.max_shift,
                                                seed=EVAL_PAIR_SEED)),
        ])

    def _train_dataset(self, image_dir, ann_file, rng_seed):
        rng = np.random.default_rng(rng_seed)
        return CocoDataset(image_dir, ann_file,
                           preprocess=self._preprocess(rng),
                           annotation_filter=True, min_kp_anns=1,
                           category_ids=[1], rng=rng)

    def train_loader(self):
        return self.loader(
            self._train_dataset(CocoKp.train_image_dir,
                                CocoKp.train_annotations, self.seed),
            shuffle=True, seed=self.seed,
            collate_fn=collate_tracking_images_targets_meta)

    def val_loader(self):
        return self.loader(
            self._train_dataset(CocoKp.val_image_dir, CocoKp.val_annotations,
                                self.seed + 1),
            shuffle=False, seed=self.seed + 1,
            collate_fn=collate_tracking_images_targets_meta)

    def eval_loader(self):
        return self.eval_batches(
            CocoDataset(CocoKp.eval_image_dir, CocoKp.eval_annotations,
                        preprocess=self._eval_preprocess(),
                        annotation_filter=True, min_kp_anns=1,
                        category_ids=[1]),
            collate_fn=collate_tracking_images_anns_meta)

    def metrics(self):
        return [
            metric.Coco(ground_truth_from_loader=True,
                        keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS),
            metric.PoseTrack(
                keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS),
        ]
