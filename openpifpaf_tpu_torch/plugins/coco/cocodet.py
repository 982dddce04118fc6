"""CocoDet data module: COCO object detection (80 categories).

Port of ``openpifpaf_tpu/plugins/coco/cocodet.py`` (``CocoDet``): one
CifDet head over ``COCO_CATEGORIES``, the ``--cocodet-*`` flags with the
JAX package's defaults, the training chain (rescale, crop and pad, or
without augmentation rescale and pad) to ``square_edge`` 513, the eval
chain at ``eval_long_edge`` 641 and the COCO ``bbox`` metric.  The
annotations keep their box (``fixed_bbox``) and category; their keypoint
lists are empty.  The augmentations draw from one generator seeded from
the data module's ``seed``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import constants
from .cocokp import configure_val
from .dataset import CocoDataset
from ... import encoder, headmeta, metric, transforms
from ...datasets import DataModule


class CocoDet(DataModule):
    train_annotations = 'data-mscoco/annotations/instances_train2017.json'
    val_annotations = 'data-mscoco/annotations/instances_val2017.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-mscoco/images/train2017/'
    val_image_dir = 'data-mscoco/images/val2017/'
    eval_image_dir = val_image_dir

    square_edge = 513
    augmentation = True
    eval_long_edge = 641

    def __init__(self):
        cifdet = headmeta.CifDet('cifdet', 'cocodet',
                                 categories=constants.COCO_CATEGORIES)
        self.head_metas = [cifdet]

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('data module CocoDet')
        group.add_argument('--cocodet-train-annotations',
                           default=cls.train_annotations)
        group.add_argument('--cocodet-val-annotations',
                           default=cls.val_annotations)
        group.add_argument('--cocodet-train-image-dir',
                           default=cls.train_image_dir)
        group.add_argument('--cocodet-val-image-dir',
                           default=cls.val_image_dir)
        group.add_argument('--cocodet-square-edge', default=cls.square_edge,
                           type=int)
        group.add_argument('--cocodet-no-augmentation',
                           dest='cocodet_augmentation',
                           default=True, action='store_false')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.train_annotations = args.cocodet_train_annotations
        cls.train_image_dir = args.cocodet_train_image_dir
        configure_val(cls, args.cocodet_val_annotations,
                      args.cocodet_val_image_dir)
        cls.square_edge = args.cocodet_square_edge
        cls.augmentation = args.cocodet_augmentation

    @staticmethod
    def _normalize():
        return transforms.NormalizeAnnotations(
            keypoints=[], skeleton=[], categories=constants.COCO_CATEGORIES)

    def _preprocess(self, rng: np.random.Generator):
        steps = [self._normalize()]
        if self.augmentation:
            steps += [
                transforms.RescaleRelative((0.5, 2.0), power_law=True,
                                           rng=rng),
                transforms.Crop(self.square_edge, rng=rng),
                transforms.CenterPad(self.square_edge),
            ]
        else:
            steps += [
                transforms.RescaleAbsolute(self.square_edge),
                transforms.CenterPad(self.square_edge),
            ]
        steps += [
            transforms.TRAIN_TRANSFORM,
            encoder.Encoders(encoder.factory(self.head_metas)),
        ]
        return transforms.Compose(steps)

    def _eval_preprocess(self):
        return transforms.Compose([
            self._normalize(),
            transforms.RescaleAbsolute(self.eval_long_edge),
            transforms.CenterPad(self.eval_long_edge),
            transforms.EVAL_TRANSFORM,
        ])

    def _train_dataset(self, image_dir, ann_file, rng_seed):
        rng = np.random.default_rng(rng_seed)
        return CocoDataset(image_dir, ann_file,
                           preprocess=self._preprocess(rng),
                           annotation_filter=True, rng=rng)

    def train_loader(self):
        return self.loader(self._train_dataset(
            self.train_image_dir, self.train_annotations, self.seed),
            shuffle=True, seed=self.seed)

    def val_loader(self):
        return self.loader(self._train_dataset(
            self.val_image_dir, self.val_annotations, self.seed + 1),
            shuffle=False, seed=self.seed + 1)

    def eval_loader(self, *, long_edge=None, hflip=False):
        """The eval images at ``eval_long_edge``, with their boxes; one
        scale, unflipped (the JAX package's takes no variants)."""
        if long_edge not in (None, self.eval_long_edge) or hflip:
            raise ValueError('cocodet is evaluated at one scale, unflipped')
        return self.eval_batches(CocoDataset(
            self.eval_image_dir, self.eval_annotations,
            preprocess=self._eval_preprocess()))

    def metrics(self):
        have_file = os.path.exists(self.eval_annotations)
        return [metric.Coco(
            ann_file=self.eval_annotations if have_file else None,
            ground_truth_from_loader=not have_file,
            iou_type='bbox',
            category_ids=list(range(1, len(constants.COCO_CATEGORIES) + 1)))]
