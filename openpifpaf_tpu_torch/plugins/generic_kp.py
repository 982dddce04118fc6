"""Generic COCO-format keypoint data module.

Port of ``openpifpaf_tpu/plugins/generic_kp.py`` (``GenericKpDataModule``):
the shared structure of the ``crowdpose``, ``wholebody``, ``animal`` and
``apollo`` modules, each a CocoKp-shaped data module over COCO-format
annotation files with its own keypoint names, sigmas, skeleton, hflip
table and data paths.  Subclasses fill the class constants; the flag
group (``--<name>-train-annotations``, ``-val-annotations``,
``-train-image-dir``, ``-val-image-dir``, ``-square-edge``, ``-upsample``,
``-no-augmentation``) is generated from the slug.  The augmentations draw
from one generator seeded from the data module's ``seed``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import encoder, headmeta, metric, transforms
from ..datasets import DataModule
from .coco.cocokp import configure_val
from .coco.dataset import CocoDataset


class GenericKpDataModule(DataModule):
    """Subclass and set the class constants, then register."""

    # identity
    name: str = None                      # dataset slug, e.g. 'crowdpose'
    keypoints: List[str] = None
    sigmas: List[float] = None
    skeleton: List[Tuple[int, int]] = None
    hflip: Dict[str, str] = None
    upright_pose: np.ndarray = None
    score_weights: Optional[List[float]] = None
    categories: Sequence[int] = (1,)

    # data locations (COCO-format jsons)
    train_annotations: str = None
    val_annotations: str = None
    eval_annotations: str = None
    train_image_dir: str = None
    val_image_dir: str = None
    eval_image_dir: str = None

    # preprocessing
    square_edge = 385
    eval_long_edge = 641
    augmentation = True
    min_kp_anns = 1
    upsample_stride = 1

    def __init__(self):
        cif = headmeta.Cif('cif', self.name,
                           keypoints=self.keypoints,
                           sigmas=self.sigmas,
                           pose=self.upright_pose,
                           draw_skeleton=self.skeleton,
                           score_weights=self.score_weights)
        caf = headmeta.Caf('caf', self.name,
                           keypoints=self.keypoints,
                           sigmas=self.sigmas,
                           pose=self.upright_pose,
                           skeleton=self.skeleton)
        cif.upsample_stride = self.upsample_stride
        caf.upsample_stride = self.upsample_stride
        self.head_metas = [cif, caf]

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        if cls.name is None:
            return
        group = parser.add_argument_group(f'data module {cls.name}')
        for flag, default in (('train-annotations', cls.train_annotations),
                              ('val-annotations', cls.val_annotations),
                              ('train-image-dir', cls.train_image_dir),
                              ('val-image-dir', cls.val_image_dir)):
            group.add_argument(f'--{cls.name}-{flag}',
                               dest=f'{cls.name}_{flag.replace("-", "_")}',
                               default=default)
        group.add_argument(f'--{cls.name}-square-edge',
                           dest=f'{cls.name}_square_edge',
                           default=cls.square_edge, type=int)
        group.add_argument(f'--{cls.name}-upsample',
                           dest=f'{cls.name}_upsample',
                           default=cls.upsample_stride, type=int)
        group.add_argument(f'--{cls.name}-no-augmentation',
                           dest=f'{cls.name}_augmentation',
                           default=cls.augmentation, action='store_false')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        if cls.name is None:
            return
        cls.train_annotations = getattr(args, f'{cls.name}_train_annotations')
        cls.train_image_dir = getattr(args, f'{cls.name}_train_image_dir')
        configure_val(cls, getattr(args, f'{cls.name}_val_annotations'),
                      getattr(args, f'{cls.name}_val_image_dir'))
        cls.square_edge = getattr(args, f'{cls.name}_square_edge')
        cls.upsample_stride = getattr(args, f'{cls.name}_upsample')
        cls.augmentation = getattr(args, f'{cls.name}_augmentation')

    def _normalize(self):
        return transforms.NormalizeAnnotations(
            keypoints=self.keypoints, skeleton=self.skeleton,
            sigmas=self.sigmas, score_weights=self.score_weights)

    def _preprocess(self, rng: np.random.Generator):
        steps = [self._normalize(), transforms.AnnotationCopy()]
        if self.augmentation:
            if self.hflip:
                steps.append(transforms.RandomApply(
                    transforms.HFlip(self.keypoints, self.hflip), 0.5,
                    rng=rng))
            steps += [
                transforms.RescaleRelative((0.4, 2.0), power_law=True,
                                           rng=rng),
                transforms.Crop(self.square_edge, use_area_of_interest=True,
                                rng=rng),
                transforms.CenterPad(self.square_edge),
                transforms.MinSize(min_side=4.0),
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

    def _eval_preprocess(self, long_edge=None, hflip=False):
        long_edge = long_edge or self.eval_long_edge
        steps = [self._normalize()]
        if hflip:
            if not self.hflip:
                raise ValueError(f'{self.name}: no hflip table; '
                                 'use --no-multi-scale-hflip')
            steps.append(transforms.HFlip(self.keypoints, self.hflip))
        steps += [
            transforms.RescaleAbsolute(long_edge),
            transforms.CenterPad(long_edge),
            transforms.EVAL_TRANSFORM,
        ]
        return transforms.Compose(steps)

    def _train_dataset(self, image_dir, ann_file, rng_seed):
        rng = np.random.default_rng(rng_seed)
        return CocoDataset(image_dir, ann_file,
                           preprocess=self._preprocess(rng),
                           annotation_filter=True,
                           min_kp_anns=self.min_kp_anns,
                           category_ids=list(self.categories), rng=rng)

    def train_loader(self):
        return self.loader(self._train_dataset(
            self.train_image_dir, self.train_annotations, self.seed),
            shuffle=True, seed=self.seed)

    def val_loader(self):
        return self.loader(self._train_dataset(
            self.val_image_dir, self.val_annotations, self.seed + 1),
            shuffle=False, seed=self.seed + 1)

    def eval_loader(self, *, long_edge=None, hflip=False):
        return self.eval_batches(CocoDataset(
            self.eval_image_dir or self.val_image_dir,
            self.eval_annotations or self.val_annotations,
            preprocess=self._eval_preprocess(long_edge, hflip),
            annotation_filter=True,
            min_kp_anns=self.min_kp_anns,
            category_ids=list(self.categories)))

    def _ann_file(self):
        """The eval annotation file, where it exists."""
        ann_file = self.eval_annotations or self.val_annotations
        return ann_file if ann_file and os.path.exists(ann_file) else None

    def metrics(self):
        ann_file = self._ann_file()
        return [metric.Coco(
            ann_file=ann_file,
            ground_truth_from_loader=ann_file is None,
            iou_type='keypoints',
            keypoint_oks_sigmas=self.sigmas)]
