"""CocoKp data module: COCO person keypoints.

Port of ``openpifpaf_tpu/plugins/coco/cocokp.py`` (``CocoKp``): the CIF
(17 x 5) and CAF (19 x 9) heads, with ``--cocokp-with-dense`` the dense
``caf25`` head; every ``--cocokp-*`` flag and ``--coco-eval-long-edge``
with the JAX package's defaults; the augmentation chain in the JAX
package's order (normalize, copy, hflip, rescale, blur, the choice of
``RotateBy90`` and ``RotateUniform``, crop, pad, ``MinSize``, the tensor
boundary, the encoders), the chain without augmentation, the eval chain
(``long_edge``, ``hflip``), the loaders and the COCO keypoint metric, with
the annotation file as ground truth when it exists.  The augmentations draw
from one generator seeded from the data module's ``seed`` (the JAX ones
from unseeded generators).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import constants
from .dataset import CocoDataset
from ... import encoder, headmeta, metric, transforms
from ...datasets import DataModule


def configure_val(cls, annotations: str, image_dir: str) -> None:
    """Set the val files; the eval files follow them where they are the
    val files (the JAX package's ``configure`` leaves them at their
    defaults, so its eval reads the default paths whatever the flags
    say)."""
    if cls.eval_annotations == cls.val_annotations:
        cls.eval_annotations = annotations
    if cls.eval_image_dir == cls.val_image_dir:
        cls.eval_image_dir = image_dir
    cls.val_annotations = annotations
    cls.val_image_dir = image_dir


class CocoKp(DataModule):
    # data locations (reference defaults relative to data-mscoco)
    train_annotations = 'data-mscoco/annotations/person_keypoints_train2017.json'
    val_annotations = 'data-mscoco/annotations/person_keypoints_val2017.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-mscoco/images/train2017/'
    val_image_dir = 'data-mscoco/images/val2017/'
    eval_image_dir = val_image_dir

    square_edge = 385
    extended_scale = False
    orientation_invariant = 0.0
    blur = 0.0
    augmentation = True
    rescale_images = 1.0
    upsample_stride = 1
    min_kp_anns = 1
    bmin = 0.1

    eval_annotation_filter = True
    eval_long_edge = 641
    eval_orientation_invariant = 0.0
    eval_extended_scale = False
    with_dense = False    # add the caf25 dense-connection head

    def __init__(self):
        cif = headmeta.Cif('cif', 'cocokp',
                           keypoints=constants.COCO_KEYPOINTS,
                           sigmas=constants.COCO_PERSON_SIGMAS,
                           pose=constants.COCO_UPRIGHT_POSE,
                           draw_skeleton=constants.COCO_PERSON_SKELETON,
                           score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
        caf = headmeta.Caf('caf', 'cocokp',
                           keypoints=constants.COCO_KEYPOINTS,
                           sigmas=constants.COCO_PERSON_SIGMAS,
                           pose=constants.COCO_UPRIGHT_POSE,
                           skeleton=constants.COCO_PERSON_SKELETON)
        cif.upsample_stride = self.upsample_stride
        caf.upsample_stride = self.upsample_stride
        self.head_metas = [cif, caf]
        if self.with_dense:
            # auxiliary dense associations, decoded only with
            # --dense-connections
            caf25 = headmeta.Caf(
                'caf25', 'cocokp',
                keypoints=constants.COCO_KEYPOINTS,
                sigmas=constants.COCO_PERSON_SIGMAS,
                pose=constants.COCO_UPRIGHT_POSE,
                skeleton=constants.DENSER_COCO_PERSON_CONNECTIONS,
                sparse_skeleton=constants.COCO_PERSON_SKELETON,
                only_in_field_of_view=True)
            caf25.upsample_stride = self.upsample_stride
            self.head_metas.append(caf25)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('data module CocoKp')
        group.add_argument('--cocokp-train-annotations',
                           default=cls.train_annotations)
        group.add_argument('--cocokp-val-annotations',
                           default=cls.val_annotations)
        group.add_argument('--cocokp-train-image-dir',
                           default=cls.train_image_dir)
        group.add_argument('--cocokp-val-image-dir',
                           default=cls.val_image_dir)
        group.add_argument('--cocokp-square-edge', default=cls.square_edge,
                           type=int, help='square edge of input images')
        group.add_argument('--cocokp-extended-scale', default=False,
                           action='store_true',
                           help='augment with an extended scale range')
        group.add_argument('--cocokp-orientation-invariant',
                           default=cls.orientation_invariant, type=float,
                           help='augment with random orientations')
        group.add_argument('--cocokp-blur', default=cls.blur, type=float,
                           help='augment with blur')
        group.add_argument('--cocokp-no-augmentation',
                           dest='cocokp_augmentation',
                           default=True, action='store_false')
        group.add_argument('--cocokp-rescale-images',
                           default=cls.rescale_images, type=float)
        group.add_argument('--cocokp-upsample', default=cls.upsample_stride,
                           type=int, help='head upsample stride')
        group.add_argument('--cocokp-min-kp-anns', default=cls.min_kp_anns,
                           type=int)
        group.add_argument('--coco-eval-long-edge', default=cls.eval_long_edge,
                           type=int)
        group.add_argument('--cocokp-with-dense', dest='cocokp_with_dense',
                           default=cls.with_dense, action='store_true',
                           help='train the auxiliary dense caf25 head')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.train_annotations = args.cocokp_train_annotations
        cls.train_image_dir = args.cocokp_train_image_dir
        configure_val(cls, args.cocokp_val_annotations,
                      args.cocokp_val_image_dir)
        cls.square_edge = args.cocokp_square_edge
        cls.extended_scale = args.cocokp_extended_scale
        cls.orientation_invariant = args.cocokp_orientation_invariant
        cls.blur = args.cocokp_blur
        cls.augmentation = args.cocokp_augmentation
        cls.rescale_images = args.cocokp_rescale_images
        cls.upsample_stride = args.cocokp_upsample
        cls.min_kp_anns = args.cocokp_min_kp_anns
        cls.eval_long_edge = args.coco_eval_long_edge
        cls.with_dense = args.cocokp_with_dense

    @staticmethod
    def _normalize():
        return transforms.NormalizeAnnotations(
            keypoints=constants.COCO_KEYPOINTS,
            skeleton=constants.COCO_PERSON_SKELETON,
            sigmas=constants.COCO_PERSON_SIGMAS,
            score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)

    def _preprocess(self, rng: np.random.Generator):
        encoders = encoder.Encoders(encoder.factory(self.head_metas))
        if not self.augmentation:
            return transforms.Compose([
                self._normalize(),
                transforms.RescaleAbsolute(self.square_edge),
                transforms.CenterPad(self.square_edge),
                transforms.TRAIN_TRANSFORM,
                encoders,
            ])
        low = 0.25 if self.extended_scale else 0.4
        rescale_t = transforms.RescaleRelative(
            scale_range=(low * self.rescale_images,
                         2.0 * self.rescale_images),
            power_law=True, stretch_range=(0.75, 1.33), rng=rng)
        return transforms.Compose([
            self._normalize(),
            transforms.AnnotationCopy(),
            transforms.RandomApply(
                transforms.HFlip(constants.COCO_KEYPOINTS, constants.HFLIP),
                0.5, rng=rng),
            rescale_t,
            transforms.RandomApply(transforms.Blur(rng=rng), self.blur,
                                   rng=rng),
            transforms.RandomChoice(
                [transforms.RotateBy90(rng=rng),
                 transforms.RotateUniform(30.0, rng=rng)],
                [self.orientation_invariant, 0.4], rng=rng,
            ) if self.orientation_invariant else None,
            transforms.Crop(self.square_edge, use_area_of_interest=True,
                            rng=rng),
            transforms.CenterPad(self.square_edge),
            transforms.MinSize(min_side=4.0),
            transforms.TRAIN_TRANSFORM,
            encoders,
        ])

    def _eval_preprocess(self, long_edge=None, hflip=False):
        long_edge = long_edge or self.eval_long_edge
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

    def _train_dataset(self, image_dir, ann_file, rng_seed):
        rng = np.random.default_rng(rng_seed)
        return CocoDataset(image_dir, ann_file,
                           preprocess=self._preprocess(rng),
                           annotation_filter=True,
                           min_kp_anns=self.min_kp_anns, category_ids=[1],
                           rng=rng)

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
            self.eval_image_dir, self.eval_annotations,
            preprocess=self._eval_preprocess(long_edge, hflip),
            annotation_filter=self.eval_annotation_filter,
            min_kp_anns=self.min_kp_anns if self.eval_annotation_filter else 0,
            category_ids=[1]))

    def metrics(self):
        have_file = os.path.exists(self.eval_annotations)
        return [metric.Coco(
            ann_file=self.eval_annotations if have_file else None,
            ground_truth_from_loader=not have_file,
            iou_type='keypoints',
            keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS)]
