"""ToyWb: a 133-keypoint WholeBody-topology synthetic training workload.

It trains real 133-keypoint, 129-edge fields in minutes, so the decoder's
budgets can be studied on trained fields and not only on painted ones
(reference decode surface: ``csrc/src/decoder/cifcaf.cpp:~140`` at
WholeBody scale, ``plugins/wholebody/constants.py`` topology).  The
keypoint names and skeleton are the WholeBody plugin's verbatim, but the
layout is a spread toy pose: the true WholeBody face and hand geometry has
0.02-pose-unit point spacing (below a pixel at any toy rendering scale, so
a literal layout cannot be learned); here face points form a grid above
the head and each hand a fan beside the body, with >= 0.45-unit spacing so
every blob is resolvable.  Uniform toy sigmas (0.05) replace the
WholeBody per-part sigmas for the same reason.  What this preserves is the
decode topology: 133 fields, 129 directed-edge pairs, the deep face and
hand chains hanging off single body joints, and the seed and CAF budget
pressure of 133 seeds per figure.

Port of ``openpifpaf_tpu/plugins/toykp/toywb.py``: the same pose, sigmas,
ground truth and head metas; the render is the port's toykp render
(numpy, no PIL), and the preprocess draws its augmentations from the data
module's seeded generator.
"""

from __future__ import annotations

import argparse

import numpy as np

from ... import encoder, headmeta, metric, transforms
from ..coco import constants as coco_constants
from ..wholebody import constants as wb
from .datamodule import ToyKp, ToyKpDataset


def toywb_pose() -> np.ndarray:
    """(133, 3) spread layout: COCO body + separated feet/face/hands."""
    pose = np.zeros((133, 3), np.float32)
    pose[:, 2] = 2.0
    pose[:17, :2] = np.asarray(coco_constants.COCO_UPRIGHT_POSE,
                               np.float32)[:, :2]

    # feet (17..22): toes fanned around each ankle (ankles at +-1.4, y 0.1)
    for side, ankle_x in ((0, -1.4), (1, 1.4)):
        for i in range(3):
            pose[17 + 3 * side + i, 0] = ankle_x + (i - 1) * 0.5
            pose[17 + 3 * side + i, 1] = -0.9

    # face (23..90): 68 points as a grid above the head (head top y ~9.7)
    face = np.arange(68)
    cols, rows = face % 9, face // 9
    pose[23:91, 0] = (cols - 4) * 0.48
    pose[23:91, 1] = 10.6 + rows * 0.5

    # hands (91..111 left, 112..132 right): 3x7 grids beside the wrists
    # (wrists at x ~ +-2.75, y ~4.5); left = negative x
    hand = np.arange(21)
    hcols, hrows = hand % 3, hand // 3
    for side, x0 in ((0, -5.6), (1, 3.8)):
        lo = 91 + 21 * side
        pose[lo:lo + 21, 0] = x0 + hcols * 0.9
        pose[lo:lo + 21, 1] = 1.6 + hrows * 0.75
    return pose


TOYWB_POSE = toywb_pose()
TOYWB_SIGMAS = [0.05] * 133


class ToyWbDataset(ToyKpDataset):
    KEYPOINTS = wb.KEYPOINTS
    POSE = TOYWB_POSE
    BLOB_VAR = 2.0    # tighter blobs: 133 points must stay resolvable

    # pose-unit bounds of TOYWB_POSE (x: hand fans, y: feet..face grid)
    Y_MAX = 14.1
    Y_SPAN = 15.0

    def ground_truth(self, index: int):
        """One full-frame figure, without y-compression.

        The ToyKp mapping (``kp_y = (5 - pose_y/2) * scale/3``) squeezes
        the 15-unit WholeBody spread pose into 2-4 px per unit at any usable
        image size, so the 0.5-unit face-grid spacing lands 1-3 px apart,
        below the resolution of stride 16, and the fields cannot be learned
        (trained confidences plateaued at ~0.4 with the JAX package).  Here
        one figure fills ~88% of the frame at ~size/17 px per pose unit:
        face rows are ~0.5 * size/17 px apart (9+ px at the 321 default) —
        resolvable blobs, learnable CIF/CAF targets, and the decode
        topology (133 fields, 129 directed edges, deep face and hand
        chains) is exactly preserved."""
        rng = np.random.default_rng(self.seed + index)
        size = self.image_size
        ppu = rng.uniform(size / 20.0, size / 17.0)
        cx = size / 2.0 + rng.uniform(-0.05, 0.05) * size
        top = rng.uniform(0.02, 0.08) * size
        pose = np.asarray(self.POSE, np.float32)
        kp = np.zeros((self.n_keypoints, 3), np.float32)
        kp[:, 0] = pose[:, 0] * ppu + cx
        kp[:, 1] = (self.Y_MAX - pose[:, 1]) * ppu + top
        kp[:, 2] = 2.0
        return [kp]


class ToyWb(ToyKp):
    """Datamodule: wholebody-topology head metas over the toy renderer."""

    n_images = 32
    n_val_images = 8
    image_size = 321
    augmentation = True
    dataset_cls = ToyWbDataset

    def __init__(self):
        cif = headmeta.Cif('cif', 'toywb',
                           keypoints=list(wb.KEYPOINTS),
                           sigmas=TOYWB_SIGMAS,
                           pose=TOYWB_POSE,
                           draw_skeleton=wb.SKELETON,
                           score_weights=[1.0] * 133)
        caf = headmeta.Caf('caf', 'toywb',
                           keypoints=list(wb.KEYPOINTS),
                           sigmas=TOYWB_SIGMAS,
                           pose=TOYWB_POSE,
                           skeleton=wb.SKELETON)
        self.head_metas = [cif, caf]

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('data module ToyWb')
        group.add_argument('--toywb-n-images', default=cls.n_images,
                           type=int)
        group.add_argument('--toywb-image-size', default=cls.image_size,
                           type=int)
        group.add_argument('--toywb-no-augmentation',
                           dest='toywb_augmentation',
                           default=cls.augmentation, action='store_false')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.n_images = args.toywb_n_images
        cls.image_size = args.toywb_image_size
        cls.augmentation = args.toywb_augmentation

    def _normalize(self):
        return transforms.NormalizeAnnotations(
            keypoints=list(wb.KEYPOINTS),
            skeleton=wb.SKELETON,
            sigmas=TOYWB_SIGMAS,
            score_weights=[1.0] * 133)

    def preprocess(self, rng: np.random.Generator):
        # no HFlip: the spread toy layout is not mirror-symmetric under
        # the wholebody HFLIP pairing (face grid placed by index, not by
        # mirror pairs), so flip augmentation would teach contradictory
        # layouts.  Scale/crop augmentation is kept.
        steps = [self._normalize()]
        if self.augmentation:
            steps += [
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
        if hflip:
            raise ValueError('toywb: hflip eval unsupported (layout is '
                             'not mirror-symmetric, see preprocess)')
        return transforms.Compose([
            self._normalize(),
            transforms.RescaleAbsolute(long_edge),
            transforms.CenterPad(long_edge),
            transforms.EVAL_TRANSFORM,
        ])

    def metrics(self):
        return [metric.Coco(
            ground_truth_from_loader=True,
            keypoint_oks_sigmas=np.asarray(TOYWB_SIGMAS, np.float32))]
