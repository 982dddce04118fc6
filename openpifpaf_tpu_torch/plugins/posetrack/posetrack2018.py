"""PoseTrack2018 data module: consecutive frame pairs of video sequences.

Port of ``openpifpaf_tpu/plugins/posetrack/posetrack2018.py``
(``:33-241``): one json per sequence (``images`` with ``frame_id``,
``annotations`` with ``track_id``), under ``data_root``.  Each sequence
gives its consecutive frame pairs in ``frame_id`` order, only those whose
current frame is annotated (``only_annotated``); the meta carries the
sequence's name as ``sequence_id``, so ``TrackingPose`` resets its tracks
at sequence boundaries and the CLEAR-MOT metric segments there.

Training runs one per-frame chain on both frames of a pair with the same
draws (``transforms.SyncPair``), with or without the augmentations
(hflip, a power-law rescale, a crop around the people), then the CIF, CAF
and TCAF encoders.  The augmentations draw from the dataset's generator,
seeded from the data module's ``seed`` (the JAX module's from unseeded
ones).  Eval rescales and pads both frames and keeps the current frame's
ground truth.  Frames are read by ``image_io.read_image``: the format by
content, without PIL.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from . import constants
from .pairs import tracking_head_metas
from ... import encoder, image_io, metric, transforms
from ...datasets import (DataModule, collate_tracking_images_anns_meta,
                         collate_tracking_images_targets_meta)


class PoseTrack2018Dataset(torch.utils.data.Dataset):
    """Consecutive-frame pairs from PoseTrack2018 sequence jsons."""

    def __init__(self, annotation_files, data_root: str, preprocess,
                 only_annotated: bool = True,
                 rng: np.random.Generator = None):
        self.preprocess = preprocess
        self.data_root = data_root
        self.rng = rng
        self.pairs = []  # (seq_id, fn_prev, fn_curr, anns_prev, anns_curr)
        for path in annotation_files:
            with open(path) as f:
                seq = json.load(f)
            seq_id = os.path.splitext(os.path.basename(path))[0]
            by_image = {}
            for ann in seq.get('annotations', []):
                by_image.setdefault(ann['image_id'], []).append(ann)
            images = sorted(seq.get('images', []),
                            key=lambda im: im.get('frame_id', im['id']))
            for prev, curr in zip(images, images[1:]):
                if only_annotated and curr['id'] not in by_image:
                    continue
                self.pairs.append((
                    seq_id, prev['file_name'], curr['file_name'],
                    by_image.get(prev['id'], []),
                    by_image.get(curr['id'], []),
                ))

    def __len__(self):
        return len(self.pairs)

    @staticmethod
    def _to_dicts(raw_anns):
        return [{
            'keypoints': np.asarray(raw['keypoints'],
                                    np.float32).reshape(-1, 3),
            'bbox': raw.get('bbox', [0.0, 0.0, 1.0, 1.0]),
            'iscrowd': raw.get('iscrowd', 0),
            'track_id': raw.get('track_id', -1),
            'category_id': raw.get('category_id', 1),
        } for raw in raw_anns]

    def read_image(self, file_name: str) -> torch.Tensor:
        """(3, H, W) float32 in uint8 levels."""
        array = image_io.read_image(os.path.join(self.data_root, file_name))
        return torch.from_numpy(array).permute(2, 0, 1).float()

    def __getitem__(self, index):
        seq_id, fn_prev, fn_curr, anns_prev, anns_curr = self.pairs[index]
        meta = {'dataset_index': index, 'file_name': fn_curr,
                'image_id': index, 'sequence_id': seq_id}
        return self.preprocess(
            [self.read_image(fn_prev), self.read_image(fn_curr)],
            [self._to_dicts(anns_prev), self._to_dicts(anns_curr)], meta)


class PairCompose:
    """The per-frame steps on each frame of a pair, then the pair steps.

    The per-frame steps run on each frame with its own draws; random
    augmentations that both frames must share go into a pair step,
    ``transforms.SyncPair`` (``posetrack2018.py:100-128``)."""

    def __init__(self, frame_steps, pair_steps):
        self.frame_steps = frame_steps
        self.pair_steps = pair_steps

    def __call__(self, images, anns_pair, meta):
        out_images, out_anns = [], []
        out_meta = dict(meta)
        for image, anns in zip(images, anns_pair):
            m = dict(meta)
            for step in self.frame_steps:
                image, anns, m = step(image, anns, m)
            out_images.append(image)
            out_anns.append(anns)
            out_meta = m
        result = (out_images, out_anns, out_meta)
        for step in self.pair_steps:
            result = step(*result)
        return result


def keep_current(images, anns_pair, meta):
    """Eval: both frames, the current frame's ground truth."""
    return images, anns_pair[1], meta


class PoseTrack2018(DataModule):
    data_root = 'data-posetrack2018'
    train_annotations = 'data-posetrack2018/annotations/train/*.json'
    val_annotations = 'data-posetrack2018/annotations/val/*.json'
    square_edge = 385
    augmentation = True

    def __init__(self):
        self.head_metas = tracking_head_metas(
            'posetrack2018',
            keypoints=constants.KEYPOINTS,
            sigmas=constants.SIGMAS,
            pose=constants.UPRIGHT_POSE,
            skeleton=constants.SKELETON)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('data module PoseTrack2018')
        group.add_argument('--posetrack2018-data-root', default=cls.data_root)
        group.add_argument('--posetrack2018-train-annotations',
                           default=cls.train_annotations)
        group.add_argument('--posetrack2018-val-annotations',
                           default=cls.val_annotations)
        group.add_argument('--posetrack2018-square-edge',
                           default=cls.square_edge, type=int)
        group.add_argument('--posetrack2018-no-augmentation',
                           dest='posetrack2018_augmentation',
                           default=cls.augmentation, action='store_false')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.data_root = args.posetrack2018_data_root
        cls.train_annotations = args.posetrack2018_train_annotations
        cls.val_annotations = args.posetrack2018_val_annotations
        cls.square_edge = args.posetrack2018_square_edge
        cls.augmentation = args.posetrack2018_augmentation

    @staticmethod
    def _annotation_files(pattern: str):
        files = sorted(glob.glob(pattern))
        if not files:
            raise FileNotFoundError(
                f'no PoseTrack annotation files match {pattern!r}')
        return files

    @staticmethod
    def _normalize():
        return transforms.NormalizeAnnotations(
            keypoints=constants.KEYPOINTS,
            skeleton=constants.SKELETON,
            sigmas=constants.SIGMAS)

    def _preprocess(self, rng: np.random.Generator):
        if self.augmentation:
            frame = transforms.Compose([
                self._normalize(),
                transforms.RandomApply(
                    transforms.HFlip(constants.KEYPOINTS, constants.HFLIP),
                    0.5, rng=rng),
                transforms.RescaleRelative((0.5, 1.5), power_law=True,
                                           rng=rng),
                transforms.Crop(self.square_edge, use_area_of_interest=True,
                                rng=rng),
                transforms.CenterPad(self.square_edge),
                transforms.TRAIN_TRANSFORM,
            ])
        else:
            frame = transforms.Compose([
                self._normalize(),
                transforms.RescaleAbsolute(self.square_edge),
                transforms.CenterPad(self.square_edge),
                transforms.TRAIN_TRANSFORM,
            ])
        return PairCompose([], [
            transforms.SyncPair(frame),   # the same draws for both frames
            encoder.TrackingEncoders(encoder.factory(self.head_metas)),
        ])

    def _eval_preprocess(self):
        return PairCompose([
            self._normalize(),
            transforms.RescaleAbsolute(self.square_edge),
            transforms.CenterPad(self.square_edge),
            transforms.EVAL_TRANSFORM,
        ], [keep_current])

    def _train_dataset(self, pattern: str, rng_seed: int):
        rng = np.random.default_rng(rng_seed)
        return PoseTrack2018Dataset(self._annotation_files(pattern),
                                    self.data_root, self._preprocess(rng),
                                    rng=rng)

    def train_loader(self):
        return self.loader(
            self._train_dataset(self.train_annotations, self.seed),
            shuffle=True, seed=self.seed,
            collate_fn=collate_tracking_images_targets_meta)

    def val_loader(self):
        return self.loader(
            self._train_dataset(self.val_annotations, self.seed + 1),
            shuffle=False, seed=self.seed + 1,
            collate_fn=collate_tracking_images_targets_meta)

    def eval_loader(self):
        return self.eval_batches(
            PoseTrack2018Dataset(self._annotation_files(self.val_annotations),
                                 self.data_root, self._eval_preprocess()),
            collate_fn=collate_tracking_images_anns_meta)

    def metrics(self):
        return [
            metric.Coco(ground_truth_from_loader=True,
                        keypoint_oks_sigmas=constants.SIGMAS),
            metric.PoseTrack(keypoint_oks_sigmas=constants.SIGMAS),
        ]
