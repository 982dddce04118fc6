"""CIFAR-10 as a CifDet data module.

Port of ``openpifpaf_tpu/plugins/cifar10/datamodule.py``.  Reference
parity: ``src/openpifpaf/plugins/cifar10/datamodule.py:~20``: each 32x32
image is one full-image box of its class, for a CifDet head with 10
categories and a PixelShuffle upsampling of 2 (a 5x5 field at stride 8 on
the image padded to 33 px).  The data are the standard CIFAR-10 python
batches under ``--cifar10-root`` when that directory holds them; otherwise
a deterministic synthetic stand-in (per-class colours and stripes), the
same numpy code from the same seeds as the JAX package's, so no download
is needed.  The image stays an (H, W, 3) uint8 array (no PIL) and enters
the transforms as a (3, H, W) tensor.  ``metrics`` is the COCO ``bbox``
metric on the eval loader's boxes.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ... import encoder, headmeta, metric, transforms
from ...datasets import DataModule

CATEGORIES = ['airplane', 'automobile', 'bird', 'cat', 'deer',
              'dog', 'frog', 'horse', 'ship', 'truck']
# images are padded from 32 to 33 px, so their size is 1 (mod stride) like
# every other data module's (the field grid, the PixelShuffle crop)
PADDED_SIZE = 33


def load_cifar_batches(root: str, train: bool):
    """Read the python-version CIFAR-10 batch files under ``root``."""
    batch_dir = os.path.join(root, 'cifar-10-batches-py')
    names = ([f'data_batch_{i}' for i in range(1, 6)] if train
             else ['test_batch'])
    images, labels = [], []
    for name in names:
        with open(os.path.join(batch_dir, name), 'rb') as f:
            batch = pickle.load(f, encoding='bytes')
        images.append(np.asarray(batch[b'data'], np.uint8)
                      .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.extend(int(label) for label in batch[b'labels'])
    return np.concatenate(images), np.asarray(labels, np.int64)


def synthetic_cifar(n_images: int, seed: int):
    """Deterministic per-class patterns, the stand-in without the data:
    (n, 32, 32, 3) uint8 images and their labels."""
    rng = np.random.default_rng(seed)
    class_rng = np.random.default_rng(4242)
    palette = class_rng.integers(40, 255, (len(CATEGORIES), 2, 3))
    labels = rng.integers(0, len(CATEGORIES), n_images)
    yy, xx = np.mgrid[0:32, 0:32]
    images = np.empty((n_images, 32, 32, 3), np.uint8)
    for i, label in enumerate(labels):
        bg, fg = palette[label]
        img = np.tile(bg[None, None, :], (32, 32, 1)).astype(np.float32)
        img += rng.normal(0.0, 12.0, (32, 32, 3))
        # class-specific pattern frequency
        phase = (label + 1) * (xx + 2 * yy) / 6.0
        img += (np.sin(phase)[:, :, None] * 0.5 + 0.5) * (fg - bg)[None, None]
        images[i] = np.clip(img, 0, 255).astype(np.uint8)
    return images, labels


class Cifar10Dataset(torch.utils.data.Dataset):
    def __init__(self, images: np.ndarray, labels: np.ndarray, preprocess):
        self.images = images
        self.labels = labels
        self.preprocess = preprocess

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, index):
        image = torch.from_numpy(self.images[index]).permute(2, 0, 1)
        h, w = image.shape[1:]
        anns = [{
            'bbox': [0.0, 0.0, float(w), float(h)],
            'category_id': int(self.labels[index]) + 1,
            'iscrowd': 0,
            'keypoints': np.zeros((0, 3), np.float32),
        }]
        meta = {'dataset_index': index, 'image_id': index,
                'file_name': f'cifar10_{index}.png'}
        return self.preprocess(image.float(), anns, meta)


def cifdet_head_meta() -> headmeta.CifDet:
    cifdet = headmeta.CifDet('cifdet', 'cifar10', categories=CATEGORIES)
    cifdet.upsample_stride = 2
    return cifdet


class Cifar10(DataModule):
    root = 'data-cifar10'
    n_synthetic = 64          # synthetic stand-in sizes
    n_synthetic_val = 16

    def __init__(self):
        self.head_metas = [cifdet_head_meta()]

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('data module Cifar10')
        group.add_argument('--cifar10-root', default=cls.root,
                           help='directory with cifar-10-batches-py/')
        group.add_argument('--cifar10-n-synthetic', default=cls.n_synthetic,
                           type=int,
                           help='synthetic dataset size when no real data')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.root = args.cifar10_root
        cls.n_synthetic = args.cifar10_n_synthetic

    # ------------------------------------------------------------------
    def _have_real_data(self) -> bool:
        return os.path.isdir(os.path.join(self.root, 'cifar-10-batches-py'))

    def data(self, train: bool):
        """(images, labels): the real batches, else the synthetic stand-in
        (seed 0 for training, 1 for validation and eval)."""
        if self._have_real_data():
            return load_cifar_batches(self.root, train)
        n = self.n_synthetic if train else self.n_synthetic_val
        return synthetic_cifar(n, seed=0 if train else 1)

    def _preprocess(self):
        return transforms.Compose([
            transforms.NormalizeAnnotations(keypoints=[], skeleton=[]),
            transforms.CenterPad(PADDED_SIZE),
            transforms.TRAIN_TRANSFORM,
            encoder.Encoders(encoder.factory(self.head_metas)),
        ])

    def _eval_preprocess(self):
        return transforms.Compose([
            transforms.NormalizeAnnotations(keypoints=[], skeleton=[]),
            transforms.CenterPad(PADDED_SIZE),
            transforms.EVAL_TRANSFORM,
        ])

    def train_loader(self):
        return self.loader(Cifar10Dataset(*self.data(train=True),
                                          self._preprocess()),
                           shuffle=True, seed=self.seed)

    def val_loader(self):
        return self.loader(Cifar10Dataset(*self.data(train=False),
                                          self._preprocess()),
                           shuffle=False, seed=self.seed + 1)

    def eval_loader(self, *, long_edge=None, hflip=False):
        """The validation images at 33 px, with their boxes; one scale,
        no flip (multi-scale eval is for keypoints)."""
        if long_edge not in (None, PADDED_SIZE) or hflip:
            raise ValueError('cifar10 is evaluated at one scale, unflipped')
        return self.eval_batches(Cifar10Dataset(*self.data(train=False),
                                                self._eval_preprocess()))

    def metrics(self):
        return [metric.Coco(
            ground_truth_from_loader=True,
            iou_type='bbox',
            category_ids=list(range(1, len(CATEGORIES) + 1)))]
