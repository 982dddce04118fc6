"""ToyCrowd: the crowded-overlap variant of the synthetic workload.

The toykp renderer forces separated instances (its additive blend
saturates where blobs overlap, destroying the keypoint signal), so its
trained fields never cover the one regime where scheduling drift is known
to cost: dense overlapping crowds.  This variant renders 4–9 clustered
people with ordered alpha compositing — people later in the list are
nearer and cleanly overwrite what is behind them — so overlap keeps a
learnable signal for the front figure while genuinely occluding the back
figure.  Back-figure joints hidden behind a front figure are marked
invisible (v=0), mirroring COCO annotation practice for occluded
keypoints.

Reference decode semantics this stresses:
``src/openpifpaf/csrc/src/decoder/cifcaf.cpp:~140`` (occupancy-ordered
seed consumption in crowds).

Port of ``openpifpaf_tpu/plugins/toykp/crowd.py``: the same ground truth
and occlusion rule; ``render`` returns the (H, W, 3) uint8 array that the
JAX version wraps in a PIL image.
"""

from __future__ import annotations

import argparse

import numpy as np

from .datamodule import ToyKp, ToyKpDataset


class ToyCrowdDataset(ToyKpDataset):
    """4-9 overlapping people per image, clustered; z-order = list order."""

    n_people_range = (4, 10)

    def ground_truth(self, index: int):
        rng = np.random.default_rng(self.seed + index)
        n_people = int(rng.integers(*self.n_people_range))
        size = self.image_size
        n_clusters = max(1, (n_people + 2) // 3)
        clusters = rng.uniform(size * 0.3, size * 0.7, (n_clusters, 2))
        anns = []
        for _ in range(n_people):
            scale = float(rng.uniform(size / 18.0, size / 9.0))
            cx, cy = clusters[int(rng.integers(n_clusters))]
            cx = float(np.clip(cx + rng.normal(0, 1.6 * scale),
                               1.2 * scale, size - 1.2 * scale))
            cy = float(np.clip(cy + rng.normal(0, 1.6 * scale),
                               2.0 * scale, size - 2.0 * scale))
            pose = np.asarray(self.POSE, np.float32)
            kp = np.zeros((self.n_keypoints, 3), np.float32)
            kp[:, 0] = pose[:, 0] * scale / 3.0 + cx
            kp[:, 1] = (5.0 - pose[:, 1] / 2.0) * scale / 3.0 + cy
            kp[:, 2] = 2.0
            anns.append(kp)

        # occlusion: a joint is invisible when a nearer (later) person's
        # figure covers it — same alpha model as the renderer (gaussian
        # blobs, sigma^2 = 4), threshold at alpha 0.5 <=> distance ~2.35px
        for i, kp in enumerate(anns):
            for j in range(i + 1, len(anns)):
                front = anns[j]
                d2 = ((kp[:, None, :2] - front[None, :, :2]) ** 2).sum(-1)
                alpha = np.exp(-0.5 * d2.min(axis=1) / 4.0)
                kp[:, 2] = np.where(alpha > 0.5, 0.0, kp[:, 2])

        # drop fully-hidden figures from BOTH ground truth and render
        return [kp for kp in anns if (kp[:, 2] > 0).sum() >= 2]

    def render(self, index: int, gt) -> np.ndarray:
        """(H, W, 3) uint8."""
        rng = np.random.default_rng(self.seed + index + 99)
        size = self.image_size
        img = rng.integers(0, 60, (size, size, 3)).astype(np.float32)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        for kp in gt:          # back to front; later people overwrite
            layer = np.zeros((size, size, 3), np.float32)
            alpha = np.zeros((size, size), np.float32)
            for f in range(self.n_keypoints):
                x, y, _ = kp[f]   # occluded joints still belong to the
                # figure: they are drawn, then covered by nearer figures
                d2 = (xx - x) ** 2 + (yy - y) ** 2
                blob = np.exp(-0.5 * d2 / 4.0)
                layer += blob[:, :, None] * self.colors[f][None, None, :]
                alpha = np.maximum(alpha, blob)
            img = img * (1.0 - alpha[:, :, None]) + layer
        return np.clip(img, 0, 255).astype(np.uint8)


class ToyCrowd(ToyKp):
    """Datamodule: toykp head metas over the crowded renderer."""

    n_images = 64
    n_val_images = 16
    image_size = 161
    augmentation = True
    dataset_cls = ToyCrowdDataset

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('data module ToyCrowd')
        group.add_argument('--toycrowd-n-images', default=cls.n_images,
                           type=int)
        group.add_argument('--toycrowd-image-size', default=cls.image_size,
                           type=int)
        group.add_argument('--toycrowd-no-augmentation',
                           dest='toycrowd_augmentation',
                           default=cls.augmentation, action='store_false')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.n_images = args.toycrowd_n_images
        cls.image_size = args.toycrowd_image_size
        cls.augmentation = args.toycrowd_augmentation
