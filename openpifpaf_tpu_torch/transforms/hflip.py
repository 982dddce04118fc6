"""Horizontal flip with keypoint-name swapping.

Port of ``openpifpaf_tpu/transforms/hflip.py`` on (3, H, W) tensors.
"""

from __future__ import annotations

import numpy as np

from .base import Preprocess


class HorizontalSwap:
    """Reorders keypoint rows according to a left/right swap table."""

    def __init__(self, keypoints, hflip_map):
        self.perm = np.arange(len(keypoints))
        for i, name in enumerate(keypoints):
            swapped = hflip_map.get(name)
            if swapped is not None:
                self.perm[i] = keypoints.index(swapped)

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return data[self.perm]


class HFlip(Preprocess):
    def __init__(self, keypoints, hflip_map):
        self.swap = HorizontalSwap(keypoints, hflip_map)

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        w = image.shape[-1]
        image = image.flip(-1)
        for ann in anns:
            ann.data[:, 0] = -ann.data[:, 0] + (w - 1)
            if len(ann.data) == len(self.swap.perm):
                ann.data = self.swap(ann.data)
            if ann.fixed_bbox is not None:
                bb = np.asarray(ann.fixed_bbox, np.float32)
                bb[0] = -(bb[0] + bb[2]) + (w - 1)
                ann.fixed_bbox = bb
        va = meta['valid_area']
        meta['valid_area'] = np.array(
            (w - 1 - (va[0] + va[2]), va[1], va[2], va[3]))
        meta['hflip'] = not meta['hflip']
        meta['horizontal_swap'] = self.swap
        return image, anns, meta
