"""Horizontal flip with keypoint-name swapping.

Port of ``openpifpaf_tpu/transforms/hflip.py`` on (3, H, W) tensors
(box-only annotations mirror their box), with ``hflip_map_from_keypoints`` (the swap table multi-scale eval derives from
the head's keypoint names).
"""

from __future__ import annotations

import numpy as np

from .base import Preprocess, is_box_only


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


def hflip_map_from_keypoints(keypoints):
    """Derive a left/right swap table from keypoint names.

    Covers the naming conventions of the built-in plugins
    (``left_*``/``right_*``, ``*_left``/``*_right``, ``l_*``/``r_*``);
    names without a counterpart map to themselves (stay unswapped).
    """
    def swapped_name(name: str):
        for a, b in (('left', 'right'), ('Left', 'Right'), ('L_', 'R_'),
                     ('l_', 'r_')):
            if a in name:
                return name.replace(a, b)
            if b in name:
                return name.replace(b, a)
        return None

    table = {}
    names = set(keypoints)
    for name in keypoints:
        other = swapped_name(name)
        if other is not None and other in names:
            table[name] = other
    return table


def _mirror(bbox, w: int) -> np.ndarray:
    bb = np.array(bbox, np.float32)
    bb[0] = -(bb[0] + bb[2]) + (w - 1)
    return bb


class HFlip(Preprocess):
    def __init__(self, keypoints, hflip_map):
        self.swap = HorizontalSwap(keypoints, hflip_map)

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        w = image.shape[-1]
        image = image.flip(-1)
        for ann in anns:
            if is_box_only(ann):
                ann.bbox = _mirror(ann.bbox, w)
                continue
            ann.data[:, 0] = -ann.data[:, 0] + (w - 1)
            if len(ann.data) == len(self.swap.perm):
                ann.data = self.swap(ann.data)
            if ann.fixed_bbox is not None:
                ann.fixed_bbox = _mirror(ann.fixed_bbox, w)
        va = meta['valid_area']
        meta['valid_area'] = np.array(
            (w - 1 - (va[0] + va[2]), va[1], va[2], va[3]))
        meta['hflip'] = not meta['hflip']
        meta['horizontal_swap'] = self.swap
        return image, anns, meta
