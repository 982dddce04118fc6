"""Preprocess base class and meta conventions.

Port of ``openpifpaf_tpu/transforms/preprocess.py`` (named ``base`` here:
``transforms.preprocess`` is the eval function the ``Predictor`` calls).  Every transform
implements ``__call__(image, anns, meta)`` and records enough in ``meta``
for predictions to be mapped back to original image coordinates
(``Annotation.inverse_transform``): ``x_original = (x_transformed +
offset) / scale``.  Images are (3, H, W) float32 tensors in uint8 levels
(PIL images in the JAX package) until ``ImageToTensor`` normalizes them.
"""

from __future__ import annotations

import copy
from typing import List

import numpy as np

from .eval import init_meta


class Preprocess:
    def __call__(self, image, anns, meta):
        raise NotImplementedError

    @staticmethod
    def init_meta(image, meta=None) -> dict:
        """``meta`` completed with the defaults for a (3, H, W) image (or
        an (H, W, 3) array); keys already present win, as in the JAX
        package."""
        meta = dict(meta) if meta else {}
        # an (H, W, 3) array is the JAX package's layout (``video.py``)
        h, w = (image.shape[:2] if isinstance(image, np.ndarray)
                else image.shape[-2:])
        defaults = init_meta(w, h)
        for key in ('offset', 'scale', 'rotation', 'valid_area', 'hflip',
                    'width_height'):
            meta.setdefault(key, defaults[key])
        # first init wins: the original canvas, for inverse transforms
        meta.setdefault('original_width_height', meta['width_height'])
        meta.setdefault('horizontal_swap', None)
        return meta


class AnnotationCopy(Preprocess):
    """Deep copies of the annotations, so that the transforms after it do
    not change the dataset's own."""

    def __call__(self, image, anns, meta):
        return image, copy.deepcopy(anns), meta


def is_box_only(ann) -> bool:
    """AnnotationDet and AnnotationCrowd carry a box and no keypoints."""
    return getattr(ann, 'data', None) is None


def rescale_annotations(anns: List, x_scale: float, y_scale: float):
    scale4 = np.array([x_scale, y_scale, x_scale, y_scale])
    for ann in anns:
        if is_box_only(ann):
            ann.bbox = np.asarray(ann.bbox, np.float32) * scale4
            continue
        ann.data[:, 0] *= x_scale
        ann.data[:, 1] *= y_scale
        ann.joint_scales *= (x_scale + y_scale) / 2.0
        if ann.fixed_bbox is not None:
            ann.fixed_bbox = np.asarray(ann.fixed_bbox, np.float32) * scale4
    return anns


def translate_annotations(anns: List, dx: float, dy: float):
    shift4 = np.array([dx, dy, 0.0, 0.0])
    for ann in anns:
        if is_box_only(ann):
            ann.bbox = np.asarray(ann.bbox, np.float32) + shift4
            continue
        ann.data[:, 0] += dx
        ann.data[:, 1] += dy
        if ann.fixed_bbox is not None:
            ann.fixed_bbox = np.asarray(ann.fixed_bbox, np.float32) + shift4
    return anns
