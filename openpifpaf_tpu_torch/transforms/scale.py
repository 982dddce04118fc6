"""Rescaling transforms.

Port of ``RescaleAbsolute``, ``RescaleRelative`` and ``ScaleMix`` of
``openpifpaf_tpu/transforms/scale.py`` on (3, H, W) tensors, resized by
``eval.resize`` (PIL's bilinear within 1 grey level).  ``RescaleRelative``
draws from the generator it is given (the JAX one from an unseeded
``np.random.default_rng()``).
"""

from __future__ import annotations

import numpy as np

from .base import Preprocess, rescale_annotations
from .eval import rescale_meta, resize


def _rescale(image, anns, meta, target_wh):
    h, w = image.shape[-2:]
    tw, th = int(target_wh[0]), int(target_wh[1])
    if (tw, th) == (w, h):
        return image, anns, meta
    image = resize(image, tw, th)
    x_scale = (tw - 1) / (w - 1) if w > 1 else 1.0
    y_scale = (th - 1) / (h - 1) if h > 1 else 1.0
    anns = rescale_annotations(anns, x_scale, y_scale)
    return image, anns, rescale_meta(meta, x_scale, y_scale)


class RescaleAbsolute(Preprocess):
    """Rescale so the long edge equals ``long_edge`` (preserving aspect)."""

    def __init__(self, long_edge: int):
        self.long_edge = long_edge

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        h, w = image.shape[-2:]
        s = self.long_edge / max(w, h)
        return _rescale(image, anns, meta, (round(w * s), round(h * s)))


class RescaleRelative(Preprocess):
    """Rescale by a random factor in ``scale_range``."""

    def __init__(self, scale_range=(0.4, 2.0), *, rng: np.random.Generator,
                 power_law=True, stretch_range=None):
        self.scale_range = scale_range
        self.power_law = power_law
        self.stretch_range = stretch_range
        self.rng = rng

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        lo, hi = self.scale_range
        if self.power_law:
            log_s = self.rng.uniform(np.log2(lo), np.log2(hi))
            s = 2.0 ** log_s
        else:
            s = self.rng.uniform(lo, hi)
        sx = sy = s
        if self.stretch_range is not None:
            stretch = self.rng.uniform(*self.stretch_range)
            sx = s * np.sqrt(stretch)
            sy = s / np.sqrt(stretch)
        h, w = image.shape[-2:]
        return _rescale(image, anns, meta,
                        (max(2, round(w * sx)), max(2, round(h * sy))))


class ScaleMix(Preprocess):
    """Upscale images whose instances are all small, downscale those whose
    instances are all large (reference ``transforms/scale.py`` ScaleMix)."""

    def __init__(self, scale_threshold, *, upscale_factor=2.0,
                 downscale_factor=0.5):
        self.scale_threshold = scale_threshold
        self.upscale_factor = upscale_factor
        self.downscale_factor = downscale_factor

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        scales = []
        for ann in anns:
            if getattr(ann, 'iscrowd', False):
                continue
            m = ann.data[:, 2] > 0
            if m.sum() < 2:
                continue
            xy = ann.data[m, :2]
            scales.append(np.sqrt(
                max(1.0, (xy[:, 0].max() - xy[:, 0].min()))
                * max(1.0, (xy[:, 1].max() - xy[:, 1].min()))))
        if not scales:
            return image, anns, meta
        h, w = image.shape[-2:]
        if max(scales) < self.scale_threshold:
            factor = self.upscale_factor
        elif min(scales) > self.scale_threshold:
            factor = self.downscale_factor
        else:
            return image, anns, meta
        return _rescale(image, anns, meta,
                        (round(w * factor), round(h * factor)))
