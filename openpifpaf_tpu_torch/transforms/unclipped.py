"""Filters of clipped annotations.

Port of ``openpifpaf_tpu/transforms/unclipped.py``: ``UnclippedArea`` and
``UnclippedSides`` drop annotations whose in-frame part is too small after
a crop, so that heavily clipped instances make no misleading targets.
Crowd annotations are kept.
"""

from __future__ import annotations

from .base import Preprocess


def _box(ann):
    return ann.bbox() if callable(getattr(ann, 'bbox', None)) else \
        getattr(ann, 'bbox', None)


def _clipped_bbox_fraction(ann, width: float, height: float) -> float:
    bbox = _box(ann)
    if bbox is None:
        return 1.0
    x, y, w, h = [float(v) for v in bbox]
    if w <= 0 or h <= 0:
        return 0.0
    x0, y0 = max(0.0, x), max(0.0, y)
    x1, y1 = min(width, x + w), min(height, y + h)
    visible = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    return visible / (w * h)


class UnclippedArea(Preprocess):
    """Drop annotations with less than ``threshold`` of their box in the
    frame."""

    def __init__(self, *, threshold: float = 0.5):
        self.threshold = threshold

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        w, h = meta['width_height']
        kept = [ann for ann in anns
                if getattr(ann, 'iscrowd', False)
                or _clipped_bbox_fraction(ann, w, h) >= self.threshold]
        return image, kept, meta


class UnclippedSides(Preprocess):
    """Drop annotations clipped on more than ``max_clipped_sides`` sides
    (a side counts within ``margin`` px of the frame)."""

    def __init__(self, *, margin: float = 10.0, max_clipped_sides: int = 2):
        self.margin = margin
        self.max_clipped_sides = max_clipped_sides

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        w, h = meta['width_height']
        kept = []
        for ann in anns:
            bbox = _box(ann)
            if getattr(ann, 'iscrowd', False) or bbox is None:
                kept.append(ann)
                continue
            x, y, bw, bh = [float(v) for v in bbox]
            clipped = sum((
                x < self.margin,
                y < self.margin,
                x + bw > w - self.margin,
                y + bh > h - self.margin,
            ))
            if clipped <= self.max_clipped_sides:
                kept.append(ann)
        return image, kept, meta
