"""Annotation filter by size.

Port of ``openpifpaf_tpu/transforms/minsize.py`` (``MinSize``).
"""

from __future__ import annotations

from .base import Preprocess


class MinSize(Preprocess):
    """Drop annotations whose visible extent is below ``min_side`` px."""

    def __init__(self, min_side: float = 0.0):
        self.min_side = min_side

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        if self.min_side <= 0:
            return image, anns, meta
        out = []
        for ann in anns:
            m = ann.data[:, 2] > 0
            if m.sum() >= 2:
                xy = ann.data[m, :2]
                side = max(xy[:, 0].max() - xy[:, 0].min(),
                           xy[:, 1].max() - xy[:, 1].min())
                if side < self.min_side:
                    continue
            out.append(ann)
        return image, out, meta
