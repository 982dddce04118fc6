"""Compose transforms sequentially (port of ``transforms/compose.py``)."""

from __future__ import annotations

from .base import Preprocess


class Compose(Preprocess):
    def __init__(self, transforms):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, image, anns, meta=None):
        meta = Preprocess.init_meta(image, meta)
        for t in self.transforms:
            image, anns, meta = t(image, anns, meta)
        return image, anns, meta
