"""Centre padding.

Port of ``CenterPad`` and ``CenterPadTight`` of
``openpifpaf_tpu/transforms/pad.py`` on (3, H, W) tensors, with the JAX
package's fill colour (``eval.pad``).
"""

from __future__ import annotations

import numpy as np

from .base import Preprocess, translate_annotations
from .eval import pad


def _pad(image, anns, meta, ltrb):
    left, top, right, bottom = ltrb
    if not any(ltrb):
        return image, anns, meta
    image = pad(image, left, top, right, bottom)
    anns = translate_annotations(anns, left, top)
    meta['offset'] = meta['offset'] - np.array((left, top), float)
    meta['valid_area'] = meta['valid_area'] + np.array(
        (left, top, 0.0, 0.0))
    meta['width_height'] = np.array((image.shape[2], image.shape[1]))
    return image, anns, meta


class CenterPad(Preprocess):
    def __init__(self, target_size):
        if isinstance(target_size, int):
            target_size = (target_size, target_size)
        self.target_size = target_size

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        h, w = image.shape[-2:]
        tw, th = self.target_size
        left = max(0, (tw - w) // 2)
        top = max(0, (th - h) // 2)
        right = max(0, tw - w - left)
        bottom = max(0, th - h - top)
        return _pad(image, anns, meta, (left, top, right, bottom))


class CenterPadTight(Preprocess):
    """Pad to the next multiple of ``multiple`` (plus 1), centred."""

    def __init__(self, multiple: int = 16):
        self.multiple = multiple

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        h, w = image.shape[-2:]
        tw = ((w - 1) // self.multiple + 1) * self.multiple + 1
        th = ((h - 1) // self.multiple + 1) * self.multiple + 1
        left = (tw - w) // 2
        top = (th - h) // 2
        return _pad(image, anns, meta,
                    (left, top, tw - w - left, th - h - top))
