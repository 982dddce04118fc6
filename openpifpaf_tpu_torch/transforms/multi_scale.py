"""Multi-scale evaluation transform.

Port of ``openpifpaf_tpu/transforms/multi_scale.py``: at eval time one
sample becomes several rescaled (and, with a swap table, mirrored) copies,
each with its own meta, so that every copy's predictions map back to the
original image before they are merged.
"""

from __future__ import annotations

import copy

from .compose import Compose
from .hflip import HFlip
from .pad import CenterPad
from .base import Preprocess
from .scale import RescaleAbsolute


class MultiScale(Preprocess):
    """Expand one sample into N rescaled (image, anns, meta) samples."""

    def __init__(self, long_edges, *, pad_to=None, hflip_keypoints=None,
                 hflip_table=None):
        self.pipelines = []
        for long_edge in long_edges:
            self.pipelines.append(Compose([
                RescaleAbsolute(long_edge),
                CenterPad(max(long_edge, pad_to) if pad_to else long_edge),
            ]))
            if hflip_keypoints is not None and hflip_table is not None:
                self.pipelines.append(Compose([
                    HFlip(hflip_keypoints, hflip_table),
                    RescaleAbsolute(long_edge),
                    CenterPad(long_edge),
                ]))

    def __call__(self, image, anns, meta):
        images, anns_list, metas = [], [], []
        for pipeline in self.pipelines:
            im, an, me = pipeline(image, copy.deepcopy(anns),
                                  copy.deepcopy(meta))
            images.append(im)
            anns_list.append(an)
            metas.append(me)
        return images, anns_list, metas
