"""Random crop with annotation-aware area selection.

Port of ``openpifpaf_tpu/transforms/crop.py`` (``Crop``) on (3, H, W)
tensors, drawing from the generator it is given.
"""

from __future__ import annotations

import numpy as np

from .base import Preprocess, translate_annotations


class Crop(Preprocess):
    def __init__(self, long_edge, *, rng: np.random.Generator,
                 use_area_of_interest=True):
        self.long_edge = long_edge
        self.use_area_of_interest = use_area_of_interest
        self.rng = rng

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        h, w = image.shape[-2:]
        if w <= self.long_edge and h <= self.long_edge:
            return image, anns, meta

        crop_w = min(w, self.long_edge)
        crop_h = min(h, self.long_edge)

        # bias the crop toward annotated regions
        if self.use_area_of_interest and anns:
            points = np.concatenate([
                ann.data[ann.data[:, 2] > 0, :2] for ann in anns
            ] + [np.zeros((0, 2), np.float32)])
        else:
            points = np.zeros((0, 2), np.float32)
        if len(points):
            center = points[self.rng.integers(len(points))]
            x0 = int(np.clip(center[0] - crop_w / 2, 0, w - crop_w))
            y0 = int(np.clip(center[1] - crop_h / 2, 0, h - crop_h))
            # jitter
            x0 = int(np.clip(x0 + self.rng.integers(-crop_w // 4, crop_w // 4 + 1),
                             0, w - crop_w))
            y0 = int(np.clip(y0 + self.rng.integers(-crop_h // 4, crop_h // 4 + 1),
                             0, h - crop_h))
        else:
            x0 = int(self.rng.integers(0, w - crop_w + 1))
            y0 = int(self.rng.integers(0, h - crop_h + 1))

        image = image[:, y0:y0 + crop_h, x0:x0 + crop_w]
        anns = translate_annotations(anns, -x0, -y0)
        meta['offset'] = meta['offset'] + np.array((x0, y0), float)
        va = meta['valid_area']
        new_x0 = max(0.0, va[0] - x0)
        new_y0 = max(0.0, va[1] - y0)
        new_x1 = min(crop_w - 1.0, va[0] + va[2] - x0)
        new_y1 = min(crop_h - 1.0, va[1] + va[3] - y0)
        meta['valid_area'] = np.array((new_x0, new_y0,
                                       max(0.0, new_x1 - new_x0),
                                       max(0.0, new_y1 - new_y0)))
        meta['width_height'] = np.array((crop_w, crop_h))
        return image, anns, meta
