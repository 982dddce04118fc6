"""CifDet encoder: ground-truth boxes -> detection field targets.

Port copy of ``openpifpaf_tpu/encoder/cifdet.py``.  Reference parity:
``src/openpifpaf/encoder/cifdet.py``: per category, paint a
``side_length``² neighborhood of the box center with the confidence (1 in
the core), the offset to the center and the box size (w, h) in cells as a
second vector; the closer center wins a contested cell.  Crowd boxes are
masked out of the confidence loss.

Targets (numpy, for ``F`` categories on an ``H × W`` grid): ``conf`` (F, H,
W) f32, ``conf_mask`` (F, H, W) bool, ``vec`` (F, 2, 2, H, W) f32,
``vec_mask`` (F, 2, H, W) bool, and empty ``scale`` / ``scale_mask`` (F,
0, H, W).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .annrescaler import AnnRescaler
from .cif import field_shape
from .. import headmeta


@dataclasses.dataclass
class CifDetEncoder:
    meta: headmeta.CifDet
    side_length: int = 4

    def __call__(self, image, anns, meta_info=None) -> dict:
        f = self.meta.n_fields
        stride = self.meta.stride
        h, w = field_shape(image, stride)

        bg = AnnRescaler(stride).bg_mask(anns, (h, w))

        conf = np.zeros((f, h, w), np.float32)
        conf_mask = np.broadcast_to(bg, (f, h, w)).copy()
        vec = np.zeros((f, 2, 2, h, w), np.float32)
        vec_mask = np.zeros((f, 2, h, w), bool)
        scale = np.zeros((f, 0, h, w), np.float32)
        scale_mask = np.zeros((f, 0, h, w), bool)
        closest = np.full((f, h, w), np.inf, np.float32)

        s_l = self.side_length
        offset = (s_l - 1) / 2.0

        for ann in anns:
            if getattr(ann, 'iscrowd', False):
                continue
            bbox = getattr(ann, 'bbox', None)
            category_id = getattr(ann, 'category_id', 1)
            if callable(bbox):
                bbox = bbox()
            if bbox is None or category_id is None:
                continue
            fi = category_id - 1
            if not 0 <= fi < f:
                continue
            bx, by, bw, bh = np.asarray(bbox, np.float32) / stride
            cx, cy = bx + bw / 2.0, by + bh / 2.0
            i0 = int(np.round(cx - offset))
            j0 = int(np.round(cy - offset))
            for j in range(max(0, j0), min(h, j0 + s_l)):
                for i in range(max(0, i0), min(w, i0 + s_l)):
                    d2 = (cx - i) ** 2 + (cy - j) ** 2
                    if d2 >= closest[fi, j, i]:
                        continue
                    closest[fi, j, i] = d2
                    if abs(cx - i) < 1.0 and abs(cy - j) < 1.0:
                        conf[fi, j, i] = 1.0
                    conf_mask[fi, j, i] = True
                    vec[fi, 0, 0, j, i] = cx - i
                    vec[fi, 0, 1, j, i] = cy - j
                    vec[fi, 1, 0, j, i] = bw
                    vec[fi, 1, 1, j, i] = bh
                    vec_mask[fi, :, j, i] = True

        return {
            'conf': conf, 'conf_mask': conf_mask,
            'vec': vec, 'vec_mask': vec_mask,
            'scale': scale, 'scale_mask': scale_mask,
        }
