"""TCAF encoder: temporal association targets across a frame pair.

Port copy of ``openpifpaf_tpu/encoder/tcaf.py`` (``:20-106``), numpy only.
Reference parity: ``src/openpifpaf/encoder/tcaf.py:~30`` — for every track
present in both frames, paint the segment between a keypoint's position in
frame t-1 and its position in frame t with two offset vectors (one per
frame) and the two scales; one field per keypoint type.  Images are the
port's (3, H, W) tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .annrescaler import AnnRescaler
from .cif import field_shape
from .. import headmeta


@dataclasses.dataclass
class TcafEncoder:
    meta: headmeta.Tcaf
    min_size: int = 2
    v_threshold: int = 0

    def __call__(self, image, anns, meta_info=None) -> dict:
        """``anns`` is a pair (anns of the previous frame, anns of the
        current frame); tracks are matched by ``Annotation.id_``."""
        f = self.meta.n_fields
        stride = self.meta.stride
        h, w = field_shape(image, stride)

        anns1, anns2 = anns
        rescaler = AnnRescaler(stride)
        bg = rescaler.bg_mask(anns1, (h, w)) & rescaler.bg_mask(anns2, (h, w))

        conf = np.zeros((f, h, w), np.float32)
        conf_mask = np.broadcast_to(bg, (f, h, w)).copy()
        vec = np.zeros((f, 2, 2, h, w), np.float32)
        vec_mask = np.zeros((f, 2, h, w), bool)
        scale = np.zeros((f, 2, h, w), np.float32)
        scale_mask = np.zeros((f, 2, h, w), bool)
        closest = np.full((f, h, w), np.inf, np.float32)

        by_id1 = {a.id_: a for a in anns1
                  if not getattr(a, 'iscrowd', False) and a.id_ >= 0}
        sigmas = np.asarray(self.meta.sigmas_single_frame, np.float32)
        pad = self.min_size / 2.0 + 0.5

        for ann2 in anns2:
            if getattr(ann2, 'iscrowd', False) or ann2.id_ < 0:
                continue
            ann1 = by_id1.get(ann2.id_)
            if ann1 is None:
                continue
            kps1 = np.copy(ann1.data)
            kps1[:, :2] /= stride
            kps2 = np.copy(ann2.data)
            kps2[:, :2] /= stride
            inst_scale = rescaler.scale(kps2)
            for fi in range(f):
                x1, y1, v1 = kps1[fi]
                x2, y2, v2 = kps2[fi]
                if v1 <= self.v_threshold or v2 <= self.v_threshold:
                    continue
                s = max(1e-3, float(sigmas[fi]) * inst_scale)
                i_lo = max(0, int(np.floor(min(x1, x2) - pad)))
                i_hi = min(w - 1, int(np.ceil(max(x1, x2) + pad)))
                j_lo = max(0, int(np.floor(min(y1, y2) - pad)))
                j_hi = min(h - 1, int(np.ceil(max(y1, y2) + pad)))
                if i_hi < i_lo or j_hi < j_lo:
                    continue
                ii, jj = np.meshgrid(np.arange(i_lo, i_hi + 1),
                                     np.arange(j_lo, j_hi + 1))
                dx, dy = x2 - x1, y2 - y1
                seg_len2 = max(1e-8, dx * dx + dy * dy)
                t = np.clip(((ii - x1) * dx + (jj - y1) * dy) / seg_len2,
                            0.0, 1.0)
                d2 = (ii - (x1 + t * dx)) ** 2 + (jj - (y1 + t * dy)) ** 2
                sel = d2 <= pad * pad
                jsel, isel, dsel = jj[sel], ii[sel], d2[sel]
                better = dsel < closest[fi, jsel, isel]
                jsel, isel, dsel = jsel[better], isel[better], dsel[better]
                closest[fi, jsel, isel] = dsel
                conf[fi, jsel, isel] = 1.0
                conf_mask[fi, jsel, isel] = True
                vec[fi, 0, 0, jsel, isel] = x1 - isel
                vec[fi, 0, 1, jsel, isel] = y1 - jsel
                vec[fi, 1, 0, jsel, isel] = x2 - isel
                vec[fi, 1, 1, jsel, isel] = y2 - jsel
                vec_mask[fi, :, jsel, isel] = True
                scale[fi, 0, jsel, isel] = s
                scale[fi, 1, jsel, isel] = s
                scale_mask[fi, :, jsel, isel] = True

        return {
            'conf': conf, 'conf_mask': conf_mask,
            'vec': vec, 'vec_mask': vec_mask,
            'scale': scale, 'scale_mask': scale_mask,
        }
