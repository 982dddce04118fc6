"""CAF encoder: ground-truth skeletons -> association field training targets.

Port of ``openpifpaf_tpu/encoder/caf.py``: the C++ painter with
``use_native`` (the default; ``caf.py:62-70``), else numpy, as in
``cif.py``.  For every skeleton edge with both endpoints visible, fill the cells along the
segment between the endpoints with confidence 1, the two offset vectors to
the endpoints and the two endpoint scales.  Closer edges win contested
cells.

Targets (numpy, for ``E`` edges): ``conf`` (E, H, W) f32, ``conf_mask``
(E, H, W) bool, ``vec`` (E, 2, 2, H, W) f32, ``vec_mask`` (E, 2, H, W)
bool, ``scale`` (E, 2, H, W) f32, ``scale_mask`` (E, 2, H, W) bool.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import native
from .annrescaler import AnnRescaler
from .cif import field_shape
from .. import headmeta


@dataclasses.dataclass
class CafEncoder:
    meta: headmeta.Caf
    min_size: int = 3         # reference: paint at least a 3-cell-wide band
    v_threshold: int = 0
    use_native: bool = True   # the C++ painter (csrc/encoders.cpp)

    def __call__(self, image, anns, meta_info=None) -> dict:
        e = self.meta.n_fields
        h, w = field_shape(image, self.meta.stride)

        rescaler = AnnRescaler(self.meta.stride, self.meta.pose)
        kp_sets = rescaler.keypoint_sets(anns)
        bg = rescaler.bg_mask(anns, (h, w))

        conf = np.zeros((e, h, w), np.float32)
        conf_mask = np.broadcast_to(bg, (e, h, w)).copy()
        vec = np.zeros((e, 2, 2, h, w), np.float32)
        vec_mask = np.zeros((e, 2, h, w), bool)
        scale = np.zeros((e, 2, h, w), np.float32)
        scale_mask = np.zeros((e, 2, h, w), bool)

        skeleton = np.asarray(self.meta.skeleton, np.int32) - 1
        sigmas = np.asarray(self.meta.sigmas, np.float32)
        pad = self.min_size / 2.0
        targets = {
            'conf': conf, 'conf_mask': conf_mask,
            'vec': vec, 'vec_mask': vec_mask,
            'scale': scale, 'scale_mask': scale_mask,
        }

        if self.use_native:
            native.paint_caf(kp_sets, [rescaler.scale(kps) for kps in kp_sets],
                             sigmas, skeleton, h=h, w=w,
                             min_size=self.min_size,
                             v_threshold=float(self.v_threshold), **targets)
            return targets

        closest = np.full((e, h, w), np.inf, np.float32)

        for kps in kp_sets:
            inst_scale = rescaler.scale(kps)
            for ei, (a, b) in enumerate(skeleton):
                x1, y1, v1 = kps[a]
                x2, y2, v2 = kps[b]
                if v1 <= self.v_threshold or v2 <= self.v_threshold:
                    continue
                s1 = max(1e-3, float(sigmas[a]) * inst_scale)
                s2 = max(1e-3, float(sigmas[b]) * inst_scale)

                # cells within `pad` of the segment, via dense bbox scan
                i_lo = max(0, int(np.floor(min(x1, x2) - pad)))
                i_hi = min(w - 1, int(np.ceil(max(x1, x2) + pad)))
                j_lo = max(0, int(np.floor(min(y1, y2) - pad)))
                j_hi = min(h - 1, int(np.ceil(max(y1, y2) + pad)))
                if i_hi < i_lo or j_hi < j_lo:
                    continue
                ii, jj = np.meshgrid(np.arange(i_lo, i_hi + 1),
                                     np.arange(j_lo, j_hi + 1))
                # distance from cell to segment
                dx, dy = x2 - x1, y2 - y1
                seg_len2 = max(1e-8, dx * dx + dy * dy)
                t = np.clip(((ii - x1) * dx + (jj - y1) * dy) / seg_len2,
                            0.0, 1.0)
                px = x1 + t * dx
                py = y1 + t * dy
                d2 = (ii - px) ** 2 + (jj - py) ** 2
                sel = d2 <= pad * pad

                jsel = jj[sel]
                isel = ii[sel]
                dsel = d2[sel]
                better = dsel < closest[ei, jsel, isel]
                jsel, isel, dsel = jsel[better], isel[better], dsel[better]
                closest[ei, jsel, isel] = dsel
                conf[ei, jsel, isel] = 1.0
                conf_mask[ei, jsel, isel] = True
                vec[ei, 0, 0, jsel, isel] = x1 - isel
                vec[ei, 0, 1, jsel, isel] = y1 - jsel
                vec[ei, 1, 0, jsel, isel] = x2 - isel
                vec[ei, 1, 1, jsel, isel] = y2 - jsel
                vec_mask[ei, :, jsel, isel] = True
                scale[ei, 0, jsel, isel] = s1
                scale[ei, 1, jsel, isel] = s2
                scale_mask[ei, :, jsel, isel] = True

        return targets
