"""CIF encoder: ground-truth keypoints -> intensity field training targets.

Port copy of the numpy path of ``openpifpaf_tpu/encoder/cif.py``
(``:77-99``).  The JAX package's C++ painter (``use_native``,
``encoder/native.py``) is host code with the same output and is not
ported; this encoder always paints in numpy.

For every visible keypoint, paint a ``side_length``² cell neighborhood:
confidence 1 in the core, exact offset vectors from each painted cell to
the keypoint, and the joint scale (per-keypoint sigma × instance scale).
When two keypoints of the same type compete for a cell, the closer one
wins.  Crowd regions are excluded from the confidence loss via the
background mask.

Targets (numpy, for ``F`` fields on an ``H × W`` grid): ``conf`` (F, H, W)
f32, ``conf_mask`` (F, H, W) bool, ``vec`` (F, 1, 2, H, W) f32,
``vec_mask`` (F, 1, H, W) bool, ``scale`` (F, 1, H, W) f32, ``scale_mask``
(F, 1, H, W) bool.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .annrescaler import AnnRescaler
from .. import headmeta


def field_shape(image, stride: int):
    """Field (H, W) for a (..., H, W) image (the port's images are CHW)."""
    h_px, w_px = image.shape[-2:]
    return (h_px - 1) // stride + 1, (w_px - 1) // stride + 1


@dataclasses.dataclass
class CifEncoder:
    meta: headmeta.Cif
    side_length: int = 4
    v_threshold: int = 0      # min visibility flag to paint (0: also occluded)

    def __call__(self, image, anns, meta_info=None) -> dict:
        f = self.meta.n_fields
        h, w = field_shape(image, self.meta.stride)

        rescaler = AnnRescaler(self.meta.stride, self.meta.pose)
        kp_sets = rescaler.keypoint_sets(anns)
        bg = rescaler.bg_mask(anns, (h, w))

        conf = np.zeros((f, h, w), np.float32)
        conf_mask = np.broadcast_to(bg, (f, h, w)).copy()
        vec = np.zeros((f, 1, 2, h, w), np.float32)
        vec_mask = np.zeros((f, 1, h, w), bool)
        scale = np.zeros((f, 1, h, w), np.float32)
        scale_mask = np.zeros((f, 1, h, w), bool)
        closest = np.full((f, h, w), np.inf, np.float32)  # competition dist

        s_l = self.side_length
        offset = (s_l - 1) / 2.0
        sigmas = np.asarray(self.meta.sigmas, np.float32)

        for kps in kp_sets:
            inst_scale = rescaler.scale(kps)
            for fi in range(f):
                x, y, v = kps[fi]
                if v <= self.v_threshold:
                    continue
                joint_scale = max(1e-3, float(sigmas[fi]) * inst_scale)
                i0 = int(np.round(x - offset))
                j0 = int(np.round(y - offset))
                for j in range(max(0, j0), min(h, j0 + s_l)):
                    for i in range(max(0, i0), min(w, i0 + s_l)):
                        d2 = (x - i) ** 2 + (y - j) ** 2
                        if d2 >= closest[fi, j, i]:
                            continue
                        closest[fi, j, i] = d2
                        core = (abs(x - i) < 1.0) and (abs(y - j) < 1.0)
                        conf[fi, j, i] = 1.0 if core else conf[fi, j, i]
                        conf_mask[fi, j, i] = True
                        vec[fi, 0, 0, j, i] = x - i
                        vec[fi, 0, 1, j, i] = y - j
                        vec_mask[fi, 0, j, i] = True
                        scale[fi, 0, j, i] = joint_scale
                        scale_mask[fi, 0, j, i] = joint_scale > 0
        return {
            'conf': conf, 'conf_mask': conf_mask,
            'vec': vec, 'vec_mask': vec_mask,
            'scale': scale, 'scale_mask': scale_mask,
        }
