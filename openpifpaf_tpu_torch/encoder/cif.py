"""CIF encoder: ground-truth keypoints -> intensity field training targets.

Port of ``openpifpaf_tpu/encoder/cif.py``.  With ``use_native`` (the
default, as in JAX) the C++ painter of ``csrc/encoders.cpp`` paints
(``native.py``, built at first use; a failed build raises), as JAX's
``cif.py:65-73`` does; ``use_native=False`` paints in numpy (``:77-99``),
the oracle the tests hold the library to.

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

from . import native
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
    use_native: bool = True   # the C++ painter (csrc/encoders.cpp)

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

        s_l = self.side_length
        offset = (s_l - 1) / 2.0
        sigmas = np.asarray(self.meta.sigmas, np.float32)
        targets = {
            'conf': conf, 'conf_mask': conf_mask,
            'vec': vec, 'vec_mask': vec_mask,
            'scale': scale, 'scale_mask': scale_mask,
        }

        if self.use_native:
            native.paint_cif(kp_sets, [rescaler.scale(kps) for kps in kp_sets],
                             sigmas, h=h, w=w, side_length=s_l,
                             v_threshold=float(self.v_threshold), **targets)
            return targets

        closest = np.full((f, h, w), np.inf, np.float32)  # competition dist

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
        return targets
