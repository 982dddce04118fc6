"""Rotation augmentations.

Port of ``openpifpaf_tpu/transforms/rotate.py`` (``RotateBy90``,
``RotateUniform``) on (3, H, W) tensors in uint8 levels, with PIL's pixels:

- ``RotateBy90`` is ``torch.rot90``: PIL rotates by 90, 180 and 270
  degrees with ``expand`` by a transpose, so no pixel is resampled.
- ``RotateUniform`` redoes PIL's bilinear ``rotate`` (``expand=False``,
  the fill colour ``PAD_FILL``): the rotation about (w/2, h/2), each output
  pixel's centre (x + 0.5, y + 0.5) mapped back by the matrix PIL builds
  (entries rounded to 15 digits), the fill wherever the source point lies
  outside [0, w) x [0, h), elsewhere PIL's bilinear filter (0.5 subtracted,
  neighbour indices clamped into the image, the row below dropped at the
  bottom edge) in float64, truncated to uint8.

Keypoints turn with the JAX package's ``_rotate_points`` about the pixel
centres' centre ((w - 1)/2, (h - 1)/2).  Both draw from the generator they
are given.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Preprocess
from .eval import PAD_FILL


def _rotate_points(xy: np.ndarray, angle_deg: float, center, new_center):
    ang = np.radians(angle_deg)
    rot = np.array([[np.cos(ang), -np.sin(ang)],
                    [np.sin(ang), np.cos(ang)]], np.float32)
    return (xy - center) @ rot.T + new_center


def pil_rotate_matrix(angle: float, width: int, height: int):
    """The inverse affine map (a, b, c, d, e, f) of PIL's ``Image.rotate``
    without ``expand``: an output point (X, Y) samples the input at
    (a X + b Y + c, d X + e Y + f)."""
    cx, cy = width / 2.0, height / 2.0
    ang = -math.radians(angle)
    a, b = round(math.cos(ang), 15), round(math.sin(ang), 15)
    d, e = round(-math.sin(ang), 15), round(math.cos(ang), 15)
    c = a * -cx + b * -cy + cx
    f = d * -cx + e * -cy + cy
    return a, b, c, d, e, f


def rotate_bilinear(image: torch.Tensor, angle: float) -> torch.Tensor:
    """PIL's ``image.rotate(angle, resample=BILINEAR, fillcolor=PAD_FILL)``
    of a (3, H, W) image in uint8 levels."""
    _, h, w = image.shape
    a, b, c, d, e, f = pil_rotate_matrix(angle, w, h)
    opts = dict(dtype=torch.float64, device=image.device)
    x_out = torch.arange(w, **opts)[None, :] + 0.5
    y_out = torch.arange(h, **opts)[:, None] + 0.5
    xin = a * x_out + b * y_out + c
    yin = d * x_out + e * y_out + f
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x0, y0 = torch.floor(xin), torch.floor(yin)
    dx, dy = xin - x0, yin - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    src = image.to(torch.float64)

    def row(y):
        left, right = src[:, y, xa], src[:, y, xb]
        return left + (right - left) * dx

    top = row(ya)
    below = torch.where(y0 + 1 < h, row(yb), top)
    value = (top + (below - top) * dy).to(torch.int64)
    fill = torch.tensor(PAD_FILL, dtype=torch.int64,
                        device=image.device)[:, None, None]
    return torch.where(inside, value, fill).to(image.dtype)


class RotateBy90(Preprocess):
    def __init__(self, angle_perturbation=0.0, fixed_angle=None, *,
                 rng: np.random.Generator):
        self.angle_perturbation = angle_perturbation
        self.fixed_angle = fixed_angle
        self.rng = rng

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        angle = self.fixed_angle if self.fixed_angle is not None \
            else float(self.rng.choice([0, 90, 180, 270]))
        if angle == 0:
            return image, anns, meta
        if angle % 90:
            raise ValueError(f'RotateBy90 turns by multiples of 90 degrees, '
                             f'not {angle}')
        h, w = image.shape[-2:]
        # counter-clockwise, the canvas turned with the image
        image = torch.rot90(image, int(angle) // 90 % 4, dims=(-2, -1))
        nh, nw = image.shape[-2:]
        center = np.array(((w - 1) / 2.0, (h - 1) / 2.0))
        new_center = np.array(((nw - 1) / 2.0, (nh - 1) / 2.0))
        for ann in anns:
            ann.data[:, :2] = _rotate_points(ann.data[:, :2], -angle,
                                             center, new_center)
        meta['rotation'] = {'angle': angle, 'width': nw, 'height': nh,
                            'orig_width': w, 'orig_height': h}
        meta['width_height'] = np.array((nw, nh))
        meta['valid_area'] = np.array((0.0, 0.0, nw - 1.0, nh - 1.0))
        return image, anns, meta


class RotateUniform(Preprocess):
    def __init__(self, max_angle=30.0, *, rng: np.random.Generator):
        self.max_angle = max_angle
        self.rng = rng

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        angle = float(self.rng.uniform(-self.max_angle, self.max_angle))
        if abs(angle) < 0.1:
            return image, anns, meta
        h, w = image.shape[-2:]
        image = rotate_bilinear(image, angle)
        center = np.array(((w - 1) / 2.0, (h - 1) / 2.0))
        for ann in anns:
            ann.data[:, :2] = _rotate_points(ann.data[:, :2], -angle,
                                             center, center)
        meta['rotation'] = {'angle': angle, 'width': w, 'height': h,
                            'orig_width': w, 'orig_height': h}
        return image, anns, meta
