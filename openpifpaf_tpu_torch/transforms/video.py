"""Video-frame clean-up transforms.

Port of ``openpifpaf_tpu/transforms/video.py``: ``Deinterlace`` and
``ImputeNaN``.  The JAX transforms branch on the image's type, and so do
these: an (H, W, 3) numpy array (what the JAX package's tensor boundary
gives) takes the array branch, a (3, H, W) tensor takes the branch of a
PIL image, the port's image before its tensor boundary.

- ``Deinterlace`` on an array repeats every even scan line over the odd
  one below it.  On a tensor in uint8 levels it redoes PIL's
  ``resize((w, h // 2), NEAREST)`` then ``resize((w, h), BILINEAR)``:
  the nearest rows ``floor((j + 0.5) h / (h // 2))``, then PIL's vertical
  bilinear resampling (``precompute_coeffs`` with support 1, weights in
  22-bit fixed point, rounded and clipped to uint8); the width is kept, so
  PIL runs no horizontal pass.
- ``ImputeNaN`` replaces non-finite values by the mean of the finite ones
  (numpy's ``nanmean`` over the (H, W, 3) layout, as the JAX package);
  PIL images hold no NaN, so JAX leaves them alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Preprocess

RESAMPLE_PRECISION_BITS = 32 - 8 - 2


def bilinear_coefficients(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for a
    bilinear resize of ``in_size`` samples to ``out_size``: per output
    sample its first input index and integer weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    bounds, weights = [], []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        taps = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) / filterscale))
                for x in range(xmax)]
        total = sum(taps)
        taps = [t / total if total != 0.0 else t for t in taps]
        weights.append([int(-0.5 + t * (1 << RESAMPLE_PRECISION_BITS))
                        if t < 0 else
                        int(0.5 + t * (1 << RESAMPLE_PRECISION_BITS))
                        for t in taps])
        bounds.append(xmin)
    return bounds, weights


def resize_rows_bilinear(levels: torch.Tensor, out_h: int) -> torch.Tensor:
    """PIL's vertical bilinear pass of (3, H, W) int64 levels to
    ``out_h`` rows."""
    bounds, weights = bilinear_coefficients(levels.shape[1], out_h)
    out = torch.empty((levels.shape[0], out_h, levels.shape[2]),
                      dtype=torch.int64)
    for y, (ymin, taps) in enumerate(zip(bounds, weights)):
        acc = torch.full_like(levels[:, 0], 1 << (RESAMPLE_PRECISION_BITS - 1))
        for i, weight in enumerate(taps):
            acc += levels[:, ymin + i] * weight
        out[:, y] = (acc >> RESAMPLE_PRECISION_BITS).clamp(0, 255)
    return out


class Deinterlace(Preprocess):
    """Drop every second scan line and resize back (removes comb artefacts
    from interlaced footage)."""

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        if isinstance(image, np.ndarray):
            half = image[::2]
            return np.repeat(half, 2, axis=0)[:image.shape[0]], anns, meta
        h = image.shape[1]
        rows = [math.floor((j + 0.5) * (h / (h // 2)))
                for j in range(h // 2)]
        half = image[:, rows].round().to(torch.int64)
        return resize_rows_bilinear(half, h).to(image.dtype), anns, meta


class ImputeNaN(Preprocess):
    """Replace non-finite pixel values (corrupted frames, capture
    glitches) with the frame mean."""

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        as_tensor = isinstance(image, torch.Tensor)
        array = (np.ascontiguousarray(image.permute(1, 2, 0).numpy())
                 if as_tensor else image)
        bad = ~np.isfinite(array)
        if not bad.any():
            return image, anns, meta
        fill = float(np.nanmean(np.where(bad, np.nan, array)))
        array = np.where(bad, fill, array)
        if as_tensor:
            return (torch.from_numpy(array).permute(2, 0, 1).to(image.dtype),
                    anns, meta)
        return array, anns, meta
