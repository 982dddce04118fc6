"""Image-only transforms: colour jitter, blur, JPEG compression and the
tensor boundary.

Port of ``openpifpaf_tpu/transforms/image.py``.  The JAX transforms call
PIL (``ImageEnhance``, ``ImageFilter.GaussianBlur``, a JPEG round trip) on
PIL images; these take (3, H, W) tensors in uint8 levels and redo PIL's
integer arithmetic, so that they give PIL's pixels without PIL:

- ``ColorTint`` chains PIL's ``Color``, ``Contrast`` and ``Brightness``
  enhancers.  Each blends (``Image.blend``, a float32 ``a + f (b - a)``
  truncated to uint8 and, when extrapolating, clipped first) the image
  with a degenerate one: its greyscale (``L = (19595 R + 38470 G + 7471 B
  + 2^15) >> 16``, PIL's ``convert('L')``), the rounded mean of that
  greyscale, black.
- ``Blur`` is PIL's ``GaussianBlur``: not a sampled Gaussian but three
  passes of an extended box blur along the rows, then three down the
  columns, with the box radius PIL derives from sigma
  (``_gaussian_blur_radius``), 24-bit fixed-point weights and a rounding
  to uint8 after every pass (``ImagingLineBoxBlur32``).
- ``JpegCompression`` round-trips through the port's JPEG encoder and
  decoder (``jpeg.py``), which write and read what PIL's ``save(buf,
  'JPEG', quality=q)`` and ``open(buf).convert('RGB')`` write and read.

``ImageToTensor`` is the port of ``ImageToNumpy`` (``image.py:63-73``): the
normalized (3, H, W) float32 tensor (``eval.normalize``), the layout the
port's model takes.  Random transforms draw from the generator they are
given.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import jpeg
from .base import Preprocess
from .eval import normalize

BOX_BLUR_PASSES = 3


def to_levels(image: torch.Tensor) -> torch.Tensor:
    """(3, H, W) in uint8 levels -> int64 levels."""
    return image.round().to(torch.int64)


def grey_levels(levels: torch.Tensor) -> torch.Tensor:
    """PIL's ``convert('L')`` of (3, H, W) int64 RGB levels: (H, W)."""
    r, g, b = levels
    return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16


def blend(degenerate: torch.Tensor, image: torch.Tensor,
          factor: float) -> torch.Tensor:
    """PIL's ``Image.blend(degenerate, image, factor)`` on int64 levels:
    float32 arithmetic, truncated to uint8 (clipped first when the factor
    extrapolates)."""
    alpha = torch.tensor(factor, dtype=torch.float32)
    a = degenerate.to(torch.float32)
    out = a + alpha * (image.to(torch.float32) - a)
    if not 0.0 <= float(alpha) <= 1.0:
        out = out.clamp(0.0, 255.0)
    return out.to(torch.int64)


class ColorTint(Preprocess):
    def __init__(self, max_shift=0.4, *, rng: np.random.Generator):
        self.max_shift = max_shift
        self.rng = rng

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        levels = to_levels(image)
        for step in ('color', 'contrast', 'brightness'):
            factor = 1.0 + float(self.rng.uniform(-self.max_shift,
                                                  self.max_shift))
            if step == 'color':
                degenerate = grey_levels(levels).expand_as(levels)
            elif step == 'contrast':
                mean = int(float(grey_levels(levels).double().mean()) + 0.5)
                degenerate = torch.full_like(levels, mean)
            else:
                degenerate = torch.zeros_like(levels)
            levels = blend(degenerate, levels, factor)
        return levels.to(image.dtype), anns, meta


def gaussian_blur_radius(sigma: float, passes: int = BOX_BLUR_PASSES):
    """The extended box radius of PIL's ``_gaussian_blur_radius`` (float32
    arithmetic, as PIL's C), after Gwosdek et al., "Theoretical Foundations
    of Gaussian Convolution by Extended Box Filtering" (SSVM 2011)."""
    f = np.float32
    sigma2 = f(f(sigma) * f(sigma) / f(passes))
    box = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    whole = f(math.floor((float(box) - 1.0) / 2.0))
    part = f(f(f(2) * whole + f(1))
             * f(whole * f(whole + f(1)) - f(3) * sigma2))
    part = f(part / f(f(6) * f(sigma2 - f(whole + f(1)) * f(whole + f(1)))))
    return f(whole + part)


def box_blur_rows(levels: torch.Tensor, radius) -> torch.Tensor:
    """One pass of PIL's extended box blur along the last axis of int64
    levels: the integer box of ``int(radius)`` with weight ``ww`` per tap,
    the two taps beyond it with ``fw``, edge pixels repeated, rounded from
    24-bit fixed point."""
    whole = int(radius)
    ww = int(np.float32(1 << 24) / np.float32(radius * np.float32(2)
                                               + np.float32(1)))
    fw = ((1 << 24) - (2 * whole + 1) * ww) // 2
    width = levels.shape[-1]
    # padded[..., j] is the pixel at x = j - whole - 1, clamped
    idx = torch.arange(-whole - 1, width + whole + 1).clamp(0, width - 1)
    padded = levels[..., idx]
    csum = torch.nn.functional.pad(padded.cumsum(-1), (1, 0))
    xs = torch.arange(width)
    box = csum[..., xs + 2 * whole + 2] - csum[..., xs + 1]
    far = padded[..., xs] + padded[..., xs + 2 * whole + 2]
    return (box * ww + far * fw + (1 << 23)) >> 24


def box_blur(levels: torch.Tensor, radius) -> torch.Tensor:
    """PIL's ``ImagingBoxBlur`` of (3, H, W) int64 levels: the passes
    along the rows, then along the columns."""
    for _ in range(BOX_BLUR_PASSES):
        levels = box_blur_rows(levels, radius)
    levels = levels.transpose(-1, -2)
    for _ in range(BOX_BLUR_PASSES):
        levels = box_blur_rows(levels, radius)
    return levels.transpose(-1, -2)


class Blur(Preprocess):
    def __init__(self, max_sigma=5.0, *, rng: np.random.Generator):
        self.max_sigma = max_sigma
        self.rng = rng

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        sigma = float(self.rng.uniform(0.0, self.max_sigma))
        if sigma == 0.0:   # PIL returns a copy for a zero radius
            return image, anns, meta
        blurred = box_blur(to_levels(image), gaussian_blur_radius(sigma))
        return blurred.to(image.dtype), anns, meta


class JpegCompression(Preprocess):
    """A JPEG round trip at a random quality, through the port's encoder
    and decoder."""

    def __init__(self, quality_range=(50, 100), *, rng: np.random.Generator):
        self.quality_range = quality_range
        self.rng = rng

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        quality = int(self.rng.integers(*self.quality_range))
        array = to_levels(image).permute(1, 2, 0).to(torch.uint8).numpy()
        out = jpeg.decode(jpeg.encode(array, quality))
        return (torch.from_numpy(out).permute(2, 0, 1).to(image.dtype),
                anns, meta)


class ImageToTensor(Preprocess):
    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        return normalize(image), anns, meta
