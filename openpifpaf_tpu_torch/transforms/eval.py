"""Eval preprocessing: rescale the long edge, centre pad, normalize.

Port of the eval transforms the JAX Predictor composes
(``openpifpaf_tpu/transforms``: ``RescaleAbsolute`` in ``scale.py``,
``CenterPad`` in ``pad.py``, ``ImageToNumpy`` in ``image.py:63-73``), on
torch tensors instead of PIL images — the machine with the card has no PIL.
Images are (3, H, W) float32 tensors in uint8 levels until ``normalize``.
Each step records in ``meta`` what ``Annotation.inverse_transform`` needs:
``x_original = (x_transformed + offset) / scale``.

The rescale (``resize``) is ``F.interpolate(mode='bilinear',
antialias=True)`` rounded to uint8 levels, which approximates PIL's
bilinear ``resize`` (the test states the tolerance); it is the identity
when the long edge is already the target, as in PIL's path.  The training
transforms (``scale.py``, ``pad.py``) share ``resize`` and ``pad``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PAD_FILL = (124, 116, 104)


def init_meta(width: int, height: int) -> dict:
    wh = np.array((width, height))
    return {
        'offset': np.array((0.0, 0.0)),
        'scale': np.array((1.0, 1.0)),
        'rotation': {'angle': 0.0, 'width': None, 'height': None},
        'valid_area': np.array((0.0, 0.0, width - 1, height - 1)),
        'hflip': False,
        'width_height': wh,
        'original_width_height': wh,
        'horizontal_swap': None,
    }


def resize(image: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(3, H, W) in uint8 levels -> (3, height, width), PIL-like bilinear."""
    image = F.interpolate(image[None], size=(height, width), mode='bilinear',
                          align_corners=False, antialias=True)[0]
    return torch.clamp(torch.round(image), 0.0, 255.0)


def rescale_meta(meta: dict, x_scale: float, y_scale: float) -> dict:
    meta['offset'] = meta['offset'] * np.array((x_scale, y_scale))
    meta['scale'] = meta['scale'] * np.array((x_scale, y_scale))
    meta['valid_area'] = meta['valid_area'] * np.array(
        (x_scale, y_scale, x_scale, y_scale))
    return meta


def rescale_absolute(image: torch.Tensor, long_edge: int, meta: dict):
    """image: (3, H, W) float32 in uint8 levels.  Rescale so the long edge
    equals ``long_edge``, preserving aspect."""
    _, h, w = image.shape
    s = long_edge / max(w, h)
    tw, th = round(w * s), round(h * s)
    if (tw, th) == (w, h):
        return image, meta
    image = resize(image, tw, th)
    x_scale = (tw - 1) / (w - 1) if w > 1 else 1.0
    y_scale = (th - 1) / (h - 1) if h > 1 else 1.0
    return image, rescale_meta(meta, x_scale, y_scale)


def pad(image: torch.Tensor, left: int, top: int, right: int,
        bottom: int) -> torch.Tensor:
    """Pad a (3, H, W) image with the JAX package's fill colour."""
    _, h, w = image.shape
    out = torch.empty((3, h + top + bottom, w + left + right),
                      dtype=image.dtype, device=image.device)
    out[:] = torch.tensor(PAD_FILL, dtype=image.dtype,
                          device=image.device)[:, None, None]
    out[:, top:top + h, left:left + w] = image
    return out


def center_pad(image: torch.Tensor, target_size: int, meta: dict):
    """Pad symmetrically to ``target_size`` squared with the JAX package's
    fill colour; the left/top share is the floor of half the padding."""
    _, h, w = image.shape
    left = max(0, (target_size - w) // 2)
    top = max(0, (target_size - h) // 2)
    right = max(0, target_size - w - left)
    bottom = max(0, target_size - h - top)
    if not any((left, top, right, bottom)):
        return image, meta
    out = pad(image, left, top, right, bottom)
    meta['offset'] = meta['offset'] - np.array((left, top), float)
    meta['valid_area'] = meta['valid_area'] + np.array((left, top, 0.0, 0.0))
    meta['width_height'] = np.array((out.shape[2], out.shape[1]))
    return out, meta


def normalize(image: torch.Tensor) -> torch.Tensor:
    """uint8 levels -> ImageNet-normalized float32 (3, H, W)."""
    mean = torch.tensor(IMAGENET_MEAN, device=image.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=image.device)[:, None, None]
    return (image / 255.0 - mean) / std


def preprocess(image: np.ndarray, long_edge: int, device):
    """One NHWC-style (H, W, 3) uint8 image -> ((3, S, S) float32 on
    ``device``, meta)."""
    h, w = image.shape[:2]
    meta = init_meta(w, h)
    t = torch.as_tensor(np.ascontiguousarray(image, dtype=np.uint8),
                        device=device).permute(2, 0, 1).float()
    t, meta = rescale_absolute(t, long_edge, meta)
    t, meta = center_pad(t, long_edge, meta)
    return normalize(t), meta
