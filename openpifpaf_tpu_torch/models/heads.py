"""Composite field head networks.

Port of ``openpifpaf_tpu/models/heads.py``.  Reference parity:
``src/openpifpaf/network/heads.py:~200`` (``CompositeField4``): a single
1x1 conv produces ``n_fields * n_components`` channels (times
``upsample_stride**2`` with the optional PixelShuffle upsampling); the
output is viewed as ``(B, n_fields, n_components, H, W)`` in float32.
``dropout_rate`` (``--head-dropout``) drops features before the conv in
train mode, as the JAX head's ``nn.Dropout`` (``heads.py:77-88``); in eval
mode it is the identity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import headmeta


class FieldComponents(NamedTuple):
    """Structured view of a composite field tensor (inference activations).

    Shapes (single image or batched with a leading B axis):
      - ``conf``: (..., F, H, W) in [0, 1]
      - ``vec``:  (..., F, V, 2, H, W) offsets in feature-cell units
      - ``spread``: (..., F, V, H, W) Laplace spread b > 0
      - ``scale``: (..., F, S, H, W) scale in feature-cell units
    """

    conf: torch.Tensor
    vec: torch.Tensor
    spread: torch.Tensor
    scale: torch.Tensor


def split_fields(x: torch.Tensor, meta: headmeta.Base) -> FieldComponents:
    """Slice a packed ``(..., F, C, H, W)`` field tensor into components.

    Applies the inference activations: sigmoid on the confidence, softplus
    (+1e-4 on the spread) elsewhere.  ``F.softplus``
    returns ``x`` itself above 20 where ``jax.nn.softplus`` keeps the
    ``log1p(exp(-x))`` term; that term is below f32 resolution there.
    """
    nc, nv, ns = meta.n_confidences, meta.n_vectors, meta.n_scales
    conf = x[..., 0:nc, :, :]
    vec = x[..., nc:nc + 2 * nv, :, :]
    spread = x[..., nc + 2 * nv:nc + 3 * nv, :, :]
    scale = x[..., nc + 3 * nv:nc + 3 * nv + ns, :, :]

    lead = vec.shape[:-3]
    h, w = vec.shape[-2:]
    vec = vec.reshape(*lead, nv, 2, h, w)

    conf = torch.sigmoid(conf)
    spread = F.softplus(spread) + 1e-4
    scale = F.softplus(scale)
    if nc == 1:
        conf = conf[..., 0, :, :]
    return FieldComponents(conf=conf, vec=vec, spread=spread, scale=scale)


class CompositeField4(nn.Module):
    """1x1-conv composite field head: NCHW features -> (B, F, C, H, W) f32."""

    def __init__(self, meta: headmeta.Base, in_features: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.meta = meta
        u = meta.upsample_stride
        # the mask draws from torch's generator (seeded by the trainer)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0.0 \
            else None
        self.conv = nn.Conv2d(in_features,
                              meta.n_fields * meta.n_components * u * u, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        meta = self.meta
        u = meta.upsample_stride
        if self.dropout is not None:
            x = self.dropout(x)   # the identity in eval mode
        x = self.conv(x).float()
        if u > 1:
            # channel order (c rh rw), as torch's and the JAX head's
            x = F.pixel_shuffle(x, u)
            # the reference crops the upsample margin (heads.py:~250)
            cut = u // 2
            x = x[:, :, cut:x.shape[2] - cut + 1, cut:x.shape[3] - cut + 1]
        b, _, h, w = x.shape
        return x.reshape(b, meta.n_fields, meta.n_components, h, w)
