"""CifDet decoder: detection fields -> boxes, on the device, without loops.

Port of ``openpifpaf_tpu/decoder/cifdet.py`` (``:66-161``).  Reference
parity: ``src/openpifpaf/decoder/cifdet.py:~30`` and
``csrc/src/decoder/cifdet.cpp:~30``: boxes from the raw (w, h) vector, the
box centers splatted into a high-resolution map per category
(``cif_hr.accumulate``, K1's CUDA kernel on the card, at sigma 0.1 x half
the box's short side, floor 2 px), each cell's score blended 0.9 / 0.1
from that map and its confidence, a 3x3 local maximum, the top
``max_detections`` cells, and IoU NMS per category.  The JAX decode is one
``jit(vmap(...))``; here every step is a batched tensor operation with the
batch axis in front, so the decode runs no fixpoint loop and reads nothing
back before its one transfer of the final boxes.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .decoder import Decoder
from .. import headmeta
from ..annotation import AnnotationDet
from ..device import resolve_device
from ..models.heads import split_fields
from ..ops import cif_hr
from ..ops.common import gather_field_grouped, masked_top_k

LOG = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CifDetConfig:
    stride: int
    image_hw: Tuple[int, int]
    cifhr: cif_hr.CifHrConfig
    seed_threshold: float = 0.3
    iou_threshold: float = 0.5
    max_detections: int = 64


class DecodedDets(NamedTuple):
    """Per image the ``max_detections`` best cells in descending score:
    ``category`` (B, K) int64, 1-based; ``score`` (B, K) f32, 0 where
    invalid or suppressed; ``bbox`` (B, K, 4) f32 (x, y, w, h) in px."""

    category: torch.Tensor
    score: torch.Tensor
    bbox: torch.Tensor


def decode_cifdet(field: torch.Tensor, *, meta: headmeta.CifDet,
                  config: CifDetConfig) -> DecodedDets:
    """field: (B, F, C, H, W) raw CifDet head output (C = 7, or 5 without
    the spreads, as painted fields have them)."""
    comp = split_fields(field, meta)
    b, f, h, w = comp.conf.shape
    stride, device = config.stride, field.device
    jj = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    ii = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    cx = (ii + comp.vec[:, :, 0, 0]) * stride
    cy = (jj + comp.vec[:, :, 0, 1]) * stride
    bw = torch.clamp(comp.vec[:, :, 1, 0], min=0.1) * stride
    bh = torch.clamp(comp.vec[:, :, 1, 1], min=0.1) * stride

    sp = config.cifhr.spacing
    hr_hw = ((config.image_hw[0] + sp - 1) // sp,
             (config.image_hw[1] + sp - 1) // sp)
    hr = cif_hr.accumulate(comp.conf, cx, cy, torch.minimum(bw, bh) * 0.5,
                           out_hw=hr_hw, config=config.cifhr)
    fields = torch.arange(f, dtype=torch.int64, device=device)
    v = (0.9 * gather_field_grouped(hr, fields, cx, cy, sp)
         + 0.1 * comp.conf)

    # local maximum (-inf padding, as reduce_window's SAME) and top-k
    vmax = F.max_pool2d(v, 3, 1, 1)
    mask = (v > config.seed_threshold) & (v >= vmax)
    vals, idx, valid = masked_top_k(v.reshape(b, -1), mask.reshape(b, -1),
                                    config.max_detections)
    category = idx // (h * w)

    def take(t):
        return torch.gather(t.reshape(b, -1), 1, idx)

    bws, bhs = take(bw), take(bh)
    x0 = take(cx) - bws / 2
    y0 = take(cy) - bhs / 2
    score = torch.where(valid, vals, 0.0)

    # IoU NMS per category over the sorted boxes: a box goes when an
    # earlier valid box of its category overlaps it
    x1, y1 = x0 + bws, y0 + bhs
    ix0 = torch.maximum(x0[:, :, None], x0[:, None, :])
    iy0 = torch.maximum(y0[:, :, None], y0[:, None, :])
    ix1 = torch.minimum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.minimum(y1[:, :, None], y1[:, None, :])
    inter = torch.clamp(ix1 - ix0, min=0.0) * torch.clamp(iy1 - iy0, min=0.0)
    area = bws * bhs
    iou = inter / torch.clamp(area[:, :, None] + area[:, None, :] - inter,
                              min=1e-6)
    n = score.shape[1]
    order = torch.arange(n, device=device)
    same_category = category[:, :, None] == category[:, None, :]
    earlier = order[None, :] < order[:, None]
    suppressed = (same_category & earlier & (iou > config.iou_threshold)
                  & (score[:, None, :] > 0)).any(dim=2)
    score = torch.where(suppressed, 0.0, score)
    return DecodedDets(category=category + 1, score=score,
                       bbox=torch.stack([x0, y0, bws, bhs], dim=-1))


class CifDet(Decoder):
    # class-level configuration (the JAX package's defaults)
    seed_threshold = 0.3
    instance_threshold = 0.15
    iou_threshold = 0.5
    max_detections = 64
    hr_spacing = 2

    def __init__(self, meta: headmeta.CifDet, *, device=None):
        self.meta = meta
        self.device = resolve_device(device)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('CifDet decoder')
        group.add_argument('--cifdet-seed-threshold',
                           default=cls.seed_threshold, type=float)
        group.add_argument('--cifdet-iou-threshold',
                           default=cls.iou_threshold, type=float)
        group.add_argument('--cifdet-max-detections',
                           default=cls.max_detections, type=int)

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.seed_threshold = args.cifdet_seed_threshold
        cls.iou_threshold = args.cifdet_iou_threshold
        cls.max_detections = args.cifdet_max_detections

    @classmethod
    def match(cls, head_metas) -> bool:
        return any(isinstance(m, headmeta.CifDet) for m in head_metas)

    @classmethod
    def factory(cls, head_metas, *, device=None) -> List['CifDet']:
        return [cls(m, device=device) for m in head_metas
                if isinstance(m, headmeta.CifDet)]

    def config_for(self, image_hw: Tuple[int, int]) -> CifDetConfig:
        """The decode configuration; on the card the CifHr profiles are
        f32 (the kernel's), on the CPU bf16-rounded as in the JAX default
        unless ``--cifhr-f32-profiles``."""
        return CifDetConfig(
            stride=self.meta.stride,
            image_hw=tuple(image_hw),
            cifhr=cif_hr.CifHrConfig(
                spacing=self.hr_spacing, sigma_factor=0.1, min_sigma_px=2.0,
                profile_bf16=self.profile_bf16(self.device)),
            seed_threshold=self.seed_threshold,
            iou_threshold=self.iou_threshold,
            max_detections=self.max_detections)

    def batch_decoded(self, fields) -> DecodedDets:
        """Batched decode on the device: ``DecodedDets`` of tensors."""
        field = torch.as_tensor(fields[self.meta.head_index]).to(self.device)
        h, w = field.shape[-2:]
        stride = self.meta.stride
        image_hw = ((h - 1) * stride + 1, (w - 1) * stride + 1)
        return decode_cifdet(field, meta=self.meta,
                             config=self.config_for(image_hw))

    def decoded_to_annotations(self, category, score, bbox
                               ) -> List[AnnotationDet]:
        """One image's numpy decode -> AnnotationDet objects above
        ``instance_threshold``, in descending score order of the cells."""
        return [AnnotationDet(self.meta.categories).set(int(c), float(s), bb)
                for c, s, bb in zip(category, score, bbox)
                if s >= self.instance_threshold]

    def batch_fields(self, fields, metas=None) -> List[List[AnnotationDet]]:
        return self.annotations_from_decoded(self.batch_decoded(fields))

    def annotations_from_decoded(self, decoded) -> List[List[AnnotationDet]]:
        """``batch_decoded``'s tensors -> per image the detections."""
        # one device->host transfer for the whole batch
        packed = torch.cat([decoded.category[..., None].float(),
                            decoded.score[..., None], decoded.bbox],
                           dim=-1).cpu().numpy()
        return [self.decoded_to_annotations(p[:, 0].astype(np.int64),
                                            p[:, 1], p[:, 2:])
                for p in packed]

    def __call__(self, fields) -> List[AnnotationDet]:
        """Decode one image: ``fields[meta.head_index]`` is (F, C, H, W)."""
        field = torch.as_tensor(np.asarray(fields[self.meta.head_index]))
        return self.batch_fields({self.meta.head_index: field[None]})[0]
