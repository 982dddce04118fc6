"""The CifCaf decode pipeline, batched.

Port of ``openpifpaf_tpu/ops/pipeline.py``.  Reference parity:
``src/openpifpaf/csrc/src/decoder/cifcaf.cpp:~80`` (``CifCaf::call``):
CifHr accumulation -> seed selection -> CAF scoring -> greedy growth ->
keypoint NMS.  The JAX decode is single-image and ``vmap``-batched under
``jit``; here the batch axis is written out and the fixpoint loops run in
Python (one host sync per iteration, ``common.HOST_SYNCS``), or, under
``torch.export``, as traced loops: ``decode_cifcaf`` is one program
(``export_program --include-decoder``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import caf_scored, cif_hr, growth, nms, seeds
from .common import gather_field_grouped
from ..device import resolve_device
from ..models.heads import split_fields


@dataclasses.dataclass(frozen=True)
class CifCafConfig:
    """All static decode configuration."""

    stride: int = 16
    image_hw: tuple = (641, 641)    # padded input image size
    cifhr: cif_hr.CifHrConfig = cif_hr.CifHrConfig()
    seeds: seeds.SeedsConfig = seeds.SeedsConfig()
    caf: caf_scored.CafScoredConfig = caf_scored.CafScoredConfig()
    # separately thresholded candidate set consumed only by the relaxed
    # force-complete second pass; None = reuse the first-pass candidates
    caf_fc: caf_scored.CafScoredConfig = None
    growth: growth.GrowthConfig = growth.GrowthConfig()
    nms: nms.NMSConfig = nms.NMSConfig()

    @property
    def hr_hw(self):
        sp = self.cifhr.spacing
        return ((self.image_hw[0] + sp - 1) // sp,
                (self.image_hw[1] + sp - 1) // sp)


class DecodedPoses(NamedTuple):
    """Decode result, batched."""

    xyv: torch.Tensor            # (B, P, K, 3)
    joint_scales: torch.Tensor   # (B, P, K) px
    scores: torch.Tensor         # (B, P)
    valid: torch.Tensor          # (B, P) bool
    n_dropped_caf: torch.Tensor  # (B,) CAF candidate budget overflow
    n_dropped_cif: torch.Tensor  # (B,) CifHr max_active budget overflow
    n_dropped_poses: torch.Tensor  # (B,) seeds beyond the max_poses budget


class FrontEnd(NamedTuple):
    """Decode front-end outputs (everything before pose growth)."""

    sds: seeds.Seeds
    cands: caf_scored.CafCandidates
    cands_fc: caf_scored.CafCandidates   # None unless force-complete 2nd set
    scale_px: torch.Tensor               # (B, Fk, H, W) CIF scale field, px
    n_dropped_cif: torch.Tensor
    n_dropped_caf: torch.Tensor


def cif_positions(cif, stride: int):
    """(x_px, y_px, scale_px), each (B, F, H, W): the regressed target of
    every CIF cell and its scale, in image pixels."""
    h, w = cif.conf.shape[-2:]
    device = cif.conf.device
    jj = torch.arange(h, dtype=torch.float32, device=device)[None, None, :, None]
    ii = torch.arange(w, dtype=torch.float32, device=device)[None, None, None, :]
    return ((ii + cif.vec[:, :, 0, 0]) * stride,
            (jj + cif.vec[:, :, 0, 1]) * stride,
            cif.scale[:, :, 0] * stride)


def decode_front_end(cif_fields: torch.Tensor, caf_fields: torch.Tensor, *,
                     cif_meta, caf_meta, config: CifCafConfig) -> FrontEnd:
    """CifHr accumulation -> seed selection -> CAF candidate scoring.

    cif_fields (B, Fk, 5, H, W), caf_fields (B, Fe, 9, H, W): raw heads.
    """
    stride = config.stride
    skeleton = np.asarray(caf_meta.skeleton, np.int64) - 1  # 0-based

    cif = split_fields(cif_fields, cif_meta)
    caf = split_fields(caf_fields, caf_meta)

    x_px, y_px, scale_px = cif_positions(cif, stride)

    # 1) high-res confidence accumulation (the CUDA kernel on the card)
    hr, n_dropped_cif = cif_hr.accumulate(
        cif.conf, x_px, y_px, scale_px, out_hw=config.hr_hw,
        config=config.cifhr, return_overflow=True)

    # 2) seeds
    sds = seeds.select(cif.conf, x_px, y_px, scale_px, hr,
                       hr_spacing=config.cifhr.spacing, config=config.seeds)

    # 3) scored CAF candidates
    conf_scales = (np.asarray(caf_meta.decoder_confidence_scales, np.float32)
                   if caf_meta.decoder_confidence_scales is not None else None)
    cands = caf_scored.score(caf, hr, skeleton, stride=stride,
                             hr_spacing=config.cifhr.spacing,
                             config=config.caf, confidence_scales=conf_scales)
    n_dropped_caf = cands.n_dropped
    cands_fc = None
    if config.growth.force_complete and config.caf_fc is not None:
        # the force-complete pass's own candidates, on the same CifHr map
        cands_fc = caf_scored.score(caf, hr, skeleton, stride=stride,
                                    hr_spacing=config.cifhr.spacing,
                                    config=config.caf_fc,
                                    confidence_scales=conf_scales)
        n_dropped_caf = n_dropped_caf + cands_fc.n_dropped
    return FrontEnd(sds=sds, cands=cands, cands_fc=cands_fc,
                    scale_px=scale_px, n_dropped_cif=n_dropped_cif,
                    n_dropped_caf=n_dropped_caf)


def finalize_poses(poses: torch.Tensor, placed: torch.Tensor,
                   pose_valid: torch.Tensor, scale_px: torch.Tensor, *,
                   score_weights, config: CifCafConfig,
                   seed_f: torch.Tensor = None):
    """Joint-scale refinement + keypoint NMS + instance scoring.

    ``seed_f`` (B, P) enables the seed-time occupancy suppression; the wave
    decode has already applied it and passes None.  Returns (poses_out
    (B,P,K,4), joint_scales (B,P,K), scores (B,P), valid (B,P)).
    """
    fk = poses.shape[2]
    if seed_f is not None and config.nms.seed_suppression:
        pose_valid = nms.seed_claim_suppression(
            poses, placed, pose_valid, seed_f, image_hw=config.image_hw,
            config=config.nms)
    # group by keypoint field: (B, P, K) -> (B, K, P)
    js_cif = gather_field_grouped(
        scale_px, torch.arange(fk, device=poses.device),
        poses[..., 0].transpose(1, 2), poses[..., 1].transpose(1, 2),
        spacing=config.stride).transpose(1, 2)
    joint_scales = torch.where(js_cif > 0.0, js_cif, poses[..., 3])
    joint_scales = torch.where(placed, joint_scales, 0.0)

    poses = poses.clone()
    poses[..., 2] = torch.where(placed, poses[..., 2], 0.0)
    weights = torch.as_tensor(np.asarray(score_weights, np.float32),
                              device=poses.device)
    poses_out, scores, valid = nms.keypoint_nms(
        poses, pose_valid, joint_scales, weights, config.nms)
    return poses_out, joint_scales, scores, valid


def decode_cifcaf(cif_fields: torch.Tensor, caf_fields: torch.Tensor, *,
                  cif_meta, caf_meta, config: CifCafConfig) -> DecodedPoses:
    """Decode a batch of raw (packed) CIF/CAF head tensors.

    cif_fields: (B, Fk, 5, H, W); caf_fields: (B, Fe, 9, H, W) — raw head
    outputs (activations applied here).
    """
    fe = decode_front_end(cif_fields, caf_fields, cif_meta=cif_meta,
                          caf_meta=caf_meta, config=config)
    return decode_back_end(fe, cif_meta=cif_meta, caf_meta=caf_meta,
                           config=config)


def decode_back_end(fe: FrontEnd, *, cif_meta, caf_meta,
                    config: CifCafConfig) -> DecodedPoses:
    """Growth, joint scales and keypoint NMS on a front end's seeds and
    candidates."""
    skeleton = np.asarray(caf_meta.skeleton, np.int64) - 1
    score_weights = (cif_meta.score_weights
                     if cif_meta.score_weights is not None
                     else [1.0] * cif_meta.n_fields)
    fk = cif_meta.n_fields

    # 4) wave-recycled parallel frontier growth (seed-claim fixpoint
    # between waves)
    edges = growth.directed_edges(skeleton)
    poses, placed, pose_valid, n_dropped_poses, _, _ = growth.grow_waves(
        fe.sds, fe.cands, edges, n_keypoints=fk, image_hw=config.image_hw,
        config=config.growth, nms_config=config.nms,
        force_cand=fe.cands_fc)

    # 5-6) joint scale refinement + keypoint NMS
    poses_out, joint_scales, scores, valid = finalize_poses(
        poses, placed, pose_valid, fe.scale_px,
        score_weights=score_weights, config=config, seed_f=None)

    return DecodedPoses(
        xyv=poses_out[..., :3],
        joint_scales=joint_scales,
        scores=scores,
        valid=valid,
        n_dropped_caf=fe.n_dropped_caf,
        n_dropped_cif=fe.n_dropped_cif,
        n_dropped_poses=n_dropped_poses,
    )


def make_batch_decoder(*, cif_meta, caf_meta, config: CifCafConfig,
                       device=None):
    """Returns ``decode(cif_fields (B,Fk,5,H,W), caf_fields (B,Fe,9,H,W))
    -> DecodedPoses`` on ``device`` (``None``: the card, raising without
    CUDA).  Fields given as numpy arrays or tensors elsewhere are moved."""
    device = resolve_device(device)

    @torch.no_grad()
    def decode(cif_fields, caf_fields) -> DecodedPoses:
        cif_fields = torch.as_tensor(cif_fields, dtype=torch.float32,
                                     device=device)
        caf_fields = torch.as_tensor(caf_fields, dtype=torch.float32,
                                     device=device)
        return decode_cifcaf(cif_fields, caf_fields, cif_meta=cif_meta,
                             caf_meta=caf_meta, config=config)
    return decode
