"""TrackingPose decoder: per-frame poses and TCAF track association.

Port of ``openpifpaf_tpu/decoder/tracking_pose.py`` (``:29-250``).
Reference parity: ``src/openpifpaf/decoder/tracking_pose.py:~30`` — per
frame CifCaf poses, associated across the frame pair by TCAF connections,
with ``frame_number`` and track ids.  Each frame decodes at batch 1
through the port's CifCaf decode (``CifCaf._decoder_for``, so K1 runs
there on the card), and the association (``ops/tracking.py``) runs on the
same device with one readback, the match.  The ids, the carry-over of
recently lost tracks into free pose slots (``forget_after``), the
``sequence_id`` reset and ``batch_fields`` over the pairs of a batch stay
on the host: they are sequential across frames.  The TCAF debug view
(``--debug-indices tcaf:N``) waits for the visualizers.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import List, Optional

import numpy as np
import torch

from .cifcaf import CifCaf
from .decoder import Decoder
from .. import headmeta
from ..annotation import Annotation
from ..ops import TrackingConfig, tracking
from ..signal_ import Signal

LOG = logging.getLogger(__name__)


class TrackingPose(Decoder):
    # class-level configuration (reference tracking_pose.py statics)
    forget_after = 5            # frames a track survives without a match
    track_threshold = 0.05      # min association score (ops.TrackingConfig)
    tcaf_score_th = 0.2
    max_track_candidates = 128

    def __init__(self, cif_meta: headmeta.Cif, caf_meta: headmeta.Caf,
                 tcaf_meta: headmeta.Tcaf, *, device=None):
        self.cif_meta = cif_meta
        self.caf_meta = caf_meta
        self.tcaf_meta = tcaf_meta
        self.cifcaf = CifCaf(cif_meta, caf_meta, device=device)
        self.device = self.cifcaf.device
        self.reset()
        Signal.subscribe('eval_reset', self.reset)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('TrackingPose decoder')
        group.add_argument('--tracking-forget-after',
                           default=cls.forget_after, type=int,
                           help='frames a track survives without a match')
        group.add_argument('--tracking-threshold',
                           default=cls.track_threshold, type=float,
                           help='minimum TCAF association score to link')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.forget_after = args.tracking_forget_after
        cls.track_threshold = args.tracking_threshold

    @classmethod
    def match(cls, head_metas) -> bool:
        return (len(head_metas) >= 3
                and isinstance(head_metas[0], headmeta.Cif)
                and isinstance(head_metas[1], headmeta.Caf)
                and isinstance(head_metas[2], headmeta.Tcaf))

    @classmethod
    def factory(cls, head_metas, *, device=None) -> List['TrackingPose']:
        if not cls.match(head_metas):
            return []
        return [cls(head_metas[0], head_metas[1], head_metas[2],
                    device=device)]

    # ------------------------------------------------------------------
    def reset(self) -> None:
        self.next_track_id = 1
        self._sequence = None
        self.reset_tracks()

    def reset_tracks(self) -> None:
        """Drop the track memory (sequence boundary); ids keep counting
        so they stay unique across sequences."""
        self.frame_number = 0
        self.last_association_time = 0.0
        # the previous frame's state, on the host
        self.prev_xyv = None        # (P, K, 3) px
        self.prev_valid = None      # (P,) float
        self.prev_ids = None        # (P,) int
        self.prev_ages = None       # (P,) int

    def tracking_config(self) -> TrackingConfig:
        return TrackingConfig(
            score_th=self.tcaf_score_th,
            max_candidates=self.max_track_candidates,
            min_match_score=self.track_threshold,
            max_tracks=self.cifcaf.max_poses)

    def _decode_frame(self, cif_field, caf_field):
        """One frame's decode on the device: ``DecodedPoses`` of tensors
        without the batch axis."""
        h, w = cif_field.shape[-2:]
        stride = self.cif_meta.stride
        image_hw = ((h - 1) * stride + 1, (w - 1) * stride + 1)
        decode = self.cifcaf._decoder_for(image_hw)  # pylint: disable=protected-access
        decoded = decode(cif_field[None], caf_field[None])
        return type(decoded)(*[x[0] for x in decoded])

    @staticmethod
    def _host(decoded):
        return type(decoded)(*[x.cpu().numpy() for x in decoded])

    def _start_tracks(self, decoded) -> None:
        valid = np.asarray(decoded.valid, bool)
        n = valid.shape[0]
        self.prev_xyv = np.asarray(decoded.xyv)
        self.prev_valid = valid.astype(np.float32)
        self.prev_ids = np.full((n,), -1, np.int64)
        self.prev_ages = np.zeros((n,), np.int64)
        for p in np.nonzero(valid)[0]:
            self.prev_ids[p] = self.next_track_id
            self.next_track_id += 1

    def __call__(self, fields, meta: Optional[dict] = None) -> List[Annotation]:
        """Decode one frame pair.

        ``fields``: [cif (2, F, 5, h, w), caf (2, E, 9, h, w),
        tcaf (K, 9, h, w)], tensors or arrays — frame 0 is the previous
        frame, frame 1 the current one (``models/tracking_base.py``).

        ``meta['sequence_id']`` (when present) segments the track state: a
        new sequence drops the track memory, so independent eval pairs
        never associate against another image's poses, and a real sequence
        keeps its ids across its consecutive pairs.
        """
        sequence = (meta or {}).get('sequence_id')
        if sequence is not None and sequence != self._sequence:
            self._sequence = sequence
            self.reset_tracks()

        cif_pair = torch.as_tensor(fields[self.cif_meta.head_index])
        caf_pair = torch.as_tensor(fields[self.caf_meta.head_index])
        tcaf_field = torch.as_tensor(fields[self.tcaf_meta.head_index],
                                     dtype=torch.float32, device=self.device)

        if self.frame_number == 0 or self.prev_xyv is None:
            self._start_tracks(self._host(
                self._decode_frame(cif_pair[0], caf_pair[0])))

        on_device = self._decode_frame(cif_pair[1], caf_pair[1])
        decoded = self._host(on_device)
        curr_xyv = decoded.xyv
        curr_valid = decoded.valid.astype(bool)

        start = time.perf_counter()   # the decode's readback synchronized
        match, _ = tracking.associate(
            tcaf_field, self.prev_xyv, self.prev_valid, on_device.xyv,
            on_device.valid.float(), tcaf_meta=self.tcaf_meta,
            config=self.tracking_config())
        self.last_association_time = time.perf_counter() - start

        # host id bookkeeping
        n = curr_valid.shape[0]
        curr_ids = np.full((n,), -1, np.int64)
        curr_ages = np.zeros((n,), np.int64)
        matched_prev = set()
        for q in np.nonzero(curr_valid)[0]:
            p = int(match[q])
            if p >= 0 and self.prev_ids[p] >= 0 and p not in matched_prev:
                curr_ids[q] = self.prev_ids[p]
                matched_prev.add(p)
            else:
                curr_ids[q] = self.next_track_id
                self.next_track_id += 1

        # carry recently lost tracks over into free (invalid) pose slots,
        # so that they can recover (the reference's recovery window)
        free_slots = [q for q in range(n) if not curr_valid[q]]
        kept_xyv = curr_xyv.copy()
        kept_valid = curr_valid.astype(np.float32)
        for p in range(self.prev_valid.shape[0]):
            if self.prev_valid[p] <= 0 or p in matched_prev:
                continue
            age = self.prev_ages[p] + 1
            if age > self.forget_after or not free_slots:
                continue
            q = free_slots.pop(0)
            kept_xyv[q] = self.prev_xyv[p]
            kept_valid[q] = 1.0
            curr_ids[q] = self.prev_ids[p]
            curr_ages[q] = age

        self.prev_xyv = kept_xyv
        self.prev_valid = kept_valid
        self.prev_ids = curr_ids
        self.prev_ages = curr_ages
        self.frame_number += 1

        annotations = []
        for q in np.argsort(-decoded.scores):
            if not curr_valid[q]:
                continue
            ann = Annotation(
                self.cif_meta.keypoints, self.caf_meta.skeleton,
                sigmas=self.cif_meta.sigmas,
                score_weights=self.cif_meta.score_weights)
            ann.data[:] = curr_xyv[q]
            ann.joint_scales[:] = decoded.joint_scales[q]
            ann.fixed_score = float(decoded.scores[q])
            ann.id_ = int(curr_ids[q])
            annotations.append(ann)
        return annotations

    def batch_fields(self, fields, metas=None) -> List[List[Annotation]]:
        """Decode a batch of frame pairs, interleaved as the tracking model
        gives them, in order: the track state carries over within a
        sequence, and ``metas[i]['sequence_id']`` boundaries reset it."""
        cif = fields[self.cif_meta.head_index]
        caf = fields[self.caf_meta.head_index]
        tcaf = fields[self.tcaf_meta.head_index]
        return [
            self([cif[2 * i:2 * i + 2], caf[2 * i:2 * i + 2], tcaf[i]],
                 meta=metas[i] if metas else None)
            for i in range(tcaf.shape[0])
        ]
