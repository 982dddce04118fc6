"""Pose similarity: the OKS matrix between two pose sets, and the
``PoseSimilarity`` tracker.

Port of ``openpifpaf_tpu/decoder/pose_similarity.py``.  ``oks_matrix``
(``:26-53``) serves the multi-scale merge of ``Predictor``.  Reference
parity: ``src/openpifpaf/decoder/pose_similarity.py:~20`` —
``PoseSimilarity`` decodes single-frame CifCaf poses and links them across
frames by pose similarity (OKS or euclidean), greedy best-first: the video
CLI's tracker for a model without a TCAF head.  It is never chosen by head
metas.
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from .cifcaf import CifCaf
from .decoder import Decoder
from .. import headmeta
from ..annotation import Annotation
from ..signal_ import Signal


def oks_matrix(prev_xyv: np.ndarray, curr_xyv: np.ndarray,
               sigmas: np.ndarray) -> np.ndarray:
    """Object keypoint similarity between pose sets (P, K, 3) x (Q, K, 3)."""
    vis_p = prev_xyv[..., 2] > 0.0
    vis_q = curr_xyv[..., 2] > 0.0
    both = vis_p[:, None] & vis_q[None]                       # (P, Q, K)

    d2 = ((prev_xyv[:, None, :, 0] - curr_xyv[None, :, :, 0]) ** 2
          + (prev_xyv[:, None, :, 1] - curr_xyv[None, :, :, 1]) ** 2)

    def area(xyv, vis):
        out = np.zeros(xyv.shape[0], np.float32)
        for i in range(xyv.shape[0]):
            if vis[i].sum() < 2:
                out[i] = 1.0
                continue
            xy = xyv[i, vis[i], :2]
            out[i] = max(1.0, (xy[:, 0].max() - xy[:, 0].min())
                         * (xy[:, 1].max() - xy[:, 1].min()))
        return out

    s2 = np.maximum(area(prev_xyv, vis_p)[:, None],
                    area(curr_xyv, vis_q)[None])              # (P, Q)
    k2 = (2.0 * np.asarray(sigmas, np.float32)) ** 2          # (K,)
    e = d2 / (2.0 * s2[:, :, None] * k2[None, None])
    oks_k = np.where(both, np.exp(-e), 0.0)
    denom = np.maximum(1.0, both.sum(-1))
    return oks_k.sum(-1) / denom


def euclidean_similarity(prev_xyv: np.ndarray, curr_xyv: np.ndarray,
                         scale_px: float = 100.0) -> np.ndarray:
    vis_p = prev_xyv[..., 2] > 0.0
    vis_q = curr_xyv[..., 2] > 0.0
    both = vis_p[:, None] & vis_q[None]
    d = np.sqrt((prev_xyv[:, None, :, 0] - curr_xyv[None, :, :, 0]) ** 2
                + (prev_xyv[:, None, :, 1] - curr_xyv[None, :, :, 1]) ** 2)
    sim_k = np.where(both, np.maximum(0.0, 1.0 - d / scale_px), 0.0)
    denom = np.maximum(1.0, both.sum(-1))
    return sim_k.sum(-1) / denom


class PoseSimilarity(Decoder):
    distance = 'oks'            # or 'euclidean'
    similarity_threshold = 0.3
    forget_after = 5

    def __init__(self, cif_meta: headmeta.Cif, caf_meta: headmeta.Caf, *,
                 device=None):
        self.cif_meta = cif_meta
        self.caf_meta = caf_meta
        self.cifcaf = CifCaf(cif_meta, caf_meta, device=device)
        self.reset()
        Signal.subscribe('eval_reset', self.reset)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('PoseSimilarity decoder')
        group.add_argument('--posesimilarity-distance', default=cls.distance,
                           choices=('oks', 'euclidean'))
        group.add_argument('--posesimilarity-threshold',
                           default=cls.similarity_threshold, type=float)

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.distance = args.posesimilarity_distance
        cls.similarity_threshold = args.posesimilarity_threshold

    @classmethod
    def match(cls, head_metas) -> bool:
        # never chosen by head metas (CifCaf decodes plain models); the
        # video CLI builds it for a model without a TCAF head
        return False

    @classmethod
    def factory(cls, head_metas, *, device=None) -> List['PoseSimilarity']:
        return []

    def reset(self) -> None:
        self.frame_number = 0
        self.next_track_id = 1
        self.tracks = []  # [(id, age, xyv)]

    def _similarity(self, prev_xyv, curr_xyv):
        if self.distance == 'euclidean':
            return euclidean_similarity(prev_xyv, curr_xyv)
        sigmas = np.asarray(
            self.cif_meta.sigmas if self.cif_meta.sigmas is not None
            else [0.1] * len(self.cif_meta.keypoints), np.float32)
        return oks_matrix(prev_xyv, curr_xyv, sigmas)

    def __call__(self, fields) -> List[Annotation]:
        """Decode one frame, ``fields`` = [cif (F, 5, H, W), caf (E, 9, H,
        W)] (tensors or arrays), and link its poses to the running
        tracks."""
        annotations = self.cifcaf.batch_fields(
            [torch.as_tensor(f)[None] for f in fields])[0]
        curr_xyv = (np.stack([a.data for a in annotations])
                    if annotations else
                    np.zeros((0, self.cif_meta.n_fields, 3), np.float32))

        if self.tracks:
            prev_xyv = np.stack([t[2] for t in self.tracks])
            sim = self._similarity(prev_xyv, curr_xyv) \
                if len(annotations) else np.zeros((len(self.tracks), 0))
        else:
            sim = np.zeros((0, len(annotations)))

        assigned_prev = set()
        curr_ids = [-1] * len(annotations)
        for flat in np.argsort(-sim, axis=None):
            p, q = np.unravel_index(flat, sim.shape)
            if sim[p, q] < self.similarity_threshold:
                break
            if p in assigned_prev or curr_ids[q] >= 0:
                continue
            assigned_prev.add(p)
            curr_ids[q] = self.tracks[p][0]

        new_tracks = []
        for q, ann in enumerate(annotations):
            if curr_ids[q] < 0:
                curr_ids[q] = self.next_track_id
                self.next_track_id += 1
            ann.id_ = curr_ids[q]
            new_tracks.append((curr_ids[q], 0, ann.data.copy()))

        # keep unmatched tracks alive for recovery
        for p, (tid, age, xyv) in enumerate(self.tracks):
            if p in assigned_prev or age + 1 > self.forget_after:
                continue
            new_tracks.append((tid, age + 1, xyv))
        self.tracks = new_tracks
        self.frame_number += 1
        return annotations
