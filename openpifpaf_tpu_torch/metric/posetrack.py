"""PoseTrack tracking metric: CLEAR-MOT scores and the prediction writer.

Port copy of ``openpifpaf_tpu/metric/posetrack.py`` (``:40-139``), numpy
and the standard library only.  The reference writes per-sequence
PoseTrack-format prediction jsons for the external ``poseval`` tool; this
metric keeps that writer and evaluates in tree: MOTA = 1 - (misses +
false positives + id switches) / ground-truth count, with OKS-based
matching per frame.
"""

from __future__ import annotations

import json
import logging
from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np

from .base import Base

LOG = logging.getLogger(__name__)


def oks(gt_xyv: np.ndarray, dt_xyv: np.ndarray,
        sigmas: np.ndarray) -> float:
    vis = gt_xyv[:, 2] > 0
    if not vis.any():
        return 0.0
    xy = gt_xyv[vis, :2]
    area = max(1.0, float((xy[:, 0].max() - xy[:, 0].min())
                          * (xy[:, 1].max() - xy[:, 1].min())))
    d2 = ((gt_xyv[:, 0] - dt_xyv[:, 0]) ** 2
          + (gt_xyv[:, 1] - dt_xyv[:, 1]) ** 2)
    e = d2[vis] / (2.0 * area * (2.0 * sigmas[vis]) ** 2 + 1e-9)
    return float(np.mean(np.exp(-e)))


class PoseTrack(Base):
    """CLEAR-MOT accumulation over tracked pose predictions."""

    text_labels = ['MOTA', 'MOTP', 'misses', 'false_positives',
                   'id_switches', 'n_gt']

    def __init__(self, *, keypoint_oks_sigmas: Sequence[float],
                 oks_threshold: float = 0.5):
        self.sigmas = np.asarray(keypoint_oks_sigmas, np.float32)
        self.oks_threshold = oks_threshold

        self.misses = 0
        self.false_positives = 0
        self.id_switches = 0
        self.n_gt = 0
        self.matched_oks: List[float] = []
        # (sequence, gt track id) -> predicted track id of the last match,
        # per sequence: id continuity is demanded within a sequence only
        # (independent eval pairs reuse gt ids 0, 1, ...)
        self.last_match: dict = {}
        self.frames = defaultdict(list)  # sequence -> [frame dicts]
        self._frame_counter = 0

    def accumulate(self, predictions, image_meta, *,
                   ground_truth: Optional[list] = None) -> None:
        sequence = (image_meta or {}).get('sequence_id', 'seq0')
        frame = {
            'image': (image_meta or {}).get('file_name',
                                            f'{self._frame_counter:06d}'),
            'predictions': [
                dict(ann.json_data(), track_id=getattr(ann, 'id_', -1))
                for ann in predictions
            ],
        }
        self.frames[sequence].append(frame)
        self._frame_counter += 1

        if ground_truth is None:
            return
        gts = [g for g in ground_truth if not getattr(g, 'iscrowd', False)]
        self.n_gt += len(gts)

        # OKS matrix gt x pred, greedy best-first matching
        scores = np.zeros((len(gts), len(predictions)), np.float32)
        for gi, gt in enumerate(gts):
            for pi, pred in enumerate(predictions):
                scores[gi, pi] = oks(np.asarray(gt.data),
                                     np.asarray(pred.data), self.sigmas)
        matched_gt, matched_pred = set(), set()
        for flat in np.argsort(-scores, axis=None):
            gi, pi = np.unravel_index(flat, scores.shape)
            if scores[gi, pi] < self.oks_threshold:
                break
            if gi in matched_gt or pi in matched_pred:
                continue
            matched_gt.add(gi)
            matched_pred.add(pi)
            self.matched_oks.append(float(scores[gi, pi]))
            gt_key = (sequence, getattr(gts[gi], 'id_', gi))
            pred_id = getattr(predictions[pi], 'id_', -1)
            if gt_key in self.last_match \
                    and self.last_match[gt_key] != pred_id:
                self.id_switches += 1
            self.last_match[gt_key] = pred_id

        self.misses += len(gts) - len(matched_gt)
        self.false_positives += len(predictions) - len(matched_pred)

    def stats(self) -> dict:
        n = max(1, self.n_gt)
        mota = 1.0 - (self.misses + self.false_positives
                      + self.id_switches) / n
        motp = float(np.mean(self.matched_oks)) if self.matched_oks else 0.0
        return {
            'stats': [mota, motp, float(self.misses),
                      float(self.false_positives),
                      float(self.id_switches), float(self.n_gt)],
            'text_labels': self.text_labels,
        }

    def predictions_json(self):
        """PoseTrack-format sequences, for offline poseval tooling."""
        return [{'sequence': seq, 'frames': frames}
                for seq, frames in sorted(self.frames.items())]

    def write_predictions(self, filename: str, *, additional_data=None):
        for seq, frames in self.frames.items():
            out = f'{filename}.{seq}.predictions.json'
            with open(out, 'w') as f:
                json.dump({'sequence': seq, 'frames': frames}, f)
            LOG.info('wrote %s', out)
        if additional_data:
            with open(filename + '.pred_meta.json', 'w') as f:
                json.dump(additional_data, f)
