"""In-memory pose annotation objects (numpy).

Port copy of ``openpifpaf_tpu/annotation.py`` (the ``Annotation`` class —
the only annotation type the CifCaf predict path produces).  Reference
parity: ``src/openpifpaf/annotation.py`` — ``Annotation`` holds a ``(K, 3)``
xyv array plus per-joint scales, computes a weighted score and emits
COCO-format ``json_data()`` (coordinates rounded to 2 decimals).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class Annotation:
    """A single decoded pose.

    ``data`` is a ``(K, 3)`` float array of (x, y, v) per keypoint where v is
    the confidence (0 = not detected).  ``joint_scales`` is a ``(K,)`` array
    of per-joint scales (pixels) used for occupancy and OKS-style scoring.
    """

    def __init__(self, keypoints: Sequence[str],
                 skeleton: Sequence[Tuple[int, int]],
                 *,
                 sigmas: Optional[Sequence[float]] = None,
                 score_weights: Optional[Sequence[float]] = None,
                 category_id: int = 1):
        self.keypoints = list(keypoints)
        self.skeleton = [tuple(s) for s in skeleton]
        self.sigmas = (np.asarray(sigmas, dtype=np.float32)
                       if sigmas is not None else None)
        self.category_id = category_id

        n = len(self.keypoints)
        self.data = np.zeros((n, 3), dtype=np.float32)
        self.joint_scales = np.zeros((n,), dtype=np.float32)
        self.fixed_score: Optional[float] = None
        # ground truth (training transforms): crowd flag and the dataset's box
        self.iscrowd = False
        self.fixed_bbox: Optional[np.ndarray] = None
        self.id_: int = -1  # tracking id

        if score_weights is not None:
            score_weights = np.asarray(score_weights, dtype=np.float32)
        else:
            score_weights = np.ones((n,), dtype=np.float32)
        self.score_weights = score_weights

    @property
    def score(self) -> float:
        """Weighted pose score: confidences sorted descending, weighted by
        ``score_weights`` and normalized by the weight sum."""
        if self.fixed_score is not None:
            return float(self.fixed_score)
        v_sorted = np.sort(self.data[:, 2])[::-1]
        return float((v_sorted * self.score_weights).sum()
                     / max(1e-8, self.score_weights.sum()))

    def bbox(self) -> np.ndarray:
        """(x, y, w, h): the fixed box if set, else from the valid joints,
        expanded by joint scales."""
        if self.fixed_bbox is not None:
            return np.asarray(self.fixed_bbox, dtype=np.float32)
        m = self.data[:, 2] > 0.0
        if not np.any(m):
            return np.zeros((4,), dtype=np.float32)
        s = np.maximum(self.joint_scales[m], 2.0)
        x = np.min(self.data[m, 0] - s)
        y = np.min(self.data[m, 1] - s)
        w = np.max(self.data[m, 0] + s) - x
        h = np.max(self.data[m, 1] + s) - y
        return np.array([x, y, w, h], dtype=np.float32)

    def json_data(self, coordinate_digits: int = 2) -> dict:
        """COCO-result-format dict (same rounding as the reference)."""
        kps = np.copy(self.data)
        kps[kps[:, 2] == 0.0, :2] = 0.0
        data = {
            'keypoints': np.around(kps, coordinate_digits).reshape(-1).tolist(),
            'bbox': [round(float(c), coordinate_digits) for c in self.bbox()],
            'score': max(0.001, round(float(self.score), 3)),
            'category_id': self.category_id,
        }
        if self.id_ >= 0:
            data['id_'] = self.id_
        return data

    def inverse_transform(self, meta) -> 'Annotation':
        """Map back to original image coordinates using transform meta
        (``x_original = (x_transformed + offset) / scale``), then undo a
        horizontal flip (mirror on the original canvas, swap left/right
        rows).  The port has no rotation transform."""
        ann = self.copy()
        ann.data[:, 0] += meta['offset'][0]
        ann.data[:, 1] += meta['offset'][1]
        ann.data[:, 0] /= meta['scale'][0]
        ann.data[:, 1] /= meta['scale'][1]
        ann.joint_scales /= meta['scale'][0]

        if meta.get('hflip', False):
            # after undoing offset/scale the frame is the original canvas
            w = meta.get('original_width_height', meta['width_height'])[0]
            ann.data[:, 0] = -ann.data[:, 0] + (w - 1)
            if meta.get('horizontal_swap') is not None:
                ann.data[:] = meta['horizontal_swap'](ann.data)
        return ann

    def copy(self) -> 'Annotation':
        out = Annotation(self.keypoints, self.skeleton, sigmas=self.sigmas,
                         score_weights=self.score_weights,
                         category_id=self.category_id)
        out.data = np.copy(self.data)
        out.joint_scales = np.copy(self.joint_scales)
        out.fixed_score = self.fixed_score
        out.iscrowd = self.iscrowd
        out.id_ = self.id_
        out.fixed_bbox = (None if self.fixed_bbox is None
                          else np.copy(self.fixed_bbox))
        return out

    def __repr__(self):
        return (f'Annotation(category_id={self.category_id}, '
                f'score={self.score:.3f}, '
                f'n_visible={int((self.data[:, 2] > 0).sum())})')
