"""Pose similarity: the OKS matrix between two pose sets.

Port of ``oks_matrix`` of ``openpifpaf_tpu/decoder/pose_similarity.py``
(``:26-53``), which the multi-scale merge of ``Predictor`` uses.  The
``PoseSimilarity`` tracker of that module waits for the tracking slice.
"""

from __future__ import annotations

import numpy as np


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
