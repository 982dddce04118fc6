"""AnnRescaler: annotation coordinates -> feature-cell grid.

Port copy of ``openpifpaf_tpu/encoder/annrescaler.py`` (``:16-63``), numpy
only.  Reference parity: ``src/openpifpaf/encoder/annrescaler.py:~20`` —
scales keypoints to the stride grid, computes per-instance scales and the
background mask (cells covered by crowd regions are excluded from the
confidence loss).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class AnnRescaler:
    def __init__(self, stride: int, pose: np.ndarray = None):
        self.stride = stride
        self.pose = pose

    def keypoint_sets(self, anns) -> List[np.ndarray]:
        """(K, 3) arrays in feature-cell coordinates, skipping crowd anns."""
        out = []
        for ann in anns:
            if getattr(ann, 'iscrowd', False):
                continue
            kps = np.copy(ann.data)
            kps[:, :2] /= self.stride
            out.append(kps)
        return out

    def bg_mask(self, anns, field_hw: Tuple[int, int],
                crowd_margin: float = 0.0) -> np.ndarray:
        """(H, W) bool mask: True where the confidence loss applies.

        Crowd-annotation bounding boxes are masked out (reference bg_mask
        semantics: crowd regions produce no background gradient).
        """
        h, w = field_hw
        mask = np.ones((h, w), dtype=bool)
        for ann in anns:
            if not getattr(ann, 'iscrowd', False):
                continue
            bbox = ann.bbox() if callable(getattr(ann, 'bbox', None)) \
                else getattr(ann, 'bbox', None)
            if bbox is None:
                continue
            x0 = int(np.floor((bbox[0] - crowd_margin) / self.stride))
            y0 = int(np.floor((bbox[1] - crowd_margin) / self.stride))
            x1 = int(np.ceil((bbox[0] + bbox[2] + crowd_margin) / self.stride))
            y1 = int(np.ceil((bbox[1] + bbox[3] + crowd_margin) / self.stride))
            mask[max(0, y0):max(0, y1) + 1, max(0, x0):max(0, x1) + 1] = False
        return mask

    def scale(self, keypoints_cells: np.ndarray) -> float:
        """Instance scale in feature-cell units (sqrt of visible-kp area)."""
        visible = keypoints_cells[:, 2] > 0.0
        if visible.sum() < 2:
            return 4.0 / self.stride  # minimal fallback scale
        xy = keypoints_cells[visible, :2]
        area = max(1e-4, (xy[:, 0].max() - xy[:, 0].min())
                   * (xy[:, 1].max() - xy[:, 1].min()))
        return float(np.sqrt(area))
