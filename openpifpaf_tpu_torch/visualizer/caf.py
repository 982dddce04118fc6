"""CAF field debug views.

Port of ``openpifpaf_tpu/visualizer/caf.py``: renders the
confidence heatmap and the two-endpoint association arrows of selected CAF
fields, for both training targets and network predictions.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import Base
from .. import headmeta

LOG = logging.getLogger(__name__)


class Caf(Base):
    def __init__(self, meta: headmeta.Caf):
        super().__init__(meta.name)
        self.meta = meta

    # ------------------------------------------------------------------
    def targets(self, field: dict, *, annotation_dicts=None) -> None:
        """Render encoder targets (dict from CafEncoder.__call__)."""
        if not self.indices:
            return
        conf = np.asarray(field['conf'])
        vec = np.asarray(field['vec'])
        self._confidences(conf, 'targets')
        self._associations(vec[:, 0], vec[:, 1], conf, 'targets')

    def predicted(self, field: np.ndarray) -> None:
        """Render a predicted (activated) field tensor (F, 9, H, W)."""
        if not self.indices:
            return
        field = np.asarray(field)
        conf = field[:, 0]
        vec1 = field[:, 1:3]
        vec2 = field[:, 3:5]
        self._confidences(conf, 'predicted')
        self._associations(vec1, vec2, conf, 'predicted')

    # ------------------------------------------------------------------
    def _confidences(self, confidences: np.ndarray, label: str) -> None:
        for f in self.indices:
            if not self.wanted(f, 'confidence'):
                continue
            LOG.debug('%s %s confidence field %d', self.head_name, label, f)
            with self.image_canvas() as ax:
                im = ax.imshow(
                    self.scale_scalar(confidences[f], self.meta.stride),
                    alpha=0.9, vmin=0.0, vmax=1.0, cmap='Blues')
                ax.get_figure().colorbar(im, ax=ax)
                ax.set_title(f'{self.head_name} {label} confidence '
                             f'{self._field_name(f)}')

    def _associations(self, vec1: np.ndarray, vec2: np.ndarray,
                      confidences: np.ndarray, label: str) -> None:
        stride = self.meta.stride
        for f in self.indices:
            if not self.wanted(f, 'regression'):
                continue
            with self.image_canvas() as ax:
                mask = confidences[f] > 0.1
                jj, ii = np.nonzero(mask)
                x1 = (ii + vec1[f, 0][mask]) * stride
                y1 = (jj + vec1[f, 1][mask]) * stride
                x2 = (ii + vec2[f, 0][mask]) * stride
                y2 = (jj + vec2[f, 1][mask]) * stride
                for a, b, c, d, v in zip(x1, y1, x2, y2,
                                         confidences[f][mask]):
                    ax.plot([a, c], [b, d], '-', color='blue',
                            alpha=float(min(1.0, v)), lw=0.5)
                ax.plot(x1, y1, '.', color='green', markersize=1)
                ax.plot(x2, y2, '.', color='red', markersize=1)
                ax.set_title(f'{self.head_name} {label} association '
                             f'{self._field_name(f)}')

    def _field_name(self, f: int) -> str:
        if self.meta.skeleton and f < len(self.meta.skeleton):
            j1, j2 = self.meta.skeleton[f]
            if self.meta.keypoints:
                return (f'{self.meta.keypoints[j1 - 1]}-'
                        f'{self.meta.keypoints[j2 - 1]}')
        return str(f)
