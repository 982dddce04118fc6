"""CifDet field debug views.

Port of ``openpifpaf_tpu/visualizer/cifdet.py``: renders the
per-category confidence heatmap and regressed boxes of selected CifDet
fields.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import Base
from .. import headmeta

LOG = logging.getLogger(__name__)


class CifDet(Base):
    def __init__(self, meta: headmeta.CifDet):
        super().__init__(meta.name)
        self.meta = meta

    # ------------------------------------------------------------------
    def targets(self, field: dict, *, annotation_dicts=None) -> None:
        if not self.indices:
            return
        conf = np.asarray(field['conf'])
        vec = np.asarray(field['vec'])
        self._confidences(conf, 'targets')
        self._boxes(vec[:, 0], vec[:, 1], conf, 'targets')

    def predicted(self, field: np.ndarray) -> None:
        """Render a predicted (activated) field tensor (F, 7, H, W)."""
        if not self.indices:
            return
        field = np.asarray(field)
        self._confidences(field[:, 0], 'predicted')
        self._boxes(field[:, 1:3], field[:, 3:5], field[:, 0], 'predicted')

    # ------------------------------------------------------------------
    def _confidences(self, confidences: np.ndarray, label: str) -> None:
        for f in self.indices:
            if not self.wanted(f, 'confidence'):
                continue
            LOG.debug('%s %s confidence field %d', self.head_name, label, f)
            with self.image_canvas() as ax:
                im = ax.imshow(
                    self.scale_scalar(confidences[f], self.meta.stride),
                    alpha=0.9, vmin=0.0, vmax=1.0, cmap='Greens')
                ax.get_figure().colorbar(im, ax=ax)
                ax.set_title(f'{self.head_name} {label} confidence '
                             f'{self._field_name(f)}')

    def _boxes(self, center_vec: np.ndarray, wh_vec: np.ndarray,
               confidences: np.ndarray, label: str) -> None:
        import matplotlib.patches  # pylint: disable=import-outside-toplevel

        stride = self.meta.stride
        for f in self.indices:
            if not self.wanted(f, 'regression'):
                continue
            with self.image_canvas() as ax:
                mask = confidences[f] > 0.1
                jj, ii = np.nonzero(mask)
                for j, i in zip(jj, ii):
                    cx = (i + center_vec[f, 0, j, i]) * stride
                    cy = (j + center_vec[f, 1, j, i]) * stride
                    w = wh_vec[f, 0, j, i] * stride
                    h = wh_vec[f, 1, j, i] * stride
                    rect = matplotlib.patches.Rectangle(
                        (cx - w / 2.0, cy - h / 2.0), w, h,
                        fill=False, color='green',
                        alpha=float(min(1.0, confidences[f, j, i])), lw=0.5)
                    ax.add_patch(rect)
                ax.set_title(f'{self.head_name} {label} boxes '
                             f'{self._field_name(f)}')

    def _field_name(self, f: int) -> str:
        if self.meta.categories and f < len(self.meta.categories):
            return self.meta.categories[f]
        return str(f)
