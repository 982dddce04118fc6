"""CIF field debug views.

Port of ``openpifpaf_tpu/visualizer/cif.py``: renders the
confidence heatmap, regression quiver and scale circles of selected CIF
fields, for both training targets and network predictions.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import Base
from .. import headmeta

LOG = logging.getLogger(__name__)


class Cif(Base):
    def __init__(self, meta: headmeta.Cif):
        super().__init__(meta.name)
        self.meta = meta

    # ------------------------------------------------------------------
    def targets(self, field: dict, *, annotation_dicts=None) -> None:
        """Render encoder targets (dict from CifEncoder.__call__)."""
        if not self.indices:
            return
        conf = np.asarray(field['conf'])
        vec = np.asarray(field['vec'])
        scale = np.asarray(field['scale'])
        self._confidences(conf, 'targets')
        self._regressions(vec[:, 0, 0], vec[:, 0, 1], scale[:, 0],
                          conf, 'targets')

    def predicted(self, field: np.ndarray) -> None:
        """Render a predicted (activated) field tensor (F, 5, H, W)."""
        if not self.indices:
            return
        field = np.asarray(field)
        conf = field[:, 0]
        self._confidences(conf, 'predicted')
        self._regressions(field[:, 1], field[:, 2], field[:, 4],
                          conf, 'predicted')

    # ------------------------------------------------------------------
    def _confidences(self, confidences: np.ndarray, label: str) -> None:
        for f in self.indices:
            if not self.wanted(f, 'confidence'):
                continue
            LOG.debug('%s %s confidence field %d', self.head_name, label, f)
            with self.image_canvas() as ax:
                im = ax.imshow(
                    self.scale_scalar(confidences[f], self.meta.stride),
                    alpha=0.9, vmin=0.0, vmax=1.0, cmap='Oranges')
                ax.get_figure().colorbar(im, ax=ax)
                ax.set_title(f'{self.head_name} {label} confidence '
                             f'{self._field_name(f)}')

    def _regressions(self, vx: np.ndarray, vy: np.ndarray,
                     scale: np.ndarray, confidences: np.ndarray,
                     label: str) -> None:
        import matplotlib.patches  # pylint: disable=import-outside-toplevel

        stride = self.meta.stride
        for f in self.indices:
            if not self.wanted(f, 'regression'):
                continue
            with self.image_canvas() as ax:
                mask = confidences[f] > 0.1
                jj, ii = np.nonzero(mask)
                ax.quiver(ii * stride, jj * stride,
                          vx[f][mask] * stride, vy[f][mask] * stride,
                          confidences[f][mask],
                          angles='xy', scale_units='xy', scale=1.0,
                          cmap='Oranges', clim=(0.0, 1.0), width=0.002)
                for j, i in zip(jj, ii):
                    s = scale[f, j, i] * stride
                    if s <= 0:
                        continue
                    circle = matplotlib.patches.Circle(
                        ((i + vx[f, j, i]) * stride,
                         (j + vy[f, j, i]) * stride),
                        s / 2.0, fill=False, color='cyan', lw=0.5)
                    ax.add_patch(circle)
                ax.set_title(f'{self.head_name} {label} regression '
                             f'{self._field_name(f)}')

    def _field_name(self, f: int) -> str:
        if self.meta.keypoints and f < len(self.meta.keypoints):
            return self.meta.keypoints[f]
        return str(f)
