"""Seed selection debug view.

Port of ``openpifpaf_tpu/visualizer/seeds.py``: scatters the
selected seed candidates (position, field type, confidence) over the image.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import Base

LOG = logging.getLogger(__name__)


class Seeds(Base):
    def __init__(self, stride: int = 1, field_names=None):
        super().__init__('seeds')
        self.stride = stride
        self.field_names = field_names

    def predicted(self, seeds) -> None:
        """Render seeds: object with (v, f, x, y, s) arrays or an (N, 5) array.

        Positions are in px; invalid entries have v <= 0.
        """
        if not any(hn == self.head_name for hn, _, _ in self.all_indices):
            return
        if hasattr(seeds, 'v'):
            v = np.asarray(seeds.v)
            f = np.asarray(seeds.f)
            x = np.asarray(seeds.x)
            y = np.asarray(seeds.y)
        else:
            seeds = np.asarray(seeds)
            v, f, x, y = seeds[:, 0], seeds[:, 1], seeds[:, 2], seeds[:, 3]
        mask = v > 0.0
        with self.image_canvas() as ax:
            sc = ax.scatter(x[mask], y[mask], c=v[mask], s=8,
                            cmap='Oranges', vmin=0.0, vmax=1.0)
            ax.get_figure().colorbar(sc, ax=ax)
            for xi, yi, fi in zip(x[mask], y[mask], f[mask].astype(int)):
                name = (self.field_names[fi]
                        if self.field_names and fi < len(self.field_names)
                        else str(fi))
                ax.annotate(name, (xi, yi), fontsize=4, alpha=0.7)
            ax.set_title('seeds')
