"""Occupancy mask debug view.

Port of ``openpifpaf_tpu/visualizer/occupancy.py``: renders the
per-field occupancy grids that suppress duplicate seeds/joints during
decoding.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import Base

LOG = logging.getLogger(__name__)


class Occupancy(Base):
    def __init__(self, *, reduction: int = 1, field_names=None):
        super().__init__('occupancy')
        self.reduction = reduction
        self.field_names = field_names

    def predicted(self, occupancy: np.ndarray) -> None:
        """Render selected occupancy fields (F, H, W) (bool or float)."""
        if not self.indices:
            return
        occupancy = np.asarray(occupancy, np.float32)
        for f in self.indices:
            LOG.debug('occupancy field %d', f)
            with self.image_canvas() as ax:
                ax.imshow(self.scale_scalar(occupancy[f], self.reduction),
                          alpha=0.7, vmin=0.0, vmax=1.0, cmap='Greys')
                name = (self.field_names[f]
                        if self.field_names and f < len(self.field_names)
                        else str(f))
                ax.set_title(f'occupancy {name}')
