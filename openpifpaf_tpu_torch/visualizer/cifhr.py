"""CifHr accumulator debug view.

Port of ``openpifpaf_tpu/visualizer/cifhr.py``: renders the
high-resolution confidence accumulation produced during decoding.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import Base
from .. import headmeta

LOG = logging.getLogger(__name__)


class CifHr(Base):
    def __init__(self, meta: headmeta.Cif = None, *,
                 stride: int = 1, field_names=None):
        super().__init__('cifhr')
        self.meta = meta
        self._stride = meta.stride if meta is not None else stride
        self._field_names = (meta.keypoints if meta is not None
                             else field_names)

    def predicted(self, hr_fields: np.ndarray, *, spacing: int = 2) -> None:
        """Render selected hires accumulator fields (F, Hh, Wh)."""
        if not self.indices:
            return
        hr_fields = np.asarray(hr_fields)
        for f in self.indices:
            LOG.debug('cifhr field %d', f)
            with self.image_canvas() as ax:
                im = ax.imshow(self.scale_scalar(hr_fields[f], spacing),
                               alpha=0.9, vmin=0.0, vmax=1.0,
                               cmap='Oranges')
                ax.get_figure().colorbar(im, ax=ax)
                name = (self._field_names[f]
                        if self._field_names and f < len(self._field_names)
                        else str(f))
                ax.set_title(f'cifhr {name}')
