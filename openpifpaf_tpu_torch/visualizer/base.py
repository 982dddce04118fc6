"""Visualizer base: debug views of fields during training and decoding.

Port of ``openpifpaf_tpu/visualizer/base.py:24-135``: the class-level
registry of wanted fields (``--debug-indices``), the ``--save-all``
directory with its ``NNNN-<head>.jpeg`` file names, the current image and
network input, and ``scale_scalar``.  Rendering is matplotlib on numpy
arrays; a visualizer with no wanted field returns before drawing.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

import numpy as np

LOG = logging.getLogger(__name__)


class Base:
    all_indices: List[tuple] = []          # [(head_name, field_index, type)]
    common_ax = None
    processed_image_intensity_spread = 2.0
    save_dir: Optional[str] = None         # write figures here instead of showing
    _save_counter = 0

    _image: Optional[np.ndarray] = None
    _processed_image: Optional[np.ndarray] = None
    _image_meta: Optional[dict] = None

    def __init__(self, head_name: str):
        self.head_name = head_name
        self._ax = None

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('visualizer')
        group.add_argument('--debug-indices', default=[], nargs='+',
                           help='indices of fields to create debug plots for '
                                'of the form headname:fieldindex, e.g. cif:5')
        group.add_argument('--save-all', nargs='?', default=None,
                           const='all-images/',
                           help='every debug plot is saved to this directory '
                                'instead of being shown')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        if args.debug_indices:
            # the views render with matplotlib: without it the run stops
            # here, before any work
            from ..show.canvas import require_matplotlib  # pylint: disable=import-outside-toplevel
            require_matplotlib()
        cls.set_all_indices(args.debug_indices)
        cls.save_dir = args.save_all

    @classmethod
    def set_all_indices(cls, indices: List[str]) -> None:
        cls.all_indices = []
        for index in indices:
            parts = index.split(':')
            head_name = parts[0]
            field_str = parts[1] if len(parts) > 1 else '0'
            type_ = parts[2] if len(parts) > 2 else 'all'
            cls.all_indices.append((head_name, int(field_str), type_))

    # ------------------------------------------------------------------
    @classmethod
    def image(cls, image=None, meta=None) -> None:
        """Set the current un-processed image (original pixel space)."""
        if image is None:
            cls._image = None
            cls._image_meta = None
            return
        cls._image = np.asarray(image)
        cls._image_meta = meta

    @classmethod
    def processed_image(cls, image=None) -> None:
        """Set the current network-input image (normalized CHW or HWC)."""
        if image is None:
            cls._processed_image = None
            return
        image = np.asarray(image, dtype=np.float32)
        if image.ndim == 3 and image.shape[0] in (1, 3):  # CHW -> HWC
            image = np.moveaxis(image, 0, -1)
        # undo normalization for display
        spread = cls.processed_image_intensity_spread
        image = np.clip(image / spread * 0.5 + 0.5, 0.0, 1.0)
        cls._processed_image = image

    @classmethod
    def reset(cls) -> None:
        cls._image = None
        cls._processed_image = None
        cls._image_meta = None

    # ------------------------------------------------------------------
    @property
    def indices(self) -> List[int]:
        return [f for hn, f, _ in self.all_indices if hn == self.head_name]

    def wanted(self, field_index: int, type_: str = 'all') -> bool:
        for head_name, f, t in self.all_indices:
            if head_name != self.head_name or f != field_index:
                continue
            if t in ('all', type_):
                return True
        return False

    # drawing helpers ---------------------------------------------------
    def image_canvas(self, fig_file=None, **kwargs):
        from ..show.canvas import image_canvas  # pylint: disable=import-outside-toplevel

        image = (self._processed_image if self._processed_image is not None
                 else self._image)
        if image is None:
            image = np.zeros((100, 100, 3), np.float32)
        if fig_file is None and Base.save_dir is not None:
            os.makedirs(Base.save_dir, exist_ok=True)
            Base._save_counter += 1
            fig_file = os.path.join(
                Base.save_dir,
                f'{Base._save_counter:04d}-{self.head_name}.jpeg')
        return image_canvas(image, fig_file, show=fig_file is None, **kwargs)

    @staticmethod
    def scale_scalar(field: np.ndarray, stride: int) -> np.ndarray:
        """Upsample a stride-resolution scalar field to pixel resolution."""
        field = np.repeat(np.asarray(field), stride, 0)
        field = np.repeat(field, stride, 1)
        # center the feature cells on their receptive field centers
        half = stride // 2
        return np.pad(field, ((half, 0), (half, 0)), mode='edge')[
            :field.shape[0], :field.shape[1]]
