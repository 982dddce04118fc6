"""Live frame-by-frame display.

Port of ``openpifpaf_tpu/show/animation_frame.py``: an interactive
``imshow`` with the ``frame_init`` / per-frame ``update`` contract.  As in
the JAX package, no CLI uses it: the video CLI's ``--show`` is parsed and
has no effect (``video.py``).
"""

from __future__ import annotations

import logging

import numpy as np

LOG = logging.getLogger(__name__)


class AnimationFrame:
    video_fps = 10
    show = True

    def __init__(self, *, fig_width=8.0, fig_init_args=None):
        self.fig_width = fig_width
        self.fig_init_args = fig_init_args or {}
        self.fig = None
        self.ax = None
        self._im = None

    def frame_init(self, image: np.ndarray):
        import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel

        image = np.asarray(image)
        self.fig = plt.figure(
            figsize=(self.fig_width,
                     self.fig_width * image.shape[0] / image.shape[1]),
            **self.fig_init_args)
        self.ax = plt.Axes(self.fig, [0.0, 0.0, 1.0, 1.0])
        self.ax.set_axis_off()
        self.fig.add_axes(self.ax)
        self._im = self.ax.imshow(image)
        if self.show:  # pragma: no cover - interactive
            plt.ion()
            plt.show()
        return self.fig, self.ax

    def update(self, image: np.ndarray):
        """Show the next frame; clears overlays from the previous one."""
        if self.fig is None:
            return self.frame_init(image)
        for artist in list(self.ax.lines) + list(self.ax.patches):
            artist.remove()
        for text in list(self.ax.texts):
            text.remove()
        self._im.set_data(np.asarray(image))
        if self.show:  # pragma: no cover - interactive
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
        return self.fig, self.ax

    def save_frame(self, fig_file: str, dpi: int = 100):
        self.fig.savefig(fig_file, dpi=dpi)

    def close(self):
        import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel

        if self.fig is not None:
            plt.close(self.fig)
            self.fig = None
