"""Matplotlib canvases: ``image_canvas`` (draw over an image) and
``canvas`` (blank axes), each saved to a file or shown.

Port of ``openpifpaf_tpu/show/canvas.py:14-52``, the same figure sizes,
axes and dpi, so the same drawing gives the same pixels.  matplotlib is
imported inside the functions only.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np


def require_matplotlib() -> None:
    """Import matplotlib now: a run asked to render (``-o``,
    ``--video-output``, ``--debug-indices``, the logs plots) raises its
    ``ImportError`` before any work, not after it."""
    import matplotlib  # pylint: disable=import-outside-toplevel,unused-import
    import matplotlib.pyplot  # pylint: disable=import-outside-toplevel,unused-import


@contextmanager
def canvas(fig_file=None, *, show=True, dpi=150, nomargin=False, **kwargs):
    import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel

    fig, ax = plt.subplots(**kwargs)
    yield ax
    fig.set_layout_engine('none' if nomargin else 'tight')
    if fig_file:
        fig.savefig(fig_file, dpi=dpi)
    if show and not fig_file:  # pragma: no cover - interactive
        plt.show()
    plt.close(fig)


@contextmanager
def image_canvas(image, fig_file=None, *, show=True, dpi_factor=1.0,
                 fig_width=10.0, **kwargs):
    import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel

    image = np.asarray(image)
    fig = plt.figure(figsize=(fig_width,
                              fig_width * image.shape[0] / image.shape[1]))
    ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
    ax.set_axis_off()
    ax.set_xlim(0, image.shape[1])
    ax.set_ylim(image.shape[0], 0)
    fig.add_axes(ax)
    ax.imshow(image, **kwargs)
    yield ax
    if fig_file:
        fig.savefig(fig_file, dpi=image.shape[1] / fig_width * dpi_factor)
    if show and not fig_file:  # pragma: no cover - interactive
        plt.show()
    plt.close(fig)


def white_screen(ax, alpha=0.9):
    ax.set_facecolor('white')
    ax.patch.set_alpha(alpha)
