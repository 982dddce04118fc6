"""Annotation painters.

Port of ``openpifpaf_tpu/show/painters.py:23-133``: ``KeypointPainter``
draws skeletons with a colour per limb and the score in a text box,
``DetectionPainter`` boxes, ``CrowdPainter`` filled crowd regions, and
``AnnotationPainter`` dispatches on the annotation's class name.  The same
matplotlib calls with the same arguments, so equal annotations give equal
pixels.  Kept from the JAX package: ``KeypointPainter.annotation`` reads
none of ``show_box``, ``show_joint_scales``, ``show_joint_confidences``
and ``show_decoding_order``; ``AnnotationPainter``'s default painters have
no ``CrowdPainter``, so an ``AnnotationCrowd`` is logged and skipped; and
``CrowdPainter`` draws only an annotation with a ``fixed_bbox``.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from ..annotation import Annotation, AnnotationDet

LOG = logging.getLogger(__name__)


class KeypointPainter:
    show_joint_scales = False
    show_joint_confidences = False
    show_decoding_order = False
    show_box = False
    textbox_alpha = 0.5
    text_color = 'white'
    monocolor_connections = False
    line_width = 2
    marker_size = 3
    solid_threshold = 0.5

    def __init__(self, *, xy_scale=1.0, highlight=None):
        self.xy_scale = xy_scale
        self.highlight = highlight

    def _draw_skeleton(self, ax, x, y, v, *, skeleton, color=None, alpha=1.0):
        import matplotlib  # pylint: disable=import-outside-toplevel

        if not np.any(v > 0):
            return
        for ci, (j1i, j2i) in enumerate(np.array(skeleton) - 1):
            if v[j1i] <= 0 or v[j2i] <= 0:
                continue
            c = color
            if not self.monocolor_connections:
                c = matplotlib.colormaps['tab20']((ci % 20 + 0.05) / 20)
            ax.plot([x[j1i], x[j2i]], [y[j1i], y[j2i]],
                    linewidth=self.line_width, color=c,
                    linestyle='solid' if v[j1i] > self.solid_threshold
                    and v[j2i] > self.solid_threshold else 'dashed',
                    alpha=alpha)
        m = v > 0
        ax.plot(x[m], y[m], 'o', markersize=self.marker_size,
                markerfacecolor=color or 'white', markeredgewidth=1,
                alpha=alpha)

    def annotation(self, ax, ann: Annotation, *, color=None, text=None):
        x = ann.data[:, 0] * self.xy_scale
        y = ann.data[:, 1] * self.xy_scale
        v = ann.data[:, 2]
        self._draw_skeleton(ax, x, y, v, skeleton=ann.skeleton, color=color)
        if text is None:
            text = f'{ann.score:.0%}'
        m = v > 0
        if np.any(m):
            ax.annotate(text, (np.min(x[m]), np.min(y[m])),
                        fontsize=8, color=self.text_color,
                        bbox={'facecolor': color or 'black',
                              'alpha': self.textbox_alpha, 'linewidth': 0})


class DetectionPainter:
    def __init__(self, *, xy_scale=1.0):
        self.xy_scale = xy_scale

    def annotation(self, ax, ann: AnnotationDet, *, color=None, text=None):
        import matplotlib.patches  # pylint: disable=import-outside-toplevel

        if color is None:
            color = 'red'
        x, y, w, h = np.asarray(ann.bbox) * self.xy_scale
        ax.add_patch(matplotlib.patches.Rectangle(
            (x, y), w, h, fill=False, color=color, linewidth=1.5))
        if text is None:
            text = f'{ann.category} {ann.score:.0%}'
        ax.annotate(text, (x, y), fontsize=8, color='white',
                    bbox={'facecolor': color, 'alpha': 0.5, 'linewidth': 0})


class CrowdPainter:
    def __init__(self, *, alpha=0.5, color='orange'):
        self.alpha = alpha
        self.color = color

    def annotation(self, ax, ann, *, color=None, text=None):
        import matplotlib.patches  # pylint: disable=import-outside-toplevel

        if getattr(ann, 'fixed_bbox', None) is None:
            return
        x, y, w, h = np.asarray(ann.fixed_bbox)
        ax.add_patch(matplotlib.patches.Rectangle(
            (x, y), w, h, fill=True, alpha=self.alpha,
            color=color or self.color))


class AnnotationPainter:
    def __init__(self, *, xy_scale=1.0, painters=None):
        self.painters = painters or {
            'Annotation': KeypointPainter(xy_scale=xy_scale),
            'AnnotationDet': DetectionPainter(xy_scale=xy_scale),
        }

    def annotations(self, ax, annotations: List, *, color=None,
                    colors=None, texts=None):
        import matplotlib  # pylint: disable=import-outside-toplevel

        for i, ann in enumerate(annotations):
            this_color = color
            if colors is not None:
                this_color = colors[i]
            if this_color is None:
                this_color = matplotlib.colormaps['tab20'](
                    (i % 20 + 0.05) / 20)
            text = texts[i] if texts is not None else None
            painter = self.painters.get(type(ann).__name__)
            if painter is None:
                LOG.warning('no painter for %s', type(ann).__name__)
                continue
            painter.annotation(ax, ann, color=this_color, text=text)
