"""Rendering of predictions with matplotlib.

Port of ``openpifpaf_tpu/show/``.  Importing it loads no matplotlib: the
rendering functions import it when they run, so the package imports on a
machine without it, and a run that was asked to render raises there
(``canvas.require_matplotlib``).
"""

from .animation_frame import AnimationFrame
from . import cli as cli_mod
from .canvas import canvas, image_canvas, require_matplotlib, white_screen
from .painters import (AnnotationPainter, CrowdPainter, DetectionPainter,
                       KeypointPainter)

cli = cli_mod.cli
configure = cli_mod.configure

__all__ = ['AnimationFrame', 'cli', 'configure', 'canvas', 'image_canvas',
           'require_matplotlib', 'white_screen', 'AnnotationPainter',
           'CrowdPainter', 'DetectionPainter', 'KeypointPainter']
