"""The ``show`` flag group of the predict and video CLIs: it configures
the painters and the animation display.

Port of ``openpifpaf_tpu/show/cli.py:16-51``, the same flags and defaults.
``--show-box``, ``--show-joint-scales``, ``--show-joint-confidences`` and
``--show-decoding-order`` set ``KeypointPainter``'s attributes, which its
``annotation`` does not read (as in the JAX package): they change no pixel.
"""

from __future__ import annotations

import argparse

from .animation_frame import AnimationFrame
from .painters import KeypointPainter


def cli(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group('show')
    group.add_argument('--show-box', default=KeypointPainter.show_box,
                       action='store_true')
    group.add_argument('--show-joint-scales',
                       default=KeypointPainter.show_joint_scales,
                       action='store_true')
    group.add_argument('--show-joint-confidences',
                       default=KeypointPainter.show_joint_confidences,
                       action='store_true')
    group.add_argument('--show-decoding-order',
                       default=KeypointPainter.show_decoding_order,
                       action='store_true')
    group.add_argument('--textbox-alpha', default=KeypointPainter.textbox_alpha,
                       type=float)
    group.add_argument('--line-width', default=KeypointPainter.line_width,
                       type=int)
    group.add_argument('--marker-size', default=KeypointPainter.marker_size,
                       type=int)
    group.add_argument('--monocolor-connections',
                       default=KeypointPainter.monocolor_connections,
                       action='store_true')
    group.add_argument('--video-fps', default=AnimationFrame.video_fps,
                       type=int)


def configure(args: argparse.Namespace) -> None:
    KeypointPainter.show_box = args.show_box
    KeypointPainter.show_joint_scales = args.show_joint_scales
    KeypointPainter.show_joint_confidences = args.show_joint_confidences
    KeypointPainter.show_decoding_order = args.show_decoding_order
    KeypointPainter.textbox_alpha = args.textbox_alpha
    KeypointPainter.line_width = args.line_width
    KeypointPainter.marker_size = args.marker_size
    KeypointPainter.monocolor_connections = args.monocolor_connections
    AnimationFrame.video_fps = args.video_fps
