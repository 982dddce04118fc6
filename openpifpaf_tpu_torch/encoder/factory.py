"""Encoder factory and the Encoders transform.

Port of ``openpifpaf_tpu/encoder/factory.py`` (``:21-58``) for the CIF and
CAF heads.  ``Encoders`` is applied as the final training transform,
turning (image, anns, meta) into (image, per-head targets, meta).
"""

from __future__ import annotations

import argparse
from typing import Sequence

from .caf import CafEncoder
from .cif import CifEncoder
from .. import headmeta


def factory_head(meta: headmeta.Base):
    if isinstance(meta, headmeta.Cif):
        return CifEncoder(meta)
    if isinstance(meta, headmeta.Caf):
        return CafEncoder(meta)
    raise ValueError(f'no encoder for head meta {type(meta).__name__}')


def factory(head_metas: Sequence[headmeta.Base]):
    return [factory_head(m) for m in head_metas]


def cli(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group('encoders')
    group.add_argument('--cif-side-length', default=CifEncoder.side_length,
                       type=int, help='side length of the CIF paint square')
    group.add_argument('--caf-min-size', default=CafEncoder.min_size,
                       type=int, help='min width of the CAF paint band')


def configure(args: argparse.Namespace) -> None:
    CifEncoder.side_length = args.cif_side_length
    CafEncoder.min_size = args.caf_min_size


class Encoders:
    """Final training transform: paint targets for every head."""

    def __init__(self, encoders):
        self.encoders = encoders

    def __call__(self, image, anns, meta):
        targets = tuple(enc(image, anns, meta) for enc in self.encoders)
        return image, targets, meta
