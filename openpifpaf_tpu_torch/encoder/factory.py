"""Encoder factory and the Encoders transform.

Port of ``openpifpaf_tpu/encoder/factory.py`` (``:21-85``) for the CIF, CAF
and TCAF heads.  ``Encoders`` is applied as the final training transform,
turning (image, anns, meta) into (image, per-head targets, meta);
``TrackingEncoders`` does it for frame pairs.
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np

from .caf import CafEncoder
from .cif import CifEncoder
from .tcaf import TcafEncoder
from .. import headmeta


def factory_head(meta: headmeta.Base):
    if isinstance(meta, headmeta.Cif):
        return CifEncoder(meta)
    if isinstance(meta, headmeta.Caf):
        return CafEncoder(meta)
    if isinstance(meta, headmeta.Tcaf):
        return TcafEncoder(meta)
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


class TrackingEncoders:
    """Final training transform for frame pairs: single-frame heads get
    per-frame targets stacked on a leading pair axis (folded into the batch
    by the loss, ``losses/composite.py``); ``Tcaf`` heads get one
    cross-frame target, painted on the current frame's grid."""

    def __init__(self, encoders):
        self.encoders = encoders

    def __call__(self, images, anns_pair, meta):
        image1, image2 = images
        anns1, anns2 = anns_pair
        targets = []
        for enc in self.encoders:
            if isinstance(enc, TcafEncoder):
                targets.append(enc(image2, (anns1, anns2), meta))
            else:
                t1 = enc(image1, anns1, meta)
                t2 = enc(image2, anns2, meta)
                targets.append({k: np.stack([t1[k], t2[k]]) for k in t1})
        return images, tuple(targets), meta
