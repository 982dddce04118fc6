"""Decoder registry, CLI and factory.

Port of ``openpifpaf_tpu/decoder/factory.py``: the decoders are matched
against the model's head metas.  ``DECODERS`` holds CifCaf, CifDet,
TrackingPose and PoseSimilarity (which no head metas select);
TrackingPose takes precedence over CifCaf on the same heads
(``factory.py:74-77``).  One matching decoder is returned as it is; more
(a model with pose and detection heads, from ``--dataset toykp,cifar10``)
are wrapped in ``Multi``.  ``DECODERS`` is a tuple, so ``Multi`` runs them
in a fixed order, CifCaf before CifDet; the JAX package's is a ``set``,
whose order may change from one process to the next.
"""

from __future__ import annotations

import argparse
import logging

from .cifcaf import CifCaf
from .cifdet import CifDet
from .decoder import Decoder
from .multi import Multi
from .pose_similarity import PoseSimilarity
from .tracking_pose import TrackingPose

LOG = logging.getLogger(__name__)

DECODERS = (CifCaf, CifDet, TrackingPose, PoseSimilarity)

_requested_decoders = None  # names from --decoder (None = by head metas)


def cli(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group('decoder')
    group.add_argument('--decoder', default=None, nargs='+',
                       help='decoder names to instantiate (cifcaf, '
                            'cifdet, trackingpose); default: by head metas')
    group.add_argument('--profile-decoder', default=None, nargs='?',
                       const='decoder.prof',
                       help='cProfile the decode step into this file')
    group.add_argument('--cifhr-f32-profiles', default=False,
                       action='store_true',
                       help='decode on the CPU with f32 CifHr profiles, as '
                            'the card\'s kernel computes them (default: '
                            'rounded to bf16, as the JAX package)')
    group.add_argument('--decoder-workers', default=None, type=int,
                       help='(compatibility) the decode runs on the '
                            'predictor\'s device, in the calling process; '
                            'accepted and without effect')
    for decoder in DECODERS:
        decoder.cli(parser)


def configure(args: argparse.Namespace) -> None:
    global _requested_decoders  # pylint: disable=global-statement
    Decoder.profile = args.profile_decoder
    Decoder.f32_profiles = args.cifhr_f32_profiles
    _requested_decoders = ([n.lower() for n in args.decoder]
                           if args.decoder else None)
    if args.decoder_workers:
        LOG.warning('--decoder-workers has no effect: the decode runs on '
                    'the predictor\'s device in this process')
    for decoder in DECODERS:
        decoder.configure(args)


def factory(head_metas, *, device=None) -> Decoder:
    classes = DECODERS
    if _requested_decoders is not None:
        classes = [c for c in DECODERS
                   if c.__name__.lower() in _requested_decoders]
        if not classes:
            raise ValueError(
                f'--decoder {_requested_decoders} matched none of '
                f'{sorted(c.__name__.lower() for c in DECODERS)}')
    decoders = [d for cls in classes
                for d in cls.factory(head_metas, device=device)]
    if any(isinstance(d, TrackingPose) for d in decoders):
        # the tracking decoder subsumes the plain CifCaf decode of the
        # same heads
        decoders = [d for d in decoders if type(d) is not CifCaf]
    if not decoders:
        raise ValueError(f'no decoder found for head metas '
                         f'{[type(m).__name__ for m in head_metas]}')
    if len(decoders) == 1:
        return decoders[0]
    LOG.info('multiple decoders matched: %s', decoders)
    return Multi(decoders)
