"""Decoder registry, CLI and factory.

Port of ``openpifpaf_tpu/decoder/factory.py``: the decoder is matched
against the model's head metas.  The port has the CifCaf decoder only, so
``DECODERS`` registers that one and ``--decoder`` can name only it.
"""

from __future__ import annotations

import argparse
import logging

from .cifcaf import CifCaf
from .decoder import Decoder

LOG = logging.getLogger(__name__)

DECODERS = (CifCaf,)

_requested_decoders = None  # names from --decoder (None = by head metas)


def cli(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group('decoder')
    group.add_argument('--decoder', default=None, nargs='+',
                       help='decoder names to instantiate (the port has '
                            'cifcaf); default: by head metas')
    group.add_argument('--profile-decoder', default=None, nargs='?',
                       const='decoder.prof',
                       help='cProfile the decode step into this file')
    group.add_argument('--decoder-workers', default=None, type=int,
                       help='(compatibility) the decode runs on the '
                            'predictor\'s device, in the calling process; '
                            'accepted and without effect')
    for decoder in DECODERS:
        decoder.cli(parser)


def configure(args: argparse.Namespace) -> None:
    global _requested_decoders  # pylint: disable=global-statement
    Decoder.profile = args.profile_decoder
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
    if len(decoders) != 1:
        raise ValueError(f'expected one decoder for head metas '
                         f'{[type(m).__name__ for m in head_metas]}, found '
                         f'{len(decoders)}')
    return decoders[0]
