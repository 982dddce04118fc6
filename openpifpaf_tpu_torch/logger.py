"""Logging configuration of the CLIs.

Port of ``openpifpaf_tpu/logger.py``.  Reference parity:
``src/openpifpaf/logger.py:~15``: ``--debug``, ``-q/--quiet``, the version
line, and the runtime checks of ``debug_checks`` (``--debug-checks``,
also enabled by ``--debug``).  ``--log-stats`` is accepted as the JAX CLIs
accept it (``logger.py:21``); nothing in either package reads it.
"""

from __future__ import annotations

import argparse
import logging
import sys

from . import __version__, debug_checks


def cli(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group('logging')
    group.add_argument('--debug', default=False, action='store_true',
                       help='print debug messages (also enables the runtime '
                            'debug checks)')
    group.add_argument('-q', '--quiet', default=False, action='store_true',
                       help='only warnings and errors')
    group.add_argument('--log-stats', default=False, action='store_true',
                       help='enable stats logging')
    debug_checks.cli(parser)


def configure(args: argparse.Namespace) -> None:
    level = logging.INFO
    if args.debug:
        level = logging.DEBUG
    elif args.quiet:
        level = logging.WARNING
    logging.basicConfig(stream=sys.stdout, level=level,
                        format='%(levelname)s:%(name)s:%(message)s')
    logging.getLogger(__name__).info('openpifpaf_tpu_torch %s', __version__)
    debug_checks.configure(args)
