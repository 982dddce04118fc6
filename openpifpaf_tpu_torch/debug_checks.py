"""Runtime NaN/Inf and out-of-bounds assertions (``--debug-checks``).

Port of ``openpifpaf_tpu/debug_checks.py``.  The JAX package discharges
``checkify`` assertions from its jitted programs; here a check is a plain
assertion on a tensor: it reads the predicate back to the host (one sync
per check) and raises ``DebugCheckError``.  Off by default, and then a
check is one Python branch, with no tensor operation and no sync.
Enabled by ``--debug-checks`` (or ``--debug``), the checks are:

- a finite-coordinate and field-index bounds assertion in the decode's
  gathers (``ops/common.py``: ``gather_field``, hence
  ``gather_field_grouped``),
- a finite-loss assertion in the train and val steps
  (``training/trainer.py``).
"""

from __future__ import annotations

import argparse
import logging

import torch

LOG = logging.getLogger(__name__)

_ENABLED = False


class DebugCheckError(RuntimeError):
    """A runtime assertion of ``--debug-checks`` failed."""


def enabled() -> bool:
    return _ENABLED


def enable(value: bool = True) -> None:
    global _ENABLED  # pylint: disable=global-statement
    _ENABLED = bool(value)


def cli(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group('debug checks')
    group.add_argument('--debug-checks', default=False, action='store_true',
                       help='assert finite coordinates, field indices in '
                            'bounds and finite losses at run time (one '
                            'host sync per check; also enabled by --debug)')


def configure(args: argparse.Namespace) -> None:
    enable(getattr(args, 'debug_checks', False)
           or getattr(args, 'debug', False))
    if enabled():
        LOG.info('runtime debug checks enabled')


def check(pred: torch.Tensor, msg: str) -> None:
    """Raise unless every element of ``pred`` holds (when enabled)."""
    if _ENABLED and not bool(torch.as_tensor(pred).all()):
        raise DebugCheckError(msg)


def check_finite(x: torch.Tensor, msg: str) -> None:
    """Raise unless every element of ``x`` is finite (when enabled)."""
    if _ENABLED and not bool(torch.isfinite(x).all()):
        raise DebugCheckError(msg)
