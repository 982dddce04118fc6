"""Checkpoint migrations: bring old npz checkpoints to the current layout.

Port of ``openpifpaf_tpu/models/model_migration.py`` (``:20-57``): each
fixer takes and returns the flat ``{path: array}`` dict and the json
header; ``migrate`` runs, in order, every fixer introduced after the
checkpoint's ``format_version`` and sets the current version.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Tuple

import numpy as np

LOG = logging.getLogger(__name__)

CURRENT_FORMAT_VERSION = 1

Fixer = Callable[[Dict[str, np.ndarray], dict],
                 Tuple[Dict[str, np.ndarray], dict]]

# (introduced_in_version, fixer) in version order; a checkpoint at version
# v gets every fixer with introduced_in_version > v
MODEL_MIGRATION: List[Tuple[int, Fixer]] = []


def register_migration(version: int):
    def deco(fn: Fixer) -> Fixer:
        MODEL_MIGRATION.append((version, fn))
        MODEL_MIGRATION.sort(key=lambda t: t[0])
        return fn
    return deco


def migrate(flat: Dict[str, np.ndarray], header: dict):
    """Apply every fixer newer than the checkpoint's format version."""
    version = header.get('format_version', 0)
    for introduced, fixer in MODEL_MIGRATION:
        if introduced > version:
            LOG.info('applying checkpoint migration %s (v%d)',
                     fixer.__name__, introduced)
            flat, header = fixer(flat, header)
    header['format_version'] = CURRENT_FORMAT_VERSION
    return flat, header


@register_migration(1)
def strip_module_prefixes(flat, header):
    """v0 -> v1: drop legacy ``module.`` path parts (DataParallel's)."""
    out = {}
    for path, value in flat.items():
        parts = [p for p in path.split('/') if p != 'module.']
        out['/'.join(parts)] = value
    return out, header
