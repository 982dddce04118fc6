"""CifCaf decode ops, batched, with the CifHr splat on a CUDA kernel."""

from . import caf_scored, cif_hr, common, growth, nms, pipeline, seeds
from .pipeline import (CifCafConfig, DecodedPoses, decode_cifcaf,
                       decode_front_end, finalize_poses, make_batch_decoder)

__all__ = [
    'caf_scored', 'cif_hr', 'common', 'growth', 'nms', 'pipeline', 'seeds',
    'CifCafConfig', 'DecodedPoses', 'decode_cifcaf', 'decode_front_end',
    'finalize_poses', 'make_batch_decoder',
]
