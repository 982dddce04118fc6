"""CifCaf decode ops, batched, with the CifHr splat on a CUDA kernel, and
the temporal association of the tracking decode."""

from . import caf_scored, cif_hr, common, growth, nms, pipeline, seeds
from . import tracking
from .pipeline import (CifCafConfig, DecodedPoses, decode_cifcaf,
                       decode_front_end, finalize_poses, make_batch_decoder)
from .tracking import TrackingConfig, associate

__all__ = [
    'caf_scored', 'cif_hr', 'common', 'growth', 'nms', 'pipeline', 'seeds',
    'tracking', 'TrackingConfig', 'associate',
    'CifCafConfig', 'DecodedPoses', 'decode_cifcaf', 'decode_front_end',
    'finalize_poses', 'make_batch_decoder',
]
