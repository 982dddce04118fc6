"""Preprocessing transforms on (3, H, W) tensors, PIL-free.

The eval functions the ``Predictor`` runs (``eval.py``: ``preprocess``,
``rescale_absolute``, ``center_pad``, ``normalize``, ``init_meta``) and the
training transforms ``ToyKp`` and ``ToyKpSt`` compose (with the frame
pair transforms of ``pair.py``), ported from
``openpifpaf_tpu/transforms`` with the same ``Preprocess`` contract and
meta tracking.  Random transforms draw from an explicit
``np.random.Generator``.
"""

from .annotations import NormalizeAnnotations
from .compose import Compose
from .base import Preprocess
from .crop import Crop
from .eval import (IMAGENET_MEAN, IMAGENET_STD, PAD_FILL, center_pad,
                   init_meta, normalize, preprocess, rescale_absolute, resize)
from .hflip import HFlip, HorizontalSwap, hflip_map_from_keypoints
from .image import ImageToTensor
from .pad import CenterPad
from .pair import ImageToTracking, SingleImage, SyncPair
from .random import RandomApply
from .scale import RescaleAbsolute, RescaleRelative

# the tensor boundary of the eval and training loaders
EVAL_TRANSFORM = ImageToTensor()
TRAIN_TRANSFORM = ImageToTensor()

__all__ = [
    'NormalizeAnnotations', 'Compose', 'Crop', 'EVAL_TRANSFORM',
    'IMAGENET_MEAN', 'IMAGENET_STD', 'PAD_FILL', 'center_pad', 'init_meta',
    'normalize', 'preprocess', 'rescale_absolute', 'resize', 'HFlip',
    'HorizontalSwap', 'hflip_map_from_keypoints', 'ImageToTensor',
    'CenterPad', 'ImageToTracking', 'Preprocess', 'RandomApply',
    'RescaleAbsolute', 'RescaleRelative', 'SingleImage', 'SyncPair',
    'TRAIN_TRANSFORM',
]
