"""Preprocessing transforms on (3, H, W) tensors, PIL-free.

The eval functions the ``Predictor`` runs (``eval.py``: ``preprocess``,
``rescale_absolute``, ``center_pad``, ``normalize``, ``init_meta``) and
every transform of ``openpifpaf_tpu/transforms``, under the JAX package's
names, with the same ``Preprocess`` contract and meta tracking (the frame
pair transforms in ``pair.py``).  Images are (3, H, W) float32 tensors in
uint8 levels until ``ImageToTensor`` (the JAX package's ``ImageToNumpy``)
normalizes them; the transforms that the JAX package computes with PIL redo
PIL's arithmetic on them.  Random transforms draw from an explicit
``np.random.Generator``.
"""

from .annotations import NormalizeAnnotations
from .base import AnnotationCopy, Preprocess
from .compose import Compose
from .crop import Crop
from .eval import (IMAGENET_MEAN, IMAGENET_STD, PAD_FILL, center_pad,
                   init_meta, normalize, preprocess, rescale_absolute, resize)
from .hflip import HFlip, HorizontalSwap, hflip_map_from_keypoints
from .image import Blur, ColorTint, ImageToTensor, JpegCompression
from .minsize import MinSize
from .multi_scale import MultiScale
from .pad import CenterPad, CenterPadTight
from .pair import ImageToTracking, SingleImage, SyncPair
from .random import DeterministicEqualChoice, RandomApply, RandomChoice
from .rotate import RotateBy90, RotateUniform
from .scale import RescaleAbsolute, RescaleRelative, ScaleMix
from .toannotations import (ToAnnotations, ToCrowdAnnotations,
                            ToDetAnnotations, ToKpAnnotations)
from .unclipped import UnclippedArea, UnclippedSides
from .video import Deinterlace, ImputeNaN

# the tensor boundary of the eval and training loaders
EVAL_TRANSFORM = ImageToTensor()
TRAIN_TRANSFORM = ImageToTensor()

__all__ = [
    'NormalizeAnnotations', 'AnnotationCopy', 'Preprocess', 'Compose',
    'Crop', 'EVAL_TRANSFORM', 'IMAGENET_MEAN', 'IMAGENET_STD', 'PAD_FILL',
    'center_pad', 'init_meta', 'normalize', 'preprocess', 'rescale_absolute',
    'resize', 'HFlip', 'HorizontalSwap', 'hflip_map_from_keypoints', 'Blur',
    'ColorTint', 'ImageToTensor', 'JpegCompression', 'MinSize', 'MultiScale',
    'CenterPad', 'CenterPadTight', 'ImageToTracking', 'SingleImage',
    'SyncPair', 'DeterministicEqualChoice', 'RandomApply', 'RandomChoice',
    'RotateBy90', 'RotateUniform', 'RescaleAbsolute', 'RescaleRelative',
    'ScaleMix', 'ToAnnotations', 'ToCrowdAnnotations', 'ToDetAnnotations',
    'ToKpAnnotations', 'UnclippedArea', 'UnclippedSides', 'Deinterlace',
    'ImputeNaN', 'TRAIN_TRANSFORM',
]
