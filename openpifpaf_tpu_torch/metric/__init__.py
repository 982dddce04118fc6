"""Evaluation metrics: the numpy COCO OKS/IoU evaluation.

Port of ``openpifpaf_tpu/metric`` without ``PoseTrack``, which waits for
the tracking slice.
"""

from .base import Base
from .coco import Coco
from .cocoeval import CocoEval, DtInstance, GtInstance

__all__ = ['Base', 'Coco', 'CocoEval', 'DtInstance', 'GtInstance']
