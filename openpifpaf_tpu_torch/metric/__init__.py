"""Evaluation metrics: the numpy COCO OKS/IoU evaluation and the
CLEAR-MOT ``PoseTrack`` metric.

Port of ``openpifpaf_tpu/metric``.
"""

from .base import Base
from .coco import Coco
from .cocoeval import CocoEval, DtInstance, GtInstance
from .posetrack import PoseTrack

__all__ = ['Base', 'Coco', 'CocoEval', 'DtInstance', 'GtInstance',
           'PoseTrack']
