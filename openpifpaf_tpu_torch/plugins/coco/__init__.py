"""COCO plugin: the keypoint and detection constants, ``CocoDataset`` and
the ``cocokp`` and ``cocodet`` data modules."""

from . import constants
from .cocodet import CocoDet
from .cocokp import CocoKp
from .dataset import CocoDataset

__all__ = ['CocoDataset', 'CocoDet', 'CocoKp', 'constants']
