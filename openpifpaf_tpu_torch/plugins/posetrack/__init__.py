"""PoseTrack plugin: the tracking data modules.

Port of ``openpifpaf_tpu/plugins/posetrack``: ``tracking_head_metas`` and
``PairEval`` (``pairs.py``), the PoseTrack keypoint ``constants``,
``CocoKpSt`` (COCO images as pseudo-tracking pairs), ``PoseTrack2018``
(consecutive frames of the PoseTrack2018 sequences) and ``ToyKpSt``, which
renders its own data.
"""

from .cocokpst import CocoKpSt
from .pairs import PairEval, tracking_head_metas
from .posetrack2018 import PoseTrack2018
from .toykpst import ToyKpSt

__all__ = ['CocoKpSt', 'PairEval', 'PoseTrack2018', 'ToyKpSt',
           'tracking_head_metas']
