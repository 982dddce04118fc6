"""PoseTrack plugin: tracking head metas and the synthetic ``toykpst``.

Port of ``openpifpaf_tpu/plugins/posetrack``: ``tracking_head_metas`` and
``_PairEval`` (``cocokpst.py:26``, ``:45``) and ``ToyKpSt``
(``toykpst.py``), which renders its own data.  ``CocoKpSt`` and
``PoseTrack2018`` read COCO and PoseTrack json files and are not ported.
"""

from .pairs import PairEval, tracking_head_metas
from .toykpst import ToyKpSt

__all__ = ['PairEval', 'ToyKpSt', 'tracking_head_metas']
