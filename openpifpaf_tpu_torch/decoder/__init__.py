"""Field decoders (CifCaf, CifDet, TrackingPose, PoseSimilarity, and
Multi over several), their CLI and the OKS matrix."""

from .cifcaf import CifCaf
from .cifdet import CifDet
from .decoder import Decoder
from .factory import DECODERS, cli, configure, factory
from .multi import Multi
from .pose_similarity import PoseSimilarity
from .tracking_pose import TrackingPose

__all__ = ['CifCaf', 'CifDet', 'Decoder', 'DECODERS', 'Multi',
           'PoseSimilarity', 'TrackingPose', 'cli', 'configure', 'factory']
