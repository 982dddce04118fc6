"""Field decoders (CifCaf, TrackingPose, PoseSimilarity), their CLI and
the OKS matrix."""

from .cifcaf import CifCaf
from .decoder import Decoder
from .factory import DECODERS, cli, configure, factory
from .pose_similarity import PoseSimilarity
from .tracking_pose import TrackingPose

__all__ = ['CifCaf', 'Decoder', 'DECODERS', 'PoseSimilarity', 'TrackingPose',
           'cli', 'configure', 'factory']
