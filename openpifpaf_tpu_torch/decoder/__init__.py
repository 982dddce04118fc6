"""Field decoders (CifCaf), their CLI and the OKS matrix."""

from .cifcaf import CifCaf
from .decoder import Decoder
from .factory import DECODERS, cli, configure, factory

__all__ = ['CifCaf', 'Decoder', 'DECODERS', 'cli', 'configure', 'factory']
