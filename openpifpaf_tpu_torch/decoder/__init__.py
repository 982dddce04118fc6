"""Field decoders (CifCaf)."""

from .cifcaf import CifCaf
from .decoder import Decoder
from .factory import DECODERS, factory

__all__ = ['CifCaf', 'Decoder', 'DECODERS', 'factory']
