"""Encoders: ground truth -> composite-field training targets."""

from .annrescaler import AnnRescaler
from .caf import CafEncoder
from .cif import CifEncoder
from .factory import Encoders, cli, configure, factory, factory_head

__all__ = ['AnnRescaler', 'CafEncoder', 'CifEncoder', 'Encoders', 'cli',
           'configure', 'factory', 'factory_head']
