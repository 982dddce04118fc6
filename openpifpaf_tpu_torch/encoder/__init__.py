"""Encoders: ground truth -> composite-field training targets."""

from .annrescaler import AnnRescaler
from .caf import CafEncoder
from .cif import CifEncoder
from .cifdet import CifDetEncoder
from .factory import (Encoders, TrackingEncoders, cli, configure, factory,
                      factory_head)
from .tcaf import TcafEncoder

__all__ = ['AnnRescaler', 'CafEncoder', 'CifDetEncoder', 'CifEncoder',
           'Encoders',
           'TcafEncoder', 'TrackingEncoders', 'cli', 'configure', 'factory',
           'factory_head']
