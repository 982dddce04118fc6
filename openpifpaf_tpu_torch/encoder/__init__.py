"""Encoders: ground truth -> composite-field training targets."""

from .annrescaler import AnnRescaler
from .caf import CafEncoder
from .cif import CifEncoder
from .factory import (Encoders, TrackingEncoders, cli, configure, factory,
                      factory_head)
from .tcaf import TcafEncoder

__all__ = ['AnnRescaler', 'CafEncoder', 'CifEncoder', 'Encoders',
           'TcafEncoder', 'TrackingEncoders', 'cli', 'configure', 'factory',
           'factory_head']
