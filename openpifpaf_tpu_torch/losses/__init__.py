"""Composite-field losses."""

from . import components
from .composite import CompositeLoss, CompositeLossConfig
from .factory import Factory
from .multi_head import MultiHeadLoss

__all__ = ['components', 'CompositeLoss', 'CompositeLossConfig', 'Factory',
           'MultiHeadLoss']
