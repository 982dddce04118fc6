"""Training: optimizer and schedule factory, and the trainer."""

from .optimize import AmsGrad, OptimizeFactory
from .trainer import Trainer

__all__ = ['AmsGrad', 'OptimizeFactory', 'Trainer']
