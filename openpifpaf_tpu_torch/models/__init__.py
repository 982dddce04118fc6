"""Backbones, heads, the Shell/Model wrapper and the model factory."""

from .base import BASE_FACTORIES, BaseNetworkSpec, register_basenet
from .factory import build_shell, factory, init_weights
from .from_jax import from_jax_variables, to_jax_variables
from .heads import CompositeField4, FieldComponents, split_fields
from .shell import Model, Shell
from .shufflenetv2k import InvertedResidualK, ShuffleNetV2K, channel_shuffle
from .tracking_base import TrackingModel, TrackingShell, is_tracking_metas

__all__ = [
    'BASE_FACTORIES', 'BaseNetworkSpec', 'register_basenet', 'build_shell',
    'factory', 'init_weights', 'from_jax_variables', 'to_jax_variables',
    'CompositeField4', 'FieldComponents', 'split_fields', 'Model', 'Shell',
    'InvertedResidualK', 'ShuffleNetV2K', 'channel_shuffle',
    'TrackingModel', 'TrackingShell', 'is_tracking_metas',
]
