"""Datasets: the DataModule contract, the registry and the collates."""

from .collate import collate_images_anns_meta, collate_images_targets_meta
from .factory import DATAMODULES, cli, configure, factory
from .module import DataModule

__all__ = ['collate_images_anns_meta', 'collate_images_targets_meta',
           'DATAMODULES', 'cli', 'configure', 'factory', 'DataModule']
