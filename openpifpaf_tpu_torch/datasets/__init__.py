"""Datasets: the DataModule contract, the registry, multi-dataset training,
the collates, the image-file dataset of the predictor and the adapter of
torch-style datasets."""

from .collate import (collate_images_anns_meta, collate_images_targets_meta,
                      collate_tracking_images_anns_meta,
                      collate_tracking_images_targets_meta)
from .factory import DATAMODULES, cli, configure, factory
from .loader_with_reset import LoaderWithReset
from .image_list import ImageList
from .module import DataModule, ShardSampler
from .multimodule import MultiDataModule
from .torch_dataset import TorchDatasetAdapter

__all__ = ['collate_images_anns_meta', 'collate_images_targets_meta',
           'collate_tracking_images_anns_meta',
           'collate_tracking_images_targets_meta', 'DATAMODULES', 'cli',
           'configure', 'factory', 'ImageList', 'LoaderWithReset',
           'DataModule', 'MultiDataModule', 'ShardSampler',
           'TorchDatasetAdapter']
