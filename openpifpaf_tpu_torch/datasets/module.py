"""DataModule: the per-dataset contract.

Port of ``openpifpaf_tpu/datasets/module.py``: a DataModule declares its
``head_metas``, provides the train, val and eval loaders and its eval
metrics.  Class-level configuration (batch size 8, 0 workers) follows the
``cli``/``configure`` pattern of ``datasets/factory.py``.  ``seed`` seeds the augmentations and
the shuffling, so a run is reproducible (the JAX loaders draw from unseeded
generators).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.utils.data import DataLoader

from .collate import collate_images_anns_meta, collate_images_targets_meta
from .. import headmeta


def _reseed_worker(worker_id: int) -> None:  # pylint: disable=unused-argument
    """A loader worker holds a copy of its dataset's generator: reseed it
    from the worker's own seed (derived from the loader's seeded
    generator), so that workers draw different augmentations."""
    info = torch.utils.data.get_worker_info()
    rng = getattr(info.dataset, 'rng', None)
    if rng is not None:
        rng.bit_generator.state = \
            np.random.default_rng(info.seed).bit_generator.state


class DataModule:
    """Base class for datasets."""

    # class-level configuration, set by datasets.factory cli/configure
    batch_size = 8
    loader_workers = 0

    # instance attributes set by subclasses / the caller
    head_metas: List[headmeta.Base] = None
    seed = 0

    @classmethod
    def cli(cls, parser):
        """Add dataset-specific CLI options."""

    @classmethod
    def configure(cls, args):
        """Apply parsed CLI options to class attributes."""

    def metrics(self):
        """List of ``metric.Base`` instances for evaluation."""
        raise NotImplementedError

    def train_loader(self):
        raise NotImplementedError

    def val_loader(self):
        raise NotImplementedError

    def eval_loader(self, *, long_edge=None, hflip=False):
        """Eval loader; ``long_edge``/``hflip`` override the eval rescale
        size and mirror the images (multi-scale eval: the Evaluator builds
        one loader per (scale, hflip) variant and OKS-merges the decodes)."""
        raise NotImplementedError

    def loader(self, dataset, *, shuffle: bool, seed: int,
               collate_fn=collate_images_targets_meta) -> DataLoader:
        """Training-target batches of ``batch_size`` (incomplete batches
        dropped), shuffled from ``seed``."""
        return DataLoader(dataset, batch_size=self.batch_size,
                          shuffle=shuffle, drop_last=True,
                          collate_fn=collate_fn,
                          num_workers=self.loader_workers,
                          worker_init_fn=_reseed_worker,
                          generator=torch.Generator().manual_seed(seed))

    def eval_batches(self, dataset,
                     collate_fn=collate_images_anns_meta) -> DataLoader:
        """Eval batches of ``batch_size`` in dataset order: no shuffle, the
        last batch kept incomplete (``drop_last=False``), images with their
        annotations and metas (``collate_fn``, by default
        ``collate_images_anns_meta``)."""
        return DataLoader(dataset, batch_size=self.batch_size,
                          shuffle=False, drop_last=False,
                          collate_fn=collate_fn,
                          num_workers=self.loader_workers)
