"""Dataset registry and CLI.

Port of ``openpifpaf_tpu/datasets/factory.py``: the ``DATAMODULES``
registry (filled by ``plugins.register()``), ``factory(name)`` (names
joined by commas make a ``MultiDataModule``) and the ``--dataset`` /
loader CLI flags.
"""

from __future__ import annotations

import argparse
from typing import Dict, Type

from .module import DataModule

DATAMODULES: Dict[str, Type[DataModule]] = {}


def factory(dataset_name: str) -> DataModule:
    if ',' in dataset_name:
        # multi-dataset training: --dataset=toykp,cifar10
        from .multimodule import MultiDataModule  # pylint: disable=import-outside-toplevel

        return MultiDataModule([factory(n.strip())
                                for n in dataset_name.split(',')])
    if dataset_name not in DATAMODULES:
        raise ValueError(
            f'dataset {dataset_name!r} unknown; registered: {sorted(DATAMODULES)}')
    return DATAMODULES[dataset_name]()


def cli(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group('generic data module parameters')
    group.add_argument('--dataset', default='cocokp',
                       help=f'dataset to use: {sorted(DATAMODULES)}')
    group.add_argument('--loader-workers', default=DataModule.loader_workers,
                       type=int, help='number of data loading workers')
    group.add_argument('--batch-size', default=DataModule.batch_size,
                       type=int, help='batch size')
    for dm in set(DATAMODULES.values()):
        dm.cli(parser)


def configure(args: argparse.Namespace) -> None:
    DataModule.loader_workers = args.loader_workers
    DataModule.batch_size = args.batch_size
    for dm in set(DATAMODULES.values()):
        dm.configure(args)
