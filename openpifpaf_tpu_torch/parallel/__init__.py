"""Parallelism: process groups, batch shards, the banded CifHr and seeds.

Port of ``openpifpaf_tpu/parallel/`` (``dryrun.py`` is not ported: it dry
runs the TPU mesh).
"""

from .mesh import (all_gather, all_reduce, data_group, initialize_distributed,
                   rank, replicate, run_group, shard_batch, world)
from .spatial import SpatialConfig, ShardedCifHr, sharded_cif_hr, sharded_seeds

__all__ = ['all_gather', 'all_reduce', 'data_group', 'initialize_distributed',
           'rank', 'replicate', 'run_group', 'shard_batch', 'world',
           'SpatialConfig', 'ShardedCifHr', 'sharded_cif_hr', 'sharded_seeds']
