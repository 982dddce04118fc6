"""Scaling benchmark CLI: weak-scaling efficiency of the train step.

Port of ``openpifpaf_tpu/benchmark_scaling.py``: for each group size one
group of processes (the ``spawn`` start method, one card each over NCCL,
or CPU processes over gloo with ``--device cpu``) runs the data-parallel
train step; prints one json line per size and a summary efficiency line,
as the JAX CLI does.  The sizes are capped at the cards present (with
``--device cpu``, at the CPU's cores).

Usage: ``python -m openpifpaf_tpu_torch.benchmark_scaling --devices 1 2 4``
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch

from . import logger
from .device import resolve_device

LOG = logging.getLogger(__name__)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.benchmark_scaling',
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    logger.cli(parser)
    parser.add_argument('--devices', default=None, nargs='+', type=int,
                        help='group sizes to measure (default: 1, 2 and '
                             'all)')
    parser.add_argument('--batch-per-device', default=2, type=int)
    parser.add_argument('--image-size', default=65, type=int)
    parser.add_argument('--basenet', default='shufflenetv2k16')
    parser.add_argument('--iters', default=5, type=int)
    parser.add_argument('--device', default=None,
                        help='torch device type (default: the card; raises '
                             'without CUDA)')
    args = parser.parse_args(argv)
    logger.configure(args)

    from .parallel import scaling  # pylint: disable=import-outside-toplevel

    device = resolve_device(args.device)
    n_avail = (torch.cuda.device_count() if device.type == 'cuda'
               else os.cpu_count())
    counts = args.devices or sorted({1, 2, n_avail} & set(
        range(1, n_avail + 1)))
    counts = [c for c in counts if c <= n_avail]
    LOG.info('measuring group sizes %s (%d %s devices available)', counts,
             n_avail, device.type)

    points = scaling.sweep(
        counts, device=device.type,
        image_hw=(args.image_size, args.image_size),
        batch_per_device=args.batch_per_device, basenet=args.basenet,
        n_iters=args.iters)
    t1 = points[0].step_time_s if points else 0.0
    for p in points:
        # sharding_overhead = t(n) / (n * t(1)) - 1: the collectives' cost
        # over perfect time-multiplexing, the meaningful number when the
        # ranks share one host's cores; `efficiency` (t(1)/t(n)) is the
        # weak-scaling number where each rank has its own card
        overhead = (p.step_time_s / (p.n_devices * t1) - 1.0) if t1 else 0.0
        print(json.dumps({
            'devices': p.n_devices, 'global_batch': p.global_batch,
            'step_ms': round(p.step_time_s * 1000, 2),
            'images_per_s': round(p.images_per_s, 2),
            'efficiency': round(p.efficiency, 3),
            'sharding_overhead': round(overhead, 3),
        }))
    if len(points) > 1:
        print(json.dumps({
            'metric': 'scaling_efficiency',
            'value': round(points[-1].efficiency, 3),
            'unit': f'fraction at {points[-1].n_devices} devices',
            'vs_baseline': round(points[-1].efficiency / 0.8, 2),
        }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
