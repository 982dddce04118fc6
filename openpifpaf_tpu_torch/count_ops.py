"""Count ops CLI: GMACs and parameter counts.

Port of ``openpifpaf_tpu/count_ops.py``.  Reference parity:
``src/openpifpaf/count_ops.py:~10``.  The numbers come from
``torch.utils.flop_counter.FlopCounterMode`` over one image through the
canonical forward (``Model.apply``): the products of the convolutions and
matmuls, two operations per multiply-add.  (The JAX CLI reads XLA's cost
analysis of the compiled program, which counts the elementwise operations
too, so its GFLOPs are the larger.)  Over the served forward the K2
operator counts through its registered formula
(``ops.pair_chain.chain_flops``), and the pair plan's in-place ``addmm_``
(its 1x1 convolutions on a pair, ``models/fused_shufflenet.py:_mm_pair``),
for which the counter has no formula, counts as ``addmm`` does.

Usage: ``python -m openpifpaf_tpu_torch.count_ops --basenet shufflenetv2k16``
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch
from torch.utils import flop_counter

from . import logger
from .export_program import model_cli, model_from_args

LOG = logging.getLogger(__name__)

if torch.ops.aten.addmm_ not in flop_counter.flop_registry:
    flop_counter.register_flop_formula(torch.ops.aten.addmm_, get_raw=True)(
        flop_counter.addmm_flop)


def count(model, image_hw=(641, 641), forward=None) -> dict:
    """FLOPs of ``forward`` (default: the canonical ``model.apply``) on one
    image of ``image_hw``, and the model's parameters."""
    forward = model.apply if forward is None else forward
    x = torch.zeros((1, 3, *image_hw), dtype=torch.float32,
                    device=model.device)
    with torch.no_grad(), \
            flop_counter.FlopCounterMode(display=False) as counter:
        forward(x)
    flops = counter.get_total_flops()
    n_params = sum(p.numel() for p in model.module.parameters())
    return {
        'gflops': flops / 1e9,
        'gmacs': flops / 2e9,
        'million_params': n_params / 1e6,
        'image_hw': list(image_hw),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.count_ops', description=__doc__)
    logger.cli(parser)
    model_cli(parser, default_basenet='shufflenetv2k16')
    parser.add_argument('--long-edge', default=641, type=int)
    args = parser.parse_args(argv)
    logger.configure(args)

    model = model_from_args(args)
    stats = count(model, (args.long_edge, args.long_edge))
    print(f'GMACs: {stats["gmacs"]:.2f}')
    print(f'GFLOPs: {stats["gflops"]:.2f}')
    print(f'params: {stats["million_params"]:.2f}M')
    return 0


if __name__ == '__main__':
    sys.exit(main())
