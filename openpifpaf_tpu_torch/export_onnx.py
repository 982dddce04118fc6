"""Export CLI: ONNX.

Port of ``openpifpaf_tpu/export_onnx.py``.  Reference parity:
``src/openpifpaf/export_onnx.py:~30``: input and output naming, static
input shape, opset pinning.  The default path is the port's own serializer
(:mod:`openpifpaf_tpu_torch.onnx_native`): the protobuf writer and the
graph builder for every registered backbone family and the
CompositeField4 heads.  ``--verify`` parses the written file back and runs
it with the torch interpreter, on the model's device, against the port's
forward.

``export_program`` remains the native artifact of the served forward.

Usage::

    python -m openpifpaf_tpu_torch.export_onnx --checkpoint model.npz \\
        --outfile model.onnx --verify
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from . import logger, onnx_native
from .export_program import model_cli, model_from_args

LOG = logging.getLogger(__name__)


def apply(model, outfile: str, *, input_hw=(641, 641)):
    data = onnx_native.build_model_graph(model, input_hw=input_hw)
    with open(outfile, 'wb') as f:
        f.write(data)
    LOG.info('wrote %s (%d bytes, opset %d)', outfile, len(data),
             onnx_native.OPSET_VERSION)


def verify(model, outfile: str, *, input_hw=(641, 641),
           atol: float = None) -> float:
    """Parse the written artifact back and run it with
    ``onnx_native.execute_model`` on the model's device against the port's
    forward (``Model.__call__``) on random input; returns the max abs
    deviation and raises if it exceeds ``atol``.  The stand-in for the
    reference's onnxruntime check (``src/openpifpaf/export_onnx.py:~60``).

    The artifact always carries float32 weights; when the model computes
    in bfloat16 (the default, ``--no-bf16`` to disable) the comparison is
    f32 interpreter against a bf16 forward, so the default tolerance
    widens to bf16 rounding scale."""
    if atol is None:
        atol = 1e-2 if model.bf16 else 1e-3

    with open(outfile, 'rb') as f:
        parsed = onnx_native.parse_model(f.read())
    rng = np.random.default_rng(0)
    x_nchw = rng.normal(size=(1, 3, *input_hw)).astype(np.float32)
    got = onnx_native.execute_model(parsed, {'input': x_nchw},
                                    device=model.device)
    want = model(torch.from_numpy(x_nchw).to(model.device))
    if len(parsed['outputs']) != len(want):
        raise ValueError(
            f"ONNX artifact has {len(parsed['outputs'])} outputs but the "
            f'forward produced {len(want)} — a head was dropped by the graph '
            'builder')
    max_dev = 0.0
    for out_info, w in zip(parsed['outputs'], want):
        dev = float((got[out_info['name']] - w.float()).abs().max())
        max_dev = max(max_dev, dev)
    LOG.info('verify: max abs deviation %.2e over %d outputs',
             max_dev, len(parsed['outputs']))
    if max_dev > atol:
        raise ValueError(
            f'ONNX verification failed: max deviation {max_dev:.2e} '
            f'> atol {atol:.0e}')
    return max_dev


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.export_onnx', description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    logger.cli(parser)
    model_cli(parser)
    parser.add_argument('--outfile', default='openpifpaf_tpu_torch.onnx')
    parser.add_argument('--input-height', default=641, type=int)
    parser.add_argument('--input-width', default=641, type=int)
    parser.add_argument('--verify', default=False, action='store_true',
                        help='re-execute the written artifact with the '
                             'in-tree interpreter and compare against the '
                             'port\'s forward')
    args = parser.parse_args(argv)
    logger.configure(args)

    model = model_from_args(args)
    input_hw = (args.input_height, args.input_width)
    apply(model, args.outfile, input_hw=input_hw)
    if args.verify:
        verify(model, args.outfile, input_hw=input_hw)
    return 0


if __name__ == '__main__':
    sys.exit(main())
