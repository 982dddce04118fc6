"""Export CLI: CoreML (gated on coremltools being installed).

Port of ``openpifpaf_tpu/export_coreml.py``.  Reference parity:
``src/openpifpaf/export_coreml.py``: optional Apple CoreML export.  No
converter is wired in: without ``coremltools`` this CLI exits 1 with a
pointer to ``export_program``, the port's portable artifact, as the JAX
CLI points at ``export_stablehlo``.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import sys

from . import logger
from .export_program import model_cli, model_from_args

LOG = logging.getLogger(__name__)


def apply(model, outfile: str, *, input_hw=(641, 641)):
    try:
        importlib.import_module('coremltools')
    except ImportError as e:
        raise RuntimeError(
            'CoreML export needs the optional coremltools package, which is '
            'not installed in this environment. Use '
            'python -m openpifpaf_tpu_torch.export_program for the portable '
            'native artifact.') from e
    raise NotImplementedError(
        'no CoreML converter is wired in; export ONNX with export_onnx '
        'and convert the file with coremltools')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.export_coreml',
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    logger.cli(parser)
    model_cli(parser)
    parser.add_argument('--outfile', default='openpifpaf_tpu_torch.mlmodel')
    parser.add_argument('--input-height', default=641, type=int)
    parser.add_argument('--input-width', default=641, type=int)
    args = parser.parse_args(argv)
    logger.configure(args)

    try:
        # gate on coremltools before paying for model construction
        importlib.import_module('coremltools')
        model = model_from_args(args)
        apply(model, args.outfile,
              input_hw=(args.input_height, args.input_width))
    except (ImportError, RuntimeError, NotImplementedError) as e:
        LOG.error('CoreML export unavailable: %s — use '
                  'python -m openpifpaf_tpu_torch.export_program', e)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
