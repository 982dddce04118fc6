"""Export CLI: the served forward as a ``torch.export`` program (``.pt2``).

Port of ``openpifpaf_tpu/export_stablehlo.py``.  Reference parity:
``src/openpifpaf/export_torchscript.py:~20``.  The module that
``Model.__call__`` runs (``Model.served_forward()``, a ``ServedForward``:
the fused pair plan with K2 as the operator
``openpifpaf_tpu_torch::pair_chain`` for a batchnorm ShuffleNetV2K, the
canonical graph for any other backbone) is traced by ``torch.export`` and saved with its weights and folded plan;
``load_exported`` reads it back and ``.module()`` runs it with no model
code, on the device it was exported on.  The input is NCHW float32.

``--include-decoder`` chains the CifCaf decode of a CifCaf model onto the
forward (``ServedDecode``), as JAX's ``export_stablehlo`` does: the program
returns the seven ``DecodedPoses`` tensors (xyv, joint_scales, scores,
valid, n_dropped_caf, n_dropped_cif, n_dropped_poses), with K1 as the
operator ``openpifpaf_tpu_torch::cif_hr_accumulate`` and the decode's
fixpoint loops as ``torch._higher_order_ops.while_loop``
(``ops/common.py:while_loop``).  Its configuration is the decoder's
defaults at the export's input size; the CifHr profiles follow the device
(f32 on the card, bf16-rounded on the CPU), so a program exported on the
card equals the card's eager decode.  ``--debug-checks`` is never enabled
here: its host reads would not trace.  Tracing the decode takes tens of
seconds.

Usage::

    python -m openpifpaf_tpu_torch.export_program --checkpoint model.npz \\
        --input-height 641 --input-width 641 --outfile model.pt2
    # forward and decode, on the CPU (drop --device cpu for the card)
    python -m openpifpaf_tpu_torch.export_program --device cpu \\
        --basenet shufflenetv2k16 --include-decoder --outfile poses.pt2
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

from . import decoder, logger, models
from .decoder.cifcaf import CifCaf
from .models.tracking_base import TrackingModel
from .ops import pipeline

LOG = logging.getLogger(__name__)


def model_cli(parser: argparse.ArgumentParser,
              default_basenet: str = None) -> None:
    """The model flags of the export CLIs: JAX's ``models.Factory.cli``
    with ``--device``.  Without ``--checkpoint``, ``--basenet`` gets
    weights seeded by 0 and cocokp's CIF and CAF heads."""
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; raises '
                             'without CUDA)')
    group = parser.add_argument_group('network configuration')
    group.add_argument('--checkpoint', default=None,
                       help='npz checkpoint (the JAX package\'s format)')
    group.add_argument('--basenet', default=default_basenet,
                       help='base network with seeded weights and cocokp\'s '
                            'heads, when no checkpoint is given')
    models.norm_cli(group)
    models.network_cli(group)
    group.add_argument('--no-bf16', dest='bf16', default=True,
                       action='store_false',
                       help='compute in float32 instead of bfloat16')


def model_from_args(args):
    """The model ``model_cli``'s flags name, on ``--device``."""
    options = dict(device=args.device, bf16=args.bf16, norm=args.basenet_norm,
                   **models.network_options(args))
    if args.checkpoint:
        return models.factory(checkpoint=args.checkpoint, **options)
    if not args.basenet:
        raise ValueError('either checkpoint or basenet must be given')
    from .plugins.coco.cocokp import CocoKp
    return models.factory(args.basenet, CocoKp().head_metas, **options)


class ServedDecode(torch.nn.Module):
    """``Model.served_forward()`` followed by the CifCaf decode of its CIF
    and CAF heads (``fields[head_index]``, as JAX's program reads them) at
    the static configuration ``CifCaf.config_for(input_hw)``: the module
    that ``export_forward(..., include_decoder=True)`` traces."""

    def __init__(self, model, input_hw):
        super().__init__()
        dec = decoder.factory(model.head_metas, device=model.device)
        if not isinstance(dec, CifCaf):
            raise ValueError('--include-decoder supports CifCaf models only')
        self.forward_module = model.served_forward()
        self.cif_meta, self.caf_meta = dec.cif_meta, dec.caf_meta
        self.config = dec.config_for(input_hw)

    def forward(self, images: torch.Tensor):
        fields = self.forward_module(images)
        return tuple(pipeline.decode_cifcaf(
            fields[self.cif_meta.head_index].float(),
            fields[self.caf_meta.head_index].float(),
            cif_meta=self.cif_meta, caf_meta=self.caf_meta,
            config=self.config))


def export_forward(model, input_hw, *, batch_size: int = 1,
                   include_decoder: bool = False,
                   dynamic_batch: bool = False):
    """Trace ``Model.__call__`` of ``model`` on NCHW float32 images of
    ``input_hw``, with ``include_decoder`` followed by the CifCaf decode
    (``ServedDecode``); returns the ``torch.export.ExportedProgram``.  With
    ``dynamic_batch`` the batch is symbolic (for a tracking model, twice a
    symbolic number of frame pairs)."""
    module = (ServedDecode(model, input_hw) if include_decoder
              else model.served_forward())
    tracking = isinstance(model, TrackingModel)
    dynamic_shapes = None
    if dynamic_batch:
        # an example of 2 images (2 pairs): torch.export specializes 1;
        # a tracking program's pair count stays from 2 on: at 1 pair the
        # program fails its guard ``(1 + x.size()[0]) // 2 != 1``, which
        # torch's channels-last stride check (``_prims_common``
        # ``is_channels_last_contiguous_2d``) adds on the pair slices
        if tracking:
            batch_size, dim = 4, 2 * torch.export.Dim('pairs', min=2)
        else:
            batch_size, dim = 2, torch.export.Dim('batch', min=1)
        dynamic_shapes = ({0: dim},)
    x = torch.zeros((batch_size, 3, *input_hw), dtype=torch.float32,
                    device=model.device)
    with torch.no_grad():
        program = torch.export.export(module, (x,),
                                      dynamic_shapes=dynamic_shapes)
    # the example is zeros (the graph holds the input's spec): not saved
    program.example_inputs = None
    return program


def load_exported(path: str):
    """A saved program, with the operators it calls registered first."""
    from .ops import cif_hr, pair_chain  # noqa: F401  pylint: disable=unused-import
    return torch.export.load(path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.export_program',
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    logger.cli(parser)
    model_cli(parser)
    parser.add_argument('--outfile', default='openpifpaf_tpu_torch.pt2')
    parser.add_argument('--input-height', default=641, type=int)
    parser.add_argument('--input-width', default=641, type=int)
    parser.add_argument('--batch-size', default=1, type=int)
    parser.add_argument('--dynamic-batch', default=False, action='store_true',
                        help='export with a symbolic batch dimension')
    parser.add_argument('--include-decoder', default=False,
                        action='store_true',
                        help='chain the CifCaf decode into the exported '
                             'program')
    args = parser.parse_args(argv)
    logger.configure(args)

    model = model_from_args(args)
    if isinstance(model, TrackingModel) and args.batch_size % 2:
        LOG.warning('tracking models consume interleaved frame pairs; '
                    'raising --batch-size %d -> %d', args.batch_size,
                    args.batch_size + 1)
        args.batch_size += 1
    start = time.perf_counter()
    exported = export_forward(
        model, (args.input_height, args.input_width),
        batch_size=args.batch_size, include_decoder=args.include_decoder,
        dynamic_batch=args.dynamic_batch)
    seconds = time.perf_counter() - start
    torch.export.save(exported, args.outfile)
    size = os.path.getsize(args.outfile)
    LOG.info('wrote %s (%d bytes, device %s)', args.outfile, size,
             model.device)
    print(f'{args.outfile}: {size} bytes, traced in {seconds:.1f} s')
    return 0


if __name__ == '__main__':
    sys.exit(main())
