"""Train CLI of the PyTorch port.

Port of ``openpifpaf_tpu/train.py``: argparse over the ported subsystems'
``cli()`` hooks, data module, model and loss construction, and
``Trainer.loop``.  Training runs on the card unless ``--device cpu`` is
given; without CUDA it raises.  The ``visualizer`` flags (``--debug-indices``,
``--save-all``) are parsed and configured as by the JAX train CLI
(``train.py:53,63``), whose training path renders no view either; without
matplotlib ``--debug-indices`` raises before training.  ``--ddp`` trains
data parallel in the group that torchrun's ``env://`` variables describe,
one process per card (``cuda:LOCAL_RANK``, NCCL; gloo on the CPU): each
rank reads its shard of every epoch, and
``--batch-size`` is per rank, as the JAX CLI's is per host.  The
checkpoints are the JAX package's npz format, which the port's
``Predictor`` and the JAX package both load.

Usage::

    python -m openpifpaf_tpu_torch.train --dataset=toykp \\
        --basenet=shufflenetv2k16 --epochs=1 --batch-size=8 \\
        --output outputs/model
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from . import (datasets, encoder, logger, losses, models, parallel, plugins,
               visualizer)
from .device import resolve_device
from .training import OptimizeFactory, Trainer

LOG = logging.getLogger(__name__)


def default_output_file(args) -> str:
    base = args.basenet or 'model'
    return f'outputs/{base}-{args.dataset}'


def cli(argv=None) -> argparse.Namespace:
    plugins.register()
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.train',
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-o', '--output', default=None,
                        help='output file basename')
    parser.add_argument('--resume', default=False, action='store_true',
                        help='resume from output .train.npz checkpoint')
    parser.add_argument('--seed', default=0, type=int,
                        help='seeds the weights, augmentations and shuffling')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; raises '
                             'without CUDA)')
    parser.add_argument('--ddp', default=False, action='store_true',
                        help='data parallel training over the process group '
                             "of torchrun's env:// variables (one process "
                             'per card)')
    logger.cli(parser)
    group = parser.add_argument_group('network configuration')
    group.add_argument('--checkpoint', default=None,
                       help='npz checkpoint to start from')
    group.add_argument('--basenet', default=None,
                       help=f'base network, one of {sorted(models.BASE_FACTORIES)}')
    models.norm_cli(group)
    models.network_cli(group)
    group.add_argument('--no-bf16', dest='bf16', default=True,
                       action='store_false',
                       help='compute in float32 instead of bfloat16')
    losses.Factory.cli(parser)
    encoder.cli(parser)
    OptimizeFactory.cli(parser)
    Trainer.cli(parser)
    datasets.cli(parser)
    visualizer.cli(parser)
    args = parser.parse_args(argv)

    if not args.checkpoint and not args.basenet:
        parser.error('either --checkpoint or --basenet must be given')
    logger.configure(args)
    losses.Factory.configure(args)
    encoder.configure(args)
    OptimizeFactory.configure(args)
    Trainer.configure(args)
    datasets.configure(args)
    visualizer.configure(args)
    if args.output is None:
        args.output = default_output_file(args)
    return args


def main(argv=None) -> int:
    args = cli(argv)
    device = resolve_device(args.device)
    if args.ddp:
        device = parallel.initialize_distributed(device) or device
    torch.manual_seed(args.seed)
    os.makedirs(os.path.dirname(args.output) or '.', exist_ok=True)

    datamodule = datasets.factory(args.dataset)
    datamodule.seed = args.seed
    # a checkpoint with other heads than the data module's is grafted onto
    # them (models.transfer): the backbone and same-named heads carry over
    model = models.factory(args.basenet, datamodule.head_metas,
                           checkpoint=args.checkpoint, bf16=args.bf16,
                           device=device, seed=args.seed,
                           norm=args.basenet_norm,
                           **models.network_options(args))
    # the encoders take the strides of the heads they train
    for meta, model_meta in zip(datamodule.head_metas, model.head_metas):
        meta.base_stride = model.base_stride
        meta.upsample_stride = model_meta.upsample_stride
    LOG.info('model: %s on %s, %d params', model.basenet_name, device,
             sum(p.numel() for p in model.module.parameters()))

    loss_factory = losses.Factory()
    loss_fn = loss_factory.factory(model.head_metas)
    trainer = Trainer(model, loss_fn, OptimizeFactory(), args.output,
                      auto_tune_mtl=loss_factory.auto_tune_mtl)

    train_loader = datamodule.train_loader()
    val_loader = datamodule.val_loader()
    if parallel.world() > 1:
        train_loader, val_loader = (datamodule.distributed_sampler(
            loader, host_id=parallel.rank(), n_hosts=parallel.world())
            for loader in (train_loader, val_loader))
    LOG.info('%d training batches, %d validation batches',
             len(train_loader), len(val_loader))

    start_epoch = model.epoch
    if args.resume:
        start_epoch = trainer.load_train_checkpoint(
            args.output + '.train.npz', len(train_loader))
        LOG.info('resumed from epoch %d', start_epoch)

    trainer.loop(train_loader, val_loader, start_epoch=start_epoch)
    return 0


if __name__ == '__main__':
    sys.exit(main())
