"""Eval CLI of the PyTorch port: run the predictor over a data module's
eval loader and score it.

Port of ``openpifpaf_tpu/eval.py:28-186``.  Reference parity:
``src/openpifpaf/eval.py`` — ``Evaluator`` feeds the predictor's output
into the data module's metrics and writes
``<checkpoint>.eval-<dataset>.stats.json`` with the metric stats and the
time accounting, and the predictions with ``--write-predictions``.  Eval
runs on the card unless ``--device cpu`` is given; without CUDA it raises.
``--dp-eval`` under torchrun splits each batch over the ranks (one process
per card, ``Predictor``'s ``data_parallel``); rank 0 writes the files.

Usage::

    python -m openpifpaf_tpu_torch.eval --dataset=toykp \\
        --checkpoint=outputs/model.npz
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import sys
import time

from . import datasets, decoder, logger, models, parallel, plugins
from .predictor import Predictor

LOG = logging.getLogger(__name__)


class Evaluator:
    loader_warmup = 0.0  # seconds to let loader workers fill their queue
                         # before timing starts

    def __init__(self, datamodule, predictor: Predictor):
        self.datamodule = datamodule
        self.predictor = predictor
        self.metrics = datamodule.metrics()
        self.n_images = 0

    def _warm(self, loader_iters):
        """Pull each loader's first batch, wait ``loader_warmup`` seconds
        and chain the batches back, so nothing is skipped."""
        if not self.loader_warmup:
            return loader_iters
        LOG.info('waiting %.1fs for loader warmup', self.loader_warmup)
        firsts = [list(itertools.islice(it, 1)) for it in loader_iters]
        time.sleep(self.loader_warmup)
        return [itertools.chain(first, it)
                for first, it in zip(firsts, loader_iters)]

    def run(self) -> dict:
        if self.predictor.multi_scale:
            return self.run_multi_scale()
        loader_iter, = self._warm([iter(self.datamodule.eval_loader())])
        total_start = time.perf_counter()
        for pred, gt, image_meta in self.predictor.dataset_loader(
                loader_iter):
            for metric in self.metrics:
                metric.accumulate(pred, image_meta, ground_truth=gt)
            self.n_images += 1
        return self._stats(time.perf_counter() - total_start)

    def run_multi_scale(self) -> dict:
        """Eval-time multi-scale: one eval loader per (scale, hflip)
        variant, a per-image OKS merge, the metrics on the merged set."""
        predictor = self.predictor
        base = (getattr(self.datamodule, 'eval_long_edge', None)
                or getattr(self.datamodule, 'image_size', None)
                or predictor.long_edge)
        variants, reference_index = predictor.multiscale_variants(base)
        LOG.info('multi-scale eval over %d variants: %s', len(variants),
                 variants)
        loaders = [self.datamodule.eval_loader(long_edge=le, hflip=hf)
                   for le, hf in variants]
        loader_iters = self._warm([iter(loader) for loader in loaders])

        total_start = time.perf_counter()
        for merged, gt, image_meta in predictor.merged_variants(
                [predictor.dataset_loader(it) for it in loader_iters],
                reference_index):
            for metric in self.metrics:
                metric.accumulate(merged, image_meta, ground_truth=gt)
            self.n_images += 1
        return self._stats(time.perf_counter() - total_start)

    def _stats(self, total_time: float) -> dict:
        stats = {
            'n_images': self.n_images,
            'total_time': round(total_time, 3),
            'nn_time': round(self.predictor.total_nn_time, 3),
            'decoder_time': round(self.predictor.total_decoder_time, 3),
            'images_per_second': round(self.n_images / max(1e-6, total_time),
                                       3),
        }
        all_values, all_labels = [], []
        for metric in self.metrics:
            metric_stats = metric.stats()
            all_values += list(metric_stats['stats'])
            all_labels += list(metric_stats['text_labels'])
        stats['stats'] = all_values
        stats['text_labels'] = all_labels
        return stats


def cli(argv=None) -> argparse.Namespace:
    plugins.register()
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.eval',
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-o', '--output', default=None,
                        help='stats output file basename')
    parser.add_argument('--write-predictions', default=False,
                        action='store_true')
    parser.add_argument('--loader-warmup', default=Evaluator.loader_warmup,
                        type=float,
                        help='seconds to wait before timing starts')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; raises '
                             'without CUDA)')
    parser.add_argument('--seed', default=0, type=int,
                        help='seeds the weights of a fresh --basenet model')
    logger.cli(parser)
    group = parser.add_argument_group('network configuration')
    group.add_argument('--checkpoint', default=None,
                       help='npz checkpoint to evaluate')
    group.add_argument('--basenet', default=None,
                       help='base network of a fresh model with seeded '
                            'weights, when no checkpoint is given')
    models.norm_cli(group)
    models.network_cli(group)
    group.add_argument('--no-bf16', dest='bf16', default=True,
                       action='store_false',
                       help='compute in float32 instead of bfloat16')
    decoder.cli(parser)
    Predictor.cli(parser)
    datasets.cli(parser)
    args = parser.parse_args(argv)

    if not args.checkpoint and not args.basenet:
        parser.error('either --checkpoint or --basenet must be given')
    logger.configure(args)
    decoder.configure(args)
    Predictor.configure(args)
    datasets.configure(args)
    Evaluator.loader_warmup = args.loader_warmup
    return args


def main(argv=None) -> int:
    args = cli(argv)
    device = args.device
    if Predictor.data_parallel:
        # the group of torchrun's env:// variables, one process per card
        device = parallel.initialize_distributed(device) or device
    datamodule = datasets.factory(args.dataset)
    predictor = Predictor(checkpoint=args.checkpoint, base_name=args.basenet,
                          head_metas=datamodule.head_metas, device=device,
                          bf16=args.bf16, seed=args.seed,
                          norm=args.basenet_norm,
                          **models.network_options(args))
    LOG.info('eval of %s on %s', args.checkpoint or args.basenet,
             predictor.device)

    evaluator = Evaluator(datamodule, predictor)
    stats = evaluator.run()

    # rank 0 writes (JAX eval.py:165-167): every rank computed the same
    # stats from the gathered poses
    if parallel.rank() != 0:
        return 0
    if args.output is None:
        args.output = f'{args.checkpoint or "model"}.eval-{args.dataset}'
    os.makedirs(os.path.dirname(args.output) or '.', exist_ok=True)
    with open(args.output + '.stats.json', 'w') as f:
        json.dump(stats, f, indent=2)
    LOG.info('stats written to %s.stats.json', args.output)

    if args.write_predictions:
        for metric in evaluator.metrics:
            metric.write_predictions(args.output)

    for label, value in zip(stats['text_labels'], stats['stats']):
        print(f'{label:>8} = {value:.3f}')
    print(f'images/s = {stats["images_per_second"]:.2f}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
