"""Logs CLI: plot training log files.

Port of ``openpifpaf_tpu/logs.py:23-140``: parses the json-lines log that
the trainer writes (``training/trainer.py``: ``train``, ``train-epoch``
and ``val-epoch`` lines, the JAX trainer's keys) and renders matplotlib
plots of the time, the learning rate, the epoch and batch losses and the
head losses; several logs can be compared.  matplotlib is imported when
the CLI starts, so that without it the run raises before it reads a log.

Usage: ``python -m openpifpaf_tpu_torch.logs out/model.log [other.log ...]``
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List

import numpy as np

from .show.canvas import require_matplotlib

LOG = logging.getLogger(__name__)


class Plots:
    def __init__(self, log_files: List[str], labels: List[str] = None):
        self.log_files = log_files
        self.labels = labels or log_files
        self.datas = [self.read_log(f) for f in log_files]

    @staticmethod
    def read_log(path: str) -> dict:
        rows = {'train': [], 'train-epoch': [], 'val-epoch': []}
        with open(path) as f:
            for line in f:
                try:
                    data = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if data.get('type') in rows:
                    rows[data['type']].append(data)
        return rows

    def process(self, data):
        xs = [r['epoch'] + r['batch'] / max(1, r['n_batches'])
              for r in data['train']]
        return np.asarray(xs), data['train']

    def time(self, ax):
        for data, label in zip(self.datas, self.labels):
            xs, rows = self.process(data)
            ax.plot(xs, [r['time'] for r in rows], label=label)
        ax.set_xlabel('epoch')
        ax.set_ylabel('time [s]')
        ax.legend(fontsize=6)

    def lr(self, ax):
        for data, label in zip(self.datas, self.labels):
            xs, rows = self.process(data)
            ax.plot(xs, [r['lr'] for r in rows], label=label)
        ax.set_xlabel('epoch')
        ax.set_ylabel('lr')
        ax.set_yscale('log')
        ax.legend(fontsize=6)

    def epoch_loss(self, ax):
        for data, label in zip(self.datas, self.labels):
            train = data['train-epoch']
            val = data['val-epoch']
            if train:
                ax.plot([r['epoch'] for r in train],
                        [r['loss'] for r in train], 'o-',
                        markersize=2, label=f'{label} (train)')
            if val:
                ax.plot([r['epoch'] for r in val],
                        [r['loss'] for r in val], 'x-',
                        markersize=2, label=f'{label} (val)')
        ax.set_xlabel('epoch')
        ax.set_ylabel('loss')
        ax.legend(fontsize=6)

    def preprocessed_batch_loss(self, ax):
        for data, label in zip(self.datas, self.labels):
            xs, rows = self.process(data)
            ax.plot(xs, [r['loss'] for r in rows], label=label, alpha=0.7)
        ax.set_xlabel('epoch')
        ax.set_ylabel('batch loss')
        ax.legend(fontsize=6)

    def head_losses(self, axs):
        for data, label in zip(self.datas, self.labels):
            xs, rows = self.process(data)
            if not rows:
                continue
            n = len(rows[0].get('head_losses', []))
            for i in range(min(n, len(axs))):
                axs[i].plot(xs, [r['head_losses'][i] for r in rows],
                            label=label, alpha=0.7)
                axs[i].set_title(f'component {i}', fontsize=7)
        for ax in axs:
            ax.legend(fontsize=5)

    def show_all(self, output: str = None, show: bool = False):
        import matplotlib.pyplot as plt  # pylint: disable=import-outside-toplevel

        n_heads = max((len(d['train'][0].get('head_losses', []))
                       for d in self.datas if d['train']), default=0)
        n_cols = 4 + n_heads
        fig, axs = plt.subplots(1, n_cols, figsize=(3 * n_cols, 3))
        self.time(axs[0])
        self.lr(axs[1])
        self.epoch_loss(axs[2])
        self.preprocessed_batch_loss(axs[3])
        self.head_losses(axs[4:])
        fig.tight_layout()
        if output:
            fig.savefig(output, dpi=150)
            LOG.info('plot written to %s', output)
        if show:  # pragma: no cover
            plt.show()
        plt.close(fig)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.logs', description=__doc__)
    parser.add_argument('log_file', nargs='+', help='path to log file(s)')
    parser.add_argument('--label', nargs='+', default=None)
    parser.add_argument('-o', '--output', default=None,
                        help='output image file')
    parser.add_argument('--show', default=False, action='store_true')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    require_matplotlib()

    if args.output is None and not args.show:
        args.output = args.log_file[0] + '.png'
    Plots(args.log_file, args.label).show_all(args.output, args.show)
    return 0


if __name__ == '__main__':
    sys.exit(main())
