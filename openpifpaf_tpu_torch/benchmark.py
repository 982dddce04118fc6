"""Benchmark CLI: evaluate several checkpoints and tabulate.

Port of ``openpifpaf_tpu/benchmark.py``.  Reference parity:
``src/openpifpaf/benchmark.py:~30``: runs the eval CLI
(``python -m openpifpaf_tpu_torch.eval``) as a subprocess per checkpoint,
reuses a stats file that is already there unless ``--force``, and renders
a markdown table of the stats (AP, timing, file size, ``:~120``).  Flags
it does not know go to the eval CLI (``--device cpu`` for the CPU).

Usage: ``python -m openpifpaf_tpu_torch.benchmark --checkpoints a.npz
b.npz --dataset=toykp``
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys

LOG = logging.getLogger(__name__)


def run_eval(checkpoint: str, args, unknown_args) -> str:
    output = f'{args.output_dir}/{os.path.basename(checkpoint)}' \
             f'.eval-{args.dataset}'
    stats_file = output + '.stats.json'
    if os.path.exists(stats_file) and not args.force:
        LOG.info('found existing %s', stats_file)
        return stats_file
    cmd = [sys.executable, '-m', 'openpifpaf_tpu_torch.eval',
           '--dataset', args.dataset,
           '--checkpoint', checkpoint,
           '--output', output] + unknown_args
    LOG.info('running %s', ' '.join(cmd))
    subprocess.run(cmd, check=True)
    return stats_file


def format_table(rows) -> str:
    if not rows:
        return '(no results)'
    labels = rows[0]['stats'].get('text_labels', [])[:5]
    header = ('| checkpoint | ' + ' | '.join(labels)
              + ' | t_total | t_dec | size |')
    sep = '|' + '---|' * (len(labels) + 4)
    lines = [header, sep]
    for row in rows:
        s = row['stats']
        values = ' | '.join(f'{v * 100:.1f}' for v in s.get('stats', [])[:5])
        size_mb = row['size'] / 1e6
        lines.append(
            f'| {row["checkpoint"]} | {values} '
            f'| {s.get("total_time", 0):.1f}s '
            f'| {s.get("decoder_time", 0):.1f}s | {size_mb:.1f}MB |')
    return '\n'.join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.benchmark', description=__doc__)
    parser.add_argument('--checkpoints', nargs='+', required=True)
    parser.add_argument('--dataset', default='cocokp')
    parser.add_argument('--output-dir', default='benchmark_outputs')
    parser.add_argument('--force', default=False, action='store_true')
    args, unknown = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)

    os.makedirs(args.output_dir, exist_ok=True)
    rows = []
    for checkpoint in args.checkpoints:
        stats_file = run_eval(checkpoint, args, unknown)
        with open(stats_file) as f:
            stats = json.load(f)
        rows.append({
            'checkpoint': os.path.basename(checkpoint),
            'stats': stats,
            'size': os.path.getsize(checkpoint)
            if os.path.exists(checkpoint) else 0,
        })
    table = format_table(rows)
    print(table)
    with open(f'{args.output_dir}/benchmark-{args.dataset}.md', 'w') as f:
        f.write(table + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
