"""Crowd-density drift report: production decode vs the sequential oracle.

Port of the JAX repository's ``tools/drift_report.py``.  Writes a markdown
report (per-density-bucket agreement tables and the 10 worst scenes) and
prints the aggregate JSON as its last line.  The methodology is
``drift.py``'s; the scenes are the JAX report's (``default_rng(20260819)``
draws each scene's seed and density).  The decode runs on the card unless
``--device cpu`` is given; without CUDA it raises.

Usage::

    python -m openpifpaf_tpu_torch.drift_report --scenes 500 --out DRIFT.md
    python -m openpifpaf_tpu_torch.drift_report --noise --device cpu \\
        --scenes 20 --out DRIFT_noise.md
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import drift
from .ops import cif_hr, common

BUCKETS = ((5, 15), (16, 30), (31, 60))
# scenes decoded at once: one front end and one growth loop per batch
BATCH_SIZE = 10


def cli(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.drift_report',
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--scenes', type=int, default=500)
    parser.add_argument('--out', default='DRIFT.md')
    parser.add_argument('--force-complete', action='store_true')
    parser.add_argument('--noise', action='store_true',
                        help='field-level realism noise (confidence jitter, '
                             'offset/scale noise, spurious blobs, '
                             'near-threshold seeds)')
    parser.add_argument('--max-poses', type=int, default=None,
                        help='pose-slot budget (default 128, or 256 with '
                             '--noise: duplicate seeds occupy slots before '
                             'seed-claim suppression removes them, see '
                             'drift.harness_config)')
    parser.add_argument('--max-seeds', type=int, default=None,
                        help='seed budget (default 1024; wholebody 4096)')
    parser.add_argument('--spec', default='coco',
                        choices=('coco', 'wholebody'),
                        help='keypoint family (wholebody: 133 kp/129 edges)')
    parser.add_argument('--max-density', type=int, default=None,
                        help='max poses per scene (default 60; wholebody '
                             'default 16 -- 133-kp scenes saturate the '
                             '61x61 grid much earlier)')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; raises '
                             'without CUDA)')
    return parser.parse_args(argv)


def jobs_for(n_scenes: int, max_density: int):
    """The report's (seed, density) pairs, drawn as the JAX report draws
    them."""
    rng = np.random.default_rng(20260819)
    return [(int(rng.integers(2 ** 31)),
             int(rng.integers(max(2, max_density // 12), max_density + 1)))
            for _ in range(n_scenes)]


def main(argv=None) -> int:
    args = cli(argv)
    spec = (drift.wholebody_spec() if args.spec == 'wholebody'
            else drift.COCO_SPEC)
    max_density = args.max_density or (16 if args.spec == 'wholebody' else 60)
    max_poses = args.max_poses or (256 if args.noise else 128)
    max_seeds = args.max_seeds or (4096 if args.spec == 'wholebody'
                                   else 1024)
    config = drift.harness_config(max_poses=max_poses, max_seeds=max_seeds,
                                  force_complete=args.force_complete)
    harness = drift.Harness(config, spec=spec, device=args.device)
    noise = None
    if args.noise:
        noise = (drift.WHOLEBODY_NOISE if args.spec == 'wholebody'
                 else drift.FieldNoise())

    jobs = jobs_for(args.scenes, max_density)
    t0 = time.perf_counter()
    syncs, k1 = common.HOST_SYNCS, cif_hr.KERNEL_LAUNCHES
    results = []
    for first in range(0, len(jobs), BATCH_SIZE):
        results.extend(drift.run_scenes(
            harness, jobs[first:first + BATCH_SIZE], noise=noise,
            batch_size=BATCH_SIZE))
        if len(results) % 50 == 0:
            print(f'{len(results)}/{len(jobs)} scenes '
                  f'({time.perf_counter() - t0:.0f}s)', file=sys.stderr,
                  flush=True)
    seconds = time.perf_counter() - t0
    syncs, k1 = common.HOST_SYNCS - syncs, cif_hr.KERNEL_LAUNCHES - k1

    overall = drift.aggregate(results)
    buckets = (BUCKETS if max_density >= 60 else
               ((2, max_density // 3),
                (max_density // 3 + 1, 2 * max_density // 3),
                (2 * max_density // 3 + 1, max_density)))
    rows = []
    for lo, hi in buckets:
        bucket = [r for r in results if lo <= r['n_poses'] <= hi]
        if bucket:
            rows.append(((lo, hi), drift.aggregate(bucket)))

    worst = sorted(results, key=lambda r: r['f1'])[:10]

    with open(args.out, 'w') as f:
        f.write('# Decode scheduling drift: production vs sequential '
                'oracle\n\n')
        f.write(
            'Methodology (`openpifpaf_tpu_torch/drift.py`): randomized '
            'synthetic crowd scenes\n(clustered, scale-varied, partial '
            'occlusion), both decoders take the same\nfront end '
            '(`ops.pipeline.decode_front_end`) and the same finalize\n'
            '(`ops.pipeline.finalize_poses`); every deviation below is '
            'growth *scheduling*\n(the wave-recycled parallel frontier and '
            'its seed-claim fixpoint against the reference\'s\nsequential '
            'seed loop and occupancy grid, `cifcaf.cpp:~140`). Poses '
            'matched by\nOKS >= 0.5 greedily in oracle score order.\n\n')
        f.write(f'- spec: {spec.name} ({spec.n_keypoints} kp, '
                f'{len(spec.skeleton)} edges), scenes: '
                f'{overall["n_scenes"]}, force_complete: '
                f'{args.force_complete}, field_noise: {args.noise}, '
                f'max_poses: {max_poses}, max_seeds: {max_seeds}\n')
        if args.noise:
            f.write(f'- noise spec: {noise}\n')
        f.write(f'- device: {harness.device}, {seconds:.1f} s for '
                f'{len(results)} scenes ({BATCH_SIZE} per batch)\n')
        f.write(f'- generated: seed 20260819, densities uniform up to '
                f'{max_density}\n\n')
        f.write('| density | scenes | oracle poses | parallel poses | '
                'detection F1 | mean OKS | mean |score delta| | joint '
                'agreement |\n')
        f.write('|---|---|---|---|---|---|---|---|\n')

        def row(label, agg):
            f.write(f'| {label} | {agg["n_scenes"]} | {agg["n_oracle"]} | '
                    f'{agg["n_parallel"]} | {agg["detection_f1"]:.4f} | '
                    f'{agg["mean_oks"]:.4f} | {agg["mean_score_delta"]:.4f} '
                    f'| {agg["mean_joint_agreement"]:.4f} |\n')

        for (lo, hi), agg in rows:
            row(f'{lo}-{hi}', agg)
        row('all', overall)

        f.write('\n## Worst 10 scenes by detection F1\n\n')
        f.write('| seed | n_poses | oracle | parallel | matched | F1 | '
                'mean OKS |\n|---|---|---|---|---|---|---|\n')
        for r in worst:
            oks_s = ('-' if not np.isfinite(r['mean_oks'])
                     else f'{r["mean_oks"]:.3f}')
            f.write(f'| {r["seed"]} | {r["n_poses"]} | {r["n_oracle"]} | '
                    f'{r["n_parallel"]} | {r["n_matched"]} | '
                    f'{r["f1"]:.3f} | {oks_s} |\n')

    n = max(1, len(results))
    print(f'{len(results)} scenes on {harness.device} in {seconds:.3f} s: '
          f'{1e3 * seconds / n:.3f} ms per scene, the oracle '
          f'{1e3 * harness.seconds["oracle"] / n:.3f} ms per scene; host '
          f'syncs per scene {syncs / n:.2f} (the oracle\'s '
          f'{harness.oracle_syncs / n:.2f}); K1 calls {k1}', flush=True)
    print(json.dumps(overall))
    return 0


if __name__ == '__main__':
    sys.exit(main())
