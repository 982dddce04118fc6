"""Drive the PyTorch port's multi-GPU paths over NCCL, one card per rank,
on a machine with four cards.

``chip_smoke.py``'s ``parallel`` phase runs the same paths on one card
(its groups of two and four ranks share it over gloo); this script runs
them where each rank has a card of its own, joined by NVLink:

1. ``python -m openpifpaf_tpu_torch.benchmark_scaling --devices 1 2 4``:
   the train step's weak scaling at the CLI's defaults (sn2k16, f32,
   65 px, 2 images per rank), its json lines: a check of the harness,
   whose step at that size is launch overhead and all-reduce, not the
   train cell's (``--image-size 385 --batch-per-device 8`` is that);
2. one SGD step of full-width sn2k16 (f32, TF32 off, 8 toykp images at
   385 px) at 2 and 4 ranks against one rank and the float64 step
   (``chip_smoke.hold_ddp_step``);
3. ``sharded_cif_hr`` and ``sharded_seeds`` at 2 and 4 ranks (F = 17,
   40 x 41 cells, 320 x 321 hires, halo 64 px): the map against the
   unsharded K1 within 1e-6, overflow 0, the seeds against
   ``seeds.select``; K1 per band held to its plain version and timed, the
   halo exchange and the banded call timed (CUDA events);
4. the eval CLI with ``--dp-eval`` at 4 ranks on serve's bias-shifted
   sn2k16 (toykp's 8 eval images at 641 px, batch 8, after a warm-up run
   in each process) against the single process at batch 2: K1 and K2
   calls, host syncs and images/s per rank, the annotations and stats;
5. ``torchrun --nproc-per-node 4 -m openpifpaf_tpu_torch.train --ddp``:
   one toykp epoch of 64 images at 385 px, batch 8 per rank; one log and
   one set of checkpoints.

Usage (from the repository root): ``python3 multi_gpu_smoke.py``.  It
exits non-zero on any failed hold, and without four CUDA cards.
"""

import os
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs

CARDS = 4


def scaling() -> None:
    out = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.benchmark_scaling',
         '--devices', '1', '2', str(CARDS)], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=cs.REPO), cwd=cs.REPO, timeout=900)
    print(out.stdout, flush=True)
    if out.returncode != 0:
        raise AssertionError(f'benchmark_scaling failed:\n{out.stderr[-3000:]}')


def steps(port) -> None:
    from openpifpaf_tpu_torch import parallel

    metas = port.toykp.coco_head_metas()
    for meta in metas:
        meta.base_stride = 16
    images, targets, _ = cs.toykp_batch(port, metas, cs.TRAIN_EDGE,
                                        cs.TRAIN_BATCH, 'cpu')
    before = {k: v.clone() for k, v in port.models.factory(
        'shufflenetv2k16', metas, device='cpu', bf16=False,
        seed=0).module.state_dict().items()}
    swap = torch.cat([torch.arange(cs.TRAIN_BATCH // 2, cs.TRAIN_BATCH),
                      torch.arange(cs.TRAIN_BATCH // 2)])
    one_ranks = [cs.ddp_step(torch.device('cuda'), images, targets),
                 cs.ddp_step(torch.device('cuda'), images[swap],
                             [{k: v[swap] for k, v in t.items()}
                              for t in targets])]
    exact = cs.ddp_step(torch.device('cuda'), images, targets,
                        dtype=torch.float64)
    for n in (2, CARDS):
        ranks = parallel.run_group(cs.ddp_step, n, (images, targets),
                                   device='cuda', backend='nccl',
                                   timeout=600)
        if not cs.hold_ddp_step(ranks[0], one_ranks, exact, before,
                                f'NCCL, {n} ranks on {n} cards'):
            raise AssertionError(f'the {n}-rank step differs')


def bands(port) -> None:
    from openpifpaf_tpu_torch import parallel

    fields = cs.band_fields()
    conf, x, y, scale = (t.cuda() for t in fields)
    config = port.cif_hr.CifHrConfig(profile_bf16=False)
    dense = port.cif_hr.accumulate(conf, x, y, scale, out_hw=cs.BAND_OUT_HW,
                                   config=config).cpu()
    for n in (2, CARDS):
        results = parallel.run_group(cs.band_ranks, n, (fields,),
                                     device='cuda', backend='nccl',
                                     timeout=600)
        err = float((torch.cat([r['hr'] for r in results], 1)
                     - dense).abs().max())
        print(f'NCCL, {n} bands on {n} cards: the map against the unsharded '
              f'K1 max|Δ| {err:.3e} (limit {cs.BAND_TOL}), overflow '
              f'{[r["overflow"] for r in results]}, K1 '
              f'{[round(r["k1"]["ms"], 4) for r in results]} ms, the halo '
              f'exchange {[round(r["exchange_ms"], 4) for r in results]} ms, '
              f'the banded call {[round(r["banded_ms"], 4) for r in results]}'
              f' ms', flush=True)
        if not (err <= cs.BAND_TOL
                and all(r['overflow'] == 0 for r in results)):
            raise AssertionError(f'{n} bands differ from one card')


def dp_eval(port, tmp: str) -> None:
    from openpifpaf_tpu_torch import parallel

    metas = port.toykp.coco_head_metas()
    model = port.models.factory('shufflenetv2k16', metas, device='cuda',
                                seed=0)
    cs.shift_head_biases(model, metas)
    path = os.path.join(tmp, 'shifted.npz')
    port.models.checkpoint.save(path, variables=port.models.to_jax_variables(
        model.module.state_dict()), head_metas=metas,
        basenet_name='shufflenetv2k16', base_stride=16)
    argv = ['--dataset=toykp', f'--toykp-image-size={cs.DP_EVAL_EDGE}',
            '--batch-size=8', f'--checkpoint={path}', '-q']
    single = parallel.run_group(cs.dp_eval_runs, 1, ([
        argv + ['--batch-size=2', '-o', os.path.join(tmp, 'single_half')],
        argv + ['-o', os.path.join(tmp, 'single')]],), device='cuda',
        backend='nccl', timeout=600)[0]
    ranks = parallel.run_group(cs.dp_eval_runs, CARDS, ([
        argv + ['--dp-eval', '-o', os.path.join(tmp, f'dp_{i}')]
        for i in ('warm', '')],), device='cuda', backend='nccl', timeout=600)
    runs = [('single process, batch 2 (first in its process)', single[0]),
            ('single process, batch 8', single[1])] + [
        (f'--dp-eval, rank {r} of {CARDS}', rank[1])
        for r, rank in enumerate(ranks)]
    for label, run in runs:
        print(f'{label}: exit {run["rc"]}, K1 {run["k1"]} and K2 '
              f'{run["k2"]} calls, {run["syncs"]} host syncs, '
              f'{run["stats"]["images_per_second"]} images/s (nn '
              f'{run["stats"]["nn_time"]} s, decoder '
              f'{run["stats"]["decoder_time"]} s)', flush=True)
        if run['rc'] != 0:
            raise AssertionError(f'{label}: exit {run["rc"]}')
    for r, rank in enumerate(ranks):
        if (rank[1]['k1'], rank[1]['k2']) != (1, 3):
            raise AssertionError('K1 once and K2 three times per rank')
        cs.hold_eval_runs(port, rank[1], single[0],
                          f'--dp-eval, rank {r} of {CARDS}, against the '
                          'single process at batch 2')


def torchrun_train(tmp: str) -> None:
    out = os.path.join(tmp, 'ddp')
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc-per-node',
         str(CARDS), '-m', 'openpifpaf_tpu_torch.train', '--ddp',
         *cs.DDP_CLI_ARGS, '--toykp-n-images=64', '-o', out],
        capture_output=True, text=True, timeout=900, cwd=cs.REPO,
        env=dict(os.environ, PYTHONPATH=cs.REPO))
    if proc.returncode != 0:
        raise AssertionError(f'torchrun train --ddp failed:\n'
                             f'{proc.stderr[-3000:]}')
    with open(out + '.log') as f:
        lines = f.read().splitlines()
    files = sorted(n for n in os.listdir(tmp) if n.startswith('ddp'))
    print(f'torchrun --nproc-per-node {CARDS} train --ddp: exit 0, {files}, '
          f'{len(lines)} log lines: {lines[-2]}', flush=True)
    if len([line for line in lines if '"train"' in line]) != 2:
        raise AssertionError('one log line per step of the epoch expected')


def main() -> int:
    if torch.cuda.device_count() < CARDS:
        raise RuntimeError(f'multi_gpu_smoke.py needs {CARDS} CUDA cards, '
                           f'found {torch.cuda.device_count()}')
    start = time.perf_counter()
    print(cs.card_line(), f'x {torch.cuda.device_count()}', flush=True)
    port = cs._Port()  # pylint: disable=protected-access
    port.kernels.build_all(cs.KERNELS)
    for name, part in (('scaling', scaling),
                       ('steps', lambda: steps(port)),
                       ('bands', lambda: bands(port))):
        part()
        print(f'== {name} done at {time.perf_counter() - start:.1f} s',
              flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        dp_eval(port, tmp)
        print(f'== dp-eval done at {time.perf_counter() - start:.1f} s',
              flush=True)
        torchrun_train(tmp)
    print(f'multi_gpu_smoke.py: {time.perf_counter() - start:.1f} s '
          f'({cs.card_line()} x {CARDS})', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
