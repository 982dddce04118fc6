"""Drive the PyTorch port's predict, train, eval and tracking paths on an
NVIDIA card, with the dense-connection and 133-keypoint WholeBody
configurations.

Usage (from the repository root, one CUDA card):

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and exits non-zero:

1. card: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the port from ``openpifpaf_tpu_torch/csrc``,
   one ``nvcc`` each, all started together; then ``cuobjdump -sass`` of
   K2's library: per kernel the counts of HGMMA (wgmma), UTMALDG (TMA
   loads), UBLKCP (bulk copies) and HMMA (mma.sync), failing unless both
   bf16 GEMM kernels run HGMMA, load by TMA or bulk copy and run no HMMA;
3. kernels: each kernel against its plain PyTorch version on the card at
   the bench shapes, with timings (CUDA events) and its bound: K1 (its
   two CUDA kernels, ``bin_kernel`` and ``splat_kernel``) on dense and
   sparse synthetic cells (timed), on all-masked cells, a band of rows unclipped, 6561 cells on a 641x641
   grid, a 1x1 grid, an odd 37x53 grid and windows over the whole grid,
   with pass 1's masks held bit for bit to ``tile_bins_plain`` and two
   launches to identical bits; K2 on sn2k16's three stride-1 chains at
   batch 8 in bf16 and f32, also timed against the same blocks run as the
   canonical modules, on sn2k30's stage-4 chain (C = 1024, 5 blocks,
   41x41, batch 2) and on a small odd image (13x13, every tile at an edge);
   then ``Model.apply_fast`` in f32 at sn2k30's and sn2k44's widths against
   ``Model.apply``;
4. golden decode: ``tests/fixtures/golden_toykp_fields.npz`` decoded on the
   card, held against ``golden_toykp_poses.json`` and the CPU decode;
5. serve: ShuffleNetV2K-16 (CIF + CAF heads, seeded random weights, bf16)
   serves 3 distinct batches of 8 images at 641x641 through ``Predictor``,
   whose forward is the pair plan (``Model.apply_fast``), counting kernel
   launches (2 CUDA kernels per K1 call, 2 per K2 block) and host syncs;
   the served fields held against the canonical graph
   (``Model.apply``) in bf16, and in f32 on two images; two served
   images' decode (at the budgets) held against the CPU decode of the same
   fields; then per-image timings;
6. kernels at the main path's inputs: each kernel against its plain version
   and timed on the very tensors the serve phase handed it;
7. with ``--profile``: the device time per call of K1's two kernels and
   K2's two (phases 3 and 6), and one served batch under
   ``torch.profiler``, the device's busy share and the ops that take its
   time;
8. train: the port's training path (``openpifpaf_tpu_torch.training``,
   the canonical graph under autograd; it runs no hand-written kernel).
   A narrow model's loss components, gradients, one SGD step and its
   BatchNorm statistics on the card in f32 (TF32 off) against the CPU;
   ShuffleNetV2K-16 at full width with the COCO CIF/CAF heads, toykp at
   385 px, batch 8, bf16, 10 SGD-nesterov steps on one fixed batch (finite
   losses, the last below the first; ms per step by CUDA events, images per
   second, peak memory, the host's time to render and encode the batch);
   ``python -m openpifpaf_tpu_torch.train`` for one epoch and ``--resume``
   for a second (log lines, checkpoint files); the written checkpoint
   served by ``Predictor`` through K2 and K1 (their counts set to 0 before,
   read after);
9. eval: (a) ``python -m openpifpaf_tpu_torch.eval`` on the card scores
   the train phase's checkpoint at 385 px (the stats json's keys); (b) the
   golden fields replayed through the card's decode and the port's COCO
   metric, with and without ``--force-complete-pose``: the stats equal the
   CPU's, AP > 0.9; (c) sn2k16 at full width with bias-shifted heads, bf16,
   16 toykp images at 385 px in batches of 8 through ``Evaluator``:
   single-scale without and with force-complete, then multi-scale with it
   (289, 385 and 481 px, each with its hflip); per variant K1 once and K2
   three times per batch (counts set to 0 before each run, read after);
   images/s, ``nn_time``, ``decoder_time``, host syncs per batch, peak
   memory; (d) the single-scale predictions and one image of each
   multi-scale variant held to the port's CPU decode of the same fields;
   then K1 and K2 held to their plain versions and timed on the 289 and
   481 px variants' inputs;
10. dense: sn2k16 with toykp's CIF (17x5), CAF (19x9) and caf25 (18x9)
   heads, bias-shifted, bf16, decoded with ``--dense-connections 1.0`` over
   the 37 concatenated edges: 3 chained batches of 8 at 641 px (K1 once and
   K2 three times per batch, counts set to 0 before and read after), the
   first batch's decode held to the CPU decode (``hold_at_budget``), the
   painted dense scenes, at three jitter draws, held with
   ``hold_card_to_cpu``; then the train CLI
   on ``toykp --toykp-with-dense`` (one epoch of 16 images at 385 px) and
   the eval CLI on its checkpoint with ``--dense-connections``;
11. wholebody: sn2k30 with ToyWb's 133-keypoint CIF (133x5) and CAF
   (129x9) heads, bias-shifted, bf16, at WHOLEBODY_BENCH.json's budgets
   (1024 seeds, 256 CAF candidates, 96 poses), with 1 and 2 placements per
   growth round: 3 chained batches of 8 at 641 px each (K1 and K2
   counted), per-image ms, host syncs per batch and peak memory, each
   run's first batch held to the CPU at the same m (the front end stage by
   stage, the CPU back end on the card's front end by ``hold_at_budget``:
   ``hold_wholebody_batch``), painted WholeBody
   scenes, at three jitter draws, held with ``hold_card_to_cpu``; K1 at
   F = 133 and K2 at sn2k30's three
   chains (C = 256, 512, 1024) held to their plain versions and timed on the
   inputs the main path handed them; then the train CLI on ``toywb``
   (sn2k16, one epoch of 16 images at 321 px) and the eval CLI on its
   checkpoint;
12. tracking: (a) the temporal association at the budgets (96 x 96
   poses, 128 TCAF candidates per keypoint type, a jittered painted crowd)
   on the card under CUDA's sync debug mode set to raise, held to the
   port's CPU association (identical match, scores within 1e-6 of
   max(1, |s|)); (b) tshufflenetv2k16 with toykpst's CIF (17x5), CAF
   (19x9) and TCAF (17x9) heads, bias-shifted, bf16, streams 16 frames at
   641 px through ``video.VideoProcessor`` (the backbone on each new frame,
   the heads on the cached pair, ``TrackingPose``'s decode and
   association): per frame the backbone, heads, decode, association and
   end-to-end ms, host syncs (the association's apart, exactly one), K1
   and K2 calls (counts set to 0 before the stream, read after), peak
   memory; four frames held to the CPU ``TrackingPose`` from the same
   track state (``hold_tracking_frame``); (c) the train CLI on toykpst,
   the eval CLI with the COCO and PoseTrack metrics, the video CLI on PNG
   frames; (d) K1 and K2 held to their plain versions and timed on the
   stream's inputs (one frame);
13. a ``{"kernels": [...]}`` line (each kernel's ``launches`` from the
   serve phase, ``eval_launches`` from the multi-scale eval,
   ``dense_launches``, ``wholebody_launches`` and ``tracking_launches``
   from those phases' runs, ``wholebody`` and ``tracking`` its hold and
   times at those shapes), the card's name and power limit, then the last
   line ``{"ok": true, "device": {...}}``.

It imports only the port, torch and numpy.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, 'tests', 'fixtures')

# the card's published rates (H100 SXM data sheet): HBM bandwidth, the f32
# rate outside the tensor cores and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# sn2k16's stride-1 chains: (stage, blocks, side at 641 px, half-width C)
SN2K16_CHAINS = ((2, 3, 161, 174), (3, 7, 81, 348), (4, 3, 41, 696))
# K2's CUDA kernels per stride-1 block, and its chains' blocks per forward
KERNELS_PER_BLOCK = 2
SN2K16_BLOCKS = sum(n for _, n, _, _ in SN2K16_CHAINS)
KERNELS = ('cif_hr', 'pair_chain')


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase(name: str) -> None:
    print(f'== {name}', flush=True)


def cuda_ms(fn, repeats: int = 10, warmup: int = 2):
    """Median, min and max of ``repeats`` timed calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(min(times)), float(max(times))


# ---------------------------------------------------------------- kernels
def splat_inputs(kind: str, rng, *, b=8, f=17, h=41, w=41, stride=16,
                 device='cuda'):
    """(v, x, y, sigma), each (B, F, N), as ``cif_hr.accumulate`` hands
    them to the kernel at 641 px.  ``dense``: every cell above threshold,
    like an untrained head; ``sparse``: a few painted people per field,
    like a trained head."""
    jj, ii = np.mgrid[0:h, 0:w].astype(np.float32)
    if kind == 'dense':
        conf = rng.uniform(0.15, 0.9, (b, f, h, w))
        x = (ii + rng.normal(0, 0.5, (b, f, h, w))) * stride
        y = (jj + rng.normal(0, 0.5, (b, f, h, w))) * stride
        scale = np.log1p(np.exp(rng.normal(0, 1, (b, f, h, w)))) * stride
    else:
        conf = np.full((b, f, h, w), 0.02)
        x = ii * stride + np.zeros((b, f, h, w))
        y = jj * stride + np.zeros((b, f, h, w))
        scale = np.full((b, f, h, w), 30.0)
        for bi in range(b):
            for fi in range(f):
                for _ in range(6):
                    cx, cy = rng.uniform(2, w - 3), rng.uniform(2, h - 3)
                    i0, j0 = int(cx) - 1, int(cy) - 1
                    s = rng.uniform(10, 80)
                    sl = (bi, fi, slice(j0, j0 + 4), slice(i0, i0 + 4))
                    conf[sl] = rng.uniform(0.4, 1.0, (4, 4))
                    x[sl] = (cx + rng.normal(0, 0.1, (4, 4))) * stride
                    y[sl] = (cy + rng.normal(0, 0.1, (4, 4))) * stride
                    scale[sl] = s
    v = np.where(conf > 0.1, conf / 16.0, 0.0)
    sigma = np.maximum(2.0, 0.5 * scale)
    return tuple(torch.tensor(a.reshape(b, f, h * w), dtype=torch.float32,
                              device=device) for a in (v, x, y, sigma))


def splat_bound_ms(v, x, y, sigma, *, out_hw, spacing, truncate,
                   y_offset_px=0.0, clip=True):
    """The least time the card could take for this splat: bytes (each input
    read once, the output written once) over HBM bandwidth, against the
    f32 multiply-adds this data needs (each kept cell's window, rows times
    columns inside the grid) over the f32 rate.  ``clip`` does not change
    the count."""
    hh, wh = out_hw
    n_bytes = 4 * (4 * v.numel() + v.shape[0] * v.shape[1] * hh * wh)
    t = truncate * sigma

    def extent(c, off, size):
        lo = torch.clamp(torch.ceil((c - t - off) / spacing), 0, size - 1)
        hi = torch.clamp(torch.floor((c + t - off) / spacing), 0, size - 1)
        inside = (c + t - off >= 0) & (c - t - off <= (size - 1) * spacing)
        return torch.where(inside & (hi >= lo), hi - lo + 1, 0.0)

    rows = extent(y, y_offset_px, hh)
    cols = extent(x, 0.0, wh)
    ops = float((2.0 * rows * cols * (v != 0)).sum())
    bytes_s = n_bytes / HBM_BYTES_PER_S
    ops_s = ops / F32_OPS_PER_S
    return (1e3 * max(bytes_s, ops_s), 'bytes' if bytes_s >= ops_s
            else 'operations', n_bytes, ops)


def hold_cif_hr(cif_hr, name: str, inputs, kw) -> float:
    """K1 on ``inputs`` against its plain version, and returns
    max|kernel - plain|.  Also: pass 1's masks (``cif_hr_tile_bins``) equal
    ``tile_bins_plain`` bit for bit, and a second launch gives the same
    bits.  Limit 2e-5 on max|kernel - plain| when clipped, on
    max|kernel - plain| / (1 + |plain|) when not (sums above 1)."""
    got = cif_hr.cif_hr_tile_bins(*inputs, **_bin_kw(kw))
    masks = cif_hr.tile_bins_plain(*inputs, **_bin_kw(kw))
    if not torch.equal(got, masks):
        raise AssertionError(f'cif_hr {name}: bin_kernel masks differ from '
                             f'tile_bins_plain in '
                             f'{int((got != masks).sum())} words')
    first = cif_hr.cif_hr_accumulate(*inputs, **kw)
    again = cif_hr.cif_hr_accumulate(*inputs, **kw)
    want = cif_hr.accumulate_plain(*inputs, **kw)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError(f'cif_hr {name}: two launches differ')
    err = float((first - want).abs().max())
    clip = kw.get('clip', True)
    worst = err if clip else float(((first - want).abs()
                                    / (1.0 + want.abs())).max())
    b, f, n = inputs[0].shape
    kept = int((inputs[0] != 0).sum())
    per_tile = _popcount(masks) / max(1, masks.shape[2] * kept)
    print(f'cif_hr {name} [B={b} F={f} N={n} {tuple(first.shape[2:])}]: '
          f'max|kernel - plain| {err:.3e}'
          f'{"" if clip else f", /(1+|plain|) {worst:.3e}"} (limit 2e-5), '
          f'max value {float(want.max()):.4f}; masks equal tile_bins_plain, '
          f'the same bits on a second launch; share of kept cells binned per '
          f'{cif_hr.TILE[0]}x{cif_hr.TILE[1]} tile: {per_tile:.4f}',
          flush=True)
    if not worst <= 2e-5:
        raise AssertionError(f'cif_hr kernel disagrees ({name}): {worst}')
    if not clip and float(want.max()) <= 1.0:
        raise AssertionError(f'cif_hr {name}: unclipped sums stay below 1')
    return err


def _bin_kw(kw):
    return {k: v for k, v in kw.items() if k != 'clip'}


def _popcount(masks):
    m = masks.long() & 0xFFFFFFFF
    return sum(int(((m >> i) & 1).sum()) for i in range(32))


def measure_cif_hr(cif_hr, name: str, inputs, kw) -> dict:
    """K1 held to its plain version on ``inputs`` (``hold_cif_hr``), then
    timed beside the plain version."""
    err = hold_cif_hr(cif_hr, name, inputs, kw)
    ms = cuda_ms(lambda: cif_hr.cif_hr_accumulate(*inputs, **kw))
    plain = cuda_ms(lambda: cif_hr.accumulate_plain(*inputs, **kw))
    bound, bound_by, n_bytes, ops = splat_bound_ms(*inputs, **kw)
    print(f'cif_hr {name}: kernel median {ms[0]:.4f} ms [min {ms[1]:.4f}, '
          f'max {ms[2]:.4f}] at tile {cif_hr.TILE}, plain {plain[0]:.4f} ms [min {plain[1]:.4f}, max '
          f'{plain[2]:.4f}], bound {bound:.4f} ms by {bound_by} ({n_bytes} '
          f'B, {ops:.4g} f32 ops, {int((inputs[0] != 0).sum())} cells kept; '
          f'{100 * bound / ms[0]:.1f}% of it), no single PyTorch call '
          f'computes it', flush=True)
    return dict(ms=ms[0], plain_ms=plain[0], bound_ms=bound,
                bound_by=bound_by, max_abs_err=err)


def profile_cif_hr(cif_hr, name: str, inputs, kw) -> None:
    """Device time per call of K1's two CUDA kernels (bin_kernel,
    splat_kernel), from ``torch.profiler`` over 10 calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            cif_hr.cif_hr_accumulate(*inputs, **kw)
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0.0))
        found = re.search(r'\b(bin_kernel|splat_kernel)\b', e.key)
        if us and found:
            parts.append(f'{found.group(0)} {us / e.count:.2f} us '
                         f'({e.count} calls)')
    print(f'cif_hr {name} per kernel call: {", ".join(sorted(parts))}',
          flush=True)


def check_cif_hr(cif_hr, profile_on: bool = False) -> dict:
    """K1 against its plain version on the card: at the bench shape on
    dense and sparse cells (timed), then on all-masked cells, a band of
    rows unclipped, 6561 cells (compaction off) on a 641 x 641 grid, a 1 x 1
    grid, an odd 37 x 53 grid and windows that cover the whole grid."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    kw = dict(out_hw=(321, 321), spacing=2.0, truncate=1.0)
    result = {}
    for kind in ('dense', 'sparse'):
        inputs = splat_inputs(kind, rng)
        result[kind] = measure_cif_hr(cif_hr, kind, inputs, kw)
        if profile_on:
            profile_cif_hr(cif_hr, kind, inputs, kw)
    errs = [r['max_abs_err'] for r in result.values()]

    # all cells masked: exact zeros
    v, x, y, sigma = splat_inputs('dense', rng)
    zeros = cif_hr.cif_hr_accumulate(torch.zeros_like(v), x, y, sigma, **kw)
    if int(torch.count_nonzero(zeros)) != 0:
        raise AssertionError('cif_hr kernel: all-masked input is not zero')
    print('cif_hr all cells masked: exact zeros', flush=True)
    unclipped = dict(spacing=2.0, truncate=1.0, clip=False)
    cases = [
        ('band y_offset=100 clip=False', (v * 4.0, x, y, sigma * 3.0),
         dict(out_hw=(64, 321), y_offset_px=100.0, **unclipped)),
        ('6561 cells', splat_inputs('dense', rng, b=2, h=81, w=81),
         dict(out_hw=(641, 641), spacing=2.0, truncate=1.0)),
        ('1x1 grid', splat_inputs('dense', rng, b=2, f=3, h=4, w=4),
         dict(out_hw=(1, 1), spacing=2.0, truncate=1.0)),
        ('odd grid', splat_inputs('sparse', rng, b=2, f=5, h=9, w=9),
         dict(out_hw=(37, 53), spacing=2.0, truncate=1.0)),
        ('whole-grid windows', (v[:2, :4], x[:2, :4], y[:2, :4],
                                sigma[:2, :4] * 500.0),
         dict(out_hw=(321, 321), **unclipped)),
    ]
    for name, inputs, case_kw in cases:
        errs.append(hold_cif_hr(cif_hr, name,
                                tuple(t.contiguous() for t in inputs),
                                case_kw))
    result['max_abs_err'] = max(errs)
    return result


# ----------------------------------------------------------------------- K2
def perturbed_backbone(port, name='shufflenetv2k16'):
    """A seeded backbone on the card whose BatchNorm statistics are
    perturbed from a numpy seed (means + N(0, 0.3), variances times
    U(0.5, 2)), so the BN fold is not the identity and relu(o1) is not 0 at
    the image edge."""
    cif, caf = coco_metas(port.headmeta, port.constants)
    model = port.models.factory(name, [cif, caf], device='cuda', seed=0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in model.module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                shape = tuple(m.running_mean.shape)
                m.running_mean.add_(torch.as_tensor(
                    rng.normal(0.0, 0.3, shape), dtype=torch.float32,
                    device='cuda'))
                m.running_var.mul_(torch.as_tensor(
                    rng.uniform(0.5, 2.0, shape), dtype=torch.float32,
                    device='cuda'))
    return model.module.basenet


def chain_bound_ms(n_blocks, pixels, c, itemsize):
    """The least time the card could take for a chain: the bytes (the pair
    read once and written once in its storage type, each block's weights
    and folded vectors read once) over HBM bandwidth, against its
    2 * (2 C^2 + 25 C) operations per pixel and block (two C x C products
    and the 5x5 stencil) over the tensor cores' bf16 rate (the f32 rate
    outside the tensor cores for f32 storage)."""
    n_bytes = (4 * pixels * c * itemsize
               + n_blocks * (2 * c * c * itemsize + 31 * c * 4))
    ops = 2.0 * n_blocks * pixels * (2 * c * c + 25 * c)
    bytes_s = n_bytes / HBM_BYTES_PER_S
    ops_s = ops / (BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S)
    return (1e3 * max(bytes_s, ops_s), 'bytes' if bytes_s >= ops_s
            else 'operations', n_bytes, ops)


def measure_pair_chain(pc, name, a, b, chain, modules) -> dict:
    """K2 against its plain version on ``(a, b)``, then the kernel, the
    plain version and the same blocks as the canonical modules (on the
    logical NCHW tensor, bf16 through autocast) timed.  Limits: bf16
    max|kernel - plain| <= 3e-2 max|plain| (``test_fused_shufflenet.py:321``);
    f32 max|kernel - plain| / (1 + |plain|) <= 1e-5."""
    bf16 = a.dtype == torch.bfloat16
    got = pc.pair_chain(a, b, chain)
    want = pc.pair_chain_plain(a, b, chain.blocks, chain.dtype)
    torch.cuda.synchronize()
    err, worst = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        err = max(err, float(d.max()))
        if bf16:
            worst = max(worst, float(d.max() / w.float().abs().max()))
        else:
            worst = max(worst, float((d / (1.0 + w.float().abs())).max()))
    limit = 3e-2 if bf16 else 1e-5
    measure = 'max|d|/max|plain|' if bf16 else 'max|d|/(1+|plain|)'
    print(f'pair_chain {name} {tuple(a.shape)} {str(a.dtype)[6:]}: '
          f'{len(chain.blocks)} blocks, max|kernel - plain| {err:.3e}, '
          f'{measure} {worst:.3e} (limit {limit:g})', flush=True)
    if not worst <= limit:
        raise AssertionError(f'pair_chain kernel disagrees ({name}): {worst}')

    def canonical():
        x = pc.interleave(a, b).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad(), torch.autocast('cuda', dtype=torch.bfloat16,
                                             enabled=bf16):
            for module in modules:
                x = module(x)
        return x

    if bf16:
        print_plan(pc, name, a)
    ms = cuda_ms(lambda: pc.pair_chain(a, b, chain))
    plain = cuda_ms(lambda: pc.pair_chain_plain(a, b, chain.blocks,
                                                chain.dtype))
    canon = cuda_ms(canonical)
    bsz, h, w, c = a.shape
    bound, bound_by, n_bytes, ops = chain_bound_ms(
        len(chain.blocks), bsz * h * w, c, a.element_size())
    print(f'pair_chain {name}: kernel median {ms[0]:.4f} ms [min {ms[1]:.4f}, '
          f'max {ms[2]:.4f}], plain {plain[0]:.4f} ms, canonical modules '
          f'{canon[0]:.4f} ms, bound {bound:.4f} ms by {bound_by} '
          f'({n_bytes} B, {ops:.4g} ops; {100 * bound / ms[0]:.1f}% of it), '
          f'no single PyTorch call computes it', flush=True)
    return dict(ms=ms[0], plain_ms=plain[0], canonical_ms=canon[0],
                bound_ms=bound, bound_by=bound_by, max_abs_err=err)


def print_plan(pc, name, a) -> None:
    """K2's bf16 launch plan for ``a``'s shape, and the weight bytes its
    kernels stream from L2 into the SMs per block: each pixel tile a CTA
    meets reads all (Np, Kp) weights (Np padded to whole wgmma tiles)."""
    bsz, h, w, c = a.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = pc.launch_plan(c, a.dtype, bsz, h, w, sms)
    weights = p.n_tiles * p.n_tile * p.kp * 2
    rows = 'rows from q - q % 2' if p.slab_half else 'whole rows'
    print(f'pair_chain {name} plan: N tile {p.n_tile} x {p.n_tiles}, Kp '
          f'{p.kp}; expand {p.expand_rows}-pixel tiles x {p.expand_tiles} '
          f'on {p.expand_grid} CTAs, weight ring {p.expand_stages}, pair '
          f'slabs of 64 px ({rows}) x {p.slab_stages}, {p.expand_smem} B; '
          f'project {p.tile_h}x{p.tile_w} tiles x {p.project_tiles} on '
          f'{p.project_grid} CTAs, weight ring {p.project_stages}, halo ring '
          f'{p.halo_stages}, {p.project_smem} B; weights streamed from L2 '
          f'per block: expand {p.expand_tiles * weights / 1e6:.1f} MB, '
          f'project {p.project_tiles * weights / 1e6:.1f} MB', flush=True)


def profile_pair_chain(pc, name, a, b, chain) -> None:
    """Device time per call of each of K2's CUDA kernels (expand_kernel,
    project_kernel), from ``torch.profiler`` over 5 chain calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            pc.pair_chain(a, b, chain)
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0.0))
        found = re.search(r'(expand_kernel|project_kernel)<[^>]*>', e.key)
        if us and found:
            parts.append(f'{found.group(0)} {us / e.count:.1f} us x '
                         f'{e.count // 5}')
    print(f'pair_chain {name} per kernel call: {", ".join(sorted(parts))}',
          flush=True)


def check_pair_chain(port) -> dict:
    """K2 against its plain version, bf16 and f32, on random post-relu
    pairs from a numpy seed: at sn2k16's three chain shapes at batch 8, at
    sn2k30's stage-4 chain (C = 1024, 5 blocks, 41x41, batch 2), and at
    sn2k16's stage-2 chain on 13x13 images (batch 3), where every tile
    meets the image edge."""
    pc = port.pair_chain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net16 = perturbed_backbone(port)
    net30 = perturbed_backbone(port, 'shufflenetv2k30')
    rng = np.random.default_rng(2)
    result = {}
    cases = [(f'stage {stage}', net16, stage, n, 8, side, c)
             for stage, n, side, c in SN2K16_CHAINS]
    cases += [('sn2k30 stage 4', net30, 4, 5, 2, 41, 1024),
              ('stage 2 at 13x13', net16, 2, 3, 3, 13, 174)]
    for name, net, stage, n, bsz, side, c in cases:
        modules = [getattr(net, f'stage{stage}_{i}') for i in range(1, n + 1)]
        params = [pc.block_params(m) for m in modules]
        pair = [np.abs(rng.standard_normal((bsz, side, side, c),
                                           dtype=np.float32))
                for _ in range(2)]
        for dtype in (torch.bfloat16, torch.float32):
            a, b = (torch.as_tensor(x, device='cuda').to(dtype) for x in pair)
            chain = pc.pack(params, dtype)
            result[name, dtype] = measure_pair_chain(pc, name, a, b, chain,
                                                     modules)
            if dtype == torch.bfloat16 and bsz == 8:
                profile_pair_chain(pc, name, a, b, chain)
            del a, b
    return result


def sass_check(port) -> None:
    """``cuobjdump -sass`` of K2's built library: per kernel the counts of
    HGMMA (wgmma), UTMALDG (TMA loads), UBLKCP (bulk copies) and HMMA
    (mma.sync).  Raises unless every bf16 GEMM kernel (``expand_kernel``,
    ``project_kernel``) runs HGMMA, loads by TMA or bulk copy and runs no
    HMMA."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run(
        [tool, '-sass', str(port.kernels.library_path('pair_chain'))],
        capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    ops = ('HGMMA', 'UTMALDG', 'UBLKCP', 'HMMA')
    for line in sass.splitlines():
        if 'Function :' in line:
            mangled = line.split('Function :')[1].strip()
            found = re.search(r'(expand_kernel|project_kernel|expand_f32|'
                              r'project_f32)I((?:Li\d+E)+)', mangled)
            if found:
                args = re.findall(r'Li(\d+)E', found.group(2))
                name = f'{found.group(1)}<{",".join(args)}>'
            else:
                name = mangled
            counts[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            for op in ops:
                counts[name][op] += bool(re.search(rf'\b{op}\b', line))
    for name, c in sorted(counts.items()):
        print(f'sass {name}: ' + ', '.join(f'{op} {c[op]}' for op in ops),
              flush=True)
    gemms = {k: c for k, c in counts.items()
             if k.startswith(('expand_kernel<', 'project_kernel<'))}
    bad = [k for k, c in gemms.items()
           if not c['HGMMA'] or not (c['UTMALDG'] or c['UBLKCP'])
           or c['HMMA']]
    if len(gemms) < 2 or bad:
        raise AssertionError(f'bf16 GEMM kernels without HGMMA or TMA, or '
                             f'with mma.sync: {bad or "none found"}')


def check_wide_f32(port) -> None:
    """``Model.apply_fast`` in f32 at sn2k30's and sn2k44's widths (stage
    half-widths 256, 512, 1024, whose f32 chains take 32-pixel tiles above
    C = 704) against ``Model.apply``, TF32 off, one 129x129 image:
    max|d| / (1 + |canonical|) <= 1e-4."""
    pc = port.pair_chain
    metas = list(coco_metas(port.headmeta, port.constants))
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(1, 3, 129, 129)), dtype=torch.float32, device='cuda')
    for name in ('shufflenetv2k30', 'shufflenetv2k44'):
        model = port.models.factory(name, metas, device='cuda', seed=0,
                                    bf16=False)
        before = pc.KERNEL_LAUNCHES
        fast = model(x)
        if pc.KERNEL_LAUNCHES != before + len(SN2K16_CHAINS):
            raise AssertionError(f'{name} f32 forward did not run K2')
        canonical = model.apply(x)
        worst = max(float(((f - c).abs() / (1.0 + c.abs())).max())
                    for f, c in zip(fast, canonical))
        print(f'{name} f32, apply_fast (K2) vs apply, 129x129: '
              f'max|d|/(1+|canonical|) {worst:.3e} (limit 1e-4)', flush=True)
        if not worst <= 1e-4:
            raise AssertionError(f'{name}: apply_fast and apply differ in '
                                 f'f32: {worst}')
        del model


# ----------------------------------------------------------- golden decode
def coco_metas(headmeta, constants):
    cif = headmeta.Cif('cif', 'toykp', keypoints=constants.COCO_KEYPOINTS,
                       sigmas=constants.COCO_PERSON_SIGMAS,
                       score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    caf = headmeta.Caf('caf', 'toykp', keypoints=constants.COCO_KEYPOINTS,
                       sigmas=constants.COCO_PERSON_SIGMAS,
                       skeleton=constants.COCO_PERSON_SKELETON)
    return cif, caf


def check_golden_decode(port) -> None:
    fields = np.load(os.path.join(FIXTURES, 'golden_toykp_fields.npz'))
    with open(os.path.join(FIXTURES, 'golden_toykp_poses.json')) as f:
        golden = json.load(f)
    cif_meta, caf_meta = coco_metas(port.headmeta, port.constants)
    cif_meta.head_index, caf_meta.head_index = 0, 1
    cif_meta.base_stride = caf_meta.base_stride = 16
    decoder = port.decoder.CifCaf(cif_meta, caf_meta, device='cuda')
    fields_cuda = [torch.as_tensor(fields['cif'], device='cuda'),
                   torch.as_tensor(fields['caf'], device='cuda')]
    launches = port.cif_hr.KERNEL_LAUNCHES
    anns = decoder.batch_fields(fields_cuda)
    if port.cif_hr.KERNEL_LAUNCHES != launches + 1:
        raise AssertionError('golden decode on the card did not launch K1')
    # tests/test_golden.py's tolerances: score 0.01, xy 1 px, v 0.02
    for i, want_poses in enumerate(golden['poses']):
        got = sorted(anns[i], key=lambda a: -a.score)
        if len(got) != len(want_poses):
            raise AssertionError(f'golden image {i}: {len(got)} poses, '
                                 f'want {len(want_poses)}')
        for ann, want in zip(got, want_poses):
            want_xyv = np.asarray(want['xyv'], np.float32)
            vis = want_xyv[:, 2] > 0
            ok = (abs(ann.score - want['score']) < 0.01
                  and np.array_equal(ann.data[:, 2] > 0, vis)
                  and np.abs(ann.data[vis, :2] - want_xyv[vis, :2]).max() <= 1.0
                  and np.abs(ann.data[vis, 2] - want_xyv[vis, 2]).max() <= 0.02)
            if not ok:
                raise AssertionError(f'golden image {i}: pose differs')

    print(f'golden decode: {sum(len(a) for a in anns)} poses in 4 images '
          f'match golden_toykp_poses.json', flush=True)
    hold_card_to_cpu(port, decoder, decoder.batch_decoded(fields_cuda),
                     fields_cuda, 'golden decode')


def cpu_decode(port, decoder, fields):
    """The port's CPU decode of ``fields`` with the configuration the card
    runs (f32 profiles, ``profile_bf16=False``), as numpy arrays."""
    h, w = fields[0].shape[-2:]
    stride = decoder.cif_meta.stride
    config = decoder.config_for(((h - 1) * stride + 1, (w - 1) * stride + 1))
    if config.cifhr.profile_bf16:
        raise AssertionError('the card decode must run f32 profiles')
    out = port.ops.make_batch_decoder(
        cif_meta=decoder.cif_meta, caf_meta=decoder.caf_meta, config=config,
        device='cpu')(*[f.cpu() for f in fields])
    return [t.numpy() for t in out]


def pose_difference(a, b):
    """Two decodes (numpy ``DecodedPoses``): whether every image has the
    same number of valid poses, and if so the max |Δxyv| and |Δscore| over
    poses matched one to one (greedily, each pose of ``a`` to the nearest
    free pose of ``b``)."""
    valid_a, valid_b = a[3], b[3]
    same_count = np.array_equal(valid_a.sum(1), valid_b.sum(1))
    dxyv = dscore = 0.0
    for i in range(valid_b.shape[0]) if same_count else ():
        xyv_a, xyv_b = a[0][i][valid_a[i]], b[0][i][valid_b[i]]
        sc_a, sc_b = a[2][i][valid_a[i]], b[2][i][valid_b[i]]
        free = list(range(len(xyv_b)))
        for j in range(len(xyv_a)):
            d = [float(np.abs(xyv_a[j] - xyv_b[k]).max()) for k in free]
            best = int(np.argmin(d))
            dxyv = max(dxyv, d[best])
            dscore = max(dscore, float(abs(sc_a[j] - sc_b[free[best]])))
            free.pop(best)
    return same_count, dxyv, dscore


def same_counters(a, b) -> bool:
    """The CAF and CifHr overflow counters equal, the unclaimed-seed
    counter within one per image (``hold_card_to_cpu``)."""
    return (all(np.array_equal(x, y) for x, y in zip(a[4:6], b[4:6]))
            and np.abs(a[6].astype(np.int64)
                       - b[6].astype(np.int64)).max() <= 1)


def hold_card_to_cpu(port, decoder, on_card, fields_cuda, label) -> None:
    """The card's decode of ``fields_cuda`` against the port's CPU decode of
    the same fields, with the configuration the card ran (f32 profiles,
    ``profile_bf16=False``): per image the same number of valid poses, each
    card pose matched one to one with a CPU pose, xyv within 1e-3 and score
    within 1e-4 (the CPU parity tolerances against JAX), and the same CAF
    and CifHr overflow counters.  Poses are matched rather than compared
    slot by slot, and the third counter (seeds left unclaimed beyond the
    max_poses budget) may differ by one per image: whether a seed is claimed
    is a distance test against joints that the two decodes place within
    that 1e-3, and a seed on the claim radius moves the later poses to
    other slots (at the served budgets, every cell a detection, one seed of
    ~180 sits on it)."""
    card_np = [t.cpu().numpy() for t in on_card]
    cpu_np = cpu_decode(port, decoder, fields_cuda)
    valid_c, valid_h = card_np[3], cpu_np[3]
    matched, dxyv, dscore = pose_difference(card_np, cpu_np)
    counters = [np.asarray(a).tolist() for a in card_np[4:]]
    agree = same_counters(card_np, cpu_np)
    same_slots = np.array_equal(valid_c, valid_h)
    print(f'{label}, card vs CPU decode of {valid_h.shape[0]} images: '
          f'valid poses {valid_c.sum(1).tolist()} card, '
          f'{valid_h.sum(1).tolist()} CPU (same slots: {same_slots}); poses '
          f'matched one to one, max|dxyv| {dxyv:.3e} (limit 1e-3), '
          f'max|dscore| {dscore:.3e} (limit 1e-4); overflow counters (caf, '
          f'cif, poses) card {counters}, CPU '
          f'{[np.asarray(a).tolist() for a in cpu_np[4:]]}, agree: '
          f'{agree}', flush=True)
    if not (matched and agree and dxyv <= 1e-3 and dscore <= 1e-4):
        raise AssertionError(f'{label}: card and CPU decodes differ')


def poses_missed(a, b, tol: float = 1e-3):
    """Per image, how many of ``a``'s valid poses have no valid pose of
    ``b`` within ``tol`` in every xyv value."""
    missed = []
    for i in range(a[3].shape[0]):
        xyv_b = b[0][i][b[3][i]]
        xyv_b = xyv_b.reshape(len(xyv_b), int(np.prod(xyv_b.shape[1:])))
        missed.append(sum(
            not (np.abs(xyv_b - pose.reshape(-1)).max(1) <= tol).any()
            for pose in a[0][i][a[3][i]]))
    return missed


def hold_at_budget(port, decoder, on_card, fields_cuda, label,
                   cpu_np=None) -> None:
    """The card's decode of fields where every cell is a detection (the
    bias-shifted heads), at the seed and pose budgets, against the port's
    CPU decode of the same fields.  There near-ties decide: a seed on the
    claim radius of a grown pose (``hold_card_to_cpu``), two candidates
    whose scores differ in the last ulp.  Where the card's and the CPU's
    f32 arithmetic fall on either side of one, the two decodes grow a
    pose differently, and neither is wrong.  Held: per image the same
    number of valid poses, the same overflow counters (the unclaimed-seed
    counter within one), and every card pose but at most one per image
    within 1e-3 of a CPU pose in every xyv value.  Printed: the poses
    matched one to one (max |Δxyv|, |Δscore|) and the poses without a CPU
    pose within 1e-3.  ``cpu_np``: the CPU decode to hold against (default
    ``cpu_decode`` of ``fields_cuda``)."""
    card_np = [t.cpu().numpy() for t in on_card]
    if cpu_np is None:
        cpu_np = cpu_decode(port, decoder, fields_cuda)
    same_count, dxyv, dscore = pose_difference(card_np, cpu_np)
    agree = same_counters(card_np, cpu_np)
    missed = poses_missed(card_np, cpu_np)
    print(f'{label}, card vs CPU decode of {cpu_np[3].shape[0]} images at '
          f'the budgets: valid poses {card_np[3].sum(1).tolist()} card, '
          f'{cpu_np[3].sum(1).tolist()} CPU, equal: {same_count}; overflow '
          f'counters (caf, cif, poses) card '
          f'{[np.asarray(a).tolist() for a in card_np[4:]]}, CPU '
          f'{[np.asarray(a).tolist() for a in cpu_np[4:]]}, agree: {agree}; '
          f'poses matched one to one: max|dxyv| {dxyv:.3e}, max|dscore| '
          f'{dscore:.3e}; card poses without a CPU pose within 1e-3, per '
          f'image: {missed} of {int(card_np[3].sum())} (limit 1 per image)',
          flush=True)
    if not (same_count and agree and max(missed) <= 1):
        raise AssertionError(f'{label}: card and CPU decodes differ')


# ------------------------------------------------------------------ serve
def shift_head_biases(model, metas) -> None:
    """Seeded random weights give fields without detections (confidence
    ~0.5, scale ~0.7 cells), and the decode would stop after the seeds.
    Shifting the heads' confidence and scale biases makes every cell a
    detection, so seeds, CAF scoring, growth and NMS all run at their
    budgets: the heaviest decode the path has."""
    with torch.no_grad():
        for head, meta in zip(model.module.head_nets, metas):
            bias = head.conv.bias.view(meta.n_fields, meta.n_components)
            bias[:, 0] = 2.0
            bias[:, meta.n_components - meta.n_scales:] = 3.0


def serve(port, card: str) -> dict:
    from openpifpaf_tpu_torch.predictor import Predictor

    metas = list(coco_metas(port.headmeta, port.constants))
    torch.backends.cudnn.benchmark = True
    predictor = Predictor(base_name='shufflenetv2k16', head_metas=metas,
                          device='cuda', bf16=True, seed=0)
    predictor.batch_size = 8
    torch.cuda.reset_peak_memory_stats()
    shift_head_biases(predictor.model, metas)
    rng = np.random.default_rng(1)
    batches = [[rng.integers(0, 256, (641, 641, 3), dtype=np.uint8)
                for _ in range(8)] for _ in range(3)]

    # the fields of the first batch: finite, of the expected shapes, and the
    # pair plan's (apply_fast, K2) equal to the canonical graph's
    x, _ = predictor.preprocess(batches[0])
    fields = predictor.model(x)
    shapes = [tuple(f.shape) for f in fields]
    if shapes != [(8, 17, 5, 41, 41), (8, 19, 9, 41, 41)]:
        raise AssertionError(f'field shapes {shapes}')
    if not all(bool(torch.isfinite(f).all()) for f in fields):
        raise AssertionError('non-finite fields')
    hold_fast_to_canonical(port, predictor.model, x, metas)

    # warm-up, keeping what the main path hands K1 and K2 for their timing
    captured, chains = [], []
    launch = port.cif_hr.cif_hr_accumulate
    launch_chain = port.pair_chain.pair_chain

    def spy(*args, **kwargs):
        captured.append(([a.clone() for a in args], dict(kwargs)))
        return launch(*args, **kwargs)

    def spy_chain(a, b, chain):
        chains.append((a.clone(), b.clone(), chain))
        return launch_chain(a, b, chain)

    port.cif_hr.cif_hr_accumulate = spy
    port.pair_chain.pair_chain = spy_chain
    try:
        predictor.batch(batches[0])
    finally:
        port.cif_hr.cif_hr_accumulate = launch
        port.pair_chain.pair_chain = launch_chain
    if len(captured) != 1:
        raise AssertionError(f'one batch launched K1 {len(captured)} times')
    if [tuple(a.shape) for a, _, _ in chains] != [
            (8, side, side, c) for _, _, side, c in SN2K16_CHAINS]:
        raise AssertionError(f'one batch ran K2 on '
                             f'{[tuple(a.shape) for a, _, _ in chains]}')

    # the main path: counts to 0, three distinct batches, counts read; the
    # decoder's fields and results are kept to check the decode below
    decoded = []
    batch_decoded = predictor.decoder.batch_decoded

    def keep(fields):
        out = batch_decoded(fields)
        decoded.append((fields, out))
        return out

    predictor.decoder.batch_decoded = keep
    port.cif_hr.KERNEL_LAUNCHES = port.cif_hr.CUDA_LAUNCHES = 0
    port.pair_chain.KERNEL_LAUNCHES = port.pair_chain.CUDA_LAUNCHES = 0
    port.common.HOST_SYNCS = 0
    try:
        results = [predictor.batch(images) for images in batches]
    finally:
        del predictor.decoder.batch_decoded
    launches = port.cif_hr.KERNEL_LAUNCHES
    splat_kernels = port.cif_hr.CUDA_LAUNCHES
    chain_calls = port.pair_chain.KERNEL_LAUNCHES
    chain_kernels = port.pair_chain.CUDA_LAUNCHES
    syncs = port.common.HOST_SYNCS
    n_anns = [len(preds) for res in results for preds, _ in res]
    for res in results:
        for preds, _ in res:
            for ann in preds:
                if not np.isfinite(ann.data).all():
                    raise AssertionError('non-finite annotation')
    print(f'serve: 3 batches of 8 at 641x641, annotations per image '
          f'{n_anns}; cif_hr calls {launches} ({splat_kernels} CUDA '
          f'kernels), pair_chain calls '
          f'{chain_calls} ({chain_kernels} CUDA kernels), host syncs {syncs} '
          f'({syncs / 3:.1f} per batch)', flush=True)
    if launches < 3 or splat_kernels != 2 * launches:
        raise AssertionError(f'main path called cif_hr {launches} times '
                             f'({splat_kernels} CUDA kernels, want 2 each)')
    want_kernels = 3 * KERNELS_PER_BLOCK * SN2K16_BLOCKS
    if (chain_calls != 3 * len(SN2K16_CHAINS)
            or chain_kernels != want_kernels):
        raise AssertionError(f'main path ran pair_chain {chain_calls} times '
                             f'({chain_kernels} kernels), want 9 '
                             f'({want_kernels})')
    # the decode at its budgets, held to the CPU decode on two served images
    fields, on_card = decoded[0]
    hold_card_to_cpu(port, predictor.decoder, [t[:2] for t in on_card],
                     [f[:2] for f in fields], 'served batch')

    # timings: chained calls, each waits for the last (batch() syncs)
    e2e, fwd, dec = [], [], []
    for i in range(12):
        start = time.perf_counter()
        predictor.batch(batches[i % 3])
        e2e.append((time.perf_counter() - start) * 1e3 / 8)
        fwd.append(predictor.last_nn_time * 1e3 / 8)
        dec.append(predictor.last_decoder_time * 1e3 / 8)

    def stat(xs):
        return f'{np.median(xs):.3f} [{min(xs):.3f}, {max(xs):.3f}]'

    print(f'serve per-image ms, median [min, max] of 12 chained batches of '
          f'8: end to end {stat(e2e)}, forward {stat(fwd)}, decode '
          f'{stat(dec)}; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})',
          flush=True)
    return dict(launches=launches, chain_launches=chain_calls,
                host_syncs_per_batch=syncs / 3, cif_hr_inputs=captured[0],
                chain_inputs=chains, predictor=predictor, images=batches[0])


def hold_fast_to_canonical(port, model, x, metas) -> None:
    """The served forward (``apply_fast``: the pair plan with K2) against
    the canonical graph (``apply``) on the same images: in bf16 on the whole
    batch, max|d| <= 3e-2 max|canonical| per head (both round to bf16, at
    other places; the CPU tests' bound); in f32 with TF32 off on two images,
    max|d| / (1 + |canonical|) <= 1e-4 (sums in other orders over 16
    blocks)."""
    pc = port.pair_chain
    fast, canonical = model(x), model.apply(x)
    worst = max(float((f - c).abs().max() / c.abs().max())
                for f, c in zip(fast, canonical))
    print(f'served fields, apply_fast (pair plan, K2) vs apply (canonical), '
          f'bf16, batch {x.shape[0]}: max|d|/max|canonical| {worst:.3e} '
          f'(limit 3e-2)', flush=True)
    if not worst <= 3e-2:
        raise AssertionError(f'apply_fast and apply differ in bf16: {worst}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model32 = port.models.Model(model.module, metas,
                                base_stride=model.base_stride,
                                device=model.device, bf16=False)
    before = pc.KERNEL_LAUNCHES
    fast = model32(x[:2])
    if pc.KERNEL_LAUNCHES != before + len(SN2K16_CHAINS):
        raise AssertionError('the f32 forward did not run its chains on K2')
    canonical = model32.apply(x[:2])
    worst = max(float(((f - c).abs() / (1.0 + c.abs())).max())
                for f, c in zip(fast, canonical))
    print(f'served fields, apply_fast vs apply, f32 (TF32 off), 2 images: '
          f'max|d|/(1+|canonical|) {worst:.3e} (limit 1e-4)', flush=True)
    if not worst <= 1e-4:
        raise AssertionError(f'apply_fast and apply differ in f32: {worst}')


def profile_batch(predictor, images) -> None:
    """One served batch under ``torch.profiler``: wall time, the device's
    busy share (the sum of its kernels' times; one stream, so they do not
    overlap) and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        predictor.batch(images)
        wall_ms = (time.perf_counter() - start) * 1e3

    def device_us(event):
        return getattr(event, 'self_device_time_total',
                       getattr(event, 'self_cuda_time_total', 0.0))

    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith('CUDA')]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    print(f'profile: one batch of {len(images)}, wall {wall_ms:.3f} ms, '
          f'device busy '
          f'{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%, idle '
          f'{100 - 100 * busy_ms / wall_ms:.1f}%), '
          f'{sum(e.count for e in kernels)} kernel launches', flush=True)
    for e in sorted(kernels, key=device_us, reverse=True)[:12]:
        print(f'  {device_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}',
              flush=True)


# ------------------------------------------------------------------ train
# the training crop's square edge of the JAX package's cocokp data module
# (plugins/coco/cocokp.py:30), at the data modules' batch of 8
TRAIN_EDGE = 385
TRAIN_BATCH = 8
TRAIN_STEPS = 10
# the narrow ShuffleNetV2K of the CPU tests (test_torch_port_models.NARROW)
NARROW = ((1, 2, 1), (8, 16, 32, 64, 64))


def toykp_batch(port, metas, size, n, device):
    """A fixed toykp batch (seeded, no augmentation) for ``metas``, whose
    base stride is set: NCHW images and target dicts on ``device``, and
    the host seconds it took to render and encode it."""
    dm = port.toykp.ToyKp()
    dm.head_metas, dm.augmentation, dm.image_size = metas, False, size
    start = time.perf_counter()
    ds = port.toykp.ToyKpDataset(
        n, size, dm.preprocess(np.random.default_rng(0)), seed=0)
    images, targets, _ = port.datasets.collate_images_targets_meta(
        [ds[i] for i in range(n)])
    host_s = time.perf_counter() - start
    return (images.to(device),
            [{k: v.to(device) for k, v in t.items()} for t in targets], host_s)


def trainer_for(port, model, **settings):
    opt = port.training.OptimizeFactory()
    for key, value in settings.items():
        setattr(opt, key, value)
    return port.training.Trainer(
        model, port.losses.Factory().factory(model.head_metas), opt,
        os.devnull)


def check_train_card_vs_cpu(port) -> None:
    """One train step of the narrow model (seeded weights, toykp batch of
    4 at 129 px) on the card in f32 with TF32 off and on the CPU, SGD
    nesterov with clips and weight decay.  Limits: the loss components
    within 1e-4 relative; per parameter the gradient within 1e-3 of its
    largest value (at least 1e-2 of the model's largest: BatchNorm biases
    before a 1x1 conv and another BatchNorm have gradient 0 in exact
    arithmetic, and their step is lr times rounding noise), the step's
    change alike, plus 2 ulps of the parameter; the
    BatchNorm running statistics within 1e-4 relative.  cuDNN and the CPU
    sum convolutions in other orders."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    metas = port.toykp.coco_head_metas()
    for meta in metas:
        meta.base_stride = 16
    shell = port.models.Shell(
        port.models.ShuffleNetV2K(*NARROW),
        [port.models.CompositeField4(m, NARROW[1][-1]) for m in metas])
    port.models.init_weights(shell, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in shell.state_dict().items()}
    images, targets, _ = toykp_batch(port, metas, 129, 4, 'cpu')
    runs = {}
    for device in ('cpu', 'cuda'):
        model = port.models.Model(copy.deepcopy(shell), metas, base_stride=16,
                                  device=torch.device(device), bf16=False)
        trainer = trainer_for(port, model, lr=0.05, clip_grad_norm=5.0,
                              clip_grad_value=1.0, weight_decay=1e-4)
        trainer.setup(steps_per_epoch=1)
        _, comps = trainer.train_step(images, targets)
        runs[device] = (comps.cpu(),
                        {n: p.grad.cpu() for n, p in
                         model.module.named_parameters()},
                        {k: v.cpu() for k, v in
                         model.module.state_dict().items()})
    (comps, grads, state), (comps_c, grads_c, state_c) = \
        runs['cpu'], runs['cuda']
    loss_err = float(((comps_c - comps).abs()
                      / comps.abs().clamp(min=1.0)).max())
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())
    grad_err = max(float((grads_c[n] - g).abs().max())
                   / max(float(g.abs().max()), floor)
                   for n, g in grads.items())
    stat_err = max(float((state_c[k] - v).abs().max())
                   / max(1.0, float(v.abs().max()))
                   for k, v in state.items()
                   if k.endswith(('running_mean', 'running_var')))
    deltas = {n: state[n] - before[n] for n in grads}
    step_floor = 1e-2 * max(float(d.abs().max()) for d in deltas.values())
    eps = float(torch.finfo(torch.float32).eps)
    step_ratio = 0.0
    for name, delta in deltas.items():
        delta_c = state_c[name] - before[name]
        allowed = (1e-3 * max(float(delta.abs().max()), step_floor)
                   + 2 * eps * float(before[name].abs().max()))
        step_ratio = max(step_ratio,
                         float((delta_c - delta).abs().max()) / allowed)
    print(f'train card vs CPU (narrow model, 4 images at 129 px, f32, TF32 '
          f'off): losses {[round(float(c), 5) for c in comps]}, max rel '
          f'|Δ| {loss_err:.3e} (limit 1e-4); gradients max|Δ|/scale '
          f'{grad_err:.3e} (limit 1e-3); SGD step change max|Δ| / (1e-3 of '
          f'the CPU change + 2 ulps) {step_ratio:.3e} (limit 1); BN running '
          f'stats {stat_err:.3e} (limit 1e-4)', flush=True)
    if not (loss_err <= 1e-4 and grad_err <= 1e-3 and step_ratio <= 1.0
            and stat_err <= 1e-4):
        raise AssertionError('training on the card differs from the CPU')


def train_full_width(port, card) -> None:
    """ShuffleNetV2K-16 at full width with the COCO CIF/CAF heads, bf16,
    ``TRAIN_STEPS`` SGD-nesterov steps on one fixed toykp batch of
    ``TRAIN_BATCH`` at ``TRAIN_EDGE`` px: finite losses, the last below the
    first; ms per step by CUDA events."""
    torch.backends.cudnn.benchmark = True
    metas = port.toykp.coco_head_metas()
    model = port.models.factory('shufflenetv2k16', metas, device='cuda',
                                seed=0, bf16=True)
    images, targets, host_s = toykp_batch(port, metas, TRAIN_EDGE,
                                          TRAIN_BATCH, 'cuda')
    trainer = trainer_for(port, model, lr=1e-3, momentum=0.95, nesterov=True,
                          lr_warm_up_epochs=0.3, clip_grad_value=10.0,
                          weight_decay=1e-5)
    trainer.ema_decay = 1.0 - 0.01
    trainer.setup(steps_per_epoch=TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        total, _ = trainer.train_step(images, targets)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(total))
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(times))
    print(f'train sn2k16 full width, CIF 17x5 + CAF 19x9, toykp {TRAIN_EDGE} '
          f'px, batch {TRAIN_BATCH}, bf16, SGD nesterov: losses '
          f'{[round(l, 4) for l in losses]}; ms per step median {med:.3f} '
          f'[min {min(times):.3f}, max {max(times):.3f}] (first {times[0]:.3f}'
          f'), {1e3 * TRAIN_BATCH / med:.1f} images/s; peak device memory '
          f'{peak:.2f} GiB; host render and encode of the batch '
          f'{1e3 * host_s:.1f} ms ({card})', flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f'non-finite training loss: {losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'training loss did not fall: {losses}')
    del trainer, model


def train_cli(out: str) -> None:
    """``python -m openpifpaf_tpu_torch.train`` on the card: one epoch of
    16 toykp images at 385 px, batch 8, then ``--resume`` for a second."""
    args = [sys.executable, '-m', 'openpifpaf_tpu_torch.train',
            '--dataset=toykp', '--basenet=shufflenetv2k16',
            f'--toykp-image-size={TRAIN_EDGE}', '--toykp-n-images=16',
            f'--batch-size={TRAIN_BATCH}', '--log-interval=1',
            '--output', out]
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra in (['--epochs=1'], ['--epochs=2', '--resume']):
        start = time.perf_counter()
        result = subprocess.run(args + extra, cwd=REPO, env=env,
                                capture_output=True, text=True, timeout=600)
        if result.returncode != 0:
            raise AssertionError(f'train CLI {extra} failed:\n'
                                 f'{result.stderr[-3000:]}')
        print(f'train CLI {" ".join(extra)}: exit 0 in '
              f'{time.perf_counter() - start:.1f} s', flush=True)
    with open(out + '.log') as f:
        lines = [json.loads(line) for line in f]
    epochs = {kind: [l['epoch'] for l in lines if l['type'] == kind]
              for kind in ('train-epoch', 'val-epoch')}
    n_train = sum(l['type'] == 'train' for l in lines)
    files = [out + s for s in ('.npz', '.epoch001.npz', '.epoch002.npz',
                               '.train.npz')]
    print(f'train CLI log: {n_train} train lines, epochs {epochs}; '
          f'checkpoints {[os.path.basename(f) for f in files]}', flush=True)
    if (epochs != {'train-epoch': [1, 2], 'val-epoch': [1, 2]}
            or n_train != 4 or not all(os.path.exists(f) for f in files)):
        raise AssertionError('train CLI log or checkpoints incomplete')


def serve_trained(port, checkpoint: str) -> None:
    """The trained checkpoint served by ``Predictor`` on the card: 8 toykp
    images at 385 px through the pair plan (K2) and the decode (K1)."""
    from openpifpaf_tpu_torch.predictor import Predictor

    predictor = Predictor(checkpoint=checkpoint, device='cuda')
    predictor.long_edge = TRAIN_EDGE
    ds = port.toykp.ToyKpDataset(8, TRAIN_EDGE, None, seed=1000)
    images = [ds.render(i, ds.ground_truth(i)) for i in range(8)]
    port.cif_hr.KERNEL_LAUNCHES = port.cif_hr.CUDA_LAUNCHES = 0
    port.pair_chain.KERNEL_LAUNCHES = port.pair_chain.CUDA_LAUNCHES = 0
    results = predictor.batch(images)
    k1, k2 = port.cif_hr.KERNEL_LAUNCHES, port.pair_chain.KERNEL_LAUNCHES
    k1_cuda = port.cif_hr.CUDA_LAUNCHES
    k2_cuda = port.pair_chain.CUDA_LAUNCHES
    n_anns = [len(preds) for preds, _ in results]
    print(f'trained checkpoint served (epoch {predictor.model.epoch}, 8 '
          f'images at {TRAIN_EDGE} px): cif_hr calls {k1} ({k1_cuda} CUDA '
          f'kernels), pair_chain calls {k2} ({k2_cuda} CUDA kernels), '
          f'annotations per image {n_anns}', flush=True)
    if k1 < 1 or k2 != len(SN2K16_CHAINS) or predictor.model.epoch != 2:
        raise AssertionError('the trained checkpoint was not served through '
                             'K1 and K2')


def train_phase(port, card, out: str) -> None:
    """The train phase; the CLI writes its checkpoints to ``out``.*."""
    start = time.perf_counter()
    check_train_card_vs_cpu(port)
    train_full_width(port, card)
    train_cli(out)
    serve_trained(port, out + '.npz')
    print(f'train phase: {time.perf_counter() - start:.1f} s', flush=True)


# ------------------------------------------------------------------- eval
# the eval phase's toykp configuration: sn2k16 at full width, bf16, 16
# images at the train phase's 385 px in batches of 8; multi-scale at the
# JAX package's default factors (289, 385 and 481 px, each with its hflip)
EVAL_EDGE = 385
EVAL_IMAGES = 16
EVAL_BATCH = 8
EVAL_FACTORS = (0.75, 1.0, 1.25)


def eval_cli(checkpoint: str, out: str) -> None:
    """(a) ``python -m openpifpaf_tpu_torch.eval`` on the card (no
    ``--device``) scores the train phase's checkpoint on toykp's 8 eval
    images at 385 px; the stats json has the JAX package's keys."""
    args = [sys.executable, '-m', 'openpifpaf_tpu_torch.eval',
            '--dataset=toykp', f'--checkpoint={checkpoint}',
            f'--toykp-image-size={EVAL_EDGE}', f'--batch-size={EVAL_BATCH}',
            '-o', out]
    start = time.perf_counter()
    result = subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                            env=dict(os.environ, PYTHONPATH=REPO),
                            timeout=600)
    if result.returncode != 0:
        raise AssertionError(f'eval CLI failed:\n{result.stderr[-3000:]}')
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    keys = ['n_images', 'total_time', 'nn_time', 'decoder_time',
            'images_per_second', 'stats', 'text_labels']
    print(f'eval CLI on the card: exit 0 in '
          f'{time.perf_counter() - start:.1f} s; stats '
          f'{dict(zip(stats["text_labels"], stats["stats"]))}, '
          f'{stats["n_images"]} images, {stats["images_per_second"]} '
          f'images/s', flush=True)
    if (list(stats) != keys or stats['n_images'] != 8
            or stats['text_labels'][:3] != ['AP', 'AP0.5', 'AP0.75']
            or not all(-1.0 <= v <= 1.0 for v in stats['stats'])):
        raise AssertionError(f'eval CLI stats: {stats}')


class FieldReplay:
    """A model whose forward returns fixed fields (the golden ones)."""

    def __init__(self, metas, fields, device):
        self.head_metas, self.device = metas, torch.device(device)
        self.fields = [torch.as_tensor(f, device=device) for f in fields]

    def __call__(self, x):
        if x.shape[0] != self.fields[0].shape[0]:
            raise AssertionError(f'replay of {self.fields[0].shape[0]} '
                                 f'images got a batch of {x.shape[0]}')
        return self.fields


def f32_profiles(predictor) -> None:
    """The CPU decode with the card's configuration: f32 CifHr profiles
    (``profile_bf16=False``, the kernel's), as ``hold_card_to_cpu``."""
    config_for = predictor.decoder.config_for

    def f32(image_hw):
        config = config_for(image_hw)
        return dataclasses.replace(config, cifhr=dataclasses.replace(
            config.cifhr, profile_bf16=False))
    predictor.decoder.config_for = f32


def toykp_eval_module(port, size, n_images):
    dm = port.toykp.ToyKp()
    port.toykp.ToyKp.image_size = size
    port.toykp.ToyKp.n_val_images = n_images
    port.datasets.DataModule.batch_size = EVAL_BATCH
    return dm


def eval_golden(port, device='cuda') -> None:
    """(b) The golden fields (the first four toykp eval images at 161 px of
    a trained checkpoint) through the card's decode and the port's metric,
    with and without force-complete: the card's decode held to the CPU's
    (``hold_card_to_cpu``), the ten stats equal the CPU's (same f32
    profiles) within 1e-6, the test's tolerance, and AP > 0.9.  ``device``
    is the card's; a CPU rehearsal of the phase passes ``'cpu'``."""
    from openpifpaf_tpu_torch.predictor import Predictor

    data = np.load(os.path.join(FIXTURES, 'golden_toykp_fields.npz'))
    for force_complete in (False, True):
        port.decoder.CifCaf.force_complete = force_complete
        stats = {}
        for on_card in (True, False):
            dm = toykp_eval_module(port, 161, 4)
            for i, meta in enumerate(dm.head_metas):
                meta.head_index, meta.base_stride = i, 16
            where = device if on_card else 'cpu'
            predictor = Predictor(model=FieldReplay(
                dm.head_metas, [data['cif'], data['caf']], where),
                device=where)
            before = port.cif_hr.KERNEL_LAUNCHES
            if not on_card:
                f32_profiles(predictor)
            stats[on_card] = port.eval_mod.Evaluator(dm, predictor).run()
            if on_card and port.cif_hr.KERNEL_LAUNCHES != before + 1:
                raise AssertionError('golden eval on the card did not '
                                     'launch K1')
            if on_card:
                fields = predictor.model.fields
                hold_card_to_cpu(
                    port, predictor.decoder,
                    predictor.decoder.batch_decoded(fields), fields,
                    f'golden decode (force_complete={force_complete})')
        card, cpu = stats[True]['stats'], stats[False]['stats']
        diff = max(abs(a - b) for a, b in zip(card, cpu))
        print(f'golden eval (force_complete={force_complete}), 4 images '
              f'at 161 px: card {[round(v, 4) for v in card]}, CPU '
              f'{[round(v, 4) for v in cpu]}, max|diff| {diff:.3e} (limit '
              f'1e-6)', flush=True)
        if not (diff <= 1e-6 and card[0] > 0.9):
            raise AssertionError('golden eval: card and CPU stats differ or '
                                 'AP <= 0.9')
    port.decoder.CifCaf.force_complete = False


def detecting_predictor(port, device='cuda'):
    """sn2k16 at full width with the toykp heads, seeded weights, bf16, on
    the card; its heads' confidence and scale biases shifted as in the
    serve phase, so that every cell is a detection."""
    from openpifpaf_tpu_torch.predictor import Predictor

    metas = port.toykp.coco_head_metas()
    predictor = Predictor(base_name='shufflenetv2k16', head_metas=metas,
                          device=device, bf16=True, seed=0)
    shift_head_biases(predictor.model, metas)
    return predictor


def zero_counts(port) -> None:
    port.cif_hr.KERNEL_LAUNCHES = port.cif_hr.CUDA_LAUNCHES = 0
    port.pair_chain.KERNEL_LAUNCHES = port.pair_chain.CUDA_LAUNCHES = 0
    port.common.HOST_SYNCS = 0


def eval_run(port, predictor, dm, label):
    """One ``Evaluator.run`` with the counts set to 0 just before and read
    just after; per variant (one ``dataset_loader`` call each, in variant
    order) the K1 calls, K2 chain calls and images.  Keeps every batch's
    fields and decode, and the first K1 and K2 inputs of each size."""
    per_variant, decoded, captured = [], [], {}
    loader_fn = predictor.dataset_loader
    batch_decoded = predictor.decoder.batch_decoded
    launch, launch_chain = (port.cif_hr.cif_hr_accumulate,
                            port.pair_chain.pair_chain)

    def counted(loader, **kw):
        counts = [0, 0, 0]
        per_variant.append(counts)
        gen = loader_fn(loader, **kw)
        while True:
            k1 = port.cif_hr.KERNEL_LAUNCHES
            k2 = port.pair_chain.KERNEL_LAUNCHES
            try:
                item = next(gen)
            except StopIteration:
                return
            counts[0] += port.cif_hr.KERNEL_LAUNCHES - k1
            counts[1] += port.pair_chain.KERNEL_LAUNCHES - k2
            counts[2] += 1
            yield item

    def keep(fields):
        out = batch_decoded(fields)
        decoded.append((fields, out))
        return out

    def spy(*args, **kwargs):
        captured.setdefault(('cif_hr', tuple(kwargs['out_hw'])), (
            [a.clone() for a in args], dict(kwargs)))
        return launch(*args, **kwargs)

    def spy_chain(a, b, chain):
        captured.setdefault(('pair_chain', tuple(a.shape)),
                            (a.clone(), b.clone(), chain))
        return launch_chain(a, b, chain)

    predictor.dataset_loader = counted
    predictor.decoder.batch_decoded = keep
    port.cif_hr.cif_hr_accumulate = spy
    port.pair_chain.pair_chain = spy_chain
    predictor.total_nn_time = predictor.total_decoder_time = 0.0
    predictor.total_images = 0
    torch.cuda.reset_peak_memory_stats()
    zero_counts(port)
    try:
        stats = port.eval_mod.Evaluator(dm, predictor).run()
    finally:
        port.cif_hr.cif_hr_accumulate = launch
        port.pair_chain.pair_chain = launch_chain
        del predictor.dataset_loader, predictor.decoder.batch_decoded
    counts = dict(k1=port.cif_hr.KERNEL_LAUNCHES,
                  k1_cuda=port.cif_hr.CUDA_LAUNCHES,
                  k2=port.pair_chain.KERNEL_LAUNCHES,
                  k2_cuda=port.pair_chain.CUDA_LAUNCHES,
                  syncs=port.common.HOST_SYNCS,
                  batches=len(decoded),
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f'eval {label}: {stats["n_images"]} images, '
          f'{stats["images_per_second"]} images/s, total '
          f'{stats["total_time"]} s, nn_time {stats["nn_time"]} s, '
          f'decoder_time {stats["decoder_time"]} s; AP '
          f'{stats["stats"][0]:.4f}; cif_hr calls {counts["k1"]} '
          f'({counts["k1_cuda"]} CUDA kernels), pair_chain calls '
          f'{counts["k2"]} ({counts["k2_cuda"]} CUDA kernels), host syncs '
          f'{counts["syncs"]} ({counts["syncs"] / counts["batches"]:.1f} per '
          f'batch of {EVAL_BATCH}); per variant [cif_hr, pair_chain, '
          f'images] {per_variant}; peak device memory '
          f'{counts["peak_gib"]:.2f} GiB', flush=True)
    if stats['n_images'] != EVAL_IMAGES:
        raise AssertionError(f'eval {label}: {stats["n_images"]} images')
    return dict(stats=stats, counts=counts, per_variant=per_variant,
                decoded=decoded, captured=captured)


def eval_full_width(port, card, device='cuda') -> dict:
    """(c) sn2k16 at full width with bias-shifted heads over 16 toykp
    images at 385 px, batch 8, bf16: single-scale without and with
    ``--force-complete-pose``, then ``--multi-scale`` with force-complete
    (289, 385 and 481 px, each with its hflip: six variants).  Every
    variant runs K1 once and K2 three times per batch.  (d) The card's
    decodes against the port's CPU decode of the same fields
    (``hold_at_budget``): every single-scale batch and the first image of
    each multi-scale variant.  Returns the predictor and the runs."""
    torch.backends.cudnn.benchmark = True
    predictor = detecting_predictor(port, device)
    dm = toykp_eval_module(port, EVAL_EDGE, EVAL_IMAGES)
    plan = port.fused_shufflenet.supports_pair(predictor.model.module.basenet)
    print(f'eval forward: the {"pair" if plan else "r3"} plan of '
          f'models/fused_shufflenet.py', flush=True)
    runs = {}
    for label, force_complete, multi_scale in (
            ('single-scale', False, False),
            ('single-scale force-complete', True, False),
            ('multi-scale force-complete', True, True)):
        port.decoder.CifCaf.force_complete = force_complete
        predictor.decoder._decoders.clear()
        predictor.multi_scale = multi_scale
        predictor.multi_scale_factors = EVAL_FACTORS
        runs[label] = run = eval_run(port, predictor, dm, label)
        n_variants = 2 * len(EVAL_FACTORS) if multi_scale else 1
        want = [[2, 2 * len(SN2K16_CHAINS), EVAL_IMAGES]] * n_variants
        if run['per_variant'] != want or run['counts']['k1_cuda'] != \
                2 * run['counts']['k1']:
            raise AssertionError(f'eval {label}: per variant '
                                 f'{run["per_variant"]}, want {want}')
        # the multi-scale run decodes batch 0 of each variant, then batch 1
        held = run['decoded'][:n_variants] if multi_scale else run['decoded']
        for i, (fields, on_card) in enumerate(held):
            if multi_scale:
                on_card = [t[:1] for t in on_card]
                fields = [f[:1] for f in fields]
            kind = 'variant' if multi_scale else 'batch'
            hold_at_budget(port, predictor.decoder, on_card, fields,
                           f'eval {label} {kind} {i}')
    print(f'eval decoders built per image size: '
          f'{sorted(predictor.decoder._decoders)}; pair_chain launch plans '
          f'{port.pair_chain.launch_plan.cache_info()}', flush=True)
    syncs = [runs[k]['counts']['syncs'] / runs[k]['counts']['batches']
             for k in ('single-scale', 'single-scale force-complete')]
    print(f'eval host syncs per batch of {EVAL_BATCH}: {syncs[0]:.1f} '
          f'without force-complete, {syncs[1]:.1f} with ({card})',
          flush=True)
    port.decoder.CifCaf.force_complete = False
    return predictor, runs


def eval_kernels(port, predictor, runs) -> list:
    """K1 and K2 held to their plain versions, and timed, on the inputs
    the multi-scale eval handed them at 289 and 481 px (K2's launch plans
    printed for every eval size, 385 px included)."""
    captured = runs['multi-scale force-complete']['captured']
    basenet = predictor.model.module.basenet
    variants, _ = predictor.multiscale_variants(EVAL_EDGE)
    results = []
    for size in sorted({long_edge for long_edge, _ in variants}):
        hr = (size + 1) // 2
        if size != EVAL_EDGE:
            args, kwargs = captured['cif_hr', (hr, hr)]
            results.append(('cif_hr', measure_cif_hr(
                port.cif_hr, f'eval {size} px', args, kwargs)))
        for stage, n, _, c in SN2K16_CHAINS:
            side = (size - 1) // 2 ** stage + 1
            a, b, chain = captured['pair_chain', (EVAL_BATCH, side, side, c)]
            name = f'eval {size} px stage {stage}'
            if size == EVAL_EDGE:
                print_plan(port.pair_chain, name, a)
                continue
            modules = [getattr(basenet, f'stage{stage}_{i}')
                       for i in range(1, n + 1)]
            results.append(('pair_chain', measure_pair_chain(
                port.pair_chain, name, a, b, chain, modules)))
    return results


def eval_phase(port, card, checkpoint: str) -> dict:
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        eval_cli(checkpoint, os.path.join(tmp, 'eval'))
    eval_golden(port)
    predictor, runs = eval_full_width(port, card)
    checks = eval_kernels(port, predictor, runs)
    print(f'eval phase: {time.perf_counter() - start:.1f} s', flush=True)
    return dict(runs=runs, checks=checks)


# ------------------------------------------------------ dense, wholebody
# Both phases serve batches of 8 random 641 px images through Predictor,
# heads bias-shifted (``shift_head_biases``), bf16, 3 chained batches.
# dense: toykp's CIF, CAF and caf25 heads on sn2k16, decoded with
# --dense-connections over the 19 + 18 edges.  wholebody: ToyWb's
# 133-keypoint CIF and 129-edge CAF heads on sn2k30 (the backbone of the
# reference's published WholeBody model) at WHOLEBODY_BENCH.json's budgets,
# with one and two placements per growth round.
SERVE_EDGE = 641
SERVE_BATCH = 8
SERVE_BATCHES = 3
DENSE_CONNECTIONS = 1.0
WB_BASENET = 'shufflenetv2k30'
WB_BUDGETS = dict(max_seeds=1024, max_caf_candidates=256, max_poses=96)
WB_PLACEMENTS = (1, 2)
# the painted scenes' jitter draws (``painted_scenes``)
JITTER_SEEDS = (7, 8, 9)
# sn2k30's stride-1 chains: (stage, blocks, side at 641 px, half-width C)
SN2K30_CHAINS = ((2, 7, 161, 256), (3, 15, 81, 512), (4, 5, 41, 1024))
SN2K30_BLOCKS = sum(n for _, n, _, _ in SN2K30_CHAINS)
# the train and eval CLIs of the two phases: one epoch of 16 images, then
# the data module's 8 eval images
CLI_IMAGES = 16
DENSE_CLI_EDGE = TRAIN_EDGE
WB_CLI_EDGE = 321


def stat_ms(xs) -> str:
    return f'{np.median(xs):.3f} [{min(xs):.3f}, {max(xs):.3f}]'


def random_batches(seed: int):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, (SERVE_EDGE, SERVE_EDGE, 3),
                          dtype=np.uint8) for _ in range(SERVE_BATCH)]
            for _ in range(SERVE_BATCHES)]


def shifted_predictor(port, basenet: str, metas):
    """``basenet`` at full width with ``metas``' heads on the card, seeded
    weights, bf16, the heads' biases shifted (``shift_head_biases``)."""
    from openpifpaf_tpu_torch.predictor import Predictor

    torch.backends.cudnn.benchmark = True
    predictor = Predictor(base_name=basenet, head_metas=metas, device='cuda',
                          bf16=True, seed=0)
    predictor.batch_size = SERVE_BATCH
    predictor.long_edge = SERVE_EDGE
    shift_head_biases(predictor.model, metas)
    return predictor


def served_run(port, predictor, batches, label: str,
               capture: bool = False) -> dict:
    """A phase's main path: one warm-up batch (with ``capture``, the inputs
    it hands K1 and K2 are kept), then the counts set to 0, ``batches``
    served one after the other, the counts read.  Keeps the first batch's
    fields and decode, and per image the end-to-end, forward and decode ms
    of every batch (each ``batch()`` waits for its decode)."""
    captured, chains = [], []
    launch, launch_chain = (port.cif_hr.cif_hr_accumulate,
                            port.pair_chain.pair_chain)

    def spy(*args, **kwargs):
        captured.append(([a.clone() for a in args], dict(kwargs)))
        return launch(*args, **kwargs)

    def spy_chain(a, b, chain):
        chains.append((a.clone(), b.clone(), chain))
        return launch_chain(a, b, chain)

    if capture:
        port.cif_hr.cif_hr_accumulate = spy
        port.pair_chain.pair_chain = spy_chain
    try:
        predictor.batch(batches[0])
    finally:
        port.cif_hr.cif_hr_accumulate = launch
        port.pair_chain.pair_chain = launch_chain

    decoded = []
    batch_decoded = predictor.decoder.batch_decoded

    def keep(fields):
        out = batch_decoded(fields)
        decoded.append((fields, out))
        return out

    e2e, fwd, dec, n_anns = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    zero_counts(port)
    for i, images in enumerate(batches):
        predictor.decoder.batch_decoded = keep if i == 0 else batch_decoded
        start = time.perf_counter()
        results = predictor.batch(images)
        e2e.append((time.perf_counter() - start) * 1e3 / len(images))
        fwd.append(predictor.last_nn_time * 1e3 / len(images))
        dec.append(predictor.last_decoder_time * 1e3 / len(images))
        n_anns += [len(preds) for preds, _ in results]
        if not all(np.isfinite(ann.data).all()
                   for preds, _ in results for ann in preds):
            raise AssertionError(f'{label}: non-finite annotation')
    del predictor.decoder.batch_decoded
    counts = dict(k1=port.cif_hr.KERNEL_LAUNCHES,
                  k1_cuda=port.cif_hr.CUDA_LAUNCHES,
                  k2=port.pair_chain.KERNEL_LAUNCHES,
                  k2_cuda=port.pair_chain.CUDA_LAUNCHES,
                  syncs=port.common.HOST_SYNCS,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f'{label}: {len(batches)} batches of {SERVE_BATCH} at '
          f'{SERVE_EDGE}x{SERVE_EDGE}, annotations per image {n_anns}; '
          f'cif_hr calls {counts["k1"]} ({counts["k1_cuda"]} CUDA kernels), '
          f'pair_chain calls {counts["k2"]} ({counts["k2_cuda"]} CUDA '
          f'kernels), host syncs {counts["syncs"]} '
          f'({counts["syncs"] / len(batches):.1f} per batch); per-image ms, '
          f'median [min, max] of the {len(batches)} chained batches: end to '
          f'end {stat_ms(e2e)}, forward {stat_ms(fwd)}, decode '
          f'{stat_ms(dec)}; peak device memory {counts["peak_gib"]:.2f} GiB',
          flush=True)
    return dict(counts=counts, captured=captured, chains=chains,
                decoded=decoded[0], e2e=e2e)


def check_field_shapes(fields, label: str, heads) -> None:
    """Finite fields of (batch, fields, components, side, side) per head."""
    side = (SERVE_EDGE - 1) // 16 + 1
    shapes = [tuple(f.shape) for f in fields]
    if shapes != [(SERVE_BATCH, n, c, side, side) for n, c in heads]:
        raise AssertionError(f'{label} field shapes {shapes}')
    if not all(bool(torch.isfinite(f).all()) for f in fields):
        raise AssertionError(f'{label}: non-finite fields')


def check_launches(run, label: str, chains, n_blocks) -> None:
    """Every served batch ran K1 once (2 CUDA kernels) and K2 once per
    stride-1 chain (2 CUDA kernels per block)."""
    c, n = run['counts'], SERVE_BATCHES
    want = dict(k1=n, k1_cuda=2 * n, k2=n * len(chains),
                k2_cuda=n * KERNELS_PER_BLOCK * n_blocks)
    got = {k: c[k] for k in want}
    if got != want:
        raise AssertionError(f'{label}: kernel counts {got}, want {want}')


def inv_sigmoid(p):
    p = np.clip(p, 1e-6, 1 - 1e-6)
    return np.log(p / (1 - p))


def inv_softplus(s):
    return np.log(np.expm1(np.maximum(s, 1e-6)))


def paint_cif(field, kp, scales, stride):
    """Raw CIF (K, 5, H, W): a 4x4 neighbourhood per visible keypoint (the
    painter of ``tests/test_decoder.py``)."""
    _, _, h, w = field.shape
    for f, (x, y, v) in enumerate(kp):
        if v <= 0:
            continue
        cx, cy = x / stride, y / stride
        i0, j0 = int(np.floor(cx)) - 1, int(np.floor(cy)) - 1
        for j in range(max(j0, 0), min(j0 + 4, h)):
            for i in range(max(i0, 0), min(i0 + 4, w)):
                conf = 1.0 if max(abs(cx - i), abs(cy - j)) < 1.5 else 0.4
                field[f, :, j, i] = (inv_sigmoid(conf), cx - i, cy - j,
                                     inv_softplus(0.5),
                                     inv_softplus(scales[f] / stride))


def paint_caf(field, kp, scales, skeleton, stride):
    """Raw CAF (E, 9, H, W): the cells along each edge's segment."""
    _, _, h, w = field.shape
    for e, (a1, a2) in enumerate(skeleton):
        (x1, y1, v1), (x2, y2, v2) = kp[a1 - 1], kp[a2 - 1]
        if v1 <= 0 or v2 <= 0:
            continue
        c1 = np.array([x1, y1]) / stride
        c2 = np.array([x2, y2]) / stride
        for t in np.linspace(0.0, 1.0, max(
                2, int(np.ceil(np.linalg.norm(c2 - c1))) + 1)):
            i, j = (int(round(c)) for c in c1 + t * (c2 - c1))
            if 0 <= i < w and 0 <= j < h:
                field[e, :, j, i] = (
                    inv_sigmoid(1.0), c1[0] - i, c1[1] - j, c2[0] - i,
                    c2[1] - j, inv_softplus(0.5), inv_softplus(0.5),
                    inv_softplus(scales[a1 - 1] / stride),
                    inv_softplus(scales[a2 - 1] / stride))


def painted_person(pose, sigmas, dx=0.0, dy=0.0, scale=30.0):
    """An upright ``pose`` (K, 3) in px, as ``tests/test_decoder.py``'s
    ``synthetic_pose`` places it, and its joint scales."""
    pose = np.asarray(pose, np.float32)
    kp = np.zeros((len(pose), 3), np.float32)
    kp[:, 0] = pose[:, 0] * scale + 160.0 + dx
    kp[:, 1] = (10.0 - pose[:, 1]) * scale + 10.0 + dy
    kp[:, 2] = 2.0
    return kp, np.maximum(4.0, np.asarray(sigmas, np.float32) * scale * 4)


def painted_scenes(scenes, n_keypoints, skeletons, side, stride=16,
                   seed=JITTER_SEEDS[0], jitter=0.05):
    """Raw fields of ``scenes`` (lists of ``painted_person``) on a ``side``
    x ``side`` cell grid: the CIF batch, then a CAF batch per skeleton.

    Every painted value is jittered (N(0, ``jitter``) on confidence logits
    and the other components, from the numpy ``seed``), as a trained
    head's fields vary.  Exactly painted fields tie: the cells of an edge
    give candidates of one score, and which of them a decode takes is
    decided by the last ulp of the CifHr sums, so one part in 1e7 on the
    CifHr map moves joint scores by 1e-2 and more in the port's own CPU
    decode (``tests/test_torch_port_dense.py`` shows it).  The card's K1
    and the CPU's plain splat sum in other orders."""
    rng = np.random.default_rng(seed)
    out = []
    for skeleton in (None,) + tuple(skeletons):
        n = n_keypoints if skeleton is None else len(skeleton)
        fields = np.zeros((len(scenes), n, 5 if skeleton is None else 9,
                           side, side), np.float32)
        fields[:, :, 0] = -10.0
        for field, people in zip(fields, scenes):
            for kp, scales in people:
                if skeleton is None:
                    paint_cif(field, kp, scales, stride)
                else:
                    paint_caf(field, kp, scales, skeleton, stride)
        painted = np.broadcast_to(fields[:, :, :1] > -5.0, fields.shape)
        fields += np.where(painted, rng.normal(0.0, jitter, fields.shape),
                           0.0).astype(np.float32)
        out.append(fields)
    return out


def painted_dense_scenes(constants, **jitter):
    """A person, two people and a 3x3 crowd on a 21 x 21 cell grid (336
    px), painted on the sparse and the dense skeleton, as
    ``tests/test_torch_port_dense.py`` paints them: (cif, caf, dense);
    ``jitter``: ``painted_scenes``' seed and jitter."""
    def person(dx=0.0, dy=0.0, scale=30.0):
        return painted_person(constants.COCO_UPRIGHT_POSE,
                              constants.COCO_PERSON_SIGMAS, dx, dy, scale)

    scenes = [[person()], [person(-70.0), person(75.0, 10.0)],
              [person(dx, dy, 8.0) for dy in (0.0, 110.0, 220.0)
               for dx in (-110.0, 0.0, 110.0)]]
    return painted_scenes(scenes, 17, (
        constants.COCO_PERSON_SKELETON,
        constants.DENSER_COCO_PERSON_CONNECTIONS), side=21, **jitter)


def painted_wholebody_scenes(wb, **jitter):
    """One and three WholeBody people (the upright pose of
    ``plugins/wholebody/constants.py``, 40 px per pose unit) on the served
    grid: (cif, caf); ``jitter``: ``painted_scenes``' seed and jitter."""
    def person(dx, scale=40.0):
        return painted_person(wb.UPRIGHT_POSE, wb.SIGMAS, dx, 100.0, scale)

    side = (SERVE_EDGE - 1) // 16 + 1
    scenes = [[person(160.0)], [person(-30.0), person(160.0), person(350.0)]]
    return painted_scenes(scenes, len(wb.KEYPOINTS), (wb.SKELETON,), side,
                          **jitter)


def cli_train_eval(label: str, train_args, eval_args, out: str, heads,
                   extra_labels=()):
    """``python -m openpifpaf_tpu_torch.train`` on the card for one epoch
    of ``CLI_IMAGES`` images, then ``python -m openpifpaf_tpu_torch.eval``
    on its checkpoint: exit 0, the checkpoint's heads, the stats json's
    keys and the data module's 8 eval images; the COCO metric's ten
    stats, then ``extra_labels`` (a second metric's, counts among them)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    start = time.perf_counter()
    result = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.train', '--epochs=1',
         f'--batch-size={TRAIN_BATCH}', '--output', out] + train_args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if result.returncode != 0:
        raise AssertionError(f'{label} train CLI failed:\n'
                             f'{result.stderr[-3000:]}')
    train_s = time.perf_counter() - start
    from openpifpaf_tpu_torch.models import checkpoint

    names = [m.name for m in checkpoint.load(out + '.npz')[0]['head_metas']]
    start = time.perf_counter()
    result = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.eval',
         f'--checkpoint={out}.npz', f'--batch-size={EVAL_BATCH}', '-o',
         out + '.eval'] + eval_args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if result.returncode != 0:
        raise AssertionError(f'{label} eval CLI failed:\n'
                             f'{result.stderr[-3000:]}')
    with open(out + '.eval.stats.json') as f:
        stats = json.load(f)
    print(f'{label} CLIs on the card: train exit 0 in {train_s:.1f} s, '
          f'checkpoint heads {names}; eval exit 0 in '
          f'{time.perf_counter() - start:.1f} s, stats '
          f'{dict(zip(stats["text_labels"], stats["stats"]))}, '
          f'{stats["n_images"]} images, {stats["images_per_second"]} '
          f'images/s', flush=True)
    keys = ['n_images', 'total_time', 'nn_time', 'decoder_time',
            'images_per_second', 'stats', 'text_labels']
    if (names != heads or list(stats) != keys or stats['n_images'] != 8
            or stats['text_labels'][:3] != ['AP', 'AP0.5', 'AP0.75']
            or stats['text_labels'][10:] != list(extra_labels)
            or not all(-1.0 <= v <= 1.0 for v in stats['stats'][:10])
            or not all(np.isfinite(stats['stats']))):
        raise AssertionError(f'{label} CLIs: heads {names}, stats {stats}')


def dense_phase(port, card: str, tmp: str) -> dict:
    """sn2k16 with toykp's three heads, decoded with ``--dense-connections``
    over the 37 concatenated edges: the served batches (K1 and K2 counted),
    the first batch's decode held to the CPU decode (``hold_at_budget``),
    the painted dense scenes at each of ``JITTER_SEEDS`` held with
    ``hold_card_to_cpu``; then the train
    CLI on ``toykp --toykp-with-dense`` at 385 px and the eval CLI with
    ``--dense-connections`` on its checkpoint."""
    start = time.perf_counter()
    port.decoder.CifCaf.dense_connections = DENSE_CONNECTIONS
    try:
        metas = port.toykp.coco_head_metas() + [port.toykp.dense_head_meta()]
        predictor = shifted_predictor(port, 'shufflenetv2k16', metas)
        decoder = predictor.decoder
        if not decoder.uses_dense or decoder.caf_meta.n_fields != 37:
            raise AssertionError('the dense decoder does not decode 37 edges')
        run = served_run(port, predictor, random_batches(5), 'dense served')
        check_launches(run, 'dense served', SN2K16_CHAINS, SN2K16_BLOCKS)
        fields, on_card = run['decoded']
        check_field_shapes(fields, 'dense', ((17, 5), (19, 9), (18, 9)))
        hold_at_budget(port, decoder, on_card,
                       [fields[0], decoder.caf_fields(fields)],
                       'dense served batch')

        for seed in JITTER_SEEDS:
            painted = [torch.as_tensor(a, device='cuda') for a in
                       painted_dense_scenes(port.constants, seed=seed)]
            on_card = decoder.batch_decoded(painted)
            hold_card_to_cpu(port, decoder, on_card,
                             [painted[0], decoder.caf_fields(painted)],
                             f'painted dense scenes, jitter seed {seed}')
            if on_card.valid.sum(dim=1).tolist() != [1, 2, 9]:
                raise AssertionError('painted dense scenes: pose counts '
                                     f'{on_card.valid.sum(dim=1).tolist()}')

        edge = f'--toykp-image-size={DENSE_CLI_EDGE}'
        cli_train_eval('dense', ['--dataset=toykp', '--toykp-with-dense',
                                 '--basenet=shufflenetv2k16', edge,
                                 f'--toykp-n-images={CLI_IMAGES}'],
                       ['--dataset=toykp', '--toykp-with-dense', edge,
                        f'--dense-connections={DENSE_CONNECTIONS}'],
                       os.path.join(tmp, 'dense'), ['cif', 'caf', 'caf25'])
    finally:
        port.decoder.CifCaf.dense_connections = 0.0
    print(f'dense phase: {time.perf_counter() - start:.1f} s ({card})',
          flush=True)
    return run['counts']


FRONT_TOL = 1e-6   # relative: |d| <= 1e-6 * max(1, |value|), ~8 f32 ulps
FRONT_STAGES = (('cif_hr', 'accumulate'), ('seeds', 'select'),
                ('caf_scored', 'score'))


def front_end_stages(pipeline, fields, kw):
    """``pipeline.decode_front_end`` of ``fields`` with its stages recorded
    in call order: K1's ``cif_hr.accumulate``, ``seeds.select`` and
    ``caf_scored.score``, each as (name, args, kwargs, output)."""
    stages, saved = [], []

    def recorded(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            stages.append((name, args, kwargs, out))
            return out
        return call

    try:
        for module, name in FRONT_STAGES:
            fn = getattr(getattr(pipeline, module), name)
            saved.append((getattr(pipeline, module), name, fn))
            setattr(getattr(pipeline, module), name,
                    recorded(f'{module}.{name}', fn))
        front = pipeline.decode_front_end(*fields, **kw)
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    return front, stages


def tensors_of(obj):
    """The tensors of ``obj`` (nested tuples, lists and dicts), in order."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tensors_of(o)]
    return []


def to_cpu_obj(obj):
    """``obj`` (nested tuples, named tuples, lists and dicts) on the CPU."""
    if torch.is_tensor(obj):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: to_cpu_obj(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*[to_cpu_obj(o) for o in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_cpu_obj(o) for o in obj)
    return obj


def worst_difference(a, b, label: str) -> float:
    """Tensors ``a`` and ``b`` (same shapes; integers and flags equal):
    max |a - b| / max(1, |b|) over the float ones."""
    worst = 0.0
    for x, y in zip(tensors_of(a), tensors_of(b), strict=True):
        x = x.cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f'{label}: {x.shape} {x.dtype} against '
                                 f'{y.shape} {y.dtype}')
        if not x.is_floating_point():
            if not torch.equal(x, y):
                raise AssertionError(f'{label}: {int((x != y).sum())} '
                                     f'integer or flag values differ')
            continue
        if x.numel():
            worst = max(worst, float(((x.double() - y.double()).abs()
                                      / y.double().abs().clamp(min=1.0))
                                     .max()))
    return worst


def hold_front_ends(pipeline, fields_cuda, kw, label: str):
    """The card's decode front end against the CPU's, stage by stage, and
    returns the card's on the CPU.

    A stage's selection (3x3 local maxima, a stable sort to the seed and
    candidate budgets) turns one ulp between near-equal values into
    another choice, and ``sigmoid``, ``softplus`` and ``exp`` round apart
    on the two devices.  So each stage is held in two ways: its inputs on
    the card against its inputs on the CPU, every element (the CifHr map
    within K1's 2e-5, the rest within ``FRONT_TOL``); and its output on the
    card against the CPU's stage run on the card's inputs, every element in
    order (within ``FRONT_TOL``; integers and flags equal): seeds (v, f, x,
    y, s, valid) and candidates (score, x/y source and target, scale,
    valid, overflow).  K1's output, the CifHr map and its overflow count,
    is held against the CPU's plain splat within K1's 2e-5."""
    card, card_stages = front_end_stages(pipeline, fields_cuda, kw)
    _, cpu_stages = front_end_stages(
        pipeline, [f.cpu() for f in fields_cuda], kw)
    if [s[0] for s in card_stages] != [s[0] for s in cpu_stages]:
        raise AssertionError(f'{label}: the front ends ran other stages')
    functions = {f'{m}.{n}': getattr(getattr(pipeline, m), n)
                 for m, n in FRONT_STAGES}
    hr = card_stages[0][3][0]   # K1's map, an input of the later stages
    report = []
    for (name, args, kwargs, out), (_, cpu_args, cpu_kwargs, cpu_out) in zip(
            card_stages, cpu_stages):
        inputs = [(worst_difference(a, b, f'{label} {name} input'),
                   2e-5 if a is hr else FRONT_TOL)
                  for a, b in zip(tensors_of((args, kwargs)),
                                  tensors_of((cpu_args, cpu_kwargs)),
                                  strict=True)]
        if name == 'cif_hr.accumulate':
            # K1's map against the CPU's plain splat, within K1's limit
            output = (worst_difference(out, cpu_out, f'{label} {name}'), 2e-5)
        else:
            output = (worst_difference(out, functions[name](
                *to_cpu_obj(args), **to_cpu_obj(kwargs)), f'{label} {name}'),
                FRONT_TOL)
        report.append((name, max((d for d, _ in inputs), default=0.0),
                       output[0]))
        if any(d > limit for d, limit in inputs + [output]):
            raise AssertionError(f'{label} {name}: card and CPU differ, '
                                 f'inputs {inputs}, output {output} '
                                 f'(max |d|, limit)')
    print(f'{label}, front end card vs CPU, stage by stage (max |d| / '
          f'max(1, |value|); inputs card vs CPU, outputs card vs the CPU '
          f'stage on the card\'s inputs, every element in order): ' +
          ', '.join(f'{n} inputs {i:.3e}, output {o:.3e}'
                    for n, i, o in report), flush=True)
    return to_cpu_obj(card)


def hold_wholebody_batch(port, decoder, on_card, fields_cuda, label):
    """The WholeBody served batch against the CPU, in two parts.

    At these budgets the seed ranking is a near-tie: K1 sums the CifHr map
    in another order than the CPU's plain splat (up to 1.8e-7 apart), the
    random heads' near-uniform fields put hundreds of seed values within
    that of each other, and hundreds of the 1024 seeds of an image rank in
    another order on the card than on the CPU.
    The two devices then consume seeds in other orders, grow the same poses
    and leave a seed or two more or fewer unclaimed after the last wave.
    So (1) the front end is held stage by stage (``hold_front_ends``);
    (2) the back end (growth, joint scales, NMS) runs on the CPU from the
    card's front end and is held with ``hold_at_budget``."""
    pipeline = port.ops.pipeline
    h, w = fields_cuda[0].shape[-2:]
    stride = decoder.cif_meta.stride
    config = decoder.config_for(((h - 1) * stride + 1, (w - 1) * stride + 1))
    kw = dict(cif_meta=decoder.cif_meta, caf_meta=decoder.caf_meta,
              config=config)
    with torch.no_grad():
        card = hold_front_ends(pipeline, fields_cuda, kw, label)
        back = pipeline.decode_back_end(card, **kw)
    hold_at_budget(port, decoder, on_card, fields_cuda,
                   f'{label} (the CPU back end on the card\'s front end)',
                   cpu_np=[t.numpy() for t in back])


def with_placements(decoder, m: int) -> None:
    """The decoder's configuration with ``m`` placements per growth round;
    the CPU decode that ``hold_at_budget`` runs takes the same."""
    config_for = type(decoder).config_for

    def placed(image_hw):
        config = config_for(decoder, image_hw)
        return dataclasses.replace(config, growth=dataclasses.replace(
            config.growth, placements_per_round=m))
    decoder.config_for = placed
    decoder._decoders.clear()  # pylint: disable=protected-access


def sum_chains(chains) -> dict:
    """K2 over a forward's chains: times and bounds summed, bound by
    operations when most of the bound is."""
    total = {key: sum(c[key] for c in chains)
             for key in ('ms', 'plain_ms', 'canonical_ms', 'bound_ms')}
    by_ops = sum(c['bound_ms'] for c in chains
                 if c['bound_by'] == 'operations')
    total['bound_by'] = ('operations' if 2 * by_ops >= total['bound_ms']
                         else 'bytes')
    total['max_abs_err'] = max(c['max_abs_err'] for c in chains)
    return total


def wholebody_phase(port, card: str, tmp: str) -> dict:
    """sn2k30 with ToyWb's 133-keypoint heads at WHOLEBODY_BENCH.json's
    budgets, with 1 and 2 placements per growth round: the served batches
    (K1 and K2 counted, host syncs per batch), each run's first batch held
    to the CPU at the same m (``hold_wholebody_batch``) and painted scenes
    at each of ``JITTER_SEEDS`` with ``hold_card_to_cpu``; K1 at F = 133 and
    K2 at sn2k30's three chains held to their plain versions and timed on
    the inputs the main path handed them; then the train CLI on ``toywb``
    (sn2k16, 321 px) and the eval CLI on its checkpoint."""
    start = time.perf_counter()
    cls = port.decoder.CifCaf
    old = {key: getattr(cls, key) for key in WB_BUDGETS}
    try:
        for key, value in WB_BUDGETS.items():
            setattr(cls, key, value)
        metas = port.toykp.ToyWb().head_metas
        predictor = shifted_predictor(port, WB_BASENET, metas)
        batches = random_batches(6)
        runs = {}
        for m in WB_PLACEMENTS:
            with_placements(predictor.decoder, m)
            label = f'wholebody m={m}'
            runs[m] = run = served_run(port, predictor, batches,
                                       f'{label} served',
                                       capture=m == WB_PLACEMENTS[0])
            check_launches(run, label, SN2K30_CHAINS, SN2K30_BLOCKS)
            fields, on_card = run['decoded']
            check_field_shapes(fields, label, ((133, 5), (129, 9)))
            held = time.perf_counter()
            hold_wholebody_batch(port, predictor.decoder, on_card, fields,
                                 f'{label} served batch')
            print(f'{label}: the CPU decode of the held batch took '
                  f'{time.perf_counter() - held:.1f} s', flush=True)
            for seed in JITTER_SEEDS:
                painted = [torch.as_tensor(a, device='cuda') for a in
                           painted_wholebody_scenes(port.wb, seed=seed)]
                on_card = predictor.decoder.batch_decoded(painted)
                hold_card_to_cpu(port, predictor.decoder, on_card, painted,
                                 f'{label} painted scenes, jitter seed {seed}')
                if on_card.valid.sum(dim=1).tolist() != [1, 3]:
                    raise AssertionError(
                        f'{label} painted scenes: pose counts '
                        f'{on_card.valid.sum(dim=1).tolist()}')
        print(f'wholebody host syncs per batch of {SERVE_BATCH}: ' + ', '.join(
            f'{runs[m]["counts"]["syncs"] / SERVE_BATCHES:.1f} at m={m}'
            for m in WB_PLACEMENTS) + f' ({card})', flush=True)

        first = runs[WB_PLACEMENTS[0]]
        args, kwargs = first['captured'][0]
        k1 = measure_cif_hr(port.cif_hr, 'wholebody F=133', args, kwargs)
        k1['shape'] = (f'(B, F, N) {tuple(args[0].shape)} -> '
                       f'{tuple(kwargs["out_hw"])}')
        shapes = [tuple(a.shape) for a, _, _ in first['chains']]
        if shapes != [(SERVE_BATCH, side, side, c)
                      for _, _, side, c in SN2K30_CHAINS]:
            raise AssertionError(f'sn2k30 ran K2 on {shapes}')
        basenet = predictor.model.module.basenet
        k2 = sum_chains([measure_pair_chain(
            port.pair_chain, f'sn2k30 stage {stage}', a, b, chain,
            [getattr(basenet, f'stage{stage}_{i}') for i in range(1, n + 1)])
            for (a, b, chain), (stage, n, _, _) in zip(first['chains'],
                                                       SN2K30_CHAINS)])
        k2['shape'] = ', '.join(f'{tuple(a.shape)} {str(a.dtype)[6:]}'
                                for a, _, _ in first['chains'])
        print(f'pair_chain per sn2k30 batch (3 chains): kernel '
              f'{k2["ms"]:.4f} ms, plain {k2["plain_ms"]:.4f} ms, canonical '
              f'modules {k2["canonical_ms"]:.4f} ms, bound '
              f'{k2["bound_ms"]:.4f} ms ({k2["bound_by"]})', flush=True)
        counts = {m: run['counts'] for m, run in runs.items()}
        del predictor, first, runs
    finally:
        for key, value in old.items():
            setattr(cls, key, value)

    edge = f'--toywb-image-size={WB_CLI_EDGE}'
    cli_train_eval('toywb', ['--dataset=toywb', '--basenet=shufflenetv2k16',
                             edge, f'--toywb-n-images={CLI_IMAGES}'],
                   ['--dataset=toywb', edge], os.path.join(tmp, 'toywb'),
                   ['cif', 'caf'])
    print(f'wholebody phase: {time.perf_counter() - start:.1f} s ({card})',
          flush=True)
    return dict(counts=counts, k1=k1, k2=k2)


# --------------------------------------------------------------- tracking
# the tracking phase: tshufflenetv2k16 (sn2k16 over frame pairs) with
# toykpst's CIF (17x5), CAF (19x9) and TCAF (17x9) heads streams
# TRACK_FRAMES frames at 641 px; TRACK_HELD of them are held to the CPU
TRACK_FRAMES = 16
TRACK_HELD = (0, 1, 8, 15)
TRACK_PAN_PX = 8
TRACK_CLI_EDGE = 321
TRACK_CLI_FRAMES = 8
POSETRACK_LABELS = ['MOTA', 'MOTP', 'misses', 'false_positives',
                    'id_switches', 'n_gt']
ASSOC_TOL = 1e-6   # relative: |d| <= 1e-6 * max(1, |score|)


def paint_tcaf(field, kp1, kp2, scales, stride):
    """Raw TCAF (K, 9, H, W): the cells between each keypoint's position in
    the previous (``kp1``) and the current frame (``kp2``), as
    ``tests/test_tracking.py`` paints them."""
    _, _, h, w = field.shape
    for f in range(field.shape[0]):
        if kp1[f, 2] <= 0 or kp2[f, 2] <= 0:
            continue
        c1, c2 = kp1[f, :2] / stride, kp2[f, :2] / stride
        for t in np.linspace(0.0, 1.0, max(
                2, int(np.ceil(np.linalg.norm(c2 - c1))) + 1)):
            i, j = (int(round(c)) for c in c1 + t * (c2 - c1))
            if 0 <= i < w and 0 <= j < h:
                field[f, :, j, i] = (
                    inv_sigmoid(1.0), c1[0] - i, c1[1] - j, c2[0] - i,
                    c2[1] - j, inv_softplus(0.5), inv_softplus(0.5),
                    inv_softplus(scales[f] / stride),
                    inv_softplus(scales[f] / stride))


def association_inputs(constants, max_poses, seed=JITTER_SEEDS[0],
                       jitter=0.05):
    """One frame pair's association at the budgets, on the served grid: a
    4 x 3 crowd of people (8 px per pose unit) panned by (12, -6) px, its
    TCAF painted and jittered (N(0, ``jitter``) on every painted value, as
    ``painted_scenes`` jitters: exact ties split across devices), and
    ``max_poses`` valid poses per frame: the crowd, in other slots in the
    two frames, and random poses that no TCAF cell supports."""
    rng = np.random.default_rng(seed)
    side = (SERVE_EDGE - 1) // 16 + 1
    field = np.zeros((17, 9, side, side), np.float32)
    field[:, 0] = -10.0
    crowd = []
    for dy in (0.0, 200.0, 400.0):
        for dx in (-200.0, -70.0, 60.0, 190.0):
            kp, scales = painted_person(constants.COCO_UPRIGHT_POSE,
                                        constants.COCO_PERSON_SIGMAS,
                                        dx + 80.0, dy + 20.0, 8.0)
            moved = kp + np.array([12.0, -6.0, 0.0], np.float32)
            paint_tcaf(field, kp, moved, scales, 16)
            crowd.append((kp, moved))
    painted = np.broadcast_to(field[:, :1] > -5.0, field.shape)
    field += np.where(painted, rng.normal(0.0, jitter, field.shape),
                      0.0).astype(np.float32)

    def poses(order, frame):
        xyv = np.zeros((max_poses, 17, 3), np.float32)
        xyv[:, :, :2] = rng.uniform(0.0, SERVE_EDGE, (max_poses, 17, 2))
        xyv[:, :, 2] = rng.uniform(0.1, 1.0, (max_poses, 17))
        for slot, person in zip(order, crowd):
            xyv[slot] = person[frame]
        return xyv

    prev = poses(rng.permutation(max_poses)[:len(crowd)], 0)
    curr = poses(rng.permutation(max_poses)[:len(crowd)], 1)
    valid = np.ones(max_poses, np.float32)
    return field, prev, valid, curr, valid.copy(), len(crowd)


def tcaf_meta(port):
    meta = port.posetrack.ToyKpSt().head_metas[2]
    meta.base_stride = 16
    return meta


def hold_association(port, card: str) -> dict:
    """(a) the association at the budgets (96 x 96 poses, 128 candidates
    per keypoint type) on the card, run with CUDA's sync debug mode set to
    raise, against the port's CPU association of the same inputs:
    candidates' validity and the match identical, scores within
    ``ASSOC_TOL`` of max(1, |score|); then its time per frame pair."""
    tracking = port.ops.tracking
    meta = tcaf_meta(port)
    config = tracking.TrackingConfig()
    field, prev, prev_valid, curr, curr_valid, n_crowd = association_inputs(
        port.constants, config.max_tracks)
    inputs = [torch.from_numpy(a) for a in (field, prev, prev_valid, curr,
                                            curr_valid)]

    def run(f, *poses):
        cands = tracking.tcaf_candidates(
            port.models.split_fields(f, meta), stride=16, config=config)
        scores = tracking.association_scores(cands, *poses, config)
        return cands, scores, tracking.greedy_match(scores,
                                                    config.min_match_score)

    on_card = [t.cuda() for t in inputs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        cands, scores, match = run(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    cpu_cands, cpu_scores, cpu_match = run(*inputs)
    d = (scores.cpu() - cpu_scores).abs() / cpu_scores.abs().clamp(min=1.0)
    same_valid = torch.equal(cands.valid.cpu(), cpu_cands.valid)
    same_match = torch.equal(match.cpu(), cpu_match)
    linked = int((match >= 0).sum())
    print(f'association at the budgets ({config.max_tracks} x '
          f'{config.max_tracks} poses, {config.max_candidates} candidates '
          f'per keypoint type, {n_crowd} painted people): card under sync '
          f'debug mode "error" (no host sync); valid candidates '
          f'{int(cands.valid.sum())} card, {int(cpu_cands.valid.sum())} CPU, '
          f'equal: {same_valid}; scores max|d|/max(1,|s|) {float(d.max()):.3e}'
          f' (limit {ASSOC_TOL:g}); matches {linked} card, '
          f'{int((cpu_match >= 0).sum())} CPU, identical: {same_match}',
          flush=True)
    if not (same_valid and same_match and float(d.max()) <= ASSOC_TOL
            and linked >= n_crowd):
        raise AssertionError('the card association differs from the CPU')

    ms = cuda_ms(lambda: tracking.associate_on_device(
        *on_card, tcaf_meta=meta, config=config))
    print(f'association on the card: median {ms[0]:.4f} ms [min '
          f'{ms[1]:.4f}, max {ms[2]:.4f}] per frame pair ({card})',
          flush=True)
    return dict(ms=ms[0], max_rel_err=float(d.max()))


def tracking_model(port):
    """tshufflenetv2k16 at full width with toykpst's heads on the card,
    seeded weights, bf16, the heads' biases shifted."""
    metas = port.posetrack.ToyKpSt().head_metas
    model = port.models.factory('tshufflenetv2k16', metas, device='cuda',
                                bf16=True, seed=0)
    shift_head_biases(model, metas)
    return model


def track_frames(seed: int, n: int):
    """``n`` frames of a pan across one seeded random image."""
    base = np.random.default_rng(seed).integers(
        0, 256, (SERVE_EDGE, SERVE_EDGE + TRACK_PAN_PX * n, 3),
        dtype=np.uint8)
    return [np.ascontiguousarray(
        base[:, TRACK_PAN_PX * i:TRACK_PAN_PX * i + SERVE_EDGE])
        for i in range(n)]


def tracker_state(decoder) -> dict:
    return copy.deepcopy({k: getattr(decoder, k) for k in (
        'next_track_id', '_sequence', 'frame_number', 'prev_xyv',
        'prev_valid', 'prev_ids', 'prev_ages')})


def hold_tracking_frame(port, card_decoder, state, fields, card_anns,
                        label) -> float:
    """One streamed frame held to the port's CPU ``TrackingPose`` from the
    same track state, on the card's fields, with the decode configuration
    the card ran (f32 CifHr profiles): ``hold_at_budget``'s rule with the
    ids — the same number of poses, and every card pose but at most one
    with a CPU pose of the same id within 1e-3 in every xyv value."""
    cpu = port.decoder.TrackingPose(card_decoder.cif_meta,
                                    card_decoder.caf_meta,
                                    card_decoder.tcaf_meta, device='cpu')
    cpu.cifcaf.config_for = card_decoder.cifcaf.config_for
    for key, value in copy.deepcopy(state).items():
        setattr(cpu, key, value)
    start = time.perf_counter()
    cpu_anns = cpu([f.cpu() for f in fields])
    cpu_by_id = {a.id_: a.data for a in cpu_anns}
    worst, missed = 0.0, 0
    for ann in card_anns:
        other = cpu_by_id.get(ann.id_)
        d = np.inf if other is None else float(np.abs(ann.data - other).max())
        if d <= 1e-3:
            worst = max(worst, d)
        else:
            missed += 1
    print(f'{label}: card vs CPU TrackingPose from the same track state: '
          f'poses {len(card_anns)} card, {len(cpu_anns)} CPU; ids '
          f'{sorted(a.id_ for a in card_anns)[:6]}...; max|dxyv| of the '
          f'poses matched by id {worst:.3e}; card poses without a CPU pose of '
          f'the same id within 1e-3: {missed} (limit 1); CPU '
          f'{time.perf_counter() - start:.1f} s', flush=True)
    if len(card_anns) != len(cpu_anns) or missed > 1:
        raise AssertionError(f'{label}: card and CPU tracking differ')
    return worst


def tracking_stream(port, card: str) -> dict:
    """(b) ``TRACK_FRAMES`` frames streamed through ``VideoProcessor``: the
    backbone (K2) on each new frame, the heads on the cached pair, the
    decode (K1) and the association on the card; the association's device
    part under CUDA's sync debug mode set to raise.  Per frame: the stages'
    ms, host syncs (the association's apart), K1 and K2 calls; the
    ``TRACK_HELD`` frames held to the CPU (``hold_tracking_frame``).  The
    peak memory is the stream's own, its model included: the most
    allocated while streaming, less what the earlier phases still hold
    when it starts."""
    tracking = port.ops.tracking
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    model = tracking_model(port)
    processor = port.video.VideoProcessor(model, long_edge=SERVE_EDGE)
    decoder = processor.decoder
    frames = track_frames(3, TRACK_FRAMES)

    captured, chains = [], []
    launch, launch_chain = (port.cif_hr.cif_hr_accumulate,
                            port.pair_chain.pair_chain)

    def spy(*args, **kwargs):
        captured.append(([a.clone() for a in args], dict(kwargs)))
        return launch(*args, **kwargs)

    def spy_chain(a, b, chain):
        chains.append((a.clone(), b.clone(), chain))
        return launch_chain(a, b, chain)

    # warm-up on two frames, keeping what they hand K1 and K2
    port.cif_hr.cif_hr_accumulate = spy
    port.pair_chain.pair_chain = spy_chain
    try:
        for frame in frames[:2]:
            processor.process(frame)
    finally:
        port.cif_hr.cif_hr_accumulate = launch
        port.pair_chain.pair_chain = launch_chain
    decoder.reset()
    processor.prev_features = None

    on_device = tracking.associate_on_device
    assoc_syncs = []

    def no_sync(*args, **kwargs):
        torch.cuda.set_sync_debug_mode('error')
        try:
            return on_device(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode('default')

    call = tracking.associate

    def counted(*args, **kwargs):
        before = port.common.HOST_SYNCS
        out = call(*args, **kwargs)
        assoc_syncs[-1] += port.common.HOST_SYNCS - before
        return out

    held = {}

    def keep(fields, meta=None):
        i = len(per_frame)
        if i in TRACK_HELD:
            held[i] = [tracker_state(decoder), [f.clone() for f in fields]]
        out = decoder(fields, meta)
        if i in TRACK_HELD:
            held[i].append(out)
        return out

    per_frame = []
    tracking.associate_on_device = no_sync
    tracking.associate = counted
    processor.decoder = keep
    torch.cuda.reset_peak_memory_stats()
    zero_counts(port)
    try:
        for frame in frames:
            assoc_syncs.append(0)
            before = (port.cif_hr.KERNEL_LAUNCHES,
                      port.pair_chain.KERNEL_LAUNCHES, port.common.HOST_SYNCS)
            start = time.perf_counter()
            preds, _ = processor.process(frame)
            e2e = time.perf_counter() - start
            t = processor.last_times
            assoc = decoder.last_association_time
            per_frame.append(dict(
                e2e=e2e * 1e3, backbone=t['backbone'] * 1e3,
                heads=t['heads'] * 1e3,
                decode=(t['decoder'] - assoc) * 1e3, association=assoc * 1e3,
                k1=port.cif_hr.KERNEL_LAUNCHES - before[0],
                k2=port.pair_chain.KERNEL_LAUNCHES - before[1],
                syncs=port.common.HOST_SYNCS - before[2],
                poses=len(preds), ids=sorted(a.id_ for a in preds)))
            if not all(np.isfinite(a.data).all() for a in preds):
                raise AssertionError('tracking: non-finite annotation')
    finally:
        tracking.associate_on_device = on_device
        tracking.associate = call
        processor.decoder = decoder
    counts = dict(k1=port.cif_hr.KERNEL_LAUNCHES,
                  k1_cuda=port.cif_hr.CUDA_LAUNCHES,
                  k2=port.pair_chain.KERNEL_LAUNCHES,
                  k2_cuda=port.pair_chain.CUDA_LAUNCHES,
                  syncs=port.common.HOST_SYNCS,
                  peak_gib=(torch.cuda.max_memory_allocated()
                            - held_before) / 2**30)
    for row, syncs in zip(per_frame, assoc_syncs):
        row['association_syncs'] = syncs

    def col(key):
        return [row[key] for row in per_frame]

    print(f'tracking stream: {TRACK_FRAMES} frames at {SERVE_EDGE}x'
          f'{SERVE_EDGE}, tshufflenetv2k16 bf16, biases shifted; per frame, '
          f'median [min, max] ms: end to end {stat_ms(col("e2e"))}, backbone '
          f'{stat_ms(col("backbone"))}, heads {stat_ms(col("heads"))}, decode '
          f'{stat_ms(col("decode"))}, association '
          f'{stat_ms(col("association"))}; host syncs per frame '
          f'{stat_ms(col("syncs"))} (the association\'s: '
          f'{sorted(set(col("association_syncs")))}); cif_hr calls per frame '
          f'{col("k1")}, pair_chain calls per frame {sorted(set(col("k2")))}; '
          f'poses per frame {col("poses")}; peak device memory of the stream '
          f'{counts["peak_gib"]:.2f} GiB (over the '
          f'{held_before / 2**30:.2f} GiB the earlier phases hold) ({card})',
          flush=True)
    want = dict(k1=TRACK_FRAMES + 1, k1_cuda=2 * (TRACK_FRAMES + 1),
                k2=len(SN2K16_CHAINS) * TRACK_FRAMES,
                k2_cuda=KERNELS_PER_BLOCK * SN2K16_BLOCKS * TRACK_FRAMES)
    got = {k: counts[k] for k in want}
    if (got != want or col('k1') != [2] + [1] * (TRACK_FRAMES - 1)
            or set(col('k2')) != {len(SN2K16_CHAINS)}):
        raise AssertionError(f'tracking: kernel counts {got}, want {want}')
    if set(col('association_syncs')) != {1}:
        raise AssertionError('tracking: the association synchronized '
                             f'{col("association_syncs")} times per frame')
    first, last = set(per_frame[1]['ids']), set(per_frame[-1]['ids'])
    print(f'tracking ids: {len(first & last)} of frame 1\'s '
          f'{len(first)} tracks still carry their id in frame '
          f'{TRACK_FRAMES - 1}', flush=True)

    worst = 0.0
    for i in TRACK_HELD:
        state, fields, anns = held[i]
        worst = max(worst, hold_tracking_frame(
            port, decoder, state, fields, anns, f'tracking frame {i}'))
    return dict(counts=counts, per_frame=per_frame, captured=captured,
                chains=chains, model=model, worst=worst)


def tracking_kernels(port, stream) -> tuple:
    """(d) K1 and K2 held to their plain versions and timed on what the
    stream handed them: one frame's CifHr (F = 17) and the backbone's
    three chains at batch 1."""
    args, kwargs = stream['captured'][0]
    k1 = measure_cif_hr(port.cif_hr, 'tracking frame', args, kwargs)
    k1['shape'] = (f'(B, F, N) {tuple(args[0].shape)} -> '
                   f'{tuple(kwargs["out_hw"])}')
    first = stream['chains'][:len(SN2K16_CHAINS)]
    shapes = [tuple(a.shape) for a, _, _ in first]
    if shapes != [(1, side, side, c) for _, _, side, c in SN2K16_CHAINS]:
        raise AssertionError(f'the streamed backbone ran K2 on {shapes}')
    basenet = stream['model'].module.basenet
    k2 = sum_chains([measure_pair_chain(
        port.pair_chain, f'tracking stage {stage}', a, b, chain,
        [getattr(basenet, f'stage{stage}_{i}') for i in range(1, n + 1)])
        for (a, b, chain), (stage, n, _, _) in zip(first, SN2K16_CHAINS)])
    k2['shape'] = ', '.join(f'{tuple(a.shape)} {str(a.dtype)[6:]}'
                            for a, _, _ in first)
    print(f'pair_chain per streamed frame (3 chains): kernel '
          f'{k2["ms"]:.4f} ms, plain {k2["plain_ms"]:.4f} ms, canonical '
          f'modules {k2["canonical_ms"]:.4f} ms, bound '
          f'{k2["bound_ms"]:.4f} ms ({k2["bound_by"]})', flush=True)
    return k1, k2


def tracking_clis(port, tmp: str, shifted: str) -> None:
    """(c) the train CLI on toykpst (tshufflenetv2k16, one epoch of 16
    images at 161 px) and the eval CLI on its checkpoint with the COCO and
    PoseTrack metrics; then both on ``shifted``, the stream's bias-shifted
    model saved as a checkpoint, so that they run with poses: the eval CLI
    must predict poses, and the video CLI, on PNG frames written by
    ``image_io.write_png`` (the card's machine has no PIL), must write
    poses on every frame and carry ids from frame to frame."""
    out = os.path.join(tmp, 'toykpst')
    cli_train_eval('toykpst', ['--dataset=toykpst',
                               '--basenet=tshufflenetv2k16',
                               f'--toykpst-n-images={CLI_IMAGES}'],
                   ['--dataset=toykpst'], out, ['cif', 'caf', 'tcaf'],
                   extra_labels=POSETRACK_LABELS)
    env = dict(os.environ, PYTHONPATH=REPO)
    start = time.perf_counter()
    result = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.eval',
         f'--checkpoint={shifted}', f'--batch-size={EVAL_BATCH}',
         '--dataset=toykpst', '-o', shifted + '.eval'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if result.returncode != 0:
        raise AssertionError('eval CLI on the shifted checkpoint failed:\n'
                             f'{result.stderr[-3000:]}')
    with open(shifted + '.eval.stats.json') as f:
        stats = json.load(f)
    stats = dict(zip(stats['text_labels'], stats['stats']))
    predicted = stats['n_gt'] - stats['misses'] + stats['false_positives']
    print(f'eval CLI on the shifted checkpoint: exit 0 in '
          f'{time.perf_counter() - start:.1f} s, stats {stats}; poses '
          f'predicted {predicted:g}', flush=True)
    if not (predicted > 0 and all(np.isfinite(list(stats.values())))):
        raise AssertionError(f'eval CLI on the shifted checkpoint: {stats}')

    frames_dir = os.path.join(tmp, 'frames')
    os.makedirs(frames_dir)
    for i, frame in enumerate(track_frames(4, TRACK_CLI_FRAMES)):
        port.image_io.write_png(os.path.join(frames_dir, f'{i:04d}.png'),
                                frame[:TRACK_CLI_EDGE, :TRACK_CLI_EDGE])
    start = time.perf_counter()
    result = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.video', '--source',
         frames_dir, f'--checkpoint={shifted}',
         f'--long-edge={TRACK_CLI_EDGE}', '--json-output',
         shifted + '.video.jsonl'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if result.returncode != 0:
        raise AssertionError(f'video CLI failed:\n{result.stderr[-3000:]}')
    with open(shifted + '.video.jsonl') as f:
        lines = [json.loads(line) for line in f]
    ids = [{p['id_'] for p in line['predictions']} for line in lines]
    carried = [len(a & b) for a, b in zip(ids, ids[1:])]
    print(f'video CLI on the card, shifted checkpoint: exit 0 in '
          f'{time.perf_counter() - start:.1f} s, {len(lines)} json lines, '
          f'poses per frame {[len(l["predictions"]) for l in lines]}, ids '
          f'carried from the frame before {carried}', flush=True)
    if ([line['frame'] for line in lines] != list(range(TRACK_CLI_FRAMES))
            or not all(ids) or not all(carried)):
        raise AssertionError(f'video CLI json lines: {lines[:2]}')


def save_tracking_model(port, model, path: str) -> None:
    """The stream's model as an npz checkpoint with its toykpst heads."""
    from openpifpaf_tpu_torch.models import checkpoint

    checkpoint.save(
        path, variables=port.models.to_jax_variables(
            model.module.state_dict()),
        head_metas=model.head_metas, basenet_name='tshufflenetv2k16',
        base_stride=model.base_stride)


def tracking_phase(port, card: str, tmp: str) -> dict:
    """Pose tracking: (a) the association at the budgets held to the CPU,
    (b) the stream, (c) the train, eval and video CLIs, (d) K1 and K2 at
    the stream's shapes."""
    start = time.perf_counter()
    association = hold_association(port, card)
    stream = tracking_stream(port, card)
    k1, k2 = tracking_kernels(port, stream)
    counts = stream['counts']
    shifted = os.path.join(tmp, 'tshufflenetv2k16-shifted.npz')
    save_tracking_model(port, stream['model'], shifted)
    del stream
    tracking_clis(port, tmp, shifted)
    print(f'tracking phase: {time.perf_counter() - start:.1f} s ({card})',
          flush=True)
    return dict(counts=counts, k1=k1, k2=k2, association=association)


class _Port:
    """The port's modules, imported after the card check."""

    def __init__(self):
        from openpifpaf_tpu_torch import (datasets, decoder, headmeta,
                                          image_io, kernels, losses, models,
                                          ops, training, video)
        from openpifpaf_tpu_torch import eval as eval_mod
        from openpifpaf_tpu_torch.models import fused_shufflenet
        from openpifpaf_tpu_torch.ops import cif_hr, common, pair_chain
        from openpifpaf_tpu_torch.plugins import posetrack, toykp
        from openpifpaf_tpu_torch.plugins.coco import constants
        from openpifpaf_tpu_torch.plugins.wholebody import constants as wb
        self.decoder, self.headmeta, self.kernels, self.models, self.ops = \
            decoder, headmeta, kernels, models, ops
        self.cif_hr, self.common, self.constants = cif_hr, common, constants
        self.pair_chain = pair_chain
        self.datasets, self.losses, self.training, self.toykp = \
            datasets, losses, training, toykp
        self.eval_mod, self.fused_shufflenet = eval_mod, fused_shufflenet
        self.wb = wb
        self.image_io, self.posetrack, self.video = image_io, posetrack, video


def main() -> int:
    phase('card')
    print(f'torch {torch.__version__} cuda {torch.version.cuda}', flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: chip_smoke.py needs a card')
    card = card_line()
    print(card, flush=True)
    port = _Port()

    phase('build')
    start = time.perf_counter()
    logs = port.kernels.build_all(KERNELS)
    print(f'built {", ".join(f"csrc/{k}.cu" for k in KERNELS)} in '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    for name in KERNELS:
        for line in logs[name].splitlines():
            if any(k in line for k in ('registers', 'spill', 'smem',
                                       'arning', 'wgmma', 'entry function')):
                print(f'  {name}: {line.strip()}', flush=True)
    sass_check(port)

    phase('kernels against plain versions')
    profile_on = '--profile' in sys.argv[1:]
    k1 = check_cif_hr(port.cif_hr, profile_on)
    k2 = check_pair_chain(port)
    check_wide_f32(port)

    phase('golden decode')
    check_golden_decode(port)

    phase('serve')
    served = serve(port, card)

    phase("kernels at the main path's inputs")
    args, kwargs = served['cif_hr_inputs']
    main = measure_cif_hr(port.cif_hr, 'served batch', args, kwargs)
    if profile_on:
        profile_cif_hr(port.cif_hr, 'served batch', args, kwargs)
    max_err = max(k1['max_abs_err'], main['max_abs_err'])
    basenet = served['predictor'].model.module.basenet
    chains = []
    for (a, b, chain), (stage, n, _, _) in zip(served['chain_inputs'],
                                               SN2K16_CHAINS):
        modules = [getattr(basenet, f'stage{stage}_{i}')
                   for i in range(1, n + 1)]
        chains.append(measure_pair_chain(port.pair_chain,
                                         f'served stage {stage}', a, b,
                                         chain, modules))
    k2_main = {key: sum(c[key] for c in chains)
               for key in ('ms', 'plain_ms', 'canonical_ms', 'bound_ms')}
    by_ops = sum(c['bound_ms'] for c in chains
                 if c['bound_by'] == 'operations')
    k2_main['bound_by'] = ('operations' if 2 * by_ops >= k2_main['bound_ms']
                           else 'bytes')
    k2_err = max(r['max_abs_err'] for r in chains + list(k2.values()))
    print(f'pair_chain per served batch (3 chains): kernel '
          f'{k2_main["ms"]:.4f} ms, plain {k2_main["plain_ms"]:.4f} ms, '
          f'canonical modules {k2_main["canonical_ms"]:.4f} ms, bound '
          f'{k2_main["bound_ms"]:.4f} ms ({k2_main["bound_by"]})', flush=True)

    if profile_on:
        phase('profile')
        profile_batch(served['predictor'], served['images'])

    with tempfile.TemporaryDirectory() as tmp:
        phase('train')
        train_phase(port, card, os.path.join(tmp, 'model'))
        phase('eval')
        evaluated = eval_phase(port, card, os.path.join(tmp, 'model.npz'))
        phase('dense')
        dense = dense_phase(port, card, tmp)
        phase('wholebody')
        wholebody = wholebody_phase(port, card, tmp)
        phase('tracking')
        tracked = tracking_phase(port, card, tmp)
    max_err = max([max_err, wholebody['k1']['max_abs_err'],
                   tracked['k1']['max_abs_err']]
                  + [r['max_abs_err'] for kind, r in evaluated['checks']
                     if kind == 'cif_hr'])
    k2_err = max([k2_err, wholebody['k2']['max_abs_err'],
                  tracked['k2']['max_abs_err']]
                 + [r['max_abs_err'] for kind, r in evaluated['checks']
                    if kind == 'pair_chain'])
    eval_counts = evaluated['runs']['multi-scale force-complete']['counts']
    wb_counts = wholebody['counts'].values()

    def at_new_shape(r):
        return {k: r[k] for k in ('shape', 'ms', 'plain_ms', 'bound_ms',
                                  'bound_by', 'max_abs_err')}

    print(json.dumps({'kernels': [{
        'name': 'cif_hr_accumulate', 'route': 'cuda',
        'source': 'openpifpaf_tpu_torch/csrc/cif_hr.cu',
        'replaces': 'openpifpaf_tpu/ops/pallas_cif_hr.py:68',
        'function': 'accumulate_pallas',
        'launches': served['launches'],
        'eval_launches': eval_counts['k1'],
        'dense_launches': dense['k1'],
        'wholebody_launches': sum(c['k1'] for c in wb_counts),
        'wholebody': at_new_shape(wholebody['k1']),
        'tracking_launches': tracked['counts']['k1'],
        'tracking': at_new_shape(tracked['k1']),
        'max_abs_err': max_err, 'max_abs_diff': max_err,
        'ms': main['ms'], 'plain_ms': main['plain_ms'],
        'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
        'library_ms': None}, {
        'name': 'pair_chain', 'route': 'cuda',
        'source': 'openpifpaf_tpu_torch/csrc/pair_chain.cu',
        'replaces': 'openpifpaf_tpu/ops/pallas_pair_chain.py:184',
        'function': 'pair_chain_pallas',
        'launches': served['chain_launches'],
        'eval_launches': eval_counts['k2'],
        'dense_launches': dense['k2'],
        'wholebody_launches': sum(c['k2'] for c in wb_counts),
        'wholebody': at_new_shape(wholebody['k2']),
        'tracking_launches': tracked['counts']['k2'],
        'tracking': at_new_shape(tracked['k2']),
        'max_abs_err': k2_err, 'max_abs_diff': k2_err,
        'ms': k2_main['ms'], 'plain_ms': k2_main['plain_ms'],
        'bound_ms': k2_main['bound_ms'], 'bound_by': k2_main['bound_by'],
        'library_ms': None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
