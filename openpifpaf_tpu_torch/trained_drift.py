"""Trained-checkpoint drift: production decode vs the sequential oracle on
the fields of a trained model.

Port of the JAX repository's ``tools/trained_drift.py``.  The synthetic
drift report (``drift_report.py``) paints fields; this tool runs a
checkpoint over a data module's deterministic eval set (toykp by default),
decodes every image with both the production parallel decoder and the
sequential-faithful oracle (one front end for both), and reports per-pose
agreement and the COCO-protocol AP of each path: the AP delta is the cost
of parallel scheduling on trained fields.  The forward is ``Model.__call__``
(the pair plan, K2 on the card), the front end the CifCaf decode's (K1 on
the card); the oracle reads the front end back once per tensor.  The
checkpoint is an npz of the JAX package's format, as the port writes it
too.  It runs on the card unless ``--device cpu`` is given; without CUDA it
raises.  The JSON printed last has the JAX tool's keys.

Usage::

    python -m openpifpaf_tpu_torch.trained_drift --checkpoint model.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from . import datasets, drift, models, plugins
from .annotation import Annotation
from .decoder.cifcaf import CifCaf
from .ops import pipeline
from .ops.common import read_back

# the CifCaf class attributes the flags set, restored when ``main`` returns
_DECODE_FLAGS = {'force_complete': 'force_complete',
                 'dense': 'dense_connections',
                 'instance_threshold': 'instance_threshold',
                 'seed_threshold': 'seed_threshold',
                 'keypoint_threshold': 'keypoint_threshold'}


@torch.no_grad()
def decode_paths(model, fields):
    """A batch's head fields (a list of (B, ...) tensors) -> per image
    (parallel poses, oracle poses, counters), the poses score-descending
    lists of (xyv (K, 3), score).

    Decode modes (``--force-complete`` / ``--dense``) are honored through
    the CifCaf class configuration exactly as the CLI sets them: the
    decoder is built by ``CifCaf.factory``, so a caf25 dense head
    concatenates into the decode skeleton."""
    dec = CifCaf.factory(model.head_metas, device=model.device)[0]
    cif_meta, caf_meta = dec.cif_meta, dec.caf_meta
    cif_f = fields[cif_meta.head_index].float()
    caf_f = torch.as_tensor(dec.caf_fields(fields)).float()
    h, w = cif_f.shape[-2:]
    stride = cif_meta.stride
    image_hw = ((h - 1) * stride + 1, (w - 1) * stride + 1)
    config = dec.config_for(image_hw)
    skeleton = np.asarray(caf_meta.skeleton, np.int32) - 1
    score_weights = np.asarray(
        cif_meta.score_weights or [1.0] * cif_meta.n_fields, np.float32)

    fe = pipeline.decode_front_end(cif_f, caf_f, cif_meta=cif_meta,
                                   caf_meta=caf_meta, config=config)

    # production: the wave-recycled growth with its claim fixpoint
    out = pipeline.decode_back_end(fe, cif_meta=cif_meta, caf_meta=caf_meta,
                                   config=config)
    parallel = drift.extract_batch(*(read_back(t) for t in
                                     (out.xyv, out.scores, out.valid)))

    # oracle
    per_image = [drift.oracle_poses(fe, i, skeleton=skeleton,
                                    n_keypoints=cif_meta.n_fields,
                                    config=config)
                 for i in range(cif_f.shape[0])]
    poses, placed, valid = (torch.as_tensor(a, device=cif_f.device)
                            for a in drift.pack_oracle_poses(
                                per_image, max_poses=config.growth.max_poses,
                                n_keypoints=cif_meta.n_fields))
    o_out, _, o_scores, o_valid = pipeline.finalize_poses(
        poses, placed, valid, fe.scale_px, score_weights=score_weights,
        config=config)
    oracle = drift.extract_batch(read_back(o_out[..., :3]),
                                 read_back(o_scores), read_back(o_valid))

    dropped = [read_back(t) for t in (out.n_dropped_poses, fe.n_dropped_caf,
                                      fe.n_dropped_cif)]
    counters = [{'n_dropped_poses': int(dropped[0][i]),
                 'n_dropped_caf': int(dropped[1][i]),
                 'n_dropped_cif': int(dropped[2][i])}
                for i in range(len(parallel))]
    return list(zip(parallel, oracle, counters))


def ap_of(per_image, metric_factory, loader_batches, cif_meta):
    metric = metric_factory()
    idx = 0
    for _, anns_gt, metas in loader_batches:
        for gt, meta in zip(anns_gt, metas):
            anns = []
            for xyv, score in per_image[idx]:
                ann = Annotation(cif_meta.keypoints,
                                 cif_meta.draw_skeleton or [],
                                 sigmas=cif_meta.sigmas,
                                 score_weights=cif_meta.score_weights)
                ann.data[:] = xyv
                ann.joint_scales[:] = 4.0
                ann.fixed_score = score
                anns.append(ann)
            metric.accumulate(anns, meta, ground_truth=gt)
            idx += 1
    stats = metric.stats()
    return dict(zip(stats['text_labels'], stats['stats']))


def cli(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.trained_drift',
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--checkpoint', required=True)
    parser.add_argument('--dataset', default='toykp',
                        help='eval datamodule (toykp, or toycrowd for the '
                             'overlapping-crowd regime)')
    parser.add_argument('--n-images', type=int, default=None,
                        help='override the eval-set size')
    parser.add_argument('--force-complete', action='store_true',
                        help='decode with --force-complete-pose semantics '
                             '(relaxed second growth pass)')
    parser.add_argument('--dense', type=float, default=None,
                        help='decode with --dense-connections at this '
                             'confidence scale (requires a caf25 head in '
                             'the checkpoint)')
    parser.add_argument('--instance-threshold', type=float, default=None,
                        help='override CifCaf.instance_threshold (same '
                             'knob as the predict/eval CLI)')
    parser.add_argument('--seed-threshold', type=float, default=None,
                        help='override CifCaf.seed_threshold')
    parser.add_argument('--keypoint-threshold', type=float, default=None,
                        help='override CifCaf.keypoint_threshold')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; raises '
                             'without CUDA)')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = cli(argv)
    plugins.register()
    saved = {attr: getattr(CifCaf, attr) for attr in _DECODE_FLAGS.values()}
    dm_cls = datasets.DATAMODULES[args.dataset]
    saved_n_val = dm_cls.n_val_images
    try:
        for flag, attr in _DECODE_FLAGS.items():
            value = getattr(args, flag)
            if value is not None and value is not False:
                setattr(CifCaf, attr, value)
        if args.n_images is not None:
            dm_cls.n_val_images = args.n_images
        out = _run(args)
    finally:
        for attr, value in saved.items():
            setattr(CifCaf, attr, value)
        dm_cls.n_val_images = saved_n_val
    print(json.dumps(out))
    return 0


def _run(args) -> dict:
    model = models.factory(checkpoint=args.checkpoint, bf16=False,
                           device=args.device)
    datamodule = datasets.factory(args.dataset)
    for meta, model_meta in zip(datamodule.head_metas, model.head_metas):
        meta.head_index = model_meta.head_index
        meta.base_stride = model_meta.base_stride
    loader = datamodule.eval_loader()

    par_all, ora_all, per_scene, counter_sums = [], [], [], []
    batches = []
    sigmas = np.asarray(model.head_metas[0].sigmas, np.float32)
    for images, anns_gt, metas in loader:
        fields = model(images)
        batches.append((images, anns_gt, metas))
        for parallel, oracle, counters in decode_paths(model, fields):
            par_all.append(parallel)
            ora_all.append(oracle)
            counter_sums.append(counters)
            per_scene.append(drift.scene_agreement(parallel, oracle,
                                                   sigmas=sigmas))

    n_o = sum(m['n_oracle'] for m in per_scene)
    n_p = sum(m['n_parallel'] for m in per_scene)
    n_m = sum(m['n_matched'] for m in per_scene)
    finite = [m['mean_oks'] for m in per_scene if np.isfinite(m['mean_oks'])]

    ap_parallel = ap_of(par_all, lambda: datamodule.metrics()[0], batches,
                        model.head_metas[0])
    ap_oracle = ap_of(ora_all, lambda: datamodule.metrics()[0], batches,
                      model.head_metas[0])

    return {
        'checkpoint': os.path.basename(args.checkpoint),
        'n_images': len(par_all),
        'poses_parallel': n_p, 'poses_oracle': n_o, 'matched': n_m,
        'detection_f1': round(2 * n_m / max(1, n_o + n_p), 4),
        'mean_oks': round(float(np.mean(finite)), 4) if finite else None,
        'AP_parallel': round(ap_parallel['AP'], 4),
        'AP_oracle': round(ap_oracle['AP'], 4),
        'AP_delta': round(ap_parallel['AP'] - ap_oracle['AP'], 4),
        # production budget-overflow counters at the decode defaults
        'n_dropped_poses': sum(c['n_dropped_poses'] for c in counter_sums),
        'n_dropped_caf': sum(c['n_dropped_caf'] for c in counter_sums),
        'n_dropped_cif': sum(c['n_dropped_cif'] for c in counter_sums),
        'dataset': args.dataset,
        'force_complete': bool(args.force_complete),
        'dense_connections': args.dense,
        'instance_threshold': CifCaf.instance_threshold,
        'seed_threshold': CifCaf.seed_threshold,
        'keypoint_threshold': CifCaf.keypoint_threshold,
    }


if __name__ == '__main__':
    sys.exit(main())
