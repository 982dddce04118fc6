"""Scaling efficiency: the train step's throughput at 1 rank against N.

Port of ``openpifpaf_tpu/parallel/scaling.py``: a weak-scaling sweep of
the whole train step (forward, loss, backward, the gradients' all-reduce,
optimizer, EMA): the global batch grows with the number of ranks, so
perfect scaling keeps the step time constant.  Each point runs a group of
N processes (``mesh.run_group``), one card each, and the port's
``Trainer.train_step`` with its data-parallel path (synchronized
BatchNorm, global loss means, averaged gradients).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import List

import numpy as np
import torch

from . import mesh

LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    global_batch: int
    step_time_s: float
    images_per_s: float
    efficiency: float      # vs the 1-device point (weak scaling)


def build_tiny_model(basenet: str = 'shufflenetv2k16', device='cpu'):
    """A model with COCO's CIF and CAF heads and its loss (the JAX
    ``parallel/dryrun.py``'s ``build_tiny_model``), f32, seeded weights."""
    # pylint: disable=import-outside-toplevel
    from .. import headmeta, losses, models
    from ..plugins.coco import constants

    cif = headmeta.Cif('cif', 'cocokp',
                       keypoints=constants.COCO_KEYPOINTS,
                       sigmas=constants.COCO_PERSON_SIGMAS,
                       score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    caf = headmeta.Caf('caf', 'cocokp',
                       keypoints=constants.COCO_KEYPOINTS,
                       sigmas=constants.COCO_PERSON_SIGMAS,
                       skeleton=constants.COCO_PERSON_SKELETON)
    model = models.factory(basenet, [cif, caf], bf16=False, device=device)
    return model, losses.Factory().factory(model.head_metas)


def random_batch(head_metas, batch: int, image_hw, seed: int = 0):
    """NCHW images and random targets of the JAX harness's kinds."""
    h, w = image_hw
    fh, fw = (h - 1) // 16 + 1, (w - 1) // 16 + 1
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, h, w, 3)).astype(np.float32)

    def target_for(meta):
        f, nv, ns = meta.n_fields, meta.n_vectors, meta.n_scales
        target = {
            'conf': rng.uniform(0, 1, (batch, f, fh, fw))
            .astype(np.float32).round(),
            'conf_mask': np.ones((batch, f, fh, fw), bool),
            'vec': rng.normal(size=(batch, f, nv, 2, fh, fw))
            .astype(np.float32),
            'vec_mask': np.ones((batch, f, nv, fh, fw), bool),
            'scale': np.abs(rng.normal(size=(batch, f, ns, fh, fw)))
            .astype(np.float32),
            'scale_mask': np.ones((batch, f, ns, fh, fw), bool),
        }
        return {k: torch.from_numpy(v) for k, v in target.items()}

    return (torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
            [target_for(m) for m in head_metas])


def measure_train_step(device, *, image_hw=(64, 64),
                       batch_per_device: int = 1,
                       basenet: str = 'shufflenetv2k16',
                       n_iters: int = 5) -> float:
    """In each rank of a group: the median seconds of the data-parallel
    train step on this rank's shard of the global batch (after one step
    that builds and warms it)."""
    # pylint: disable=import-outside-toplevel
    from ..training import OptimizeFactory, Trainer

    device = torch.device(device)
    model, loss_fn = build_tiny_model(basenet, device)
    trainer = Trainer(model, loss_fn, OptimizeFactory(), os.devnull)
    trainer.setup(steps_per_epoch=10)
    images, targets = mesh.shard_batch(random_batch(
        model.head_metas, mesh.world() * batch_per_device, image_hw))

    def step() -> float:
        start = time.perf_counter()
        total, _ = trainer.train_step(images, targets)
        float(total)    # waits for the step
        return time.perf_counter() - start

    step()
    return float(np.median([step() for _ in range(n_iters)]))


def sweep(device_counts, *, device: str = 'cpu', timeout: float = 900.0,
          **kwargs) -> List[ScalingPoint]:
    """``measure_train_step`` in a group of each size of
    ``device_counts``; rank 0's time is the point's."""
    points = []
    base_rate = None
    for n in device_counts:
        t = mesh.run_group(_measure, n, (kwargs,), device=device,
                           timeout=timeout)[0]
        batch = n * kwargs.get('batch_per_device', 1)
        rate = batch / t
        if base_rate is None:
            base_rate = rate / n  # per-device rate at the first point
        eff = rate / (base_rate * n)
        points.append(ScalingPoint(n, batch, t, rate, eff))
        LOG.info('devices=%d: %.1f ms/step, %.1f img/s, eff=%.0f%%',
                 n, t * 1000, rate, eff * 100)
    return points


def _measure(device, kwargs) -> float:
    return measure_train_step(device, **kwargs)
