"""Collate for eval and training batches.

Port of ``openpifpaf_tpu/datasets/collate.py`` (``:14-61``): every collate
stacks the (3, H, W) images into an NCHW float32 tensor (the JAX collates
give NHWC).  The eval collates keep each sample's annotations and meta as
lists; the training collates stack each head's targets into a dict of
tensors with a leading batch axis (masks stay bool).  The tracking
collates take frame pairs and interleave them, (2B, 3, H, W) with the
pairs adjacent, the layout of ``models/tracking_base.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def collate_images_anns_meta(batch):
    images = torch.stack([b[0] for b in batch]).to(torch.float32)
    anns = [b[1] for b in batch]
    metas = [b[2] for b in batch]
    return images, anns, metas


def _stack_targets(batch):
    targets = []
    for head_i in range(len(batch[0][1])):
        samples = [b[1][head_i] for b in batch]
        targets.append({k: torch.from_numpy(np.stack([s[k] for s in samples]))
                        for k in samples[0]})
    return targets


def collate_images_targets_meta(batch):
    images = torch.stack([b[0] for b in batch]).to(torch.float32)
    return images, _stack_targets(batch), [b[2] for b in batch]


def _interleave(batch):
    return torch.cat([torch.stack(list(b[0])) for b in batch]) \
        .to(torch.float32)


def collate_tracking_images_anns_meta(batch):
    """Eval collate for frame pairs: interleaved (2B, 3, H, W) images with
    the current frame's ground truth per pair."""
    return _interleave(batch), [b[1] for b in batch], [b[2] for b in batch]


def collate_tracking_images_targets_meta(batch):
    """Training collate for frame pairs: interleaved (2B, 3, H, W) images;
    single-frame targets keep their (B, 2, ...) pair axis."""
    return _interleave(batch), _stack_targets(batch), [b[2] for b in batch]
