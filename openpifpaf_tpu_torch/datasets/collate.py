"""Collate for training batches.

Port of ``collate_images_targets_meta`` (``openpifpaf_tpu/datasets/
collate.py:21-34``): stacks the (3, H, W) images into an NCHW float32
tensor (the JAX collate gives NHWC) and each head's targets into a dict of
tensors with a leading batch axis (masks stay bool); metas stay a list.
"""

from __future__ import annotations

import numpy as np
import torch


def collate_images_targets_meta(batch):
    images = torch.stack([b[0] for b in batch]).to(torch.float32)
    targets = []
    for head_i in range(len(batch[0][1])):
        samples = [b[1][head_i] for b in batch]
        targets.append({k: torch.from_numpy(np.stack([s[k] for s in samples]))
                        for k in samples[0]})
    metas = [b[2] for b in batch]
    return images, targets, metas
