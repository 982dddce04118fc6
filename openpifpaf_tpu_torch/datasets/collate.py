"""Collate for eval and training batches.

Port of ``collate_images_anns_meta`` and ``collate_images_targets_meta``
(``openpifpaf_tpu/datasets/collate.py:14-34``): both stack the (3, H, W)
images into an NCHW float32 tensor (the JAX collates give NHWC).  The eval
collate keeps each image's annotations and meta as lists; the training
collate stacks each head's targets into a dict of tensors with a leading
batch axis (masks stay bool).
"""

from __future__ import annotations

import numpy as np
import torch


def collate_images_anns_meta(batch):
    images = torch.stack([b[0] for b in batch]).to(torch.float32)
    anns = [b[1] for b in batch]
    metas = [b[2] for b in batch]
    return images, anns, metas


def collate_images_targets_meta(batch):
    images = torch.stack([b[0] for b in batch]).to(torch.float32)
    targets = []
    for head_i in range(len(batch[0][1])):
        samples = [b[1][head_i] for b in batch]
        targets.append({k: torch.from_numpy(np.stack([s[k] for s in samples]))
                        for k in samples[0]})
    metas = [b[2] for b in batch]
    return images, targets, metas
