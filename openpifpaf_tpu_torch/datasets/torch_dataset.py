"""Adapter for torch-style datasets.

Port of ``openpifpaf_tpu/datasets/torch_dataset.py``.  Reference parity:
``src/openpifpaf/datasets/torch_dataset.py``: a map-style dataset whose
items are images, or ``(image, annotations)`` tuples, feeds the port's
preprocess and loaders.  The image enters the preprocess as the port's
transforms take it, a (3, H, W) float32 tensor in uint8 levels (the JAX
version hands them a PIL image).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _image_tensor(image, index: int) -> torch.Tensor:
    """An item's image as a (3, H, W) float32 tensor in uint8 levels."""
    if hasattr(image, 'convert') and not isinstance(image, np.ndarray):
        # a PIL image, taken as its RGB array (PIL is not imported here)
        image = np.asarray(image.convert('RGB'))
    if isinstance(image, np.ndarray) and image.dtype == np.uint8 \
            and image.ndim == 3 and image.shape[2] == 3:
        return torch.from_numpy(np.ascontiguousarray(image)) \
            .permute(2, 0, 1).float()
    if isinstance(image, torch.Tensor) and image.dtype == torch.uint8 \
            and image.dim() == 3 and image.shape[0] == 3:
        return image.float()
    raise TypeError(
        f'dataset item {index} is {type(image)!r}; expected an (H, W, 3) '
        'uint8 array, a (3, H, W) uint8 tensor, a PIL image, or an '
        '(image, anns) tuple')


class TorchDatasetAdapter(torch.utils.data.Dataset):
    """Wrap a map-style dataset so that its items flow through
    ``preprocess``.

    Items are an (H, W, 3) uint8 numpy array, a (3, H, W) uint8 tensor
    (torchvision's layout) or a PIL image, or a tuple whose first element
    is one of those and whose second is a list of COCO-style annotation
    dicts.
    """

    def __init__(self, dataset, preprocess=None, *,
                 index_field: Optional[str] = 'dataset_index'):
        self.dataset = dataset
        self.preprocess = preprocess
        self.index_field = index_field

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int):
        item = self.dataset[index]
        anns = []
        if isinstance(item, tuple):
            image, anns = item[0], list(item[1]) if len(item) > 1 else []
        else:
            image = item
        image = _image_tensor(image, index)

        meta = {}
        if self.index_field:
            meta[self.index_field] = index
        if self.preprocess is not None:
            image, anns, meta = self.preprocess(image, anns, meta)
        return image, anns, meta
