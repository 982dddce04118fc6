"""Image files as a dataset: the predictor's input from paths.

Port of ``ImageList`` of ``openpifpaf_tpu/datasets/loader.py`` (``:163-186``).
Reference: the ``ImageList`` dataset the ``Predictor`` reads image files
through.  Files are read by ``image_io.read_image`` (every format PIL's
``open`` reads there, picked by content, without PIL); the image enters the preprocess as a (3, H, W)
float32 tensor in uint8 levels, as the port's transforms take it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import image_io


class ImageList(torch.utils.data.Dataset):
    """Dataset over image file paths with a preprocess transform."""

    def __init__(self, image_paths: Sequence[str], preprocess):
        self.image_paths = list(image_paths)
        self.preprocess = preprocess

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, index):
        path = self.image_paths[index]
        image = torch.from_numpy(image_io.read_image(path)).permute(2, 0, 1)
        meta = {'dataset_index': index, 'file_name': path}
        return self.preprocess(image.float(), [], meta)
