"""COCO-format dataset: json annotations, images read without PIL.

Port of ``openpifpaf_tpu/plugins/coco/dataset.py`` (``CocoDataset``): the
same json reading (no pycocotools), the same filters (``category_ids``,
``annotation_filter``, ``min_kp_anns``) and sorted image ids, the same
meta (``dataset_index``, ``image_id``, ``file_name``).  Images are read by
``image_io.read_image`` into a (3, H, W) float32 tensor in uint8 levels
(the format by content, as PIL's ``open``, without PIL).  ``rng`` is the
generator the preprocess draws from, reseeded per loader worker
(``datasets.module``).
"""

from __future__ import annotations

import copy
import json
import logging
import os
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

from ... import image_io

LOG = logging.getLogger(__name__)


class CocoDataset(torch.utils.data.Dataset):
    def __init__(self, image_dir: str, ann_file: str, *,
                 preprocess=None,
                 annotation_filter: bool = False,
                 min_kp_anns: int = 0,
                 category_ids: Optional[List[int]] = None,
                 rng: np.random.Generator = None):
        self.image_dir = image_dir
        self.preprocess = preprocess
        self.rng = rng

        with open(ann_file) as f:
            data = json.load(f)
        self.images_by_id = {img['id']: img for img in data['images']}
        anns_by_image = defaultdict(list)
        for ann in data.get('annotations', []):
            if category_ids and ann.get('category_id') not in category_ids:
                continue
            anns_by_image[ann['image_id']].append(ann)
        self.anns_by_image = anns_by_image

        ids = list(self.images_by_id)
        if annotation_filter:
            ids = [i for i in ids if anns_by_image.get(i)]
        if min_kp_anns:
            def n_kp_anns(i):
                return sum(1 for a in anns_by_image.get(i, [])
                           if a.get('num_keypoints', 0) >= 1
                           and not a.get('iscrowd'))
            ids = [i for i in ids if n_kp_anns(i) >= min_kp_anns]
        self.ids = sorted(ids)
        LOG.info('images: %d / %d', len(self.ids), len(self.images_by_id))

    def __len__(self):
        return len(self.ids)

    def read_image(self, file_name: str) -> torch.Tensor:
        """(3, H, W) float32 in uint8 levels."""
        array = image_io.read_image(os.path.join(self.image_dir, file_name))
        return torch.from_numpy(array).permute(2, 0, 1).float()

    def __getitem__(self, index):
        image_id = self.ids[index]
        image_info = self.images_by_id[image_id]
        anns = copy.deepcopy(self.anns_by_image.get(image_id, []))
        image = self.read_image(image_info['file_name'])
        meta = {
            'dataset_index': index,
            'image_id': image_id,
            'file_name': image_info['file_name'],
        }
        if self.preprocess is None:
            return image, anns, meta
        return self.preprocess(image, anns, meta)
