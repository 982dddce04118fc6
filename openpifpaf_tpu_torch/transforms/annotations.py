"""COCO-json -> Annotation normalization.

Port of ``openpifpaf_tpu/transforms/annotations.py`` (``NormalizeAnnotations``)
for keypoint annotations and for dicts that carry only a box (their
keypoints stay zero; ``Cifar10`` passes no keypoint names, so its boxes get
``(0, 3)`` keypoint data).  Annotation objects pass through.
"""

from __future__ import annotations

import numpy as np

from .base import Preprocess
from ..annotation import Annotation, Base as AnnotationBase


class NormalizeAnnotations(Preprocess):
    """Convert raw COCO-style ann dicts into Annotation objects."""

    def __init__(self, keypoints, skeleton, *, sigmas=None,
                 score_weights=None, categories=None):
        self.keypoints = keypoints
        self.skeleton = skeleton
        self.sigmas = sigmas
        self.score_weights = score_weights
        self.categories = categories

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        out = []
        for raw in anns:
            if isinstance(raw, AnnotationBase):
                out.append(raw)
                continue
            ann = Annotation(self.keypoints, self.skeleton,
                             sigmas=self.sigmas,
                             score_weights=self.score_weights,
                             categories=self.categories,
                             category_id=raw.get('category_id', 1))
            kps = raw.get('keypoints')
            if kps is not None:
                ann.data = np.asarray(kps, np.float32).reshape(-1, 3)
            ann.iscrowd = bool(raw.get('iscrowd', 0))
            bbox = raw.get('bbox')
            if bbox is not None:
                ann.fixed_bbox = np.asarray(bbox, np.float32)
            if 'track_id' in raw:
                ann.id_ = int(raw['track_id'])
            out.append(ann)
        return image, out, meta
