"""Raw annotation dicts -> typed ground-truth annotations.

Port of ``openpifpaf_tpu/transforms/toannotations.py``: ``ToAnnotations``
applies a list of converters as the last transform of an eval chain;
``ToKpAnnotations``, ``ToDetAnnotations`` and ``ToCrowdAnnotations`` turn
COCO-style dicts into ``Annotation``, ``AnnotationDet`` and
``AnnotationCrowd`` objects.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .base import Preprocess
from ..annotation import Annotation, AnnotationCrowd, AnnotationDet


class ToAnnotations(Preprocess):
    """Apply the converters; their outputs concatenated in order."""

    def __init__(self, converters: Sequence):
        self.converters = list(converters)

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        anns = [out
                for converter in self.converters
                for out in converter(anns)]
        return image, anns, meta


class ToKpAnnotations:
    """dict -> keypoint Annotation (skips crowd and keypoint-less dicts)."""

    def __init__(self, categories: Sequence[str],
                 keypoints_by_category: Dict[int, Sequence[str]],
                 skeleton_by_category: Dict[int, Sequence]):
        self.categories = list(categories)
        self.keypoints_by_category = keypoints_by_category
        self.skeleton_by_category = skeleton_by_category

    def __call__(self, anns):
        out = []
        for raw in anns:
            if isinstance(raw, Annotation):
                out.append(raw)
                continue
            if not isinstance(raw, dict) or raw.get('iscrowd'):
                continue
            kps = raw.get('keypoints')
            if kps is None:
                continue
            category_id = raw.get('category_id', 1)
            if category_id not in self.keypoints_by_category:
                continue
            ann = Annotation(self.keypoints_by_category[category_id],
                             self.skeleton_by_category[category_id],
                             categories=self.categories,
                             category_id=category_id)
            ann.data = np.asarray(kps, np.float32).reshape(-1, 3)
            bbox = raw.get('bbox')
            if bbox is not None:
                ann.fixed_bbox = np.asarray(bbox, np.float32)
            if 'track_id' in raw:
                ann.id_ = int(raw['track_id'])
            out.append(ann)
        return out


class ToDetAnnotations:
    """dict -> AnnotationDet ground-truth box (skips crowd dicts)."""

    def __init__(self, categories: Sequence[str]):
        self.categories = list(categories)

    def __call__(self, anns):
        out = []
        for raw in anns:
            if isinstance(raw, AnnotationDet):
                out.append(raw)
                continue
            if not isinstance(raw, dict) or raw.get('iscrowd'):
                continue
            bbox = raw.get('bbox')
            if bbox is None:
                continue
            out.append(AnnotationDet(self.categories).set(
                raw.get('category_id', 1), 1.0, bbox))
        return out


class ToCrowdAnnotations:
    """dict (iscrowd) -> AnnotationCrowd region; without a box, the box of
    its visible keypoints."""

    def __init__(self, categories: Sequence[str]):
        self.categories = list(categories)

    def __call__(self, anns):
        out = []
        for raw in anns:
            if isinstance(raw, AnnotationCrowd):
                out.append(raw)
                continue
            if not isinstance(raw, dict) or not raw.get('iscrowd'):
                continue
            bbox = raw.get('bbox')
            if bbox is None:
                kps = np.asarray(raw.get('keypoints', []),
                                 np.float32).reshape(-1, 3)
                visible = kps[kps[:, 2] > 0]
                if not len(visible):
                    continue
                x0, y0 = visible[:, 0].min(), visible[:, 1].min()
                bbox = [x0, y0,
                        visible[:, 0].max() - x0, visible[:, 1].max() - y0]
            out.append(AnnotationCrowd(self.categories).set(
                raw.get('category_id', 1), bbox))
        return out
