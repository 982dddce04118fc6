"""COCO metric: accumulates predictions and runs the OKS/IoU evaluation.

Port copy of ``openpifpaf_tpu/metric/coco.py``.  Reference parity:
``src/openpifpaf/metric/coco.py:~20`` — ``Coco`` wraps COCOeval for
keypoints/bbox and reports the 10-number AP/AR summary with the same text
labels.  Ground truth comes either from an annotation file (COCO json,
``ann_file``; with ``crowd_index_groups`` the CrowdPose bands) or from the
eval loader's per-image annotations (``ground_truth_from_loader=True``,
used by synthetic datasets).
"""

from __future__ import annotations

import json
import logging
from typing import List, Optional, Sequence

import numpy as np

from .base import Base
from .cocoeval import CocoEval, DtInstance, GtInstance

LOG = logging.getLogger(__name__)


class Coco(Base):
    text_labels_keypoints = ['AP', 'AP0.5', 'AP0.75', 'APM', 'APL',
                             'AR', 'AR0.5', 'AR0.75', 'ARM', 'ARL']
    text_labels_bbox = ['AP', 'AP0.5', 'AP0.75', 'APS', 'APM', 'APL',
                        'AR', 'AR0.5', 'AR0.75', 'ARS', 'ARM', 'ARL']
    # crowdposetools summary: AP by per-image crowd-index band instead of
    # by instance area (easy < 0.1 <= medium < 0.8 <= hard)
    text_labels_crowd = ['AP', 'AP0.5', 'AP0.75', 'APE', 'APM', 'APH',
                         'AR', 'AR0.5', 'AR0.75']

    def __init__(self, *, ann_file: Optional[str] = None,
                 ground_truth_from_loader: bool = False,
                 iou_type: str = 'keypoints',
                 keypoint_oks_sigmas: Optional[Sequence[float]] = None,
                 max_per_image: int = 20,
                 category_ids: Sequence[int] = (1,),
                 crowd_index_groups: bool = False):
        self.iou_type = iou_type
        self.max_per_image = max_per_image
        self.category_ids = list(category_ids)
        self.crowd_index_groups = crowd_index_groups
        if crowd_index_groups:
            self.text_labels = self.text_labels_crowd
        else:
            self.text_labels = (self.text_labels_keypoints
                                if iou_type == 'keypoints'
                                else self.text_labels_bbox)
        self.eval = CocoEval(iou_type=iou_type, sigmas=keypoint_oks_sigmas,
                             max_dets=max_per_image)
        self.ground_truth_from_loader = ground_truth_from_loader
        self.gt_by_image = {}
        self.group_by_image = {}
        if ann_file:
            self._load_gt(ann_file)
        self.predictions: List[dict] = []
        self.image_ids: List = []

    @staticmethod
    def _crowd_group(crowd_index: float) -> str:
        if crowd_index < 0.1:
            return 'E'
        if crowd_index < 0.8:
            return 'M'
        return 'H'

    def _load_gt(self, ann_file: str) -> None:
        with open(ann_file) as f:
            data = json.load(f)
        if self.crowd_index_groups:
            for image in data.get('images', []):
                self.group_by_image[image['id']] = self._crowd_group(
                    float(image.get('crowdIndex', 0.0)))
        for ann in data.get('annotations', []):
            if self.category_ids and \
                    ann.get('category_id', 1) not in self.category_ids:
                continue
            kps = ann.get('keypoints')
            kps = np.asarray(kps, np.float32).reshape(-1, 3) \
                if kps is not None else None
            bbox = np.asarray(ann.get('bbox', (0, 0, 0, 0)), np.float32)
            area = float(ann.get('area') or bbox[2] * bbox[3])
            self.gt_by_image.setdefault(ann['image_id'], []).append(
                GtInstance(keypoints=kps, bbox=bbox, area=area,
                           iscrowd=bool(ann.get('iscrowd', 0)),
                           category_id=ann.get('category_id', 1)))

    # ------------------------------------------------------------------
    def accumulate(self, predictions, image_meta, *, ground_truth=None):
        image_id = image_meta.get('image_id',
                                  image_meta.get('dataset_index'))
        self.image_ids.append(image_id)

        dts = []
        for ann in predictions:
            data = ann.json_data() if hasattr(ann, 'json_data') else ann
            data = dict(data)
            data['image_id'] = image_id
            self.predictions.append(data)
            kps = data.get('keypoints')
            kps = np.asarray(kps, np.float32).reshape(-1, 3) \
                if kps is not None else None
            dts.append(DtInstance(
                keypoints=kps,
                bbox=np.asarray(data.get('bbox', (0, 0, 0, 0)), np.float32),
                score=float(data['score']),
                category_id=data.get('category_id', 1)))

        if self.ground_truth_from_loader:
            gts = []
            for gt_ann in (ground_truth or []):
                if hasattr(gt_ann, 'data'):
                    kps = np.asarray(gt_ann.data, np.float32)
                    bbox = gt_ann.bbox()
                    area = float(bbox[2] * bbox[3])
                    gts.append(GtInstance(
                        keypoints=kps, bbox=np.asarray(bbox, np.float32),
                        area=area,
                        iscrowd=getattr(gt_ann, 'iscrowd', False)))
            self.eval.add_image(image_id, dts, gts)
        else:
            self.eval.add_image(image_id, dts,
                                self.gt_by_image.get(image_id, []),
                                group=self.group_by_image.get(image_id))

    def stats(self) -> dict:
        results = self.eval.summarize()
        if self.crowd_index_groups:
            stats = [results['AP'], results['AP0.5'], results['AP0.75'],
                     results.get('AP.E', -1.0), results.get('AP.M', -1.0),
                     results.get('AP.H', -1.0),
                     results['AR'], results['AR0.5'], results['AR0.75']]
        elif self.iou_type == 'keypoints':
            stats = [results['AP'], results['AP0.5'], results['AP0.75'],
                     results['APM'], results['APL'],
                     results['AR'], results['AR0.5'], results['AR0.75'],
                     results['ARM'], results['ARL']]
        else:
            stats = [results['AP'], results['AP0.5'], results['AP0.75'],
                     results['APS'], results['APM'], results['APL'],
                     results['AR'], results['AR0.5'], results['AR0.75'],
                     results['ARS'], results['ARM'], results['ARL']]
        return {
            'stats': stats,
            'text_labels': self.text_labels,
            'n_images': len(self.image_ids),
        }

    def predictions_json(self) -> List[dict]:
        return self.predictions
