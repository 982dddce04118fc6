"""Numpy reimplementation of COCO keypoint/bbox evaluation.

Port copy of ``openpifpaf_tpu/metric/cocoeval.py``, bbox included.
Reference parity: the reference wraps ``pycocotools.COCOeval``
(``src/openpifpaf/metric/coco.py:~20``); the protocol is reimplemented:
OKS (keypoints) / IoU (bbox) matching at thresholds 0.5:0.05:0.95, greedy
per-image matching in score order with ignore regions and crowd handling,
101-point interpolated precision, area ranges all/medium/large (and small
for bbox) and the standard 10-number summary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)

AREA_RANGES_KP = {
    'all': (0.0, 1e10),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}
AREA_RANGES_BBOX = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}


@dataclasses.dataclass
class GtInstance:
    keypoints: Optional[np.ndarray]  # (K, 3) or None for bbox-only
    bbox: np.ndarray                 # (4,) xywh
    area: float
    iscrowd: bool
    category_id: int = 1


@dataclasses.dataclass
class DtInstance:
    keypoints: Optional[np.ndarray]
    bbox: np.ndarray
    score: float
    category_id: int = 1


def oks(dt_kps: np.ndarray, gt: GtInstance, sigmas: np.ndarray) -> float:
    """Object keypoint similarity (pycocotools computeOks semantics)."""
    g = gt.keypoints
    v = g[:, 2]
    k1 = int((v > 0).sum())
    variances = (2.0 * sigmas) ** 2
    if k1 > 0:
        d2 = (dt_kps[:, 0] - g[:, 0]) ** 2 + (dt_kps[:, 1] - g[:, 1]) ** 2
        e = d2 / variances / (gt.area + np.spacing(1)) / 2.0
        return float(np.mean(np.exp(-e[v > 0])))
    # no labeled keypoints: measure against the expanded bbox (pycocotools)
    x0, y0, w, h = gt.bbox
    x1, y1 = x0 + w, y0 + h
    x0, y0 = x0 - w, y0 - h
    x1, y1 = x1 + w, y1 + h
    dx = np.maximum(0.0, np.maximum(x0 - dt_kps[:, 0], dt_kps[:, 0] - x1))
    dy = np.maximum(0.0, np.maximum(y0 - dt_kps[:, 1], dt_kps[:, 1] - y1))
    e = (dx ** 2 + dy ** 2) / variances / (gt.area + np.spacing(1)) / 2.0
    return float(np.mean(np.exp(-e)))


def bbox_iou(dt_bbox: np.ndarray, gt: GtInstance) -> float:
    x0 = max(dt_bbox[0], gt.bbox[0])
    y0 = max(dt_bbox[1], gt.bbox[1])
    x1 = min(dt_bbox[0] + dt_bbox[2], gt.bbox[0] + gt.bbox[2])
    y1 = min(dt_bbox[1] + dt_bbox[3], gt.bbox[1] + gt.bbox[3])
    inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    da = dt_bbox[2] * dt_bbox[3]
    union = da + gt.area - inter if not gt.iscrowd else da
    return float(inter / max(union, 1e-9))


@dataclasses.dataclass
class _ImgEval:
    dt_scores: np.ndarray     # (D,)
    dt_matches: np.ndarray    # (T, D) matched gt flag (1 = matched)
    dt_ignore: np.ndarray     # (T, D)
    gt_ignore: np.ndarray     # (G,)


def _dt_area(dt: DtInstance, iou_type: str) -> float:
    """Detection area for area-range ignores.

    pycocotools ``loadRes`` derives keypoint-result areas from the tight
    extent over all keypoint coordinates; bbox results use w*h.
    """
    if iou_type == 'keypoints' and dt.keypoints is not None:
        x, y = dt.keypoints[:, 0], dt.keypoints[:, 1]
        return float((x.max() - x.min()) * (y.max() - y.min()))
    return float(dt.bbox[2] * dt.bbox[3])


def evaluate_image(dts: List[DtInstance], gts: List[GtInstance], *,
                   sigmas: Optional[np.ndarray], area_range,
                   max_dets: int, iou_type: str) -> Optional[_ImgEval]:
    if not dts and not gts:
        return None
    gt_ignore_base = np.array([
        g.iscrowd or not (area_range[0] <= g.area <= area_range[1])
        or (iou_type == 'keypoints'
            and g.keypoints is not None and (g.keypoints[:, 2] > 0).sum() == 0)
        for g in gts], bool)
    # sort: non-ignored gts first (pycocotools matching preference)
    g_order = np.argsort(gt_ignore_base, kind='stable')
    gts = [gts[i] for i in g_order]
    gt_ignore_base = gt_ignore_base[g_order]

    d_order = np.argsort([-d.score for d in dts], kind='stable')[:max_dets]
    dts = [dts[i] for i in d_order]

    t_n = len(IOU_THRESHOLDS)
    d_n = len(dts)
    g_n = len(gts)
    ious = np.zeros((d_n, g_n))
    for di, dt in enumerate(dts):
        for gi, gt in enumerate(gts):
            if iou_type == 'keypoints':
                ious[di, gi] = oks(dt.keypoints, gt, sigmas)
            else:
                ious[di, gi] = bbox_iou(dt.bbox, gt)

    dt_matches = np.zeros((t_n, d_n))
    dt_ignore = np.zeros((t_n, d_n), bool)
    gt_matched = np.zeros((t_n, g_n), bool)
    for ti, t in enumerate(IOU_THRESHOLDS):
        for di in range(d_n):
            best_iou = min(t, 1 - 1e-10)
            best_gi = -1
            for gi in range(g_n):
                if gt_matched[ti, gi] and not gts[gi].iscrowd:
                    continue
                # stop at ignored gts once a non-ignored match exists
                if best_gi > -1 and not gt_ignore_base[best_gi] \
                        and gt_ignore_base[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best_gi = gi
            if best_gi == -1:
                continue
            dt_ignore[ti, di] = gt_ignore_base[best_gi]
            dt_matches[ti, di] = 1
            gt_matched[ti, best_gi] = True

    # pycocotools: unmatched detections outside the area range don't count
    # as false positives for that range
    dt_out_of_range = np.array([
        not (area_range[0] <= _dt_area(d, iou_type) <= area_range[1])
        for d in dts], bool)
    dt_ignore |= (dt_matches == 0) & dt_out_of_range[None, :]

    return _ImgEval(
        dt_scores=np.array([d.score for d in dts]),
        dt_matches=dt_matches,
        dt_ignore=dt_ignore,
        gt_ignore=gt_ignore_base,
    )


def accumulate(per_image: List[Optional[_ImgEval]]):
    """PR accumulation (pycocotools accumulate): returns (AP(T), AR(T))."""
    evals = [e for e in per_image if e is not None]
    t_n = len(IOU_THRESHOLDS)
    if not evals:
        return np.full(t_n, -1.0), np.full(t_n, -1.0)
    scores = np.concatenate([e.dt_scores for e in evals])
    order = np.argsort(-scores, kind='mergesort')
    matches = np.concatenate([e.dt_matches for e in evals], axis=1)[:, order]
    ignores = np.concatenate([e.dt_ignore for e in evals], axis=1)[:, order]
    n_gt = int(sum((~e.gt_ignore).sum() for e in evals))
    if n_gt == 0:
        return np.full(t_n, -1.0), np.full(t_n, -1.0)

    ap = np.zeros(t_n)
    ar = np.zeros(t_n)
    for ti in range(t_n):
        keep = ~ignores[ti]
        m = matches[ti][keep]
        tp = np.cumsum(m)
        fp = np.cumsum(1 - m)
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, np.spacing(1))
        # make precision monotonically decreasing
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        # 101-point interpolation
        idx = np.searchsorted(recall, RECALL_THRESHOLDS, side='left')
        q = np.zeros(len(RECALL_THRESHOLDS))
        valid = idx < len(precision)
        q[valid] = precision[idx[valid]]
        ap[ti] = q.mean()
        ar[ti] = recall[-1] if len(recall) else 0.0
    return ap, ar


class CocoEval:
    """Full evaluation over a prediction/ground-truth set."""

    def __init__(self, *, iou_type: str = 'keypoints',
                 sigmas: Optional[Sequence[float]] = None,
                 max_dets: int = 20):
        self.iou_type = iou_type
        self.sigmas = np.asarray(sigmas, np.float64) \
            if sigmas is not None else None
        self.max_dets = max_dets
        self.images: Dict[int, dict] = {}

    def add_image(self, image_id, dts: List[DtInstance],
                  gts: List[GtInstance], group: Optional[str] = None) -> None:
        """``group`` tags the image for an optional grouped breakdown
        (CrowdPose crowd-index bands: results gain ``AP.{group}``)."""
        self.images[image_id] = {'dts': dts, 'gts': gts, 'group': group}

    def summarize(self) -> Dict[str, float]:
        area_ranges = (AREA_RANGES_KP if self.iou_type == 'keypoints'
                       else AREA_RANGES_BBOX)
        results = {}
        ap_all = ar_all = None
        for range_name, area_range in area_ranges.items():
            per_image = [
                evaluate_image(img['dts'], img['gts'], sigmas=self.sigmas,
                               area_range=area_range, max_dets=self.max_dets,
                               iou_type=self.iou_type)
                for img in self.images.values()
            ]
            ap, ar = accumulate(per_image)
            suffix = '' if range_name == 'all' else range_name[0].upper()
            valid_ap = ap[ap > -1]
            valid_ar = ar[ar > -1]
            results[f'AP{suffix}'] = float(valid_ap.mean()) if len(valid_ap) else -1.0
            results[f'AR{suffix}'] = float(valid_ar.mean()) if len(valid_ar) else -1.0
            if range_name == 'all':
                ap_all, ar_all = ap, ar
        results['AP0.5'] = float(ap_all[0]) if ap_all[0] > -1 else -1.0
        results['AP0.75'] = float(ap_all[5]) if ap_all[5] > -1 else -1.0
        results['AR0.5'] = float(ar_all[0]) if ar_all[0] > -1 else -1.0
        results['AR0.75'] = float(ar_all[5]) if ar_all[5] > -1 else -1.0

        # per-group breakdown over the 'all' area range (crowdposetools
        # reports AP(easy/medium/hard) by per-image crowd index)
        groups = sorted({img['group'] for img in self.images.values()
                         if img['group'] is not None})
        area_all = area_ranges['all']
        for group in groups:
            per_image = [
                evaluate_image(img['dts'], img['gts'], sigmas=self.sigmas,
                               area_range=area_all, max_dets=self.max_dets,
                               iou_type=self.iou_type)
                for img in self.images.values() if img['group'] == group
            ]
            ap, ar = accumulate(per_image)
            valid_ap = ap[ap > -1]
            valid_ar = ar[ar > -1]
            results[f'AP.{group}'] = (float(valid_ap.mean())
                                      if len(valid_ap) else -1.0)
            results[f'AR.{group}'] = (float(valid_ar.mean())
                                      if len(valid_ar) else -1.0)
        return results
