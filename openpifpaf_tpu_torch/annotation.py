"""In-memory pose and detection annotation objects (numpy).

Port copy of ``openpifpaf_tpu/annotation.py``.  Reference parity:
``src/openpifpaf/annotation.py`` — ``Annotation`` holds a ``(K, 3)`` xyv
array plus per-joint scales, computes a weighted score and emits
COCO-format ``json_data()`` (coordinates rounded to 2 decimals);
``AnnotationDet`` is a decoded box, ``AnnotationCrowd`` a crowd region of
the ground truth.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class Base:
    """Common interface for annotation types."""

    def json_data(self):
        raise NotImplementedError

    def inverse_transform(self, meta):
        raise NotImplementedError


def _inverse_transform_bbox(bbox, meta) -> np.ndarray:
    """(x, y, w, h) back to the original image: undo offset and scale, then
    mirror on the original canvas when the image was flipped."""
    bbox = np.array(bbox, dtype=np.float32)
    bbox[:2] += np.asarray(meta['offset'], dtype=np.float32)
    bbox[0] /= meta['scale'][0]
    bbox[1] /= meta['scale'][1]
    bbox[2] /= meta['scale'][0]
    bbox[3] /= meta['scale'][1]
    if meta.get('hflip', False):
        w = meta.get('original_width_height', meta['width_height'])[0]
        bbox[0] = -(bbox[0] + bbox[2]) + (w - 1)
    return bbox


class Annotation(Base):
    """A single decoded pose.

    ``data`` is a ``(K, 3)`` float array of (x, y, v) per keypoint where v is
    the confidence (0 = not detected).  ``joint_scales`` is a ``(K,)`` array
    of per-joint scales (pixels) used for occupancy and OKS-style scoring.
    """

    def __init__(self, keypoints: Sequence[str],
                 skeleton: Sequence[Tuple[int, int]],
                 *,
                 sigmas: Optional[Sequence[float]] = None,
                 score_weights: Optional[Sequence[float]] = None,
                 categories: Optional[Sequence[str]] = None,
                 category_id: int = 1,
                 suppress_score_index: Optional[int] = None):
        self.keypoints = list(keypoints)
        self.skeleton = [tuple(s) for s in skeleton]
        self.sigmas = (np.asarray(sigmas, dtype=np.float32)
                       if sigmas is not None else None)
        self.categories = categories
        self.category_id = category_id
        # a keypoint whose confidence the score leaves out
        self.suppress_score_index = suppress_score_index

        n = len(self.keypoints)
        self.data = np.zeros((n, 3), dtype=np.float32)
        self.joint_scales = np.zeros((n,), dtype=np.float32)
        self.fixed_score: Optional[float] = None
        # ground truth (training transforms): crowd flag and the dataset's box
        self.iscrowd = False
        self.fixed_bbox: Optional[np.ndarray] = None
        self.id_: int = -1  # tracking id

        if score_weights is not None:
            score_weights = np.asarray(score_weights, dtype=np.float32)
        else:
            score_weights = np.ones((n,), dtype=np.float32)
        self.score_weights = score_weights

    @property
    def score(self) -> float:
        """Weighted pose score: confidences sorted descending, weighted by
        ``score_weights`` and normalized by the weight sum; the keypoint
        ``suppress_score_index`` counts as 0."""
        if self.fixed_score is not None:
            return float(self.fixed_score)
        v = self.data[:, 2].copy()
        if self.suppress_score_index is not None:
            v[self.suppress_score_index] = 0.0
        v_sorted = np.sort(v)[::-1]
        return float((v_sorted * self.score_weights).sum()
                     / max(1e-8, self.score_weights.sum()))

    def bbox(self) -> np.ndarray:
        """(x, y, w, h): the fixed box if set, else from the valid joints,
        expanded by joint scales."""
        if self.fixed_bbox is not None:
            return np.asarray(self.fixed_bbox, dtype=np.float32)
        m = self.data[:, 2] > 0.0
        if not np.any(m):
            return np.zeros((4,), dtype=np.float32)
        s = np.maximum(self.joint_scales[m], 2.0)
        x = np.min(self.data[m, 0] - s)
        y = np.min(self.data[m, 1] - s)
        w = np.max(self.data[m, 0] + s) - x
        h = np.max(self.data[m, 1] + s) - y
        return np.array([x, y, w, h], dtype=np.float32)

    def json_data(self, coordinate_digits: int = 2) -> dict:
        """COCO-result-format dict (same rounding as the reference)."""
        kps = np.copy(self.data)
        kps[kps[:, 2] == 0.0, :2] = 0.0
        data = {
            'keypoints': np.around(kps, coordinate_digits).reshape(-1).tolist(),
            'bbox': [round(float(c), coordinate_digits) for c in self.bbox()],
            'score': max(0.001, round(float(self.score), 3)),
            'category_id': self.category_id,
        }
        if self.id_ >= 0:
            data['id_'] = self.id_
        return data

    def inverse_transform(self, meta) -> 'Annotation':
        """Map back to original image coordinates using transform meta
        (``x_original = (x_transformed + offset) / scale``), then undo a
        rotation (``RotateBy90``, ``RotateUniform``) and a horizontal flip
        (mirror on the original canvas, swap left/right rows)."""
        ann = self.copy()
        ann.data[:, 0] += meta['offset'][0]
        ann.data[:, 1] += meta['offset'][1]
        ann.data[:, 0] /= meta['scale'][0]
        ann.data[:, 1] /= meta['scale'][1]
        ann.joint_scales /= meta['scale'][0]

        rotation = meta.get('rotation')
        if isinstance(rotation, dict) and rotation.get('angle', 0.0):
            rw, rh = rotation['width'], rotation['height']
            ow = rotation.get('orig_width', rw)
            oh = rotation.get('orig_height', rh)
            ang = np.radians(rotation['angle'])
            rot = np.array([[np.cos(ang), -np.sin(ang)],
                            [np.sin(ang), np.cos(ang)]], dtype=np.float32)
            c_new = np.array([(rw - 1) / 2.0, (rh - 1) / 2.0], np.float32)
            c_old = np.array([(ow - 1) / 2.0, (oh - 1) / 2.0], np.float32)
            ann.data[:, :2] = (ann.data[:, :2] - c_new) @ rot.T + c_old

        if meta.get('hflip', False):
            # after undoing offset/scale the frame is the original canvas
            w = meta.get('original_width_height', meta['width_height'])[0]
            ann.data[:, 0] = -ann.data[:, 0] + (w - 1)
            if meta.get('horizontal_swap') is not None:
                ann.data[:] = meta['horizontal_swap'](ann.data)
        return ann

    def copy(self) -> 'Annotation':
        out = Annotation(self.keypoints, self.skeleton, sigmas=self.sigmas,
                         score_weights=self.score_weights,
                         categories=self.categories,
                         category_id=self.category_id,
                         suppress_score_index=self.suppress_score_index)
        out.data = np.copy(self.data)
        out.joint_scales = np.copy(self.joint_scales)
        out.fixed_score = self.fixed_score
        out.iscrowd = self.iscrowd
        out.id_ = self.id_
        out.fixed_bbox = (None if self.fixed_bbox is None
                          else np.copy(self.fixed_bbox))
        return out

    def __repr__(self):
        return (f'Annotation(category_id={self.category_id}, '
                f'score={self.score:.3f}, '
                f'n_visible={int((self.data[:, 2] > 0).sum())})')


class AnnotationDet(Base):
    """A single decoded detection box, (x, y, w, h) in pixels."""

    def __init__(self, categories: Sequence[str]):
        self.categories = list(categories)
        self.category_id: Optional[int] = None
        self.score: float = 0.0
        self.bbox: Optional[np.ndarray] = None

    def set(self, category_id: int, score: float, bbox) -> 'AnnotationDet':
        self.category_id = int(category_id)
        self.score = float(score)
        self.bbox = np.asarray(bbox, dtype=np.float32)
        return self

    @property
    def category(self) -> str:
        return self.categories[self.category_id - 1]

    def json_data(self) -> dict:
        return {
            'category_id': self.category_id,
            'category': self.category,
            'score': max(0.001, round(float(self.score), 3)),
            'bbox': [round(float(c), 2) for c in self.bbox],
        }

    def inverse_transform(self, meta) -> 'AnnotationDet':
        return AnnotationDet(self.categories).set(
            self.category_id, self.score,
            _inverse_transform_bbox(self.bbox, meta))

    def __repr__(self):
        return (f'AnnotationDet(category_id={self.category_id}, '
                f'score={self.score:.3f})')


class AnnotationCrowd(Base):
    """A crowd region of the ground truth (never decoded)."""

    def __init__(self, categories: Sequence[str]):
        self.categories = list(categories)
        self.category_id: Optional[int] = None
        self.bbox: Optional[np.ndarray] = None

    def set(self, category_id: int, bbox) -> 'AnnotationCrowd':
        self.category_id = int(category_id)
        self.bbox = np.asarray(bbox, dtype=np.float32)
        return self

    @property
    def category(self) -> str:
        return self.categories[self.category_id - 1]

    def json_data(self) -> dict:
        return {
            'category_id': self.category_id,
            'category': self.category,
            'iscrowd': 1,
            'bbox': [round(float(c), 2) for c in self.bbox],
        }

    def inverse_transform(self, meta) -> 'AnnotationCrowd':
        return AnnotationCrowd(self.categories).set(
            self.category_id, _inverse_transform_bbox(self.bbox, meta))

    def __repr__(self):
        return f'AnnotationCrowd(category_id={self.category_id})'
