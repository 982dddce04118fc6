"""Frame-pair transforms for tracking training.

Port of ``openpifpaf_tpu/transforms/pair.py`` (``:25-158``).  Reference
parity: ``src/openpifpaf/transforms/pair.py`` and the single image to
pseudo-tracking conversion of ``plugins/posetrack/cocokpst.py:~30`` — a
single annotated image becomes a (previous, current) frame pair by a
simulated camera pan of a copy; track ids link the two frames' instances.
Applied after the single-frame augmentations and the tensor boundary, on
(3, H, W) float32 tensors.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .base import Preprocess, translate_annotations


class ImageToTracking(Preprocess):
    """(image, anns, meta) -> frame pair with simulated motion.

    The input image becomes frame t-1; frame t is a translated copy
    (camera pan, zeros shifted in).  Track ids are assigned per instance
    and shared across the pair.  ``max_instance_shift_px`` also offsets
    each frame-t annotation on its own, which its pixels cannot follow in
    a translated copy: label noise, so it defaults to 0 (the JAX
    docstring's caution).
    """

    def __init__(self, max_shift_px: float = 16.0,
                 max_instance_shift_px: float = 0.0, seed: int = None):
        self.max_shift_px = max_shift_px
        self.max_instance_shift_px = max_instance_shift_px
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _shift_image(image: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
        out = torch.zeros_like(image)
        h, w = image.shape[-2:]
        sx0, sx1 = max(0, -dx), min(w, w - dx)
        sy0, sy1 = max(0, -dy), min(h, h - dy)
        out[..., sy0 + dy:sy1 + dy, sx0 + dx:sx1 + dx] = \
            image[..., sy0:sy1, sx0:sx1]
        return out

    def __call__(self, image, anns, meta):
        anns1 = list(anns)
        for track_id, ann in enumerate(anns1):
            if ann.id_ < 0:
                ann.id_ = track_id

        dx = int(self.rng.uniform(-self.max_shift_px, self.max_shift_px))
        dy = int(self.rng.uniform(-self.max_shift_px, self.max_shift_px))
        image2 = self._shift_image(image, dx, dy)
        anns2 = copy.deepcopy(anns1)
        translate_annotations(anns2, dx, dy)
        h, w = image.shape[-2:]
        for ann in anns2:
            jitter = self.rng.uniform(-self.max_instance_shift_px,
                                      self.max_instance_shift_px, size=2)
            translate_annotations([ann], jitter[0], jitter[1])
            # out-of-frame keypoints are invisible in frame t
            out = ((ann.data[:, 0] < 0) | (ann.data[:, 0] >= w)
                   | (ann.data[:, 1] < 0) | (ann.data[:, 1] >= h))
            ann.data[out, 2] = 0.0

        meta = Preprocess.init_meta(image, meta)
        # every pseudo-pair is its own sequence: both frames come from one
        # image, so no track state may leak into the next item
        meta.setdefault('sequence_id', 'img{}'.format(
            meta.get('image_id', meta.get('dataset_index', id(anns1)))))
        return [image, image2], [anns1, anns2], meta


class SingleImage(Preprocess):
    """Apply a single-frame transform to each frame of a pair."""

    def __init__(self, transform: Preprocess):
        self.transform = transform

    def __call__(self, images, anns_pair, meta):
        out_images, out_anns = [], []
        out_meta = meta
        for image, anns in zip(images, anns_pair):
            image, anns, out_meta = self.transform(image, anns, dict(meta))
            out_images.append(image)
            out_anns.append(anns)
        return out_images, out_anns, out_meta


class SyncPair(Preprocess):
    """Apply a random single-frame transform to both frames of a pair with
    the same random draws: every ``np.random.Generator`` reachable from the
    wrapped transform is snapshotted before the first frame and restored
    before the second (reference ``transforms/pair.py:~20``)."""

    _CHILD_ATTRS = ('transform', 'transforms', 'preprocess',
                    'preprocess_list', 'frame_steps', 'pair_steps')

    def __init__(self, transform: Preprocess):
        self.transform = transform

    @classmethod
    def _generators(cls, root):
        found, seen = [], set()

        def visit(t):
            if t is None or id(t) in seen:
                return
            seen.add(id(t))
            rng = getattr(t, 'rng', None)
            if isinstance(rng, np.random.Generator) \
                    and not any(rng is g for g in found):
                found.append(rng)
            for name in cls._CHILD_ATTRS:
                child = getattr(t, name, None)
                if isinstance(child, (list, tuple)):
                    for c in child:
                        visit(c)
                elif child is not None and not isinstance(child, str):
                    visit(child)

        visit(root)
        return found

    def __call__(self, images, anns_pair, meta):
        rngs = self._generators(self.transform)
        states = [copy.deepcopy(r.bit_generator.state) for r in rngs]
        out_images, out_anns = [], []
        out_meta = dict(meta)
        for i, (image, anns) in enumerate(zip(images, anns_pair)):
            if i > 0:
                for r, s in zip(rngs, states):
                    r.bit_generator.state = copy.deepcopy(s)
            image, anns, out_meta = self.transform(image, anns, dict(meta))
            out_images.append(image)
            out_anns.append(anns)
        return out_images, out_anns, out_meta
