"""Predictor: batched inference API — preprocess, forward, decode.

Port of the predict path of ``openpifpaf_tpu/predictor.py`` (``:200-238``).
Reference parity: ``src/openpifpaf/predictor.py:~60``.  Images enter as
NHWC numpy arrays (``(H, W, 3)`` uint8 each), are rescaled and centre
padded to one square size, run through the model (NCHW inside) and the
batched CifCaf decode on the same device, and the annotations are mapped
back to the original image coordinates.  Multi-scale, hflip and
data-parallel eval are not ported yet.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import decoder as decoder_mod, models, transforms
from .device import resolve_device


class Predictor:
    batch_size = 1
    long_edge = 641

    def __init__(self, *, checkpoint: Optional[str] = None,
                 model: Optional[models.Model] = None,
                 base_name: Optional[str] = None, head_metas=None,
                 json_data: bool = False, device=None, bf16: bool = True,
                 seed: int = 0):
        """``device=None`` means the card (raises without CUDA).  The model
        is ``model``, else a JAX-package ``checkpoint`` npz, else a fresh
        ``base_name`` model with weights from ``seed``."""
        self.device = resolve_device(device)
        if model is None:
            model = models.factory(base_name, head_metas,
                                   checkpoint=checkpoint, bf16=bf16,
                                   device=self.device, seed=seed)
        elif model.device != self.device:
            raise ValueError(f'model on {model.device}, predictor on '
                             f'{self.device}')
        self.model = model
        self.decoder = decoder_mod.factory(model.head_metas,
                                           device=self.device)
        self.json_data = json_data
        self.last_preprocess_time = 0.0
        self.last_nn_time = 0.0
        self.last_decoder_time = 0.0

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def preprocess(self, images: Sequence[np.ndarray]):
        """NHWC images -> ((B, 3, S, S) float32 on the device, metas)."""
        out = [transforms.preprocess(im, self.long_edge, self.device)
               for im in images]
        return torch.stack([t for t, _ in out]), [m for _, m in out]

    def batch(self, images: Sequence[np.ndarray]) -> List[Tuple[List, dict]]:
        """Predict one batch: a list of (annotations, meta) per image, the
        annotations in original image coordinates (json dicts with
        ``json_data``).  Times each stage, synchronizing the card."""
        start = time.perf_counter()
        x, metas = self.preprocess(images)
        self._sync()
        self.last_preprocess_time = time.perf_counter() - start

        start = time.perf_counter()
        fields = self.model(x)
        self._sync()
        self.last_nn_time = time.perf_counter() - start

        start = time.perf_counter()
        pred_batch = self.decoder.batch_fields(fields, metas=metas)
        self.last_decoder_time = time.perf_counter() - start

        results = []
        for preds, meta in zip(pred_batch, metas):
            preds = [ann.inverse_transform(meta) for ann in preds]
            if self.json_data:
                preds = [ann.json_data() for ann in preds]
            results.append((preds, meta))
        return results

    def numpy_images(self, images) -> Iterator[Tuple[List, List, dict]]:
        """Yields ``(predictions, ground_truth=[], meta)`` per image, as
        the JAX ``Predictor.numpy_images`` does."""
        images = list(images)
        for i in range(0, len(images), self.batch_size):
            for preds, meta in self.batch(images[i:i + self.batch_size]):
                yield preds, [], meta

    def numpy_image(self, image):
        return next(iter(self.numpy_images([image])))
