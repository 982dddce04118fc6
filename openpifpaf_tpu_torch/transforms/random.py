"""Random composition.

Port of ``RandomApply`` of ``openpifpaf_tpu/transforms/random.py``,
drawing from the generator it is given.
"""

from __future__ import annotations

import numpy as np

from .base import Preprocess


class RandomApply(Preprocess):
    def __init__(self, transform, probability, *, rng: np.random.Generator):
        self.transform = transform
        self.probability = probability
        self.rng = rng

    def __call__(self, image, anns, meta):
        if self.rng.random() > self.probability:
            return image, anns, Preprocess.init_meta(image, meta)
        return self.transform(image, anns, meta)
