"""Random composition.

Port of ``openpifpaf_tpu/transforms/random.py``: ``RandomApply`` and
``RandomChoice`` draw from the generator they are given;
``DeterministicEqualChoice`` chooses by the dataset index.  Like the JAX
package, ``RandomChoice`` hands its probabilities to ``rng.choice`` as they
are, so probabilities that do not sum to 1 raise numpy's ``ValueError``
on the first call (cocokp's ``[orientation_invariant, 0.4]`` does for any
``--cocokp-orientation-invariant`` other than 0 and 0.6).
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


class RandomChoice(Preprocess):
    def __init__(self, transforms, probabilities=None, *,
                 rng: np.random.Generator):
        self.transforms = list(transforms)
        self.probabilities = probabilities
        self.rng = rng

    def __call__(self, image, anns, meta):
        i = self.rng.choice(len(self.transforms), p=self.probabilities)
        t = self.transforms[i]
        if t is None:
            return image, anns, Preprocess.init_meta(image, meta)
        return t(image, anns, meta)


class DeterministicEqualChoice(Preprocess):
    """Choose by the dataset index (stable across epochs, for val
    transforms)."""

    def __init__(self, transforms, salt=0):
        self.transforms = list(transforms)
        self.salt = salt

    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        i = (meta.get('dataset_index', 0) + self.salt) % len(self.transforms)
        t = self.transforms[i]
        if t is None:
            return image, anns, meta
        return t(image, anns, meta)
