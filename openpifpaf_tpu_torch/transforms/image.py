"""The tensor boundary: port of ``ImageToNumpy``
(``openpifpaf_tpu/transforms/image.py:63-73``).

The JAX transform turns a PIL image into a normalized (H, W, 3) array; this
one turns a (3, H, W) tensor in uint8 levels into a normalized (3, H, W)
float32 tensor (``eval.normalize``), the layout the port's model takes.
"""

from __future__ import annotations

from .base import Preprocess
from .eval import normalize


class ImageToTensor(Preprocess):
    def __call__(self, image, anns, meta):
        meta = Preprocess.init_meta(image, meta)
        return normalize(image), anns, meta
