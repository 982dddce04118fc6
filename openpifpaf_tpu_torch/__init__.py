"""openpifpaf_tpu_torch: the PyTorch/CUDA port of ``openpifpaf_tpu``.

The JAX package ``openpifpaf_tpu`` is the reference; this package rewrites
its predict, train and eval paths in PyTorch for an NVIDIA Hopper card.  Beside the
standard library it imports ``torch`` and ``numpy`` only — nothing of JAX,
flax, PIL or the JAX package — and keeps its own copies of the JAX package's framework-free
modules (``headmeta``, ``annotation``, ``plugins/coco/constants``).

Module names mirror the JAX package (``openpifpaf_tpu/ops/seeds.py`` ↔
``openpifpaf_tpu_torch/ops/seeds.py``).  Entry points run on the card
(``device=None`` means ``'cuda'``) unless the caller passes
``device='cpu'``, which selects each kernel's plain PyTorch version.
"""

__version__ = '0.1.0'
