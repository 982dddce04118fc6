"""Loader wrapper that signals consumers on every fresh iteration.

Port copy of ``openpifpaf_tpu/datasets/loader_with_reset.py``.  Reference
parity: ``src/openpifpaf/datasets/loader_with_reset.py`` — whenever
iteration restarts (a new sequence or a new epoch), the ``eval_reset``
signal fires so that stateful consumers (``TrackingPose``,
``PoseSimilarity``) clear their state.
"""

from __future__ import annotations

from ..signal_ import Signal


class LoaderWithReset:
    """Wraps any iterable of batches; emits ``eval_reset`` on every fresh
    iteration."""

    def __init__(self, loader, signal_name: str = 'eval_reset'):
        self.loader = loader
        self.signal_name = signal_name

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        Signal.emit(self.signal_name)
        yield from self.loader
