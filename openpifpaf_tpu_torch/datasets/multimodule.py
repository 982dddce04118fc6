"""Multi-dataset training: several data modules behind one model.

Port of ``openpifpaf_tpu/datasets/multimodule.py``.  Reference parity:
``src/openpifpaf/datasets/multimodule.py:~40``: the head metas of all
modules are merged in order and their loaders round-robined.  Each batch
carries targets only for its own module's heads; the other heads' target
slots are ``None`` and give zero loss (``losses/multi_head.py``), while the
model still computes every head.
"""

from __future__ import annotations

from typing import List, Sequence

from .module import DataModule


class MultiDataModule(DataModule):
    def __init__(self, datamodules: Sequence[DataModule]):
        self.datamodules = list(datamodules)
        self.head_metas = [m for dm in self.datamodules for m in dm.head_metas]
        # each module's first head in the merged head list
        self._offsets = []
        offset = 0
        for dm in self.datamodules:
            self._offsets.append(offset)
            offset += len(dm.head_metas)
        self._n_heads = offset

    @property
    def seed(self):
        return self.datamodules[0].seed

    @seed.setter
    def seed(self, value):
        for dm in self.datamodules:
            dm.seed = value

    def metrics(self) -> List:
        return [metric for dm in self.datamodules for metric in dm.metrics()]

    def _pad_targets(self, module_i: int, targets):
        """One module's target tuple aligned with the merged head list."""
        padded = [None] * self._n_heads
        offset = self._offsets[module_i]
        for i, t in enumerate(targets):
            padded[offset + i] = t
        return tuple(padded)

    def _round_robin(self, loaders):
        iterators = [iter(loader) for loader in loaders]
        active = list(range(len(iterators)))
        while active:
            for i in list(active):
                try:
                    images, targets, metas = next(iterators[i])
                except StopIteration:
                    active.remove(i)
                    continue
                yield images, self._pad_targets(i, targets), metas

    def _concat(self, loaders):
        return _RoundRobin(self, loaders)

    def train_loader(self):
        return self._concat([dm.train_loader() for dm in self.datamodules])

    def val_loader(self):
        return self._concat([dm.val_loader() for dm in self.datamodules])

    def eval_loader(self, *, long_edge=None, hflip=False):
        raise NotImplementedError('evaluate each datamodule separately')


class _RoundRobin:
    """The modules' loaders, one batch of each in turn, as one loader."""

    def __init__(self, multi: MultiDataModule, loaders):
        self.multi = multi
        self.loaders = loaders

    def __len__(self):
        return sum(len(loader) for loader in self.loaders)

    def __iter__(self):
        return self.multi._round_robin(self.loaders)  # pylint: disable=protected-access
