"""Tiny publish/subscribe signal bus.

Port copy of ``openpifpaf_tpu/signal_.py`` (standard library only).
Reference parity: ``src/openpifpaf/signal_.py:~5`` — stateful consumers
(the tracking decoders) subscribe to events such as ``'eval_reset'``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List


class Signal:
    subscribers: Dict[str, List[Callable]] = defaultdict(list)

    @classmethod
    def subscribe(cls, name: str, subscriber: Callable) -> None:
        cls.subscribers[name].append(subscriber)

    @classmethod
    def emit(cls, name: str, *args, **kwargs) -> None:
        for subscriber in cls.subscribers[name]:
            subscriber(*args, **kwargs)
