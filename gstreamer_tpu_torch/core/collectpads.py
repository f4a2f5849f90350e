"""CollectPads + DataQueue — N:1 synchronization primitives.

TPU-native equivalents of GstCollectPads (reference:
subprojects/gstreamer/libs/gst/base/gstcollectpads.c, 2319 LoC — muxers
wait until every pad has a buffer, then pop the set) and
GstDataQueue/GstVecDeque (gstdataqueue.c:812 — bounded thread-safe
queue with fullness predicates).

In the batched runtime CollectPads is a host-side gather helper used by
aggregator-style elements whose inputs arrive on independent schedules;
DataQueue backs host-side producer/consumer decoupling (the native
prefetch loader hands off through one).

A copy of the JAX package's ``core/collectpads.py`` (host only).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional


class CollectPads:
    """Collect one buffer per registered pad; `peek_collected()` returns
    the full set once every pad has data (gst_collect_pads_peek model).
    Pads that reached EOS are excluded from the wait."""

    def __init__(self):
        self._queues: Dict[str, deque] = {}
        self._eos: Dict[str, bool] = {}

    def add_pad(self, name: str) -> None:
        self._queues[name] = deque()
        self._eos[name] = False

    def remove_pad(self, name: str) -> None:
        self._queues.pop(name, None)
        self._eos.pop(name, None)

    def chain(self, name: str, buf) -> None:
        self._queues[name].append(buf)

    def eos(self, name: str) -> None:
        self._eos[name] = True

    @property
    def all_eos(self) -> bool:
        return all(self._eos.values()) if self._eos else False

    def ready(self) -> bool:
        return all(q or self._eos[n] for n, q in self._queues.items()) \
            and any(self._queues.values())

    def peek_collected(self) -> Optional[Dict[str, Any]]:
        if not self.ready():
            return None
        return {n: (q[0] if q else None) for n, q in self._queues.items()}

    def pop_collected(self) -> Optional[Dict[str, Any]]:
        got = self.peek_collected()
        if got is None:
            return None
        for n, q in self._queues.items():
            if q:
                q.popleft()
        return got


class DataQueue:
    """Bounded thread-safe queue (gstdataqueue.c): push blocks when the
    fullness predicate holds, pop blocks when empty; set_flushing wakes
    both sides."""

    def __init__(self, max_items: int = 0,
                 full_func: Optional[Callable[[int], bool]] = None):
        self._items: deque = deque()
        self._max = max_items
        self._full = full_func or (
            (lambda n: n >= max_items) if max_items else (lambda n: False))
        self._cv = threading.Condition()
        self._flushing = False

    def push(self, item, timeout: Optional[float] = None) -> bool:
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._flushing or not self._full(len(self._items)),
                timeout)
            if not ok or self._flushing:
                return False
            self._items.append(item)
            self._cv.notify_all()
            return True

    def pop(self, timeout: Optional[float] = None):
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._flushing or bool(self._items), timeout)
            if not ok or (self._flushing and not self._items):
                return None
            if not self._items:
                return None
            item = self._items.popleft()
            self._cv.notify_all()
            return item

    def set_flushing(self, flushing: bool = True) -> None:
        with self._cv:
            self._flushing = flushing
            if flushing:
                self._items.clear()
            self._cv.notify_all()

    def __len__(self):
        with self._cv:
            return len(self._items)
