"""TestClock — deterministic manually-advanced clock.

A copy of the JAX package's ``check/testclock.py``: the equivalent of
GstTestClock (reference:
subprojects/gstreamer/libs/gst/check/gsttestclock.c:1256 lines) — used to
test timing logic (videorate, aggregator timeouts) without real time.
"""

from __future__ import annotations

from typing import List, Tuple


class TestClock:
    def __init__(self, start_time: int = 0):
        self._time = start_time
        self._waits: List[Tuple[int, object]] = []

    def get_time(self) -> int:
        return self._time

    def set_time(self, t: int) -> None:
        if t < self._time:
            raise ValueError("time must be monotonic")
        self._time = t

    def advance_time(self, delta: int) -> None:
        self.set_time(self._time + delta)

    def new_single_shot_id(self, t: int):
        entry = {"time": t, "fired": False}
        self._waits.append((t, entry))
        return entry

    def process_next_clock_id(self):
        if not self._waits:
            return None
        self._waits.sort(key=lambda x: x[0])
        t, entry = self._waits.pop(0)
        self._time = max(self._time, t)
        entry["fired"] = True
        return entry
