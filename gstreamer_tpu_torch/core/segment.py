"""Segments: stream-time / running-time arithmetic (host only).

A copy of the JAX package's ``core/segment.py`` (reference:
subprojects/gstreamer/gst/gstsegment.c — gst_segment_to_running_time :330):
plain Python integer math in nanoseconds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .buffer import CLOCK_TIME_NONE


@dataclass
class Segment:
    fmt: str = "time"
    rate: float = 1.0
    applied_rate: float = 1.0
    base: int = 0
    offset: int = 0
    start: int = 0
    stop: int = CLOCK_TIME_NONE
    time: int = 0
    position: int = 0
    duration: int = CLOCK_TIME_NONE

    def clip(self, start: int, stop: Optional[int]):
        """gst_segment_clip: None when the range is fully outside."""
        if self.stop != CLOCK_TIME_NONE and start >= self.stop:
            return None
        if stop is not None and stop <= self.start:
            return None
        cstart = max(start, self.start)
        cstop = stop
        if self.stop != CLOCK_TIME_NONE:
            cstop = min(stop, self.stop) if stop is not None else self.stop
        return (cstart, cstop)

    def to_running_time(self, position: int) -> int:
        """gst_segment_to_running_time (gstsegment.c:330), forward rate."""
        if position == CLOCK_TIME_NONE:
            return CLOCK_TIME_NONE
        start = self.start + self.offset
        if self.rate > 0.0:
            if position < start:
                return CLOCK_TIME_NONE
            ret = int((position - start) / abs(self.rate))
        else:
            stop = self.stop
            if stop == CLOCK_TIME_NONE or position > stop:
                return CLOCK_TIME_NONE
            ret = int((stop - position) / abs(self.rate))
        return ret + self.base

    def to_stream_time(self, position: int) -> int:
        if position == CLOCK_TIME_NONE:
            return CLOCK_TIME_NONE
        start = self.start + self.offset
        if position < start:
            return CLOCK_TIME_NONE
        return int((position - start) * abs(self.applied_rate)) + self.time
