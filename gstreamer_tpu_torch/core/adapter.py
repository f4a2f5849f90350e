"""GstAdapter equivalent — byte accumulator for re-chunking streams.

A copy of the JAX package's ``core/adapter.py`` (host numpy only).

Reference: subprojects/gstreamer/libs/gst/base/gstadapter.c (1808 LoC):
push/available/map/take/flush with PTS tracking
(gst_adapter_prev_pts:distance semantics).

Buffers here are numpy uint8 arrays (the byte-stream convention used by
filesrc's unknown-data mode); chunks are kept in a deque and coalesced
lazily on take/map — same strategy as the reference's GSList of
GstBuffers with a cached assembled region.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np


class Adapter:
    def __init__(self):
        self._chunks: deque = deque()     # (np.uint8 array, pts | None)
        self._size = 0
        self._skip = 0                    # consumed bytes of chunks[0]
        self._prev_pts: Optional[int] = None
        self._prev_pts_dist = 0           # bytes consumed since prev_pts

    # -- writing ------------------------------------------------------------
    def push(self, data, pts: Optional[int] = None):
        arr = np.asarray(data, np.uint8).ravel()
        if arr.size == 0:
            return
        self._chunks.append((arr, pts))
        self._size += arr.size

    def clear(self):
        self._chunks.clear()
        self._size = 0
        self._skip = 0
        self._prev_pts = None
        self._prev_pts_dist = 0

    # -- reading ------------------------------------------------------------
    def available(self) -> int:
        return self._size

    def map(self, nbytes: int) -> Optional[np.ndarray]:
        """Peek nbytes without consuming (gst_adapter_map)."""
        if nbytes > self._size:
            return None
        out = np.empty(nbytes, np.uint8)
        filled = 0
        skip = self._skip
        for arr, _pts in self._chunks:
            part = arr[skip:skip + (nbytes - filled)]
            out[filled:filled + part.size] = part
            filled += part.size
            skip = 0
            if filled == nbytes:
                break
        return out

    def take(self, nbytes: int) -> Optional[np.ndarray]:
        """Consume nbytes (gst_adapter_take)."""
        out = self.map(nbytes)
        if out is not None:
            self.flush(nbytes)
        return out

    def flush(self, nbytes: int):
        """Discard nbytes (gst_adapter_flush); tracks the timestamp of the
        last chunk boundary crossed and the distance past it."""
        assert nbytes <= self._size
        self._size -= nbytes
        while nbytes:
            arr, pts = self._chunks[0]
            if self._skip == 0 and pts is not None:
                self._prev_pts = pts
                self._prev_pts_dist = 0
            step = min(arr.size - self._skip, nbytes)
            self._skip += step
            nbytes -= step
            self._prev_pts_dist += step
            if self._skip == arr.size:
                self._chunks.popleft()
                self._skip = 0

    def prev_pts(self) -> Tuple[Optional[int], int]:
        """(pts, distance-in-bytes) of the last buffer boundary consumed
        (gst_adapter_prev_pts)."""
        return self._prev_pts, self._prev_pts_dist
