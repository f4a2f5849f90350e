"""BaseParse — frame-parser scaffold.

TPU-native equivalent of GstBaseParse (reference:
subprojects/gstreamer/libs/gst/base/gstbaseparse.c, 5239 LoC — the
gather/handle_frame/output loop documented at :60-150):

* input bytes accumulate in an Adapter;
* once at least `min_frame_size` bytes are available the subclass's
  `handle_frame(view)` inspects them and returns
  (frame_size, skip, finish) — skip discards leading garbage
  (sync search), finish=n emits the first n bytes as one framed buffer,
  frame_size=0 requests more data (optionally raising min_frame_size);
* timestamps interpolate from the byte position at the configured
  bitrate or frame duration (gst_base_parse_convert_default).

Host-boundary element: parsing is inherently sequential byte work; the
FRAMED output buffers carry device-ready payloads downstream.

A copy of the JAX package's ``core/baseparse.py``; the input bytes are
taken to the host (``host_array``) whatever device they arrive on.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .adapter import Adapter
from .buffer import Buffer, host_array
from .element import PadDirection, PadTemplate, TransformElement


class BaseParse(TransformElement):
    """Subclasses override handle_frame (and optionally set_sink_caps /
    pre_push_frame) and set FACTORY/PAD_TEMPLATES."""

    HOST_ELEMENT = True

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._adapter = Adapter()
        self.min_frame_size = 1
        self.frame_duration_ns: Optional[int] = None   # per-frame pts step
        self._next_pts: Optional[int] = None
        self._frames_out = 0

    # -- subclass API -------------------------------------------------------
    def set_min_frame_size(self, n: int) -> None:
        """gst_base_parse_set_min_frame_size (gstbaseparse.c:60)."""
        self.min_frame_size = max(1, int(n))

    def set_frame_rate(self, fps_num: int, fps_den: int) -> None:
        """gst_base_parse_set_frame_rate: fixes per-frame duration."""
        if fps_num > 0:
            self.frame_duration_ns = 1_000_000_000 * fps_den // fps_num

    def handle_frame(self, view: np.ndarray) -> Tuple[int, int]:
        """Inspect `view` (>= min_frame_size bytes, not consumed).

        Return (frame_size, skip): skip>0 discards that many bytes
        (resync); frame_size>0 emits that many bytes as one frame;
        frame_size==0 with skip==0 waits for more data."""
        raise NotImplementedError

    def pre_push_frame(self, buf: Buffer) -> Buffer:
        """Hook to decorate outgoing framed buffers (caps/meta)."""
        return buf

    # -- element ------------------------------------------------------------
    def start(self):
        self._adapter.clear()
        self._next_pts = None
        self._frames_out = 0
        self.draining = False

    def flush(self):
        self.start()

    # EOS drain: the pipeline flushes decoupling host elements with
    # host_process(None); subclasses see self.draining to relax their
    # next-header lookahead (gstbaseparse.c drain mode)
    _decouple = True
    draining = False

    @property
    def _pending_buf(self):
        return True if self._adapter.available() else None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            if not self._adapter.available():
                return None
            self.draining = True
            buf = Buffer(data=np.zeros(0, np.uint8), batch=1,
                         pts=self._next_pts)
        data = host_array(buf.data).astype(np.uint8, copy=False).ravel()
        self._adapter.push(data, buf.pts)
        if self._next_pts is None and buf.pts is not None:
            self._next_pts = buf.pts

        frames: List[np.ndarray] = []
        ptss: List[Optional[int]] = []
        while self._adapter.available() >= self.min_frame_size:
            view = self._adapter.map(self._adapter.available())
            size, skip = self.handle_frame(view)
            if skip > 0:
                self._adapter.flush(skip)
                continue
            if size <= 0 or size > self._adapter.available():
                break
            frames.append(self._adapter.take(size))
            ptss.append(self._next_pts)
            if (self._next_pts is not None
                    and self.frame_duration_ns is not None):
                self._next_pts += self.frame_duration_ns
            self._frames_out += 1
        if not frames:
            return None
        out = buf.with_(data=np.stack([f for f in frames])
                        if len({len(f) for f in frames}) == 1
                        else frames,
                        pts=ptss[0], batch=len(frames),
                        duration=self.frame_duration_ns)
        return self.pre_push_frame(out)
