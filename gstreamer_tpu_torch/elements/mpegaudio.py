"""mpg123audiodec — MPEG-1/2/2.5 audio layers I/II/III decoder element.

Reference: gst-plugins-ugly/ext/mpg123/gstmpg123audiodec.c:1 (a
libmpg123 wrapper).  Here the decode is the clean-room implementation
in codecs/mp3.py (batched-matmul IMDCT + polyphase synthesis); the
element consumes the framed output of mpegaudioparse
(elements/audioparsers.py) and emits interleaved F32 audio.

Chain: filesrc location=x.mp3 ! mpegaudioparse ! mpg123audiodec ! ...

A port of the JAX package's ``elements/mpegaudio.py``: the frames come
to the host (``host_array``), the decoded samples go to the element's
device in one copy (``device_array``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve


def _frames_of(buf: Buffer) -> List[bytes]:
    if isinstance(buf.data, list):
        return [b if isinstance(b, (bytes, bytearray))
                else host_array(b).tobytes() for b in buf.data]
    arr = host_array(buf.data)
    if buf.batch > 1 and arr.ndim > 1:
        return [arr[k].tobytes() for k in range(buf.batch)]
    return [arr.tobytes()]


@register_element
class Mpg123AudioDec(TransformElement):
    FACTORY = "mpg123audiodec"
    DESCRIPTION = "Decodes mp1/mp2/mp3 streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/mpeg, mpegversion=1"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=F32LE, rate=[8000,48000], "
                    "channels=[1,2], layout=interleaved"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._dec = None
        self._peeked = None
        self._nout = 0

    def start(self):
        from ..codecs.mp3 import MP3Decoder
        self._dec = MP3Decoder()
        self._nout = 0
        self._skip_tag = True

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = None
            if self._peeked is None:
                from .image_codecs import _peek_upstream
                # walk upstream through parsers/queues to the source
                probe = self
                for _ in range(6):
                    blob = _peek_upstream(probe)
                    if blob is not None:
                        self._peeked = blob
                        break
                    pads = probe.sink_pads()
                    if not pads or pads[0].peer is None:
                        break
                    probe = pads[0].peer.element
            if self._peeked is not None:
                from ..codecs.mp3 import FrameHeader, _find_frames
                for _, h in _find_frames(bytes(self._peeked)):
                    res = Caps.from_string(
                        f"audio/x-raw, format=F32LE, rate={h.rate}, "
                        f"channels={h.channels}, layout=interleaved")
                    break
            if res is None:
                res = self.src_pads()[0].template_caps
        else:
            res = Caps.from_string("audio/mpeg, mpegversion=1")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._outcaps = outcaps

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        from ..codecs.mp3 import (EndOfData, FrameHeader, parse_xing)
        chunks = []
        rate = None
        for frame in _frames_of(buf):
            try:
                h = FrameHeader(frame)
            except ValueError:
                continue
            if self._skip_tag:
                self._skip_tag = False
                if h.layer == 3 and parse_xing(frame, h) is not None:
                    continue                  # Xing/Info tag frame
            try:
                pcm = self._dec.decode_frame(frame)
            except (ValueError, EndOfData):
                continue
            rate = h.rate
            if len(pcm):
                chunks.append(pcm)
        if not chunks:
            return None
        out = np.concatenate(chunks, axis=0).astype(np.float32)
        rate = rate or self._dec.rate or 44100
        pts = self._nout * 1_000_000_000 // rate
        self._nout += len(out)
        return Buffer(data=device_array(out, resolve(self.device)),
                      batch=1, pts=pts,
                      duration=len(out) * 1_000_000_000 // rate)
