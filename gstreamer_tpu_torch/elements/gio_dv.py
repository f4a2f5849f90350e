"""giostreamsrc/giostreamsink + dvdemux.

* giostreamsrc / giostreamsink (gst-plugins-base/gst/gio/
  gstgiostreamsrc.c, gstgiostreamsink.c): the reference reads/writes
  an application-provided GInputStream/GOutputStream; here the
  `stream` property takes any Python file-like object (read()/write())
  — the idiomatic stand-in for GIO streams.
* dvdemux (gst-plugins-good/ext/dv/gstdvdemux.c, reduced): splits a
  raw DV/DIF byte stream into fixed-size frames (120000 bytes NTSC /
  144000 PAL, selected by the APT/DSF flag in the header DIF block)
  and stamps video/x-dv frame caps; audio extraction stays with
  dvdec-level processing which wraps libdv in the reference and is
  out of scope without it.

A port of the JAX package's ``elements/gio_dv.py``: giostreamsink takes each
buffer to the host wherever it lies; dvdemux takes its source's host bytes
(``HOST_INPUT``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.baseparse import BaseParse
from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)


@register_element
class GioStreamSrc(SourceElement):
    """giostreamsrc (gstgiostreamsrc.c): pulls from the `stream`
    file-like object."""
    FACTORY = "giostreamsrc"
    DESCRIPTION = "Read from any GIO-style stream object"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "stream": (object, None, "file-like object with read()"),
        "blocksize": (int, 65536, "bytes per pulled buffer"),
    }

    def get_caps(self, filter=None):
        caps = Caps.from_string("application/octet-stream")
        if filter is not None and not filter.is_any \
                and caps.can_intersect(filter):
            caps = caps.intersect(filter)
        return caps

    def start(self):
        if self.props["stream"] is None:
            raise RuntimeError("giostreamsrc: no stream object")

    def create(self, n_frames: int) -> Optional[Buffer]:
        data = self.props["stream"].read(self.props["blocksize"])
        if not data:
            return None
        return Buffer(data=np.frombuffer(data, np.uint8), batch=1)


@register_element
class GioStreamSink(SinkElement):
    """giostreamsink (gstgiostreamsink.c): writes the byte stream to
    the `stream` file-like object."""
    FACTORY = "giostreamsink"
    DESCRIPTION = "Write to any GIO-style stream object"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "stream": (object, None, "file-like object with write()"),
    }

    def start(self):
        if self.props["stream"] is None:
            raise RuntimeError("giostreamsink: no stream object")

    def render(self, buf: Buffer) -> str:
        d = buf.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        try:
            for b in blobs:
                self.props["stream"].write(
                    b if isinstance(b, (bytes, bytearray))
                    else host_array(b).ravel().astype(
                        np.uint8).tobytes())
            return FlowReturn.OK
        except OSError:
            return FlowReturn.ERROR


_DV_NTSC = 120000
_DV_PAL = 144000


@register_element
class DvDemux(BaseParse):
    """dvdemux (gstdvdemux.c, reduced): DIF frame splitting — the
    DSF bit (header DIF block, byte 3 bit 7) selects 10 (NTSC) or 12
    (PAL) DIF sequences = 120000/144000 bytes per frame."""
    FACTORY = "dvdemux"
    DESCRIPTION = "Uses libdv to separate DV from audio (reduced: "\
                  "frame splitting + caps)"
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-dv, systemstream=false"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(4)

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("video/x-dv, systemstream=false")
               if direction == PadDirection.SINK else Caps.any())
        if filter is not None:
            res = res.intersect(filter)
        return res

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view[:4])
        dsf = bool(raw[3] & 0x80)
        size = _DV_PAL if dsf else _DV_NTSC
        if len(view) >= size:
            return size, 0
        if self.draining and len(view):
            return len(view), 0
        return 0, 0
