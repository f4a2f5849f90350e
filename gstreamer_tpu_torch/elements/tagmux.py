"""id3v2mux — prepend an ID3v2 tag to a coded audio stream.

Reference: the GstTagMux base (gst-plugins-base/gst-libs/gst/tag/
gsttagmux.c) with the id3v2mux subclass (gst-plugins-good/ext/taglib/
gstid3v2mux.cc): tags collected from upstream TAG events (and a local
`tags` property, taginject-style) are rendered once in front of the
first buffer.

A port of the JAX package's ``elements/tagmux.py``: the muxers take their
source's host bytes (``HOST_INPUT``) and write through the port's
``utils/tagwriters``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.tags import TagList


@register_element
class Id3v2Mux(TransformElement):
    FACTORY = "id3v2mux"
    DESCRIPTION = "Adds an ID3v2 header to the beginning of MP3 files"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/mpeg; application/x-id3"),
        PadTemplate("src", PadDirection.SRC, "application/x-id3"),
    ]
    PROPERTIES = {
        "tags": (str, "", "extra taglist string (title=x,artist=y)"),
        "version": (int, 4, "id3v2 minor version: 3 or 4"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._tags = TagList()
        self._written = False

    def start(self):
        self._tags = TagList()
        self._written = False
        for kv in (self.props["tags"] or "").split(","):
            k, _, v = kv.partition("=")
            if k.strip():
                self._tags.add("append", k.strip(),
                               v.strip().strip('"'))

    def sink_event(self, pad, event) -> bool:
        if getattr(event, "type", None) == "tag":
            tl = event.data.get("tags")
            if tl is not None:
                self._tags = self._tags.merge(tl)
        return super().sink_event(pad, event)

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-id3")
               if direction == PadDirection.SINK
               else Caps.from_string("audio/mpeg"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None or self._written:
            return buf
        self._written = True
        from ..utils.tagwriters import write_id3v2
        tag = write_id3v2(self._tags, version=self.props["version"])
        data = buf.data
        blobs = (data if isinstance(data, list) else [data])
        flat = b"".join(
            b if isinstance(b, (bytes, bytearray))
            else host_array(b).tobytes() for b in blobs)
        return buf.with_(data=np.frombuffer(tag + flat, np.uint8),
                         batch=1)


@register_element
class Id3Mux(Id3v2Mux):
    """id3mux (gst-plugins-bad/gst/id3tag/gstid3mux.c): same writer,
    v1+v2 capable element name."""
    FACTORY = "id3mux"
    DESCRIPTION = "Adds ID3 tags to mp3 streams"
