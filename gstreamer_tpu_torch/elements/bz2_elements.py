"""bz2 stream codec elements.

Reference: gst-plugins-bad/ext/bz2/gstbz2enc.c, gstbz2dec.c — thin
wrappers over libbz2's streaming API.  Python ships the same libbz2
bindings in the stdlib, so these are fully functional without any
system dependency.

A port of the JAX package's ``elements/bz2_elements.py``: both take their
source's host bytes (``HOST_INPUT``) and give host bytes.
"""

from __future__ import annotations

import bz2
from typing import Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)


def _raw(buf: Buffer) -> bytes:
    d = buf.data
    if isinstance(d, (tuple, list)):
        return b"".join(host_array(x).tobytes() for x in d)
    if isinstance(d, (bytes, bytearray)):
        return bytes(d)
    return host_array(d).tobytes()


@register_element
class Bz2Enc(TransformElement):
    """bz2enc: compress a byte stream with bzip2."""
    FACTORY = "bz2enc"
    DESCRIPTION = "Compresses streams"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, "application/x-bzip"),
    ]
    PROPERTIES = {
        "block-size": (int, 6, "block size (bzip2 1-9)"),
        "buffer-size": (int, 1024, "buffer size"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._comp = None
        self._decouple = True        # flush tail at EOS

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-bzip")
               if direction == PadDirection.SINK else Caps.any())
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._comp = bz2.BZ2Compressor(
            min(max(self.props["block-size"], 1), 9))
        # non-None while the compressor holds buffered data: the
        # pipeline's drain pass calls host_process(None) to flush
        self._pending_buf = True

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:              # EOS drain: flush the compressor
            if self._comp is None:
                return None
            tail = self._comp.flush()
            self._comp = None
            self._pending_buf = None
            if not tail:
                return None
            return Buffer(data=np.frombuffer(tail, np.uint8), batch=1)
        out = self._comp.compress(_raw(buf))
        if not out:
            return None
        return buf.with_(data=np.frombuffer(out, np.uint8))


@register_element
class Bz2Dec(TransformElement):
    """bz2dec: decompress a bzip2 stream (multi-member aware)."""
    FACTORY = "bz2dec"
    DESCRIPTION = "Decompresses streams"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-bzip"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "first-buffer-size": (int, 1024, "initial output buffer size"),
        "buffer-size": (int, 1024, "output buffer size"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._dec = None

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.any() if direction == PadDirection.SINK
               else Caps.from_string("application/x-bzip"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._dec = bz2.BZ2Decompressor()

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        data = _raw(buf)
        out = []
        while data:
            out.append(self._dec.decompress(data))
            if self._dec.eof:        # concatenated members
                data = self._dec.unused_data
                self._dec = bz2.BZ2Decompressor()
            else:
                data = b""
        raw = b"".join(out)
        if not raw:
            return None
        return buf.with_(data=np.frombuffer(raw, np.uint8))
