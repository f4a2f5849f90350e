"""dsdconvert + fakevideodec.

References:
* gst-plugins-base/gst/dsd/gstdsdconvert.c — converts between DSD
  grouping formats (DSDU8/U16/U32 LE/BE), interleaved/non-interleaved
  layouts and byte reversals; the math lives in our audio/dsd.py
  (gst_dsd_convert transliteration).
* gst-plugins-base/gst/videotestsrc/../fakevideodec
  (gstfakevideodec.c) — a "decoder" for the fake video codec used in
  zero-decode testing: consumes video/x-fake and outputs solid
  frames at the negotiated size.

A port of the JAX package's ``elements/dsd_elements.py``.  dsdconvert
takes its source's host bytes (``HOST_INPUT``) and gives host bytes;
fakevideodec ignores its input's bytes (``HOST_INPUT``: they are not
staged) and makes its mid-grey I420 planes on the element's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..audio.dsd import DsdInfo, dsd_convert
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.structure import Structure
from ..device import resolve

_DSD_CAPS = ("audio/x-dsd, format={ U8, U16LE, U16BE, U32LE, U32BE }, "
             "rate=[1,2147483647], channels=[1,64], "
             "layout={ interleaved, non-interleaved }")


@register_element
class DsdConvert(TransformElement):
    FACTORY = "dsdconvert"
    DESCRIPTION = "Convert between different DSD grouping formats"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _DSD_CAPS),
        PadTemplate("src", PadDirection.SRC, _DSD_CAPS),
    ]

    def transform_caps(self, direction, caps, filter=None):
        out = []
        tmpl = Caps.from_string(_DSD_CAPS)
        for s in caps:
            ns = tmpl[0].copy()
            for k in ("rate", "channels"):
                if k in s.fields:
                    ns[k] = s[k]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._in = DsdInfo.from_caps_structure(incaps[0])
        self._out = DsdInfo.from_caps_structure(outcaps[0])

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        data = host_array(buf.data).astype(np.uint8, copy=False).reshape(-1)
        out = dsd_convert(
            data, self._in.format, self._out.format,
            self._in.channels, self._in.layout, self._out.layout,
            reverse_byte_bits=(self._in.reversed_bytes
                               != self._out.reversed_bytes))
        return buf.with_(data=out)


@register_element
class FakeVideoDec(TransformElement):
    """fakevideodec: zero-work 'decoder' for video/x-fake streams —
    emits mid-gray frames of the negotiated geometry so pipelines can
    benchmark everything but the decode."""
    FACTORY = "fakevideodec"
    DESCRIPTION = "Fake video decoder"
    HOST_ELEMENT = True
    HOST_INPUT = True       # its input's bytes are never read
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-fake, width=[1,32767], height=[1,32767]"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420, width=[1,32767], "
                    "height=[1,32767]"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        out = []
        name = ("video/x-raw" if direction == PadDirection.SINK
                else "video/x-fake")
        for s in caps:
            f = {k: s[k] for k in ("width", "height", "framerate")
                 if k in s.fields}
            if direction == PadDirection.SINK:
                f["format"] = "I420"
            out.append(Structure(name, f))
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        s = outcaps[0]
        self._w = s["width"]
        self._h = s["height"]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        n = buf.batch or 1
        w, h = self._w, self._h
        dev = resolve(self.device)
        y = torch.full((n, h, w), 128, dtype=torch.uint8, device=dev)
        u = torch.full((n, h // 2, w // 2), 128, dtype=torch.uint8,
                       device=dev)
        v = torch.full((n, h // 2, w // 2), 128, dtype=torch.uint8,
                       device=dev)
        return buf.with_(data=(y, u, v))
