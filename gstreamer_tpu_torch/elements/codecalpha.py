"""Codec-alpha elements — transparent WebM (VP8/VP9 + alpha stream).

Reference: gst-plugins-bad/gst/codecalpha/ — gstcodecalphademux.c
splits buffers carrying GstVideoCodecAlphaMeta (the matroska
BlockAdditional side stream) into a color and an alpha branch;
gstalphadecodebin.c (vp8alphadecodebin / vp9alphadecodebin) wraps
demux + two decoders + alphacombine into one bin.

Framework convention: the alpha packet rides `buf.meta["alpha_data"]`
(matroskademux attaches it from BlockAdditions), mirroring the
reference's buffer meta.

A port of the JAX package's ``elements/codecalpha.py``: the packets are
taken to the host (``host_array``); the decoded A420 planes go to the
element's device in one copy (``device_planes``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.buffer import Buffer, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.structure import Structure
from ..device import resolve


def _pkt_bytes(d) -> bytes:
    if isinstance(d, (bytes, bytearray)):
        return bytes(d)
    if isinstance(d, (tuple, list)):
        return b"".join(_pkt_bytes(x) for x in d)
    return host_array(d).tobytes()


@register_element
class CodecAlphaDemux(TransformElement):
    """codecalphademux: pass the color stream through; expose the
    alpha side-stream packet under meta["alpha"] for the paired
    decoder (the reference uses a second ALWAYS src pad — this
    framework's meta channel carries the same bytes)."""
    FACTORY = "codecalphademux"
    DESCRIPTION = "Extract and expose the alpha stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = caps if caps is not None else Caps.any()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        meta = dict(buf.meta or {})
        alpha = meta.pop("alpha_data", None)
        if alpha is not None:
            meta["alpha"] = alpha
        return buf.with_(meta=meta)


class _AlphaDecodeBin(TransformElement):
    """vp8alphadecodebin / vp9alphadecodebin
    (gstalphadecodebin.c): decode the color stream and the alpha
    side-stream with two decoders, combine into A420."""
    HOST_ELEMENT = True
    CODEC = "vp8"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=A420"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._dec = None
        self._adec = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            f = {"format": "A420"}
            if caps is not None and len(caps):
                for k in ("width", "height", "framerate"):
                    v = caps[0].get(k)
                    if v is not None:
                        f[k] = v
            res = Caps([Structure("video/x-raw", f)])
        else:
            res = Caps.from_string(f"video/x-{self.CODEC}")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        from ..codecs import vpx
        self._dec = vpx.VpxDecoder(self.CODEC)
        self._adec = vpx.VpxDecoder(self.CODEC)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        pkt = _pkt_bytes(buf.data)
        frames = self._dec.decode(pkt)
        if not frames:
            return None
        y, u, v = frames[0]
        alpha_pkt = (buf.meta or {}).get("alpha_data") \
            or (buf.meta or {}).get("alpha")
        if alpha_pkt is not None:
            aframes = self._adec.decode(_pkt_bytes(alpha_pkt))
            a = aframes[0][0] if aframes else np.full_like(y, 255)
        else:
            a = np.full_like(y, 255)
        planes = device_planes([np.asarray(p)[None] for p in (y, u, v, a)],
                               resolve(self.device))
        return buf.with_(data=tuple(planes), batch=1)


@register_element
class Vp8AlphaDecodeBin(_AlphaDecodeBin):
    FACTORY = "vp8alphadecodebin"
    DESCRIPTION = "VP8 decoder with alpha channel"
    CODEC = "vp8"


@register_element
class Vp9AlphaDecodeBin(_AlphaDecodeBin):
    FACTORY = "vp9alphadecodebin"
    DESCRIPTION = "VP9 decoder with alpha channel"
    CODEC = "vp9"
