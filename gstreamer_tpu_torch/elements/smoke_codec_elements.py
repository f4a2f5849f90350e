"""smokeenc / smokedec — the Smoke conditional-replenishment codec.

Reference: gst-plugins-good/ext/jpeg/gstsmokeenc.c / gstsmokedec.c
over smokecodec.c; caps video/x-smoke with width/height/framerate.
The packet format lives in codecs/smoke.py (smokeformat.h port).

A port of the JAX package's ``elements/smoke_codec_elements.py``: smokeenc
copies each tick's planes to the host (``host_array``) and runs the JPEG
transform on the element's device; smokedec takes host packets
(``HOST_INPUT``) and puts its planes on the element's device in one copy
(``device_planes``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..codecs.smoke import SmokeDecoder, SmokeEncoder
from ..core.buffer import Buffer, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve
from ..video.info import VideoInfo

_SMOKE_CAPS = ("video/x-smoke, width=[16,4096], height=[16,4096], "
               "framerate=[0/1,2147483647/1]")
_RAW_CAPS = ("video/x-raw, format=I420, width=[16,4096], "
             "height=[16,4096], framerate=[0/1,2147483647/1]")


@register_element
class SmokeEnc(TransformElement):
    FACTORY = "smokeenc"
    DESCRIPTION = "Encode images into the Smoke format"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _RAW_CAPS),
        PadTemplate("src", PadDirection.SRC, _SMOKE_CAPS),
    ]
    PROPERTIES = {
        "qmin": (int, 10, "minimum quality"),
        "qmax": (int, 85, "maximum quality"),
        "threshold": (int, 3000, "block change threshold "
                                 "(gstsmokeenc.c default)"),
        "keyframe": (int, 20, "keyframe interval"),
    }

    def transform_caps(self, direction, caps, filter=None):
        out = []
        tmpl = (_SMOKE_CAPS if direction == PadDirection.SINK
                else _RAW_CAPS)
        for s in caps:
            ns = Caps.from_string(tmpl)[0].copy()
            for k in ("width", "height", "framerate"):
                if k in s.fields:
                    ns[k] = s[k]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])
        fps = self._info.fps
        self._enc = SmokeEncoder(
            self._info.width, self._info.height, fps.num, fps.denom,
            qmin=self.props["qmin"], qmax=self.props["qmax"],
            threshold=self.props["threshold"],
            keyframe_rate=self.props["keyframe"], device=self.device)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        planes = [host_array(p) for p in buf.data]
        n = buf.batch or 1
        out = []
        for k in range(n):
            frame = [p[k] if p.ndim == 3 else p for p in planes]
            out.append(np.frombuffer(self._enc.encode(frame),
                                     np.uint8))
        return buf.with_(data=out if len(out) > 1 else out[0])


@register_element
class SmokeDec(TransformElement):
    FACTORY = "smokedec"
    DESCRIPTION = "Decode video from the Smoke format"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _SMOKE_CAPS),
        PadTemplate("src", PadDirection.SRC, _RAW_CAPS),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._dec = SmokeDecoder(self.device)

    def transform_caps(self, direction, caps, filter=None):
        out = []
        tmpl = (_RAW_CAPS if direction == PadDirection.SINK
                else _SMOKE_CAPS)
        for s in caps:
            ns = Caps.from_string(tmpl)[0].copy()
            for k in ("width", "height", "framerate"):
                if k in s.fields:
                    ns[k] = s[k]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._dec = SmokeDecoder(self.device)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        d = buf.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        frames = []
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            if len(raw) >= 1 and raw[0] == 0x80:
                continue                        # ID packet
            arr = host_array(b)
            if arr.ndim > 1:
                for row in arr:
                    frames.append(self._dec.decode(
                        bytes(row.tobytes())))
            else:
                frames.append(self._dec.decode(raw))
        if not frames:
            return None
        data = device_planes([np.stack([f[c] for f in frames])
                              for c in range(3)], resolve(self.device))
        return buf.with_(data=data, batch=len(frames))
