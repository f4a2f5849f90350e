"""playbin3/decodebin3/parsebin/playsink aliases, y4mdec, alphacolor,
dtmfdetect.

References:
* gst-plugins-base/gst/playback/gstdecodebin3.c, gstplaybin3.c,
  gstparsebin.c, gstplaysink.c — the "3" generation shares the
  caps-driven autoplug architecture our playback module models; the
  factories are registered as aliases over the same machinery.
* gst-plugins-good/gst/y4m/gsty4mdec.c — YUV4MPEG2 stream reading
  (our filesrc already parses the headers; y4mdec is the pull-mode
  collapse like wavparse).
* gst-plugins-good/gst/alpha/gstalphacolor.c — in-place RGBA<->AYUV
  recoloring with the 8-bit cog matrices (:163-199); the RGB->YCbCr
  path stores the >>8 result WITHOUT clamping (implicit guint8
  truncation, :221-226) while YCbCr->RGB clamps (:255-259) — both
  reproduced.
* gst-plugins-good/gst/dtmf/gstdtmfdetect.c + tone_detect.c —
  Goertzel DTMF detection on S16 8 kHz mono, posting dtmf-event
  element messages (method=2, type=1).

A port of the JAX package's ``elements/playback_extra.py``.
``alphacolor`` runs as int32 torch on the element's device (the JAX
package's jitted ``jnp`` expression); the bins are the port's
``playback.py``; y4mdec and dtmfdetect stay on the host.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            TransformElement, register_element)
from .file_elements import FileSrc
from .playback import DecodeBin, PlayBin

_RGBA_FMTS = ("RGBA", "BGRA", "ARGB", "ABGR")


@register_element
class DecodeBin3(DecodeBin):
    """gstdecodebin3.c: same autoplug surface, new factory name."""
    FACTORY = "decodebin3"
    DESCRIPTION = "Autoplug and decode to raw media"


@register_element
class ParseBin(DecodeBin):
    """gstparsebin.c: autoplugs parsers/demuxers but no decoders; in
    the collapsed model the inner source already emits parsed
    streams."""
    FACTORY = "parsebin"
    DESCRIPTION = "Parse and de-multiplex to elementary streams"


@register_element
class PlayBin3(PlayBin):
    """gstplaybin3.c alias (the stream-selection era playbin)."""
    FACTORY = "playbin3"
    DESCRIPTION = "Autoplug and play media from an uri"


@register_element
class PlaySink(SinkElement):
    """gstplaysink.c (reduced): the rendering half of playbin —
    accepts raw audio/video/text on request pads and counts rendered
    buffers (offline runtime has no display; samples are observable
    via the `rendered` counters like fakesink handoffs)."""
    FACTORY = "playsink"
    DESCRIPTION = "Convenience sink for multiple streams"
    from ..core.element import PadPresence
    PAD_TEMPLATES = [
        PadTemplate("video_sink", PadDirection.SINK, Caps.any()),
        PadTemplate("audio_sink", PadDirection.SINK, Caps.any()),
        PadTemplate("text_sink", PadDirection.SINK, Caps.any()),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.rendered = {"video": 0, "audio": 0, "text": 0}

    def render(self, buf: Buffer) -> str:
        from ..core.buffer import FlowReturn
        self.rendered["video"] += buf.batch or 1
        return FlowReturn.OK


@register_element
class Y4mDec(FileSrc):
    """y4mdec (gsty4mdec.c): YUV4MPEG2 -> raw video; pull-mode
    collapse over filesrc's y4m header parsing."""
    FACTORY = "y4mdec"
    DESCRIPTION = "Demuxes/decodes a YUV4MPEG stream"


@register_element
class AlphaColor(TransformElement):
    FACTORY = "alphacolor"
    DESCRIPTION = "ARGB from/to AYUV colorspace conversion preserving " \
                  "the alpha channel"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format={ RGBA, BGRA, ARGB, ABGR, "
                    "AYUV }, width=[1,32767], height=[1,32767], "
                    "framerate=[0/1,2147483647/1]"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ RGBA, BGRA, ARGB, ABGR, "
                    "AYUV }, width=[1,32767], height=[1,32767], "
                    "framerate=[0/1,2147483647/1]"),
    ]

    # cog matrices (gstalphacolor.c:171-187, SDTV defaults)
    _RGB2YUV = ((66, 129, 25, 4096), (-38, -74, 112, 32768),
                (112, -94, -18, 32768))
    _YUV2RGB = ((298, 0, 409, -57068), (298, -100, -208, 34707),
                (298, 516, 0, -70870))

    def transform_caps(self, direction, caps, filter=None):
        from ..core.value import ValueList
        out = []
        for s in caps:
            fmt = s.fields.get("format")
            ns = s.copy()
            if isinstance(fmt, str):
                ns["format"] = ("AYUV" if fmt in _RGBA_FMTS
                                else ValueList(list(_RGBA_FMTS)))
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._to_yuv = incaps[0]["format"] in _RGBA_FMTS

    def make_fn(self):
        to_yuv = self._to_yuv
        rgb2yuv = self._RGB2YUV
        yuv2rgb = self._YUV2RGB

        def fn(planes):
            # int32 as the JAX package's; torch's >> on int32 is
            # arithmetic, and the cast to uint8 follows the mask or clamp
            c0, c1, c2, a = [p.to(torch.int32) for p in planes]
            if to_yuv:
                # no clamp: the C stores the full int into a byte
                ycf, ucf, vcf = rgb2yuv
                y = (c0 * ycf[0] + c1 * ycf[1] + c2 * ycf[2]
                     + ycf[3]) >> 8
                u = (c0 * ucf[0] + c1 * ucf[1] + c2 * ucf[2]
                     + ucf[3]) >> 8
                v = (c0 * vcf[0] + c1 * vcf[1] + c2 * vcf[2]
                     + vcf[3]) >> 8
                return tuple((x & 0xFF).to(torch.uint8)
                             for x in (y, u, v)) \
                    + (a.to(torch.uint8),)
            rc, gc, bc = yuv2rgb
            r = (c0 * rc[0] + c1 * rc[1] + c2 * rc[2] + rc[3]) >> 8
            g = (c0 * gc[0] + c1 * gc[1] + c2 * gc[2] + gc[3]) >> 8
            b = (c0 * bc[0] + c1 * bc[1] + c2 * bc[2] + bc[3]) >> 8
            return tuple(torch.clamp(x, 0, 255).to(torch.uint8)
                         for x in (r, g, b)) \
                + (a.to(torch.uint8),)

        return fn


@register_element
class DtmfDetect(TransformElement):
    """dtmfdetect: Goertzel detector over 8 DTMF frequencies on S16
    8 kHz mono, passthrough audio + dtmf-event element messages
    (gstdtmfdetect.c posts type=1, method=2)."""
    FACTORY = "dtmfdetect"
    DESCRIPTION = "Detects DTMF tones"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=S16LE, rate=8000, channels=1, "
                    "layout=interleaved"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=S16LE, rate=8000, channels=1, "
                    "layout=interleaved"),
    ]

    _ROW = (697, 770, 852, 941)
    _COL = (1209, 1336, 1477, 1633)
    _KEYS = "123A456B789C*0#D"
    _BLOCK = 205                        # classic Goertzel N at 8 kHz

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._rest = np.zeros(0, np.int16)
        self._last: Optional[int] = None

    def start(self):
        self._rest = np.zeros(0, np.int16)
        self._last = None

    def _goertzel(self, block: np.ndarray, freq: int) -> float:
        coeff = 2.0 * math.cos(2.0 * math.pi * freq / 8000.0)
        s1 = s2 = 0.0
        for x in block:
            s0 = float(x) + coeff * s1 - s2
            s2, s1 = s1, s0
        return s1 * s1 + s2 * s2 - coeff * s1 * s2

    def _detect(self, block: np.ndarray) -> Optional[int]:
        row_e = [self._goertzel(block, f) for f in self._ROW]
        col_e = [self._goertzel(block, f) for f in self._COL]
        total = float((block.astype(np.float64) ** 2).sum())
        if total < 1e3:
            return None
        ri = int(np.argmax(row_e))
        ci = int(np.argmax(col_e))
        # both tones must dominate the block energy
        if row_e[ri] + col_e[ci] < 0.8 * total * self._BLOCK / 2:
            return None
        key = self._KEYS[ri * 4 + ci]
        return "0123456789*#ABCD".index(key)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        samples = host_array(buf.data).ravel().astype(np.int16)
        data = np.concatenate([self._rest, samples])
        nblocks = len(data) // self._BLOCK
        self._rest = data[nblocks * self._BLOCK:]
        from .misc_elements import _root
        root = _root(self)
        for k in range(nblocks):
            block = data[k * self._BLOCK:(k + 1) * self._BLOCK]
            ev = self._detect(block)
            if ev is not None and ev != self._last \
                    and hasattr(root, "bus"):
                from ..core.pipeline import Message
                root.bus.post(Message("element", self.name, {
                    "name": "dtmf-event", "type": 1, "number": ev,
                    "method": 2}))
            self._last = ev
        return buf
