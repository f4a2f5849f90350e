"""Closed-caption elements: ccconverter, cccombiner, ccextractor,
cea608mux, line21encoder, line21decoder.

References (gst-plugins-bad/gst/closedcaption/):
* gstccconverter.c — format lattice closedcaption/x-cea-608
  {raw, s334-1a} <-> x-cea-708 {cc_data, cdp}; pair conversions in
  video/cc.py (ccutils.c port; CDP packets bit-exact incl. padding
  and checksum).
* gstcccombiner.c — attaches the caption stream to video buffers as
  a caption meta (here Buffer.meta['closedcaption'] = (format,
  [bytes per frame])).
* gstccextractor.c — splits the caption meta back out on a
  caption_%u pad.
* gstcea608mux.c — muxes two field streams into s334-1a triplets.
* gstline21enc.c / gstline21dec.c — VBI line-21 in the top two luma
  rows.  The reference delegates to zvbi's io-sim/bit_slicer
  (sampled sinusoidal run-in); this port uses a rectangular NRZ
  cell model (27 cells: 7 clock run-in, '001' start, 2x8 LSB-first
  data bits) — self-consistent encode/decode at any width, reduced
  analog fidelity documented here.

A port of the JAX package's ``elements/closedcaption.py``.  Caption data
stays host bytes (ccconverter and the caption pads of cccombiner take
their source's bytes unstaged); cccombiner and ccextractor touch metas
only; line21encoder writes row 0 of each captioned frame into a copy of
the luma on the buffer's device (the chroma planes pass as they are), and
line21decoder reads a host copy of row 0 only.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection,
                            PadPresence, PadTemplate, TransformElement,
                            register_element)
from ..core.structure import Structure
from ..video import cc as ccutils

_CC_CAPS = ("closedcaption/x-cea-708, format={ cdp, cc_data }; "
            "closedcaption/x-cea-608, format={ raw, s334-1a }")


def _fmt_of(s) -> str:
    if s.name.endswith("608"):
        return "raw" if s.fields.get("format", "raw") == "raw" \
            else "s334-1a"
    return s.fields.get("format", "cc_data")


def _blob(b) -> bytes:
    return (bytes(b) if isinstance(b, (bytes, bytearray))
            else host_array(b).tobytes())


@register_element
class CcConverter(TransformElement):
    FACTORY = "ccconverter"
    DESCRIPTION = "Converts Closed Captions between formats"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CC_CAPS),
        PadTemplate("src", PadDirection.SRC, _CC_CAPS),
    ]
    PROPERTIES = {"field": (int, 0, "cea608 field for raw output")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(_CC_CAPS)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._in_fmt = _fmt_of(incaps[0])
        self._out_fmt = _fmt_of(outcaps[0])
        self._outcaps = outcaps
        fr = incaps[0].fields.get("framerate")
        self._fps = ((fr.num, fr.denom) if fr is not None
                     and not isinstance(fr, tuple) else (30, 1))

    def start(self):
        self._seq = 0

    def _convert(self, data: bytes, fin: str) -> bytes:
        field = self.props["field"]
        fout = self._out_fmt
        # normalize to cc_data triplets
        if fin == "raw":
            cc = ccutils.cea608_raw_to_cc_data(data, field)
        elif fin == "s334-1a":
            cc = ccutils.s334_1a_to_cc_data(data)
        elif fin == "cdp":
            cc, _tc, _fps = ccutils.cdp_to_cc_data(data)
        else:
            cc = data
        if fout == "raw":
            return ccutils.cc_data_to_cea608_raw(cc, field)
        if fout == "s334-1a":
            return ccutils.cc_data_to_s334_1a(cc)
        if fout == "cdp":
            out = ccutils.cc_data_to_cdp(cc, self._seq, *self._fps)
            self._seq = (self._seq + 1) & 0xFFFF
            return out
        return cc

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        # a buffer with caption caps of its own in its meta (ccextractor's
        # caption pad, whose negotiated caps are the video's) is read by
        # them and leaves with the output caps; the reference reads it by
        # the negotiated caps (ROADMAP.md section 3)
        meta, fin = buf.meta or {}, self._in_fmt
        caps = meta.get("caps")
        if caps is not None and len(caps) \
                and caps[0].name.startswith("closedcaption/"):
            meta, fin = dict(meta, caps=self._outcaps), _fmt_of(caps[0])
        d = buf.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        out = [np.frombuffer(self._convert(_blob(b), fin), np.uint8)
               for b in blobs]
        return buf.with_(data=out if len(out) > 1 else out[0], meta=meta)


@register_element
class CcCombiner(AggregatorElement):
    FACTORY = "cccombiner"
    DESCRIPTION = "Combines GstVideoCaptionMeta with video input " \
                  "stream"
    HOST_ELEMENT = True
    HOST_INPUT_PADS = ("caption",)     # bytes; the video pad takes media
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, width=[1,32767], height=[1,32767]"),
        PadTemplate("caption", PadDirection.SINK, _CC_CAPS,
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, width=[1,32767], height=[1,32767]"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._cc_fmt = "raw"

    def negotiate_output(self, in_caps, allowed):
        video = None
        for pad_name, caps in in_caps.items():
            s = caps.fixate()[0]
            if s.name.startswith("closedcaption"):
                self._cc_fmt = _fmt_of(s)
            else:
                video = caps.fixate()
        return video

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        video = None
        captions: List[bytes] = []
        for pad_name in sorted(ins):
            buf = ins[pad_name]
            if pad_name.startswith("caption"):
                d = buf.data
                captions.extend(_blob(b) for b in
                                (d if isinstance(d, (list, tuple))
                                 else [d]))
            else:
                video = buf
        if video is None:
            return None
        return video.with_(meta=dict(
            video.meta or {},
            closedcaption=(self._cc_fmt, captions)))


@register_element
class CcExtractor(TransformElement):
    FACTORY = "ccextractor"
    DESCRIPTION = "Extract GstVideoCaptionMeta from input stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, width=[1,32767], height=[1,32767]"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, width=[1,32767], height=[1,32767]"),
        # ANY template: the caption pad's real caps ride per-buffer in
        # meta (heterogeneous 1:N outputs; appsink honors meta caps)
        PadTemplate("caption_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.REQUEST),
    ]

    def transform_caps(self, direction, caps, filter=None):
        # the caption branch must not constrain the video path: the
        # upstream query answers with the VIDEO template only (the
        # caption pad's caps ride per-buffer in meta)
        video = Caps.from_string(
            "video/x-raw, width=[1,32767], height=[1,32767]")
        res = caps if not caps.is_empty and not caps.is_any else video
        out = []
        for s in res:
            if s.name == "video/x-raw":
                out.append(s)
        res = Caps(out) if out else video
        if filter is not None and not filter.is_any:
            inter = res.intersect(filter)
            if not inter.is_empty:
                res = inter
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        return buf

    def route_outputs(self, buf: Buffer) -> Dict[str, Buffer]:
        out = {}
        pads = self.src_pads()
        if pads:
            out[pads[0].name] = buf
        meta = (buf.meta or {}).get("closedcaption")
        if meta and len(pads) > 1:
            fmt, captions = meta
            caps_name = ("closedcaption/x-cea-608"
                         if fmt in ("raw", "s334-1a")
                         else "closedcaption/x-cea-708")
            caps = Caps([Structure(caps_name, {"format": fmt})])
            out[pads[1].name] = buf.with_(
                data=[np.frombuffer(c, np.uint8) for c in captions],
                meta={"caps": caps})
        return out


@register_element
class Cea608Mux(AggregatorElement):
    FACTORY = "cea608mux"
    DESCRIPTION = "Combine CEA608 field 1 and field 2 streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK,
                    "closedcaption/x-cea-608, format=raw",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC,
                    "closedcaption/x-cea-608, format=s334-1a"),
    ]

    def negotiate_output(self, in_caps, allowed):
        return Caps.from_string(
            "closedcaption/x-cea-608, format=s334-1a")

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        out = bytearray()
        first = None
        for k, pad_name in enumerate(sorted(ins)):
            buf = ins[pad_name]
            if first is None:
                first = buf
            d = buf.data
            for b in (d if isinstance(d, (list, tuple)) else [d]):
                out += ccutils.cea608_raw_to_s334_1a(_blob(b),
                                                     field=k)
        if first is None:
            return None
        return first.with_(data=np.frombuffer(bytes(out), np.uint8))


@register_element
class Line21Encoder(TransformElement):
    FACTORY = "line21encoder"
    DESCRIPTION = "Inject line21 CC in SD video streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format=I420, width=[1,32767], "
                    "height=[1,32767]"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420, width=[1,32767], "
                    "height=[1,32767]"),
    ]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        meta = (buf.meta or {}).get("closedcaption")
        if not meta:
            return buf
        fmt, captions = meta
        planes = list(buf.data)
        y = planes[0]
        n = buf.batch or 1
        lines = []
        for k in range(min(n, max(1, len(captions)))):
            raw = captions[min(k, len(captions) - 1)]
            if fmt == "s334-1a":
                raw = ccutils.cea608_s334_1a_to_raw(raw, 0)
            pair = raw[:2] if len(raw) >= 2 else b"\x80\x80"
            lines.append(ccutils.line21_encode_line(y.shape[-1], pair))
        # the caller's plane stays as it was: a copy on its device, the
        # encoded rows written in one upload
        y = y.clone()
        rows = device_array(np.stack(lines), y)
        if y.ndim == 3:
            y[:len(lines), 0] = rows
        else:
            y[0] = rows[-1]
        planes[0] = y
        return buf.with_(data=tuple(planes))


@register_element
class Line21Decoder(TransformElement):
    FACTORY = "line21decoder"
    DESCRIPTION = "Extract line21 CC from SD video streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format=I420, width=[1,32767], "
                    "height=[1,32767]"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420, width=[1,32767], "
                    "height=[1,32767]"),
    ]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        y = buf.data[0] if isinstance(buf.data, (list, tuple)) \
            else buf.data
        # row 0 of each frame only
        rows = host_array(y[:, 0] if y.ndim == 3 else y[:1])
        n = buf.batch or 1
        captions = []
        for k in range(n):
            line = rows[k] if y.ndim == 3 else rows[0]
            pair = ccutils.line21_decode_line(line)
            if pair is not None:
                captions.append(pair)
        if not captions:
            return buf
        return buf.with_(meta=dict(buf.meta or {},
                                   closedcaption=("raw", captions)))
