"""h264ccinserter / h264ccextractor / h265ccinserter /
h265ccextractor — CEA-708 closed captions in SEI NAL units.

Reference: gst-plugins-bad/gst/closedcaption/gsth264ccextractor.c
and gsth264ccinserter.c (gstcodecccinserter.c base; h265 variants
alongside): captions travel as ITU-T T.35
registered user data (country 0xB5, provider 0x0031, identifier
'GA94', ATSC A/53 cc_data) in SEI NALs — type 6 for H.264, prefix
SEI (39) for H.265.

Caption payloads ride the framework's caption meta
(Buffer.meta['closedcaption'] = (format, [cc_data per AU]),
elements/closedcaption.py conventions).

A port of the JAX package's ``elements/cc_sei.py``.  The coded access
units stay host bytes (the elements take their source's bytes unstaged);
alpha_combine keeps the colour planes where they are and makes or
uploads the alpha plane on their device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

_T35_PREFIX = bytes([0xB5, 0x00, 0x31]) + b"GA94" + bytes([0x03])


def build_cc_sei_payload(cc_data: bytes) -> bytes:
    """ATSC A/53 user_data_registered_itu_t_t35 payload."""
    cc_count = len(cc_data) // 3
    return (_T35_PREFIX
            + bytes([0x40 | (cc_count & 0x1F), 0xFF])
            + cc_data[:cc_count * 3] + b"\xFF")


def parse_cc_sei_payload(payload: bytes) -> Optional[bytes]:
    if not payload.startswith(_T35_PREFIX):
        return None
    flags = payload[8]
    if not flags & 0x40:                  # process_cc_data_flag
        return None
    cc_count = flags & 0x1F
    return payload[10:10 + cc_count * 3]


def _sei_nal(payload_type: int, payload: bytes, h265: bool) -> bytes:
    body = bytes([payload_type])
    n = len(payload)
    while n >= 255:
        body += b"\xFF"
        n -= 255
    body += bytes([n]) + payload + b"\x80"   # rbsp trailing bits
    hdr = bytes([39 << 1, 1]) if h265 else bytes([6])
    return hdr + body


def _parse_sei(nal: bytes, h265: bool) -> List[bytes]:
    """-> payloads of type-4 (registered user data) SEI messages."""
    pos = 2 if h265 else 1
    out = []
    while pos + 2 <= len(nal):
        ptype = 0
        while pos < len(nal) and nal[pos] == 0xFF:
            ptype += 255
            pos += 1
        if pos >= len(nal):
            break
        ptype += nal[pos]
        pos += 1
        size = 0
        while pos < len(nal) and nal[pos] == 0xFF:
            size += 255
            pos += 1
        if pos >= len(nal):
            break
        size += nal[pos]
        pos += 1
        if ptype == 4:
            out.append(nal[pos:pos + size])
        pos += size
    return out


def _split_annexb(raw: bytes):
    out = []
    pos = 0
    while True:
        i = raw.find(b"\x00\x00\x01", pos)
        if i < 0:
            return out
        j = raw.find(b"\x00\x00\x01", i + 3)
        end = len(raw) if j < 0 else j - (1 if raw[j - 1] == 0 else 0)
        if end > i + 3:
            out.append(raw[i + 3:end])
        pos = i + 3
    return out


def _blobs(buf: Buffer) -> List[bytes]:
    d = buf.data
    if isinstance(d, list):
        return [bytes(x) if isinstance(x, (bytes, bytearray))
                else host_array(x).tobytes() for x in d]
    return [host_array(d).tobytes()]


class _CcSeiBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    H265 = False

    def transform_caps(self, direction, caps, filter=None):
        res = self.sink_pads()[0].template_caps \
            if self.PAD_TEMPLATES else Caps.any()
        if caps is not None and not caps.is_any and len(caps):
            res = caps
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def _is_vcl(self, nal: bytes) -> bool:
        if self.H265:
            return ((nal[0] >> 1) & 0x3F) <= 31
        return (nal[0] & 0x1F) in (1, 5)


class _CcInserter(_CcSeiBase):
    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        meta = (buf.meta or {}).get("closedcaption")
        if not meta:
            return buf
        _fmt, captions = meta
        if isinstance(captions, (bytes, bytearray)):
            captions = [captions]
        blobs = _blobs(buf)
        out = []
        for k, au in enumerate(blobs):
            cc = captions[k] if k < len(captions) else None
            if not cc:
                out.append(np.frombuffer(au, np.uint8))
                continue
            sei = _sei_nal(4, build_cc_sei_payload(bytes(cc)),
                           self.H265)
            rebuilt = bytearray()
            inserted = False
            for nal in _split_annexb(au):
                if not inserted and self._is_vcl(nal):
                    rebuilt += b"\x00\x00\x00\x01" + sei
                    inserted = True
                rebuilt += b"\x00\x00\x00\x01" + nal
            if not inserted:
                rebuilt += b"\x00\x00\x00\x01" + sei
            out.append(np.frombuffer(bytes(rebuilt), np.uint8))
        return buf.with_(data=out if len(out) > 1 else out[0])


class _CcExtractor(_CcSeiBase):
    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        captions = []
        for au in _blobs(buf):
            cc = b""
            for nal in _split_annexb(au):
                ntype = ((nal[0] >> 1) & 0x3F) if self.H265 \
                    else (nal[0] & 0x1F)
                if ntype != (39 if self.H265 else 6):
                    continue
                for payload in _parse_sei(nal, self.H265):
                    got = parse_cc_sei_payload(payload)
                    if got:
                        cc += got
            captions.append(cc)
        if not any(captions):
            return buf
        return buf.with_(meta=dict(buf.meta or {},
                                   closedcaption=("cc_data",
                                                  captions)))


_H264_CAPS = ("video/x-h264, stream-format=byte-stream, "
              "alignment=au")
_H265_CAPS = ("video/x-h265, stream-format=byte-stream, "
              "alignment=au")


@register_element
class H264CcInserter(_CcInserter):
    FACTORY = "h264ccinserter"
    DESCRIPTION = "Insert closed captions into H.264 SEI"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _H264_CAPS),
        PadTemplate("src", PadDirection.SRC, _H264_CAPS),
    ]


@register_element
class H264CcExtractor(_CcExtractor):
    FACTORY = "h264ccextractor"
    DESCRIPTION = "Extract closed captions from H.264 SEI"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _H264_CAPS),
        PadTemplate("src", PadDirection.SRC, _H264_CAPS),
    ]


@register_element
class H265CcInserter(_CcInserter):
    FACTORY = "h265ccinserter"
    DESCRIPTION = "Insert closed captions into H.265 SEI"
    H265 = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _H265_CAPS),
        PadTemplate("src", PadDirection.SRC, _H265_CAPS),
    ]


@register_element
class H265CcExtractor(_CcExtractor):
    FACTORY = "h265ccextractor"
    DESCRIPTION = "Extract closed captions from H.265 SEI"
    H265 = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _H265_CAPS),
        PadTemplate("src", PadDirection.SRC, _H265_CAPS),
    ]


@register_element
class AlphaCombine(TransformElement):
    """alpha_combine (gst-plugins-bad/gst/codecalpha/
    gstalphacombine.c): joins a color stream and an alpha stream
    (its luma) into A420.  Aggregator-style: `sink` carries color,
    `alpha` the transparency video."""
    FACTORY = "alpha_combine"
    DESCRIPTION = "Combine color and alpha video streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("alpha", PadDirection.SINK,
                    "video/x-raw, format={ I420, GRAY8 }"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=A420"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            f = {"format": "A420"}
            if caps is not None and len(caps):
                for k in ("width", "height", "framerate"):
                    v = caps[0].get(k)
                    if v is not None:
                        f[k] = v
            from ..core.structure import Structure
            res = Caps([Structure("video/x-raw", f)])
        else:
            res = Caps.from_string("video/x-raw, format=I420")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf):
        # color on the chain pad; alpha frames arrive via the second
        # pad's peer buffer (pipeline delivers per-pad in aggregate
        # mode) — in transform mode the alpha rides buf.meta["alpha"]
        if buf is None:
            return None
        alpha = (buf.meta or {}).get("alpha")
        y = buf.data[0]
        if alpha is None:
            alpha = torch.full_like(y, 255)
        else:
            if not isinstance(alpha, torch.Tensor):
                alpha = device_array(np.asarray(alpha), y)
            alpha = alpha.to(y.device)
            if alpha.ndim == y.ndim - 1:
                alpha = alpha.expand(y.shape).contiguous()
        return buf.with_(data=tuple(buf.data) + (alpha,))


@register_element
class AlphaCombineAlias(AlphaCombine):
    """alphacombine — the reference's element name
    (gst-plugins-bad/gst/codecalpha/gstalphacombine.c)."""
    FACTORY = "alphacombine"


def build_udu_sei_payload(uuid16: bytes, payload: bytes) -> bytes:
    """SEI user_data_unregistered body (H.264 D.1.7 / H.265 D.2.7):
    16-byte UUID + free-form data (type/size framing in _sei_nal)."""
    return uuid16[:16].ljust(16, b"\x00") + payload


class _SeiInserter(_CcInserter):
    """h264seiinserter / h265seiinserter (gst-plugins-bad/gst/
    closedcaption/gstcodecseiinserter.c): inserts closed-caption SEI
    (like the ccinserter base) AND user-data-unregistered SEI from
    buf.meta["sei-user-data"] = (uuid16, payload) or a list of them;
    remove-caption-meta drops the metas after insertion."""
    PROPERTIES = {
        "remove-caption-meta": (bool, False,
                                "drop the metas after inserting"),
        "caption-meta-order": (str, "decode",
                               "decode | display meta ordering"),
    }

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        buf = super().host_process(buf)
        if buf is None:
            return None
        udu = (buf.meta or {}).get("sei-user-data")
        if udu:
            if isinstance(udu, tuple):
                udu = [udu]
            seis = [_sei_nal(5, build_udu_sei_payload(bytes(u),
                                                      bytes(p)),
                             self.H265) for u, p in udu]
            blobs = _blobs(buf)
            out = []
            for au in blobs:
                rebuilt = bytearray()
                inserted = False
                for nal in _split_annexb(au):
                    if not inserted and self._is_vcl(nal):
                        for s in seis:
                            rebuilt += b"\x00\x00\x00\x01" + s
                        inserted = True
                    rebuilt += b"\x00\x00\x00\x01" + nal
                if not inserted:
                    for s in seis:
                        rebuilt += b"\x00\x00\x00\x01" + s
                out.append(np.frombuffer(bytes(rebuilt), np.uint8))
            buf = buf.with_(data=out if len(out) > 1 else out[0])
        if self.props["remove-caption-meta"]:
            meta = dict(buf.meta or {})
            meta.pop("closedcaption", None)
            meta.pop("sei-user-data", None)
            buf = buf.with_(meta=meta)
        return buf


@register_element
class H264SeiInserter(_SeiInserter):
    FACTORY = "h264seiinserter"
    DESCRIPTION = "Inserts SEI messages into H.264 streams"
    H265 = False
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _H264_CAPS),
        PadTemplate("src", PadDirection.SRC, _H264_CAPS),
    ]


@register_element
class H265SeiInserter(_SeiInserter):
    FACTORY = "h265seiinserter"
    DESCRIPTION = "Inserts SEI messages into H.265 streams"
    H265 = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _H265_CAPS),
        PadTemplate("src", PadDirection.SRC, _H265_CAPS),
    ]
