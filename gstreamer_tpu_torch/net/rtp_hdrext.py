"""RTP header extensions (RFC 8285) and the standard extension
elements.

Reference: gstreamer/gst-libs/gst/rtp/gstrtphdrext.c (the
GstRTPHeaderExtension base) and the per-extension elements in
gst-plugins-good/gst/rtpmanager/gstrtphdrext-*.c and
gst-plugins-base/gst/rtp/: rtphdrextclientaudiolevel (RFC 6464),
rtphdrextmid / rtphdrextstreamid / rtphdrextrepairedstreamid
(RFC 8843/8852 SDES items), rtphdrextntp64 (RFC 6051),
rtphdrexttwcc (transport-wide congestion control sequence numbers)
and rtphdrextcolorspace (the webrtc color-space extension).

Extensions attach to payloaders via `add_extension()`
(gst_rtp_base_payload_add_extension analog); the payloader writes a
one-byte-header block (profile 0xBEDE) into each packet and
depayloaders (or parse_rtp_header callers) read it back with
`parse_one_byte_extensions`.

A copy of the JAX package's ``net/rtp_hdrext.py``. Host code only: nothing
in it touches a device.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from ..core.element import Element, register_element

ONE_BYTE_PROFILE = 0xBEDE


def build_one_byte_extensions(items: List[Tuple[int, bytes]]) -> bytes:
    """[(id 1..14, data 1..16 bytes)] -> full extension block
    (profile + length words + padded elements, RFC 8285 §4.2)."""
    body = bytearray()
    for ext_id, data in items:
        if not 1 <= ext_id <= 14:
            raise ValueError(f"rtp_hdrext: bad one-byte id {ext_id}")
        if not 1 <= len(data) <= 16:
            raise ValueError("rtp_hdrext: element must be 1..16 bytes")
        body.append((ext_id << 4) | (len(data) - 1))
        body += data
    pad = (-len(body)) % 4
    body += b"\x00" * pad
    return struct.pack("!HH", ONE_BYTE_PROFILE, len(body) // 4) \
        + bytes(body)


def parse_one_byte_extensions(profile: Optional[int],
                              data: bytes) -> Dict[int, bytes]:
    """Extension block body -> {id: data} (RFC 8285 §4.2)."""
    if profile != ONE_BYTE_PROFILE:
        return {}
    out: Dict[int, bytes] = {}
    pos = 0
    while pos < len(data):
        b = data[pos]
        if b == 0:                           # padding
            pos += 1
            continue
        ext_id = b >> 4
        ln = (b & 0x0F) + 1
        if ext_id == 15:                     # reserved: stop
            break
        out[ext_id] = data[pos + 1:pos + 1 + ln]
        pos += 1 + ln
    return out


class RTPHeaderExtension(Element):
    """Base extension: `write()` produces the element data for one
    packet; `read(data)` interprets it."""
    URI = ""
    PAD_TEMPLATES = []
    PROPERTIES = {"id": (int, 1, "extension id (1..14)")}

    @property
    def ext_id(self) -> int:
        return self.props["id"]

    def write(self) -> bytes:
        raise NotImplementedError

    def read(self, data: bytes):
        return data


@register_element
class RtpHdrExtClientAudioLevel(RTPHeaderExtension):
    """RFC 6464 client-to-mixer audio level (V bit + -dBov level)."""
    FACTORY = "rtphdrextclientaudiolevel"
    DESCRIPTION = "Client-to-Mixer Audio Level (RFC 6464)"
    URI = "urn:ietf:params:rtp-hdrext:ssrc-audio-level"
    PROPERTIES = dict(RTPHeaderExtension.PROPERTIES,
                      level=(int, 0, "audio level 0..127 (-dBov)"),
                      voice=(bool, False, "voice activity flag"))

    def write(self) -> bytes:
        lvl = min(max(self.props["level"], 0), 127)
        return bytes([(0x80 if self.props["voice"] else 0) | lvl])

    def read(self, data: bytes):
        return {"voice": bool(data[0] & 0x80),
                "level": data[0] & 0x7F}


class _SdesExtension(RTPHeaderExtension):
    PROPERTIES = dict(RTPHeaderExtension.PROPERTIES,
                      value=(str, "", "SDES item value"))

    def write(self) -> bytes:
        v = self.props["value"].encode()[:16]
        return v or b"\x00"

    def read(self, data: bytes):
        return data.rstrip(b"\x00").decode("utf-8", "replace")


@register_element
class RtpHdrExtMid(_SdesExtension):
    FACTORY = "rtphdrextmid"
    DESCRIPTION = "BUNDLE media identification (RFC 8843)"
    URI = "urn:ietf:params:rtp-hdrext:sdes:mid"


@register_element
class RtpHdrExtStreamId(_SdesExtension):
    FACTORY = "rtphdrextstreamid"
    DESCRIPTION = "RTP stream identifier (RFC 8852)"
    URI = "urn:ietf:params:rtp-hdrext:sdes:rtp-stream-id"


@register_element
class RtpHdrExtRepairedStreamId(_SdesExtension):
    FACTORY = "rtphdrextrepairedstreamid"
    DESCRIPTION = "Repaired RTP stream identifier (RFC 8852)"
    URI = "urn:ietf:params:rtp-hdrext:sdes:repaired-rtp-stream-id"


@register_element
class RtpHdrExtNtp64(RTPHeaderExtension):
    """RFC 6051 64-bit NTP timestamp."""
    FACTORY = "rtphdrextntp64"
    DESCRIPTION = "RTP NTP-64 timestamps (RFC 6051)"
    URI = "urn:ietf:params:rtp-hdrext:ntp-64"
    PROPERTIES = dict(RTPHeaderExtension.PROPERTIES,
                      ntp=(int, 0, "64-bit NTP timestamp"))

    def write(self) -> bytes:
        return struct.pack("!Q", self.props["ntp"] & (2 ** 64 - 1))

    def read(self, data: bytes):
        return struct.unpack("!Q", data[:8].ljust(8, b"\x00"))[0]


@register_element
class RtpHdrExtTwcc(RTPHeaderExtension):
    """Transport-wide congestion control sequence numbers; the
    counter increments per written packet."""
    FACTORY = "rtphdrexttwcc"
    DESCRIPTION = "Transport-wide congestion control extension"
    URI = ("http://www.ietf.org/id/"
           "draft-holmer-rmcat-transport-wide-cc-extensions-01")

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0

    def write(self) -> bytes:
        v = struct.pack("!H", self._seq & 0xFFFF)
        self._seq += 1
        return v

    def read(self, data: bytes):
        return struct.unpack("!H", data[:2].ljust(2, b"\x00"))[0]


@register_element
class RtpHdrExtColorspace(RTPHeaderExtension):
    """webrtc color-space extension (primaries/transfer/matrix/range
    packed in 4 bytes)."""
    FACTORY = "rtphdrextcolorspace"
    DESCRIPTION = "Color space information (webrtc hdrext)"
    URI = "http://www.webrtc.org/experiments/rtp-hdrext/color-space"
    PROPERTIES = dict(RTPHeaderExtension.PROPERTIES,
                      primaries=(int, 1, ""), transfer=(int, 1, ""),
                      matrix=(int, 1, ""),
                      **{"full-range": (bool, False, "")})

    def write(self) -> bytes:
        return bytes([self.props["primaries"] & 0xFF,
                      self.props["transfer"] & 0xFF,
                      self.props["matrix"] & 0xFF,
                      0x02 if self.props["full-range"] else 0x00])

    def read(self, data: bytes):
        d = data[:4].ljust(4, b"\x00")
        return {"primaries": d[0], "transfer": d[1], "matrix": d[2],
                "full_range": bool(d[3] & 0x02)}
