"""gdppay / gdpdepay — GStreamer Data Protocol 1.0.

Port of gst-plugins-bad/gst/gdp/ (dataprotocol.c): typed packets with
a 62-byte big-endian header —
  [0]=major [1]=minor [2]=flags [4:6]=payload-type [6:10]=length
  [10:18]=timestamp [18:26]=duration [26:34]=offset [34:42]=offset-end
  [42:44]=buffer-flags [44:52]=dts [58:60]=header-CRC [60:62]=payload-CRC
CRC-16/CCITT-FALSE (poly 0x1021, init 0xFFFF) over bytes 0..57 and
over the payload; payload types NONE=0, BUFFER=1, CAPS=2 (caps string
+ trailing NUL), EVENT_NONE+n=64+n (dataprotocol.h:65-70).

Serialized pipelines (gdppay ! tcpserversink / filesink, then
tcpclientsrc / filesrc ! gdpdepay) carry caps + typed buffers across
processes.  Buffers serialize as the caps' canonical byte layout
(video frames via the format packer, audio via the sample packer), so
the wire format is the same bytes GStreamer would carry.

A port of the JAX package's ``elements/gdp.py``.  gdppay copies each tick's
data to the host to frame it and gives host bytes; gdpdepay is a source
whose host arrays the pipeline stages.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..audio import format as afmt
from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SourceElement,
                            TransformElement, register_element)
from ..video.format import from_bytes, to_bytes
from ..video.info import VideoInfo

HEADER_LEN = 62
PAYLOAD_BUFFER = 1
PAYLOAD_CAPS = 2

_CRC_TABLE = []
for _i in range(256):
    _c = _i << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x1021) & 0xFFFF if _c & 0x8000 \
            else (_c << 1) & 0xFFFF
    _CRC_TABLE.append(_c)


def dp_crc(data: bytes) -> int:
    if not data:
        return 0
    c = 0xFFFF
    for b in data:
        c = (_CRC_TABLE[((c >> 8) ^ b) & 0xFF] ^ (c << 8)) & 0xFFFF
    return c


FLAG_CRC_HEADER = 0x01   # dp-private.h GST_DP_HEADER_FLAG_CRC_HEADER
FLAG_CRC_PAYLOAD = 0x02  # GST_DP_HEADER_FLAG_CRC_PAYLOAD


def dp_packet(ptype: int, payload: bytes, pts=None, duration=None,
              crc_header: bool = True,
              crc_payload: bool = False) -> bytes:
    """Reference gdppay defaults: crc-header=TRUE, crc-payload=FALSE
    (gstgdppay.c:60) — flags byte 0x01, payload CRC field 0."""
    h = bytearray(HEADER_LEN)
    h[0], h[1] = 1, 0
    h[2] = ((FLAG_CRC_HEADER if crc_header else 0)
            | (FLAG_CRC_PAYLOAD if crc_payload else 0))
    struct.pack_into(">H", h, 4, ptype)
    struct.pack_into(">I", h, 6, len(payload))
    struct.pack_into(">Q", h, 10,
                     pts if pts is not None else 0xFFFFFFFFFFFFFFFF)
    struct.pack_into(">Q", h, 18, duration if duration is not None
                     else 0xFFFFFFFFFFFFFFFF)
    struct.pack_into(">Q", h, 26, 0xFFFFFFFFFFFFFFFF)
    struct.pack_into(">Q", h, 34, 0xFFFFFFFFFFFFFFFF)
    struct.pack_into(">Q", h, 44, 0xFFFFFFFFFFFFFFFF)
    struct.pack_into(">H", h, 60,
                     dp_crc(payload) if crc_payload else 0)
    struct.pack_into(">H", h, 58,
                     dp_crc(bytes(h[:58])) if crc_header else 0)
    return bytes(h) + payload


def dp_parse(data: bytes, pos: int):
    """-> (ptype, payload, pts, duration, next_pos) or None."""
    if pos + HEADER_LEN > len(data):
        return None
    h = data[pos:pos + HEADER_LEN]
    if h[0] != 1:
        raise ValueError("gdp: unsupported major version")
    hcrc = struct.unpack(">H", h[58:60])[0]
    if hcrc and dp_crc(h[:58]) != hcrc:
        raise ValueError("gdp: header CRC mismatch")
    length = struct.unpack(">I", h[6:10])[0]
    if pos + HEADER_LEN + length > len(data):
        return None
    payload = data[pos + HEADER_LEN:pos + HEADER_LEN + length]
    pcrc = struct.unpack(">H", h[60:62])[0]
    if pcrc and dp_crc(payload) != pcrc:
        raise ValueError("gdp: payload CRC mismatch")
    ptype = struct.unpack(">H", h[4:6])[0]
    pts = struct.unpack(">Q", h[10:18])[0]
    dur = struct.unpack(">Q", h[18:26])[0]
    none = 0xFFFFFFFFFFFFFFFF
    return (ptype, payload,
            None if pts == none else pts,
            None if dur == none else dur,
            pos + HEADER_LEN + length)


def _serialize_payload(buf: Buffer, caps) -> List[bytes]:
    """Per-frame canonical bytes for the negotiated caps."""
    s = caps[0]
    if s.name == "video/x-raw":
        vi = VideoInfo.from_caps_structure(s)
        raw = to_bytes(vi.finfo,
                       tuple(host_array(p) for p in buf.data),
                       vi.width, vi.height)
        return [raw.reshape(buf.batch, -1)[k].tobytes()
                for k in range(buf.batch)]
    if s.name == "audio/x-raw":
        ai = AudioInfo.from_caps_structure(s)
        return [afmt.to_bytes(ai.finfo, buf.data).tobytes()]
    # coded/opaque payloads: bytes or arrays
    d = buf.data if isinstance(buf.data, list) else [buf.data]
    return [bytes(b) if isinstance(b, (bytes, bytearray))
            else host_array(b).tobytes() for b in d]


def _deserialize_payload(payloads: List[bytes], caps):
    s = caps[0]
    if s.name == "video/x-raw":
        vi = VideoInfo.from_caps_structure(s)
        raws = np.stack([np.frombuffer(p, np.uint8)
                         for p in payloads])
        return from_bytes(vi.finfo, raws, vi.width, vi.height), \
            len(payloads)
    if s.name == "audio/x-raw":
        ai = AudioInfo.from_caps_structure(s)
        arr = afmt.from_bytes(
            ai.finfo,
            np.frombuffer(b"".join(payloads), np.uint8), ai.channels)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr, 1
    return [np.frombuffer(p, np.uint8) for p in payloads], \
        len(payloads)


@register_element
class GdpPay(TransformElement):
    FACTORY = "gdppay"
    DESCRIPTION = "Payloads GStreamer Data Protocol buffers"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, "application/x-gdp"),
    ]
    PROPERTIES = {"crc-header": (bool, True, ""),
                  "crc-payload": (bool, False, "")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._caps_sent = False

    def start(self):
        self._caps_sent = False

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-gdp")
               if direction == PadDirection.SINK else Caps.any())
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._incaps = incaps

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        out = bytearray()
        crc_h = self.props["crc-header"]
        crc_p = self.props["crc-payload"]
        if not self._caps_sent:
            caps_str = str(self._incaps)
            out += dp_packet(PAYLOAD_CAPS,
                             caps_str.encode() + b"\0",
                             crc_header=crc_h, crc_payload=crc_p)
            self._caps_sent = True
        payloads = _serialize_payload(buf, self._incaps)
        n = len(payloads)
        for k, p in enumerate(payloads):
            pts = buf.pts
            if pts is not None and buf.duration and n > 1:
                pts = pts + k * buf.duration // n
            out += dp_packet(PAYLOAD_BUFFER, p, pts=pts,
                             duration=(buf.duration // n
                                       if buf.duration and n else
                                       buf.duration),
                             crc_header=crc_h, crc_payload=crc_p)
        return buf.with_(data=np.frombuffer(bytes(out), np.uint8),
                         batch=1)


@register_element
class GdpDepay(SourceElement):
    """gdpdepay (pull-mode collapse like the other depacketizers:
    location-based; the caps packet in the stream configures the
    output caps)."""
    FACTORY = "gdpdepay"
    DESCRIPTION = "Depayloads GStreamer Data Protocol buffers"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"location": (str, "", "gdp stream file path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._packets = None
        self._caps = None
        self._pos = 0

    def _load(self):
        if self._packets is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        pos = 0
        packets = []
        caps = None
        while True:
            r = dp_parse(data, pos)
            if r is None:
                break
            ptype, payload, pts, dur, pos = r
            if ptype == PAYLOAD_CAPS:
                caps = Caps.from_string(
                    payload.rstrip(b"\0").decode())
            elif ptype == PAYLOAD_BUFFER:
                packets.append((payload, pts, dur))
        if caps is None:
            raise ValueError("gdpdepay: no caps packet in stream")
        self._caps = caps
        self._packets = packets

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        caps = self._caps if self._caps is not None else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._packets):
            return None
        s = self._caps[0]
        if s.name == "video/x-raw":
            take = self._packets[self._pos:
                                 self._pos + max(1, n_frames)]
            data, batch = _deserialize_payload(
                [p for p, _, _ in take], self._caps)
            pts = take[0][1]
            self._pos += len(take)
            return Buffer(data=data, batch=batch, pts=pts,
                          duration=take[0][2])
        payload, pts, dur = self._packets[self._pos]
        self._pos += 1
        data, batch = _deserialize_payload([payload], self._caps)
        return Buffer(data=data, batch=batch, pts=pts, duration=dur)
