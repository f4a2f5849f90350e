"""SCTP elements — sctpenc / sctpdec (WebRTC data-channel transport).

Reference: gst-plugins-bad/ext/sctp/ (gstsctpenc.c, gstsctpdec.c)
wrap usrsctp; the packet layer here is clean-room RFC 4960: common
header (ports, verification tag, CRC32c checksum) + chunks.  The
reduction implements the data plane used by data channels — DATA
chunks (TSN / stream id / SSN / PPID, unordered flag), cumulative
SACK generation, TSN reordering per stream — with a fixed
verification tag in place of the four-way handshake (the association
setup lives in webrtcbin's offer/answer in the reference too).

A copy of the JAX package's ``net/sctp.py``: the same packets, byte for
byte.  Payloads and packets stay host bytes (``host_array``); both
elements take their source's host bytes (``HOST_INPUT``).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection,
                            PadPresence, PadTemplate, TransformElement,
                            register_element)

CHUNK_DATA = 0
CHUNK_INIT = 1
CHUNK_INIT_ACK = 2
CHUNK_SACK = 3
CHUNK_HEARTBEAT = 4
CHUNK_COOKIE_ECHO = 10
CHUNK_COOKIE_ACK = 11

PPID_WEBRTC_DCEP = 50
PPID_WEBRTC_STRING = 51
PPID_WEBRTC_BINARY = 53

_CRC_TABLE = []


def _crc32c_table():
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC32c (Castagnoli) as SCTP uses it (RFC 4960 appendix B)."""
    tab = _crc32c_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return (~c) & 0xFFFFFFFF


def build_packet(src_port: int, dst_port: int, vtag: int,
                 chunks: List[bytes]) -> bytes:
    body = b"".join(chunks)
    hdr = struct.pack(">HHII", src_port, dst_port, vtag, 0)
    crc = crc32c(hdr + body)
    # checksum stored little-endian per RFC 4960 B.4 convention
    return hdr[:8] + struct.pack("<I", crc) + body


def parse_packet(pkt: bytes) -> dict:
    if len(pkt) < 12:
        raise ValueError("sctp: short packet")
    src, dst, vtag = struct.unpack(">HHI", pkt[:8])
    crc = struct.unpack("<I", pkt[8:12])[0]
    want = crc32c(pkt[:8] + b"\x00\x00\x00\x00" + pkt[12:])
    chunks = []
    pos = 12
    while pos + 4 <= len(pkt):
        ctype, flags, clen = struct.unpack(">BBH", pkt[pos:pos + 4])
        if clen < 4:
            break
        chunks.append((ctype, flags, pkt[pos + 4:pos + clen]))
        pos += (clen + 3) & ~3
    return {"src_port": src, "dst_port": dst, "vtag": vtag,
            "crc_ok": crc == want, "chunks": chunks}


def build_data_chunk(tsn: int, stream_id: int, ssn: int, ppid: int,
                     payload: bytes, unordered: bool = False) -> bytes:
    flags = 0x03 | (0x04 if unordered else 0)   # B|E single fragment
    body = struct.pack(">IHHI", tsn & 0xFFFFFFFF, stream_id,
                       ssn & 0xFFFF, ppid) + payload
    clen = 4 + len(body)
    pad = (4 - clen % 4) % 4
    return struct.pack(">BBH", CHUNK_DATA, flags, clen) \
        + body + b"\x00" * pad


def build_sack(cum_tsn: int, a_rwnd: int = 1 << 20) -> bytes:
    body = struct.pack(">IIHH", cum_tsn & 0xFFFFFFFF, a_rwnd, 0, 0)
    return struct.pack(">BBH", CHUNK_SACK, 0, 4 + len(body)) + body


@register_element
class SctpEnc(AggregatorElement):
    """sctpenc: payload buffers from per-stream request pads into
    SCTP packets (application/x-sctp).  Pad name suffix = stream id
    (sink_0, sink_1, ...); meta['ppid'] overrides the payload id."""
    FACTORY = "sctpenc"
    DESCRIPTION = "Configurable SCTP outgoing stream association"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK, Caps.any(),
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, "application/x-sctp"),
    ]
    PROPERTIES = {
        "sctp-association-id": (int, 1, "association id"),
        "remote-sctp-port": (int, 5000, "destination port"),
        "local-sctp-port": (int, 5000, "source port"),
        "vtag": (int, 0x67747075, "verification tag"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._tsn = 0
        self._ssn: Dict[int, int] = {}

    def negotiate_output(self, in_caps, allowed):
        return Caps.from_string("application/x-sctp")

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        chunks = []
        for pad_name in sorted(ins):
            buf = ins[pad_name]
            if buf is None:
                continue
            try:
                sid = int(pad_name.rsplit("_", 1)[-1])
            except ValueError:
                sid = 0
            d = buf.data
            payload = (bytes(d) if isinstance(d, (bytes, bytearray))
                       else b"".join(
                           host_array(x).tobytes()
                           for x in (d if isinstance(d, (tuple, list))
                                     else [d])))
            ppid = (buf.meta or {}).get("ppid", PPID_WEBRTC_BINARY)
            ssn = self._ssn.get(sid, 0)
            chunks.append(build_data_chunk(self._tsn, sid, ssn,
                                           ppid, payload))
            self._tsn = (self._tsn + 1) & 0xFFFFFFFF
            self._ssn[sid] = (ssn + 1) & 0xFFFF
        if not chunks:
            return None
        pkt = build_packet(self.props["local-sctp-port"],
                           self.props["remote-sctp-port"],
                           self.props["vtag"], chunks)
        return Buffer(data=[pkt], batch=1)


@register_element
class SctpDec(TransformElement):
    """sctpdec: SCTP packets -> ordered per-stream payloads.  Output
    buffers carry the payload list; each payload's (stream id, ppid)
    rides meta['sctp_streams'].  `sacks` collects the cumulative-TSN
    SACK chunks a full association would send back."""
    FACTORY = "sctpdec"
    DESCRIPTION = "Configurable SCTP incoming stream association"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-sctp"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "sctp-association-id": (int, 1, "association id"),
        "local-sctp-port": (int, 5000, "accept only this port "
                                       "(0 = any)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._next_tsn: Optional[int] = None
        self._pending: Dict[int, tuple] = {}
        self.sacks: List[bytes] = []
        self.crc_errors = 0

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.any() if direction == PadDirection.SINK
               else Caps.from_string("application/x-sctp"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._next_tsn = None
        self._pending = {}
        self.sacks = []
        self.crc_errors = 0

    def host_process(self, buf):
        if buf is None:
            return None
        d = buf.data if isinstance(buf.data, list) else [buf.data]
        out = []
        metas = []
        for p in d:
            raw = (bytes(p) if isinstance(p, (bytes, bytearray))
                   else host_array(p).tobytes())
            info = parse_packet(raw)
            if not info["crc_ok"]:
                self.crc_errors += 1
                continue
            port = self.props["local-sctp-port"]
            if port and info["dst_port"] != port:
                continue
            for ctype, flags, body in info["chunks"]:
                if ctype != CHUNK_DATA or len(body) < 12:
                    continue
                tsn, sid, ssn, ppid = struct.unpack(">IHHI",
                                                    body[:12])
                self._pending[tsn] = (sid, ppid, body[12:])
            # drain in TSN order; TSNs below the cumulative point
            # (late arrivals before the anchor settled) deliver
            # immediately rather than being dropped
            if self._next_tsn is None and self._pending:
                self._next_tsn = min(self._pending)
            late = sorted(t for t in self._pending
                          if t < self._next_tsn)
            for t in late:
                sid, ppid, payload = self._pending.pop(t)
                out.append(np.frombuffer(payload, np.uint8))
                metas.append((sid, ppid))
                self.sacks.append(build_sack(t))
            while self._next_tsn in self._pending:
                sid, ppid, payload = self._pending.pop(
                    self._next_tsn)
                out.append(np.frombuffer(payload, np.uint8))
                metas.append((sid, ppid))
                self.sacks.append(build_sack(self._next_tsn))
                self._next_tsn = (self._next_tsn + 1) & 0xFFFFFFFF
        if not out:
            return None
        return buf.with_(data=out,
                         meta=dict(buf.meta or {},
                                   sctp_streams=metas))
