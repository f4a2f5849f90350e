"""SMPTE 2022-1 forward error correction for RTP streams.

Reference: gst-plugins-bad/gst/rtp/gstrtpst2022-1-fecenc.c and
gstrtpst2022-1-fecdec.c (RFC 2733-based XOR FEC with the ST 2022-1
restrictions: 1-D row/column protection, E=1 extension header).

rtpst2022_1_fecenc: after every L media packets, emits one FEC packet
whose payload is the XOR of the L payloads (padded), with recovery
fields for PT/timestamp/length; SN base + NA identify the protected
run.  rtpst2022_1_fecdec: caches media + FEC packets and rebuilds any
single missing packet per row by XOR-ing the FEC payload with the
received packets.

A copy of the JAX package's ``net/fec.py``: the FEC packet's bytes and the
encoder are the same.  Packets stay host bytes (``host_array``) and both
elements set ``HOST_INPUT``.  The decoder differs where the JAX package's
is at fault (ROADMAP.md section 3): that one forgets every packet at the
end of each buffer, so a row that straddles two buffers (or any row, from
a source that gives one datagram a tick) is never recovered, and it sorts
by the raw 16-bit sequence number, which misorders the packets at the
65535 -> 0 wrap.  The port's keeps its packets across buffers by extended
sequence number and sends them on in that order: a packet after a missing
one waits until a FEC packet has covered the gap (recovered, or lost for
good) or the stream has gone a row's span past it (the largest NA x offset
of the FEC packets seen: the row's FEC packet is lost too), and is flushed
at end of stream.  Until the first FEC packet nothing waits, so a stream
that carries none passes straight through.  Buffers that each hold whole
rows with their FEC packets come out as the JAX package's.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from .rtp import parse_rtp_header, rtp_header


def _xor_bytes(a: bytes, b: bytes) -> bytes:
    n = max(len(a), len(b))
    x = np.frombuffer(a.ljust(n, b"\x00"), np.uint8) \
        ^ np.frombuffer(b.ljust(n, b"\x00"), np.uint8)
    return x.tobytes()


def build_fec_packet(media: List[bytes], fec_pt: int, fec_seq: int,
                     fec_ssrc: int) -> bytes:
    """One ST 2022-1 FEC packet protecting the given media packets
    (one row: offset 1, NA = len(media))."""
    hdrs = [parse_rtp_header(p) for p in media]
    sn_base = hdrs[0]["seq"]
    pt_rec = 0
    m_rec = 0
    ts_rec = 0
    len_rec = 0
    payload_xor = b""
    for h, p in zip(hdrs, media):
        pt_rec ^= h["payload_type"]
        m_rec ^= 1 if h["marker"] else 0
        ts_rec ^= h["timestamp"]
        len_rec ^= len(h["payload"])
        payload_xor = _xor_bytes(payload_xor, h["payload"])
    # RFC 2733 FEC header with the ST 2022-1 E=1 extension:
    # SNBase(16) lenRec(16) E|PTrec(8) mask(24) TSrec(32)
    # X|D|type(3)|index(3) offset(8) NA(8) SNBase-ext(8)
    # (marker recovery rides bit 7 of the otherwise-zero SNBase-ext
    # byte — RFC 2733's E bit displaces M in the PT-recovery byte)
    fec_hdr = struct.pack(
        ">HHB3sI", sn_base & 0xFFFF, len_rec & 0xFFFF,
        0x80 | (pt_rec & 0x7F), b"\x00\x00\x00",
        ts_rec & 0xFFFFFFFF)
    fec_hdr += struct.pack(">BBBB", 0x00, 1, len(media),
                           0x80 if m_rec else 0x00)
    ts = hdrs[-1]["timestamp"]
    return rtp_header(fec_pt, fec_seq, ts, fec_ssrc) \
        + fec_hdr + payload_xor


def parse_fec_packet(pkt: bytes) -> Optional[dict]:
    h = parse_rtp_header(pkt)
    body = h["payload"]
    if len(body) < 14:
        return None
    sn_base, len_rec, e_pt = struct.unpack(">HHB", body[:5])
    ts_rec = struct.unpack(">I", body[8:12])[0]
    offset, na = body[13], body[14] if len(body) > 14 else 0
    m_rec = bool(body[15] & 0x80) if len(body) > 15 else False
    return {"sn_base": sn_base, "len_rec": len_rec,
            "pt_rec": e_pt & 0x7F, "m_rec": m_rec, "ts_rec": ts_rec,
            "offset": max(offset, 1), "na": na,
            "payload_xor": body[16:], "seq": h["seq"]}


@register_element
class RtpSt2022FecEnc(TransformElement):
    FACTORY = "rtpst2022_1_fecenc"
    DESCRIPTION = "SMPTE 2022-1 FEC encoder"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "rows": (int, 5, "packets per FEC row (L)"),
        "pt": (int, 100, "FEC payload type"),
        "ssrc": (int, 0xFEC0FEC0, "FEC stream SSRC"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._row: List[bytes] = []
        self._fec_seq = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._row = []
        self._fec_seq = 0

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        pkts = buf.data if isinstance(buf.data, list) else [buf.data]
        out = []
        for p in pkts:
            raw = (bytes(p) if isinstance(p, (bytes, bytearray))
                   else host_array(p).tobytes())
            out.append(raw)
            self._row.append(raw)
            if len(self._row) >= self.props["rows"]:
                out.append(build_fec_packet(
                    self._row, self.props["pt"], self._fec_seq,
                    self.props["ssrc"]))
                self._fec_seq = (self._fec_seq + 1) & 0xFFFF
                self._row = []
        return buf.with_(data=out)


_WINDOW = 1024     # packets the decoder keeps sent, for recovery


@register_element
class RtpSt2022FecDec(TransformElement):
    FACTORY = "rtpst2022_1_fecdec"
    DESCRIPTION = "SMPTE 2022-1 FEC decoder"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "pt": (int, 100, "FEC payload type"),
    }

    _decouple = True            # flushed at end of stream

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._reset()

    def _reset(self):
        self._held: Dict[int, bytes] = {}   # waiting, by extended seq
        self._sent: Dict[int, bytes] = {}   # sent on, kept for recovery
        self._next: Optional[int] = None    # the next to send on
        self._top: Optional[int] = None     # the highest seen
        self._covered = -1                  # the highest a FEC covered
        self._span: Optional[int] = None    # the widest row of a FEC seen
        self._ssrc: Optional[int] = None    # the media's
        self._last_buf: Optional[Buffer] = None
        self.recovered = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._reset()

    @property
    def _pending_buf(self):
        return self._last_buf if self._held else None

    def _extend(self, seq: int) -> int:
        """A 16-bit sequence number as the extended one nearest the
        highest seen."""
        if self._top is None:
            return seq
        return self._top + ((seq - self._top + 0x8000) & 0xFFFF) - 0x8000

    def _packet(self, ext: int) -> Optional[bytes]:
        return self._held.get(ext, self._sent.get(ext))

    def _recover(self, fec: dict) -> Optional[Tuple[int, bytes]]:
        base = self._extend(fec["sn_base"])
        run = [base + i * fec["offset"] for i in range(fec["na"])]
        self._span = max(self._span or 0, fec["na"] * fec["offset"])
        if run:
            self._covered = max(self._covered, run[-1])
        missing = [s for s in run if self._packet(s) is None]
        if len(missing) != 1 or self._ssrc is None:
            return None
        pay = fec["payload_xor"]
        pt = fec["pt_rec"]
        marker = 1 if fec["m_rec"] else 0
        ts = fec["ts_rec"]
        length = fec["len_rec"]
        for s in run:
            p = self._packet(s)
            if p is not None:
                h = parse_rtp_header(p)
                pay = _xor_bytes(pay, h["payload"])
                pt ^= h["payload_type"]
                marker ^= 1 if h["marker"] else 0
                ts ^= h["timestamp"]
                length ^= len(h["payload"])
        pay = pay[:length]
        self.recovered += 1
        return missing[0], rtp_header(pt, missing[0] & 0xFFFF, ts,
                                      self._ssrc, marker=bool(marker)) + pay

    def _send(self, out: List[bytes], flush: bool = False) -> None:
        """Send on the held packets in order while nothing before them can
        still arrive by recovery: a gap waits for a FEC packet to cover it,
        or for the stream to go a row's span past it."""
        while self._held:
            if self._next in self._held:
                p = self._held.pop(self._next)
                self._sent[self._next] = p
                out.append(p)
            elif not (flush or self._span is None
                      or self._next <= self._covered
                      or self._top - self._next >= self._span):
                break
            self._next += 1
        for s in [s for s in self._sent if s < self._next - _WINDOW]:
            del self._sent[s]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            out: List[bytes] = []
            self._send(out, flush=True)
            return self._last_buf.with_(data=out) if out else None
        self._last_buf = buf
        pkts = buf.data if isinstance(buf.data, list) else [buf.data]
        out, fecs = [], []
        for p in pkts:
            raw = (bytes(p) if isinstance(p, (bytes, bytearray))
                   else host_array(p).tobytes())
            h = parse_rtp_header(raw)
            if h["payload_type"] == self.props["pt"]:
                f = parse_fec_packet(raw)
                if f is not None:
                    fecs.append(f)
                continue
            ext = self._extend(h["seq"])
            self._ssrc = h["ssrc"]
            self._top = ext if self._top is None else max(self._top, ext)
            if self._packet(ext) is not None:
                continue                        # a duplicate
            if self._next is not None and ext < self._next:
                self._sent[ext] = raw           # too late to wait for
                out.append(raw)
            else:
                self._held[ext] = raw
        if self._next is None and self._held:
            self._next = min(self._held)
        for f in fecs:
            rec = self._recover(f)
            if rec is not None:
                ext, pkt = rec
                if self._next is not None and ext < self._next:
                    self._sent[ext] = pkt
                    out.append(pkt)
                else:
                    self._held[ext] = pkt
        if self._next is not None:
            self._send(out)
        if not out:
            return None
        return buf.with_(data=out)
