"""RTCP (RFC 3550) — GstRTCPBuffer (gstrtcpbuffer.c) equivalent,
reduced to the packet types rtpsession uses: SR, RR, SDES(CNAME), BYE.

Packets parse/serialize as compound buffers; report blocks carry the
RFC 3550 6.4.1 fields (fraction lost, cumulative lost 24-bit, extended
highest sequence, jitter, LSR, DLSR), generated here straight from
`net.rtpmanager.RtpSource` statistics.

A copy of the JAX package's ``net/rtcp.py``. Host code only: nothing in it
touches a device.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

RTCP_VERSION = 2
TYPE_SR = 200
TYPE_RR = 201
TYPE_SDES = 202
TYPE_BYE = 203
TYPE_APP = 204
TYPE_RTPFB = 205            # transport-layer feedback (RFC 4585)
RTPFB_FMT_NACK = 1          # Generic NACK (RFC 4585 §6.2.1)


@dataclass
class ReportBlock:
    ssrc: int = 0
    fraction_lost: int = 0       # 0..255
    cumulative_lost: int = 0     # 24-bit signed-ish (clamped)
    extended_seq: int = 0
    jitter: int = 0
    lsr: int = 0
    dlsr: int = 0

    def pack(self) -> bytes:
        lost = max(-(1 << 23), min(self.cumulative_lost, (1 << 23) - 1))
        return (struct.pack(">I", self.ssrc & 0xFFFFFFFF)
                + struct.pack(">I", ((self.fraction_lost & 0xFF) << 24)
                              | (lost & 0xFFFFFF))
                + struct.pack(">IIII", self.extended_seq & 0xFFFFFFFF,
                              self.jitter & 0xFFFFFFFF,
                              self.lsr & 0xFFFFFFFF,
                              self.dlsr & 0xFFFFFFFF))

    @classmethod
    def unpack(cls, data: bytes) -> "ReportBlock":
        ssrc, fl_lost, ext, jit, lsr, dlsr = struct.unpack(
            ">IIIIII", data[:24])
        lost = fl_lost & 0xFFFFFF
        if lost & 0x800000:
            lost -= 1 << 24
        return cls(ssrc=ssrc, fraction_lost=fl_lost >> 24,
                   cumulative_lost=lost, extended_seq=ext, jitter=jit,
                   lsr=lsr, dlsr=dlsr)


@dataclass
class RtcpPacket:
    ptype: int = TYPE_RR
    ssrc: int = 0
    # SR only:
    ntp: int = 0                 # 64-bit NTP timestamp
    rtp_ts: int = 0
    packet_count: int = 0
    octet_count: int = 0
    reports: List[ReportBlock] = field(default_factory=list)
    # SDES only: list of (ssrc, cname)
    sdes: List[Tuple[int, str]] = field(default_factory=list)
    # BYE only:
    bye_ssrcs: List[int] = field(default_factory=list)
    # APP only (RFC 3550 6.7; carries RIST range NACKs):
    app_name: str = ""
    app_data: bytes = b""
    # RTPFB only (RFC 4585; count field is the FMT):
    fb_fmt: int = 0
    fb_media_ssrc: int = 0
    fci: bytes = b""

    def pack(self) -> bytes:
        if self.ptype == TYPE_SR:
            body = struct.pack(">IQIII", self.ssrc, self.ntp,
                               self.rtp_ts & 0xFFFFFFFF,
                               self.packet_count, self.octet_count)
            body += b"".join(r.pack() for r in self.reports)
            count = len(self.reports)
        elif self.ptype == TYPE_RR:
            body = struct.pack(">I", self.ssrc)
            body += b"".join(r.pack() for r in self.reports)
            count = len(self.reports)
        elif self.ptype == TYPE_SDES:
            chunks = b""
            for ssrc, cname in self.sdes:
                item = cname.encode()
                chunk = struct.pack(">I", ssrc) + bytes([1, len(item)]) \
                    + item + b"\x00"
                chunk += b"\x00" * ((4 - len(chunk) % 4) % 4)
                chunks += chunk
            body = chunks
            count = len(self.sdes)
        elif self.ptype == TYPE_BYE:
            body = b"".join(struct.pack(">I", s) for s in self.bye_ssrcs)
            count = len(self.bye_ssrcs)
        elif self.ptype == TYPE_APP:
            name = self.app_name.encode()[:4].ljust(4, b" ")
            data = self.app_data
            data += b"\x00" * ((4 - len(data) % 4) % 4)
            body = struct.pack(">I", self.ssrc) + name + data
            count = self.fb_fmt & 0x1F          # APP subtype
        elif self.ptype == TYPE_RTPFB:
            fci = self.fci + b"\x00" * ((4 - len(self.fci) % 4) % 4)
            body = struct.pack(">II", self.ssrc,
                               self.fb_media_ssrc) + fci
            count = self.fb_fmt & 0x1F
        else:
            raise ValueError(f"rtcp: unsupported type {self.ptype}")
        length = len(body) // 4     # in 32-bit words minus one, hdr adds 1
        hdr = bytes([((RTCP_VERSION << 6) | count) & 0xFF, self.ptype]) \
            + struct.pack(">H", length)
        return hdr + body


def parse_compound(data: bytes) -> List[RtcpPacket]:
    """Parse a compound RTCP buffer into packets."""
    out = []
    pos = 0
    data = bytes(data)
    while pos + 4 <= len(data):
        b0, pt = data[pos], data[pos + 1]
        if b0 >> 6 != RTCP_VERSION:
            raise ValueError("rtcp: bad version")
        count = b0 & 0x1F
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 4 + length * 4]
        pkt = RtcpPacket(ptype=pt)
        if pt == TYPE_SR:
            (pkt.ssrc, pkt.ntp, pkt.rtp_ts, pkt.packet_count,
             pkt.octet_count) = struct.unpack(">IQIII", body[:24])
            for k in range(count):
                pkt.reports.append(
                    ReportBlock.unpack(body[24 + 24 * k:]))
        elif pt == TYPE_RR:
            pkt.ssrc = struct.unpack(">I", body[:4])[0]
            for k in range(count):
                pkt.reports.append(ReportBlock.unpack(body[4 + 24 * k:]))
        elif pt == TYPE_SDES:
            p = 0
            for _ in range(count):
                ssrc = struct.unpack(">I", body[p:p + 4])[0]
                p += 4
                cname = ""
                while p < len(body) and body[p] != 0:
                    itype, ilen = body[p], body[p + 1]
                    val = body[p + 2:p + 2 + ilen].decode(
                        "utf-8", "replace")
                    if itype == 1:
                        cname = val
                    p += 2 + ilen
                p += 1                       # the terminating zero
                p += (4 - p % 4) % 4
                pkt.sdes.append((ssrc, cname))
        elif pt == TYPE_BYE:
            for k in range(count):
                pkt.bye_ssrcs.append(struct.unpack(
                    ">I", body[4 * k:4 * k + 4])[0])
        elif pt == TYPE_APP:
            pkt.ssrc = struct.unpack(">I", body[:4])[0]
            pkt.app_name = body[4:8].decode("ascii", "replace").strip()
            pkt.app_data = body[8:]
            pkt.fb_fmt = count
        elif pt == TYPE_RTPFB:
            pkt.ssrc, pkt.fb_media_ssrc = struct.unpack(">II", body[:8])
            pkt.fci = body[8:]
            pkt.fb_fmt = count
        out.append(pkt)
        pos += 4 + length * 4
    return out


def ntp_time(unix_seconds: float) -> int:
    """64-bit NTP timestamp from a UNIX time."""
    sec = int(unix_seconds) + 2208988800
    frac = int((unix_seconds % 1.0) * (1 << 32))
    return ((sec & 0xFFFFFFFF) << 32) | (frac & 0xFFFFFFFF)


def build_sr(sender_ssrc: int, ntp: int, rtp_ts: int,
             packet_count: int, octet_count: int,
             cname: str = "gstreamer-tpu") -> bytes:
    """Compound SR + SDES(CNAME) (rtpsession.c
    rtp_session_create_rtcp sender path; rtsp-stream.c sends these on
    the session's RTCP socket)."""
    sr = RtcpPacket(ptype=TYPE_SR, ssrc=sender_ssrc, ntp=ntp,
                    rtp_ts=rtp_ts, packet_count=packet_count,
                    octet_count=octet_count)
    sdes = RtcpPacket(ptype=TYPE_SDES, sdes=[(sender_ssrc, cname)])
    return sr.pack() + sdes.pack()


def build_bye(ssrc: int) -> bytes:
    return RtcpPacket(ptype=TYPE_BYE, bye_ssrcs=[ssrc]).pack()


def build_rr(sender_ssrc: int, sources, prev_expected=None,
             prev_received=None) -> bytes:
    """Receiver report from RtpSource stats (rtpsession.c
    rtp_session_create_rtcp reduced): one report block per remote
    source, fraction lost computed over the interval when the previous
    counters are supplied."""
    reports = []
    for src in sources:
        expected = src.expected
        received = src.packets
        if prev_expected is not None:
            exp_i = expected - prev_expected.get(src.ssrc, 0)
            rec_i = received - prev_received.get(src.ssrc, 0)
        else:
            exp_i, rec_i = expected, received
        lost_i = exp_i - rec_i
        fraction = (lost_i << 8) // exp_i if exp_i > 0 and lost_i > 0 \
            else 0
        reports.append(ReportBlock(
            ssrc=src.ssrc, fraction_lost=min(255, fraction),
            cumulative_lost=src.lost, extended_seq=src.extended_max,
            jitter=int(src.jitter)))
    return RtcpPacket(ptype=TYPE_RR, ssrc=sender_ssrc,
                      reports=reports).pack()


def build_generic_nack(sender_ssrc: int, media_ssrc: int,
                       seqnums) -> bytes:
    """Generic NACK feedback (RFC 4585 §6.2.1; rtpsession.c
    rtp_session_on_sending_nacks FB path): each FCI entry covers a
    PID plus a 16-packet BLP bitmask."""
    seqs = sorted(set(s & 0xFFFF for s in seqnums))
    fci = b""
    i = 0
    while i < len(seqs):
        pid = seqs[i]
        blp = 0
        j = i + 1
        while j < len(seqs) and ((seqs[j] - pid) & 0xFFFF) <= 16:
            blp |= 1 << (((seqs[j] - pid) & 0xFFFF) - 1)
            j += 1
        fci += struct.pack(">HH", pid, blp)
        i = j
    return RtcpPacket(ptype=TYPE_RTPFB, ssrc=sender_ssrc,
                      fb_fmt=RTPFB_FMT_NACK, fb_media_ssrc=media_ssrc,
                      fci=fci).pack()


def parse_generic_nack(pkt: RtcpPacket) -> List[int]:
    """Expand a Generic NACK packet's FCI into requested seqnums."""
    seqs: List[int] = []
    for k in range(0, len(pkt.fci) - 3, 4):
        pid, blp = struct.unpack(">HH", pkt.fci[k:k + 4])
        seqs.append(pid)
        for bit in range(16):
            if blp & (1 << bit):
                seqs.append((pid + bit + 1) & 0xFFFF)
    return seqs


def build_rist_nack(media_ssrc: int, ranges) -> bytes:
    """RIST range NACK: APP packet named "RIST" whose data words are
    (start_seq << 16) | extra_count (VSF TR-06-1 §5.3.4; the reference
    builds these in gstristsrc.c gst_rist_src_on_sending_nacks)."""
    data = b"".join(struct.pack(">I", ((start & 0xFFFF) << 16)
                                | (extra & 0xFFFF))
                    for start, extra in ranges)
    return RtcpPacket(ptype=TYPE_APP, ssrc=media_ssrc,
                      app_name="RIST", app_data=data).pack()


def parse_rist_nack(pkt: RtcpPacket) -> List[int]:
    """Expand a RIST APP range NACK into requested seqnums."""
    seqs: List[int] = []
    for k in range(0, len(pkt.app_data) - 3, 4):
        word = struct.unpack(">I", pkt.app_data[k:k + 4])[0]
        start, extra = word >> 16, word & 0xFFFF
        for d in range(extra + 1):
            seqs.append((start + d) & 0xFFFF)
    return seqs
