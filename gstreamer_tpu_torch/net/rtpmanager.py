"""RTP session management — rtpmanager (gst-plugins-good/gst/rtpmanager)
equivalent, reduced.

Reference: rtpsession.c / rtpsource.c keep per-SSRC receive statistics
(packet/byte counts, extended highest sequence with cycle tracking,
expected vs received -> cumulative lost and fraction lost, RFC 3550
A.8 interarrival jitter), rtpbin composes session + jitterbuffer (+
pt demux).  Here `rtpsession` is a pass-through stats collector over
the framework's list-of-packets RTP buffers and `rtpbin` collapses
session + jitterbuffer into one element, mirroring how the other
composite bins are reduced in this framework.

A copy of the JAX package's ``net/rtpmanager.py``. Host code only: packets
stay host bytes.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from .rtp import RtpJitterBuffer, parse_rtp_header


class RtpSource:
    """rtpsource.c receive-side statistics for one SSRC."""

    def __init__(self, ssrc: int, clock_rate: int = 90000):
        self.ssrc = ssrc
        self.clock_rate = clock_rate
        self.packets = 0
        self.octets = 0
        self.base_seq: Optional[int] = None
        self.max_seq = 0
        self.cycles = 0
        self.jitter = 0.0           # RFC 3550 A.8, timestamp units
        self._last_transit: Optional[float] = None

    # -- per-packet update (rtp_source_process_rtp) --------------------------
    def process(self, seq: int, timestamp: int, payload_len: int,
                arrival_ns: Optional[int] = None) -> None:
        if self.base_seq is None:
            self.base_seq = seq
            self.max_seq = seq
        else:
            delta = (seq - self.max_seq) & 0xFFFF
            if delta < 0x8000:
                if seq < self.max_seq:
                    self.cycles += 1 << 16     # wrapped
                self.max_seq = seq
        self.packets += 1
        self.octets += payload_len
        # interarrival jitter (RFC 3550 A.8): D = (Rj-Ri) - (Sj-Si) in
        # timestamp units; J += (|D| - J) / 16
        arrival = (arrival_ns if arrival_ns is not None
                   else time.monotonic_ns())
        transit = arrival * self.clock_rate / 1e9 - timestamp
        if self._last_transit is not None:
            d = abs(transit - self._last_transit)
            self.jitter += (d - self.jitter) / 16.0
        self._last_transit = transit

    # -- derived (RFC 3550 6.4.1 / A.3) ---------------------------------------
    @property
    def extended_max(self) -> int:
        return self.cycles + self.max_seq

    @property
    def expected(self) -> int:
        if self.base_seq is None:
            return 0
        return self.extended_max - self.base_seq + 1

    @property
    def lost(self) -> int:
        return self.expected - self.packets

    def stats(self) -> Dict:
        return {"ssrc": self.ssrc, "packets-received": self.packets,
                "octets-received": self.octets,
                "expected": self.expected, "lost": self.lost,
                "jitter": self.jitter,
                "extended-max": self.extended_max}


class RtpSession:
    """rtpsession.c (receive path): SSRC table of RtpSources."""

    def __init__(self, clock_rate: int = 90000):
        self.clock_rate = clock_rate
        self.sources: Dict[int, RtpSource] = {}

    def process_packet(self, pkt: bytes,
                       arrival_ns: Optional[int] = None) -> dict:
        info = parse_rtp_header(pkt)
        src = self.sources.get(info["ssrc"])
        if src is None:
            src = RtpSource(info["ssrc"], self.clock_rate)
            self.sources[info["ssrc"]] = src
        src.process(info["seq"], info["timestamp"],
                    len(info["payload"]), arrival_ns)
        return info

    def stats(self) -> Dict:
        return {"num-sources": len(self.sources),
                "sources": [s.stats() for s in self.sources.values()]}

    # -- RTCP (rtp_session_create_rtcp / _process_rtcp, reduced) -------------
    def create_rtcp(self, sender_ssrc: int,
                    cname: str = "gstreamer-tpu") -> bytes:
        """Compound RR + SDES(CNAME) from the current receive stats;
        fraction lost is computed over the interval since the previous
        report."""
        from .rtcp import RtcpPacket, TYPE_SDES, build_rr
        prev_e = getattr(self, "_prev_expected", {})
        prev_r = getattr(self, "_prev_received", {})
        rr = build_rr(sender_ssrc, list(self.sources.values()),
                      prev_e, prev_r)
        self._prev_expected = {s.ssrc: s.expected
                               for s in self.sources.values()}
        self._prev_received = {s.ssrc: s.packets
                               for s in self.sources.values()}
        sdes = RtcpPacket(ptype=TYPE_SDES,
                          sdes=[(sender_ssrc, cname)]).pack()
        return rr + sdes

    def process_rtcp(self, data: bytes):
        """Handle incoming RTCP: BYE removes the source; returns the
        parsed packets for the caller (SR timestamps etc.)."""
        from .rtcp import TYPE_BYE, parse_compound
        pkts = parse_compound(data)
        for p in pkts:
            if p.ptype == TYPE_BYE:
                for ssrc in p.bye_ssrcs:
                    self.sources.pop(ssrc, None)
        return pkts


@register_element
class RtpSessionElement(TransformElement):
    """rtpsession: pass-through RTP with per-SSRC receive statistics."""
    FACTORY = "rtpsession"
    DESCRIPTION = "RTP session management (per-SSRC statistics)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.session = RtpSession()

    def set_info(self, incaps, outcaps):
        rate = incaps[0].get("clock-rate") if len(incaps) else None
        if isinstance(rate, int) and rate > 0:
            self.session.clock_rate = rate

    def start(self):
        self.session = RtpSession(self.session.clock_rate)

    def get_stats(self) -> Dict:
        return self.session.stats()

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        pkts = buf.data if isinstance(buf.data, list) else [buf.data]
        for pkt in pkts:
            if isinstance(pkt, (np.ndarray, torch.Tensor)):
                pkt = host_array(pkt).tobytes()
            self.session.process_packet(bytes(pkt))
        return buf


@register_element
class RtpBin(RtpJitterBuffer):
    """rtpbin (reduced): session statistics + jitterbuffer reordering in
    one element — the collapse of the reference's
    rtpsession ! rtpssrcdemux ! rtpjitterbuffer chain for the
    single-stream case."""
    FACTORY = "rtpbin"
    DESCRIPTION = "Real-Time Transport Protocol bin (session + "\
        "jitterbuffer, reduced)"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.session = RtpSession()

    def get_session_stats(self) -> Dict:
        return self.session.stats()

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is not None:
            pkts = buf.data if isinstance(buf.data, list) else [buf.data]
            for pkt in pkts:
                if isinstance(pkt, (np.ndarray, torch.Tensor)):
                    pkt = host_array(pkt).tobytes()
                self.session.process_packet(bytes(pkt))
        return super().host_process(buf)