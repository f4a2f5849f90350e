"""RIST (Reliable Internet Stream Transport) — simple profile.

Clean-room equivalents of the reference RIST elements
(reference: subprojects/gst-plugins-bad/gst/rist/gstristsink.c,
gstristsrc.c, gstristrtxsend.c, gstristrtxreceive.c).  RIST simple
profile (VSF TR-06-1) is plain RTP on an even port plus bidirectional
RTCP on the adjacent odd port; lost media packets are requested via
RTCP NACKs (RFC 4585 Generic NACK or the RIST APP "RIST" range form)
and retransmitted VERBATIM (simple profile does not use RFC 4588
encapsulation — gstristrtxsend.c keeps the original seqnums).

Element mapping:
* ristsink — sends RTP packet buffers to address:port, keeps a
  retransmission history, answers NACKs arriving on its RTCP socket
  (gstristsink.c + gstristrtxsend.c collapsed into one element, the
  same composite-bin reduction used for rtpbin here);
* ristsrc  — binds port/port+1, reorders, NACKs gaps, emits the
  recovered in-order RTP packet stream (gstristsrc.c +
  gstristrtxreceive.c).

The recovery path is host-side socket work by design: IP ingest and
egress stay on the host, the media they carry goes to the device after
the depayloader and decoder.

A copy of the JAX package's ``net/rist.py``: the same packets, NACKs and
header extension, byte for byte.  Packets stay host bytes
(``host_array``); the elements that take packets set ``HOST_INPUT``.
ristsrc differs in one place (ROADMAP.md section 3): a thread reads its
media socket into a queue, which ``create`` takes from.  The JAX
package's reads the socket inside ``create`` only, so while the pipeline
decodes (20-30 ms a 1080p JPEG) the kernel's socket buffer, under two such
frames, overflows and the losses exceed what NACKs recover.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)
from . import rtcp
from .rtp import parse_rtp_header


def _seq_lt(a: int, b: int) -> bool:
    """serial-number (RFC 1982) less-than on 16-bit seqnums."""
    return ((b - a) & 0xFFFF) != 0 and ((b - a) & 0xFFFF) < 0x8000


@register_element
class RistSink(SinkElement):
    """ristsink: RIST simple-profile sender (gstristsink.c).

    Accepts the framework's packetized RTP buffers (list of packet
    bytes, as produced by the rtp*pay elements), sends one datagram
    per packet to address:port, and serves retransmission requests:
    a receive thread on the RTCP socket parses Generic NACK (RTPFB
    fmt=1) and RIST APP range NACKs and re-sends the original packets
    from a bounded seqnum-keyed history (gstristrtxsend.c's
    GstDataQueue ring, reduced to an OrderedDict)."""

    FACTORY = "ristsink"
    DESCRIPTION = "Send RIST simple-profile packets"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "address": (str, "127.0.0.1", "receiver address"),
        "port": (int, 5004, "media UDP port (RTCP rides port+1)"),
        "sender-buffer": (int, 1200, "retransmit history (ms worth "
                          "of packets; bounds the history ring)"),
        "stats-interval": (float, 0.1, "RTCP SR keepalive period (s)"),
        "cname": (str, "gtpu-rist", "RTCP SDES CNAME"),
    }

    HOST_INPUT = True       # takes the source's host packets

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._media: Optional[socket.socket] = None
        self._rtcp: Optional[socket.socket] = None
        self._history: "OrderedDict[int, bytes]" = OrderedDict()
        self._hist_lock = threading.Lock()
        self._rtcp_thread: Optional[threading.Thread] = None
        self._running = False
        self._ssrc = 0
        self._last_sr = 0.0
        # observable for tests / stats tracer
        self.stats: Dict[str, int] = {"sent": 0, "retransmitted": 0,
                                      "nacks": 0}

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._media = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._rtcp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._rtcp.bind(("0.0.0.0", 0))
        self._rtcp.settimeout(0.05)
        self._running = True
        self._rtcp_thread = threading.Thread(target=self._rtcp_loop,
                                             daemon=True)
        self._rtcp_thread.start()

    def stop(self):
        self._running = False
        if self._rtcp_thread:
            self._rtcp_thread.join(1.0)
            self._rtcp_thread = None
        for s in (self._media, self._rtcp):
            if s:
                s.close()
        self._media = self._rtcp = None
        with self._hist_lock:
            self._history.clear()

    # -- RTCP: keepalive out, NACKs in --------------------------------------
    def _rtcp_addr(self) -> Tuple[str, int]:
        return (self.props["address"], self.props["port"] + 1)

    def _send_sr(self):
        """Periodic SR+SDES so the receiver learns our RTCP return
        address (RIST RTCP is bidirectional on the odd port)."""
        now = time.monotonic()
        if now - self._last_sr < self.props["stats-interval"]:
            return
        self._last_sr = now
        ntp = int((time.time() + 2208988800) * (1 << 32))
        sr = rtcp.RtcpPacket(
            ptype=rtcp.TYPE_SR, ssrc=self._ssrc, ntp=ntp,
            rtp_ts=0, packet_count=self.stats["sent"], octet_count=0)
        sdes = rtcp.RtcpPacket(
            ptype=rtcp.TYPE_SDES, ssrc=self._ssrc,
            sdes=[(1, self.props["cname"])])
        try:
            self._rtcp.sendto(sr.pack() + sdes.pack(), self._rtcp_addr())
        except OSError:
            pass

    def _rtcp_loop(self):
        while self._running:
            self._send_sr()
            try:
                data, _ = self._rtcp.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                pkts = rtcp.parse_compound(data)
            except (ValueError, struct.error):
                continue
            seqs: List[int] = []
            for p in pkts:
                if (p.ptype == rtcp.TYPE_RTPFB
                        and p.fb_fmt == rtcp.RTPFB_FMT_NACK):
                    seqs.extend(rtcp.parse_generic_nack(p))
                elif p.ptype == rtcp.TYPE_APP and p.app_name == "RIST":
                    seqs.extend(rtcp.parse_rist_nack(p))
            if seqs:
                self.stats["nacks"] += 1
                self._retransmit(seqs)

    def _retransmit(self, seqs: List[int]):
        addr = (self.props["address"], self.props["port"])
        with self._hist_lock:
            wanted = [self._history.get(s & 0xFFFF) for s in seqs]
        for pkt in wanted:
            if pkt is None:
                continue
            try:
                self._media.sendto(pkt, addr)
                self.stats["retransmitted"] += 1
            except OSError:
                pass

    # -- media path ----------------------------------------------------------
    def render(self, buf: Buffer) -> str:
        data = buf.data
        if isinstance(data, list) and data and isinstance(
                data[0], (bytes, bytearray)):
            packets = [bytes(p) for p in data]
        else:
            # raw byte stream: callers should payload first, but keep
            # the udpsink convention of never failing on bytes
            packets = [host_array(data).tobytes()]
        addr = (self.props["address"], self.props["port"])
        # history ring sized from sender-buffer: assume >=1 pkt/ms
        max_hist = max(64, self.props["sender-buffer"])
        for pkt in packets:
            try:
                hdr = parse_rtp_header(pkt)
            except (struct.error, IndexError):
                hdr = None
            self._media.sendto(pkt, addr)
            self.stats["sent"] += 1
            if hdr and hdr.get("version") == 2:
                if not self._ssrc:
                    self._ssrc = hdr["ssrc"]
                with self._hist_lock:
                    self._history[hdr["seq"] & 0xFFFF] = pkt
                    while len(self._history) > max_hist:
                        self._history.popitem(last=False)
        self._send_sr()
        return FlowReturn.OK


@register_element
class RistSrc(SourceElement):
    """ristsrc: RIST simple-profile receiver (gstristsrc.c).

    Binds the media port and port+1 for RTCP, reorders arriving RTP by
    seqnum, detects gaps, NACKs them (Generic NACK by default, RIST
    APP ranges with nack-type=range) toward the sender's learned RTCP
    address, and emits the in-order packet stream as packetized RTP
    buffers.  A missing seq is given `reorder-section` ms to arrive
    (covering both natural reordering and the retransmission round
    trip, re-NACKed up to `max-rtx-retries` times) before being
    declared lost and skipped — the same budget/retry scheme as
    gstristsrc.c's rtx session."""

    FACTORY = "ristsrc"
    DESCRIPTION = "Receive RIST simple-profile packets"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "address": (str, "0.0.0.0", "bind address"),
        "port": (int, 5004, "media UDP port (RTCP rides port+1)"),
        "reorder-section": (float, 0.07, "per-seq recovery budget (s)"),
        "max-rtx-retries": (int, 7, "NACK retries per missing seq"),
        "nack-type": (str, "generic", "generic|range NACK form"),
        "receiver-buffer": (int, 1000, "max buffered out-of-order pkts"),
        "timeout": (float, 5.0, "idle read timeout (s); EOS on expiry"),
        "caps": (object, None, "caps of the RTP stream"),
    }

    def __init__(self, name=None, **props):
        if "caps" in props and isinstance(props["caps"], str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)
        self._media: Optional[socket.socket] = None
        self._rtcp: Optional[socket.socket] = None
        self._pending: Dict[int, bytes] = {}   # seq -> packet
        self._next_seq: Optional[int] = None
        # seq -> (first_missing_time, nacks_sent, last_nack_time)
        self._missing: Dict[int, Tuple[float, int, float]] = {}
        self._sender_rtcp: Optional[Tuple[str, int]] = None
        self._ssrc = 0
        self.bound_port: Optional[int] = None
        self.stats: Dict[str, int] = {"received": 0, "recovered": 0,
                                      "lost": 0, "nacks_sent": 0}

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        host = self.props["address"]
        self._media = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._media.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._media.bind((host, self.props["port"]))
        self.bound_port = self._media.getsockname()[1]
        self._media.settimeout(0.01)
        self._rtcp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._rtcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._rtcp.bind((host, (self.bound_port or
                                self.props["port"]) + 1))
        self._rtcp.setblocking(False)
        self._rx: "queue.SimpleQueue" = queue.SimpleQueue()
        self._rx_run = True
        self._rx_thread = threading.Thread(
            target=self._rx_loop, args=(self._media, self._rx), daemon=True)
        self._rx_thread.start()

    def _rx_loop(self, sock, q):
        """Move each datagram of the media socket into `q` as it comes;
        None once the socket fails.  ``create`` ingests them at its own
        time, as the JAX package's reads them: a gap's recovery budget
        starts when the receiver sees it."""
        while self._rx_run:
            try:
                pkt, _ = sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            q.put(pkt)
        q.put(None)

    def stop(self):
        self._rx_run = False
        if getattr(self, "_rx_thread", None) is not None:
            self._rx_thread.join(1.0)
            self._rx_thread = None
        for s in (self._media, self._rtcp):
            if s:
                s.close()
        self._media = self._rtcp = None
        self._pending.clear()
        self._missing.clear()

    def get_caps(self, filter=None):
        caps = self.props["caps"] or Caps.any()
        if filter is not None:
            caps = caps.intersect(filter) if not caps.is_any else filter
        return caps

    def fixate(self, caps: Caps) -> Caps:
        if caps.is_any:
            caps = Caps.from_string("application/x-rtp")
        return caps.fixate()

    # -- RTCP helpers --------------------------------------------------------
    def _poll_rtcp(self):
        """Learn the sender's RTCP return address from its SRs."""
        while True:
            try:
                data, addr = self._rtcp.recvfrom(65536)
            except (BlockingIOError, OSError):
                return
            self._sender_rtcp = addr
            try:
                for p in rtcp.parse_compound(data):
                    if p.ptype == rtcp.TYPE_SR:
                        self._ssrc = p.ssrc
            except (ValueError, struct.error):
                pass

    def _send_nacks(self, now: float):
        if self._sender_rtcp is None:
            return
        budget = self.props["reorder-section"]
        retries = self.props["max-rtx-retries"]
        # re-NACK pacing: spread retries across the recovery budget
        interval = max(budget / max(retries, 1), 0.005)
        due = [s for s, (t0, n, tl) in self._missing.items()
               if n < retries and now - tl >= (0 if n == 0 else interval)]
        if not due:
            return
        if self.props["nack-type"] == "range":
            due.sort()
            ranges: List[Tuple[int, int]] = []
            for s in due:
                if ranges and ((s - ranges[-1][0] - ranges[-1][1])
                               & 0xFFFF) == 1:
                    ranges[-1] = (ranges[-1][0], ranges[-1][1] + 1)
                else:
                    ranges.append((s, 0))
            pkt = rtcp.build_rist_nack(self._ssrc, ranges)
        else:
            pkt = rtcp.build_generic_nack(self._ssrc or 1, self._ssrc,
                                          due)
        try:
            self._rtcp.sendto(pkt, self._sender_rtcp)
            self.stats["nacks_sent"] += 1
        except OSError:
            return
        for s in due:
            t0, n, _ = self._missing[s]
            self._missing[s] = (t0, n + 1, now)

    # -- media path ----------------------------------------------------------
    def _ingest(self, pkt: bytes, now: float):
        try:
            hdr = parse_rtp_header(pkt)
        except (struct.error, IndexError):
            return
        if hdr.get("version") != 2:
            return
        seq = hdr["seq"] & 0xFFFF
        if self._next_seq is None:
            self._next_seq = seq
        if _seq_lt(seq, self._next_seq):
            return                       # duplicate / too-late rtx
        if seq in self._pending:
            return                       # duplicate
        self._pending[seq] = pkt
        if seq in self._missing:
            self.stats["recovered"] += 1
            del self._missing[seq]
        self.stats["received"] += 1
        # register any new gap between next_seq and this packet
        s = self._next_seq
        guard = 0
        while _seq_lt(s, seq) and guard < 0x8000:
            if s not in self._pending and s not in self._missing:
                self._missing[s] = (now, 0, 0.0)
            s = (s + 1) & 0xFFFF
            guard += 1

    def _drain(self, now: float) -> List[bytes]:
        """Release the in-order prefix; expire seqs past their budget."""
        out: List[bytes] = []
        budget = self.props["reorder-section"]
        retries = self.props["max-rtx-retries"]
        while self._next_seq is not None:
            seq = self._next_seq
            if seq in self._pending:
                out.append(self._pending.pop(seq))
                self._next_seq = (seq + 1) & 0xFFFF
                continue
            info = self._missing.get(seq)
            if info is None:
                break                     # waiting on the live edge
            t0, n, _ = info
            if now - t0 > budget and n >= retries or \
                    now - t0 > 2 * budget:
                del self._missing[seq]    # give up: declared lost
                self.stats["lost"] += 1
                self._next_seq = (seq + 1) & 0xFFFF
                continue
            break                         # still inside recovery budget
        # overflow guard (receiver-buffer): force-skip oldest gaps
        limit = self.props["receiver-buffer"]
        while len(self._pending) > limit and self._next_seq is not None:
            seq = self._next_seq
            if seq in self._pending:
                out.append(self._pending.pop(seq))
            else:
                self._missing.pop(seq, None)
                self.stats["lost"] += 1
            self._next_seq = (seq + 1) & 0xFFFF
        return out

    def create(self, n_frames: int) -> Optional[Buffer]:
        deadline = time.monotonic() + self.props["timeout"]
        while True:
            now = time.monotonic()
            if now >= deadline:
                return None               # idle -> EOS
            self._poll_rtcp()
            try:
                item = self._rx.get(timeout=0.01)
                while item is not None:      # all that has come
                    self._ingest(item, time.monotonic())
                    item = self._rx.get_nowait()
                return None                  # the socket failed
            except queue.Empty:
                pass
            self._send_nacks(time.monotonic())
            out = self._drain(time.monotonic())
            if out:
                return Buffer(data=out, batch=1)


# ---------------------------------------------------------------------------
# RIST RTP header extension + retransmission elements
# (gst-plugins-bad/gst/rist/gstristrtpext.c, gstristrtpdeext.c,
#  gstristrtxsend.c, gstristrtxreceive.c — VSF TR-06-2 §5.3)
# ---------------------------------------------------------------------------

from ..core.element import TransformElement
from .rtp import parse_rtp_header

_RIST_EXT_PROFILE = (ord('R') << 8) | ord('I')
_TS_NULL_PID = 0x1FFF


def _rist_ext_seq(prev_ext, seqnum: int):
    """gstrist.h gst_rist_rtp_ext_seq: extend a 16-bit RTP seqnum to
    32 bits assuming jumps of less than 2^15."""
    if prev_ext is None:
        return seqnum & 0xFFFFFFFF
    diff = (seqnum - (prev_ext & 0xFFFF)) & 0xFFFF
    if diff < 0x8000:
        return (prev_ext + diff) & 0xFFFFFFFF
    return (prev_ext - (0x10000 - diff)) & 0xFFFFFFFF


def _rebuild_rtp(h: dict, payload: bytes,
                 ext: "Optional[bytes]") -> bytes:
    """Reassemble an RTP packet from parsed header fields, a payload
    and an optional (profile, data) header extension."""
    b0 = (2 << 6) | (0x10 if ext is not None else 0)
    b1 = (0x80 if h["marker"] else 0) | (h["payload_type"] & 0x7F)
    head = struct.pack("!BBHII", b0, b1, h["seq"] & 0xFFFF,
                       h["timestamp"] & 0xFFFFFFFF,
                       h["ssrc"] & 0xFFFFFFFF)
    if ext is not None:
        assert len(ext) % 4 == 0
        head += struct.pack("!HH", _RIST_EXT_PROFILE, len(ext) // 4)
        head += ext
    return head + payload


def _pkt_list(buf: Buffer) -> List[bytes]:
    data = buf.data if isinstance(buf.data, list) else [buf.data]
    out = []
    for p in data:
        if not isinstance(p, (bytes, bytearray)):
            p = host_array(p).tobytes()
        out.append(bytes(p))
    return out


@register_element
class RistRtpExt(TransformElement):
    """ristrtpext: add the RIST RTP header extension — optional null
    MPEG-TS packet deletion (first 7 TS packets, flagged in the NPD
    bits) and a 16-bit sequence-number roll-over counter."""
    FACTORY = "ristrtpext"
    DESCRIPTION = "Adds RIST TR-06-2 RTP header extension"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "drop-null-ts-packets": (bool, False,
                                 "drop null MPEG-TS packets"),
        "sequence-number-extension": (bool, False,
                                      "add seqnum roll-over counter"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._ext_seq = None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def _process_pkt(self, pkt: bytes) -> bytes:
        drop_null = self.props["drop-null-ts-packets"]
        add_seq = self.props["sequence-number-extension"]
        if not drop_null and not add_seq:
            return pkt
        h = parse_rtp_header(pkt)
        payload = h["payload"]
        ts_size = 0
        ts_count = 0
        npd_bits = 0
        use_drop = False
        if drop_null and h["payload_type"] == 33:   # MP2T
            if len(payload) and len(payload) % 188 == 0:
                ts_size, ts_count = 188, len(payload) // 188
                use_drop = True
            elif len(payload) and len(payload) % 204 == 0:
                ts_size, ts_count = 204, len(payload) // 204
                use_drop = True
        if use_drop:
            kept = []
            for i in range(ts_count):
                tsp = payload[i * ts_size:(i + 1) * ts_size]
                pid = ((tsp[1] & 0x1F) << 8) | tsp[2]
                if i < 7 and tsp[0] == 0x47 and pid == _TS_NULL_PID:
                    npd_bits |= 1 << (6 - i)
                else:
                    kept.append(tsp)
            payload = b"".join(kept)
        ext = bytearray(4)
        ext[0] = (use_drop << 7) | (add_seq << 6)
        if ts_count <= 7:
            ext[0] |= (ts_count & 7) << 3
        ext[1] = ((ts_size == 204) << 7) | (npd_bits & 0x7F)
        if add_seq:
            self._ext_seq = _rist_ext_seq(self._ext_seq, h["seq"])
            struct.pack_into("!H", ext, 2, self._ext_seq >> 16)
        return _rebuild_rtp(h, payload, bytes(ext))

    def host_process(self, buf):
        if buf is None:
            return None
        return buf.with_(data=[self._process_pkt(p)
                               for p in _pkt_list(buf)])


@register_element
class RistRtpDeext(TransformElement):
    """ristrtpdeext: strip the RIST extension, reinserting deleted
    null TS packets and tracking the extended sequence number
    (max-ext-seqnum property mirrors the reference)."""
    FACTORY = "ristrtpdeext"
    DESCRIPTION = "Removes RIST TR-06-2 RTP header extension"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.max_ext_seqnum = 0
        self.have_drop_null = False
        self.have_ext_seqnum = False

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def _process_pkt(self, pkt: bytes) -> bytes:
        h = parse_rtp_header(pkt)
        if h["extension_profile"] != _RIST_EXT_PROFILE or \
                len(h["extension_data"]) < 4:
            return pkt
        ext = h["extension_data"]
        payload = h["payload"]
        drop_null = bool(ext[0] & 0x80)
        has_seq = bool(ext[0] & 0x40)
        size_bits = (ext[0] >> 3) & 7
        ts_size = 204 if ext[1] & 0x80 else 188
        npd_bits = ext[1] & 0x7F
        self.have_drop_null = self.have_drop_null or drop_null
        self.have_ext_seqnum = self.have_ext_seqnum or has_seq
        if drop_null and npd_bits:
            null_pkt = bytes([0x47, 0x1F, 0xFF, 0x10]) \
                + b"\xff" * (ts_size - 4)
            rebuilt = []
            pos = 0
            count = size_bits if size_bits else 7
            for i in range(count):
                if npd_bits & (1 << (6 - i)):
                    rebuilt.append(null_pkt)
                else:
                    rebuilt.append(payload[pos:pos + ts_size])
                    pos += ts_size
            rebuilt.append(payload[pos:])
            payload = b"".join(rebuilt)
        if has_seq:
            hi = struct.unpack("!H", ext[2:4])[0]
            extseq = (hi << 16) | h["seq"]
            if extseq > self.max_ext_seqnum:
                self.max_ext_seqnum = extseq
        return _rebuild_rtp(h, payload, None)

    def host_process(self, buf):
        if buf is None:
            return None
        return buf.with_(data=[self._process_pkt(p)
                               for p in _pkt_list(buf)])


@register_element
class RistRtxSend(TransformElement):
    """ristrtxsend: history + RIST-form retransmission.  Unlike RFC
    4588 rtx, RIST resends the ORIGINAL packet unchanged except the
    SSRC is the master SSRC + 1 (odd = retransmission)."""
    FACTORY = "ristrtxsend"
    DESCRIPTION = "Retransmit RTP packets when needed, in RIST form"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "max-size-packets": (int, 100, "history length"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._history = {}
        self._order = []
        self._pending = []
        self.num_rtx_requests = 0
        self.num_rtx_packets = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._history = {}
        self._order = []
        self._pending = []

    def request_retransmit(self, seq: int, ssrc: int = -1) -> bool:
        self.num_rtx_requests += 1
        pkt = self._history.get(seq & 0xFFFF)
        if pkt is None:
            return False
        h = parse_rtp_header(pkt)
        if ssrc not in (-1, h["ssrc"]):
            return False
        rtx = bytearray(pkt)
        struct.pack_into("!I", rtx, 8, (h["ssrc"] + 1) & 0xFFFFFFFF)
        self._pending.append(bytes(rtx))
        self.num_rtx_packets += 1
        return True

    def src_event(self, pad, event) -> bool:
        if getattr(event, "type", None) == "rtx-request":
            d = event.data or {}
            return self.request_retransmit(d.get("seqnum", -1),
                                           d.get("ssrc", -1))
        return super().src_event(pad, event)

    def host_process(self, buf):
        if buf is None:
            return None
        pkts = _pkt_list(buf)
        maxlen = self.props["max-size-packets"]
        for pkt in pkts:
            h = parse_rtp_header(pkt)
            self._history[h["seq"]] = pkt
            self._order.append(h["seq"])
            while len(self._order) > maxlen:
                self._history.pop(self._order.pop(0), None)
        out = pkts + self._pending
        self._pending = []
        return buf.with_(data=out)


@register_element
class RistRtxReceive(TransformElement):
    """ristrtxreceive: translate RIST retransmissions (odd SSRC =
    master + 1) back to their original form."""
    FACTORY = "ristrtxreceive"
    DESCRIPTION = "Receive RIST-form retransmitted RTP packets"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.num_rtx_packets = 0
        self.retransmitted_seqs = []

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def _process_pkt(self, pkt: bytes) -> bytes:
        h = parse_rtp_header(pkt)
        if h["ssrc"] & 1:            # RIST rtx: master ssrc + 1
            fixed = bytearray(pkt)
            struct.pack_into("!I", fixed, 8,
                             (h["ssrc"] - 1) & 0xFFFFFFFF)
            self.num_rtx_packets += 1
            self.retransmitted_seqs.append(h["seq"])
            return bytes(fixed)
        return pkt

    def host_process(self, buf):
        if buf is None:
            return None
        return buf.with_(data=[self._process_pkt(p)
                               for p in _pkt_list(buf)])
