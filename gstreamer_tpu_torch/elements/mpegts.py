"""mpegtsmux / tsdemux — MPEG transport stream container.

Reduced-scope port of gst-plugins-bad/gst/mpegtsmux + mpegtsdemux for
the elementary streams this framework produces (framed MPEG-1 audio,
AC-3, and private data):
* 188-byte packets with sync 0x47, PUSI, 13-bit PIDs, continuity
  counters, adaptation-field stuffing (ISO 13818-1 2.4.3);
* PSI: PAT (PID 0) + PMT with per-stream stream_type (0x03 MPEG-1
  audio, 0x81 ATSC AC-3, 0x06 private PES), MPEG-CRC32
  (poly 0x04C11DB7, init ~0, non-reflected) section checksums;
* PES with 33-bit 90 kHz PTS ('0010' marker framing) per access unit;
* PCR carried in the adaptation field of the first stream's PID.

tsdemux collapses to the location-source convention and emits each
stream's PES payloads as byte blobs with the PMT-derived caps —
`tsdemux ! mpegaudioparse`/`ac3parse` reframes downstream exactly like
the reference chain.

A port of the JAX package's ``elements/mpegts.py``: the muxers are host
elements that copy each tick to the host (``host_array``); tsdemux gives
the elementary stream's bytes on the host.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, SourceElement, register_element)

PKT = 188

_CRC_TABLE = []
for _i in range(256):
    _c = _i << 24
    for _ in range(8):
        _c = ((_c << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if _c & 0x80000000 \
            else (_c << 1) & 0xFFFFFFFF
    _CRC_TABLE.append(_c)


def mpeg_crc32(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = ((c << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((c >> 24) ^ b)
                                                 & 0xFF]
    return c


def _psi_section(table_id: int, id_ext: int, body: bytes) -> bytes:
    """table header + body + CRC32, pointer_field included."""
    # section_length covers everything after it incl. CRC
    sec = (bytes([table_id])
           + struct.pack(">H", 0xB000 | (len(body) + 9))
           + struct.pack(">H", id_ext)
           + bytes([0xC1, 0x00, 0x00])       # version 0, current
           + body)
    crc = mpeg_crc32(sec)
    return b"\0" + sec + struct.pack(">I", crc)


def _ts_packet(pid: int, payload: bytes, pusi: bool, cc: int,
               pcr: Optional[int] = None) -> bytes:
    """One 188-byte packet; short payloads pad with an adaptation
    field (ISO 13818-1 2.4.3.4 stuffing)."""
    if len(payload) > PKT - 4:
        raise ValueError("ts: payload too large for one packet")
    hdr = bytes([0x47, (0x40 if pusi else 0) | ((pid >> 8) & 0x1F),
                 pid & 0xFF])
    if pcr is None and len(payload) == PKT - 4:
        return hdr + bytes([0x10 | (cc & 0xF)]) + payload
    af_len = PKT - 4 - 1 - len(payload)
    if af_len == 0:
        af = bytes([0])
    else:
        content = bytearray([0x10 if pcr is not None else 0x00])
        if pcr is not None:
            base, ext = (pcr // 300) & ((1 << 33) - 1), pcr % 300
            content += bytes([
                (base >> 25) & 0xFF, (base >> 17) & 0xFF,
                (base >> 9) & 0xFF, (base >> 1) & 0xFF,
                ((base & 1) << 7) | 0x7E | ((ext >> 8) & 1),
                ext & 0xFF])
        if len(content) > af_len:
            raise ValueError("ts: no room for the PCR field")
        content += b"\xff" * (af_len - len(content))
        af = bytes([af_len]) + bytes(content)
    return hdr + bytes([0x30 | (cc & 0xF)]) + af + payload


def _pes(stream_id: int, payload: bytes, pts_90k: Optional[int]
         ) -> bytes:
    if pts_90k is not None:
        p = pts_90k & ((1 << 33) - 1)
        pts_bytes = bytes([
            0x21 | ((p >> 29) & 0x0E),
            (p >> 22) & 0xFF, 0x01 | ((p >> 14) & 0xFE),
            (p >> 7) & 0xFF, 0x01 | ((p << 1) & 0xFE)])
        hdr = bytes([0x80, 0x80, 5]) + pts_bytes
    else:
        hdr = bytes([0x80, 0x00, 0])
    total = len(hdr) + len(payload)
    plen = total if total <= 0xFFFF else 0
    return (b"\x00\x00\x01" + bytes([stream_id])
            + struct.pack(">H", plen) + hdr + payload)


def _adts_header(frame_len: int, rate: int, ch: int) -> bytes:
    """7-byte ADTS header, no CRC (ISO 14496-3 §1.A.2.2)."""
    from ..codecs.aac import SAMPLE_RATES
    sfi = SAMPLE_RATES.index(rate)
    total = frame_len + 7
    return bytes([
        0xFF, 0xF1,
        (1 << 6) | (sfi << 2) | ((ch >> 2) & 1),
        ((ch & 3) << 6) | ((total >> 11) & 0x3),
        (total >> 3) & 0xFF,
        ((total & 7) << 5) | 0x1F,
        0xFC])


_TYPE_FOR_CAPS = {"audio/mpeg": 0x03, "audio/x-ac3": 0x81,
                  "video/x-h264": 0x1B, "video/x-h265": 0x24,
                  "video/mpeg": 0x02}
_CAPS_FOR_TYPE = {0x03: "audio/mpeg, mpegversion=1, parsed=true",
                  0x04: "audio/mpeg, mpegversion=1, parsed=true",
                  0x0F: "audio/mpeg, mpegversion=4, "
                        "stream-format=adts",
                  0x81: "audio/x-ac3",
                  0x1B: "video/x-h264, stream-format=byte-stream, "
                        "alignment=au",
                  0x24: "video/x-h265, stream-format=byte-stream, "
                        "alignment=au",
                  0x02: "video/mpeg, mpegversion=2, "
                        "systemstream=false, parsed=true",
                  0x06: "application/octet-stream"}
_SID_FOR_TYPE = {0x03: 0xC0, 0x0F: 0xC0, 0x81: 0xBD, 0x1B: 0xE0,
                 0x24: 0xE0, 0x02: 0xE0, 0x06: 0xBD}


@register_element
class MpegTsMux(AggregatorElement):
    FACTORY = "mpegtsmux"
    DESCRIPTION = "Multiplexes media streams into an MPEG Transport " \
                  "Stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK,
                    "audio/mpeg; audio/x-ac3; video/x-h264; video/x-h265; "
                    "video/mpeg; application/octet-stream",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, "video/mpegts"),
    ]
    PROPERTIES = {
        "location": (str, "out.ts", "output path"),
        "pmt-pid": (int, 0x1000, ""),
        "start-pid": (int, 0x41, "first elementary PID"),
        "scte-35-pid": (int, 0, "PID for SCTE-35 splice sections "
                        "(0 = no splice stream; reference mpegtsmux "
                        "scte-35-pid property)"),
        "service-name": (str, "", "SDT service name (write an SDT "
                         "when set)"),
        "provider-name": (str, "gstreamer-tpu", "SDT provider name"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._file = None
        self._cc: Dict[int, int] = {}
        self._pids: Dict[str, int] = {}
        self._types: Dict[str, int] = {}
        self._adts: Dict[str, tuple] = {}
        self._packets = 0
        self._pending_splices: List = []

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed):
        pid = self.props["start-pid"]
        for pad_name in sorted(in_caps):
            s = in_caps[pad_name].fixate()[0]
            stype = _TYPE_FOR_CAPS.get(s.name, 0x06)
            if s.name == "audio/mpeg" and s.get("mpegversion") in (2, 4):
                stype = 0x0F                 # ADTS AAC (ISO 13818-1)
                if s.get("stream-format") == "raw":
                    # raw AUs (avenc_aac): wrap in ADTS ourselves
                    self._adts[pad_name] = (s["rate"], s["channels"])
            self._types[pad_name] = stype
            self._pids[pad_name] = pid
            pid += 1
        return Caps.from_string("video/mpegts, systemstream=true, "
                                "packetsize=188")

    def start(self):
        self._file = open(self.props["location"], "wb")
        self._cc = {}
        self._packets = 0
        self._write_psi()
        self._flush_splices()

    def _next_cc(self, pid):
        cc = self._cc.get(pid, 0)
        self._cc[pid] = (cc + 1) & 0xF
        return cc

    def _write_section(self, pid: int, sec_bytes: bytes) -> None:
        from ..utils.mpegts_sections import packetize_section
        ts = packetize_section(sec_bytes, pid,
                               cc_start=self._cc.get(pid, 0))
        self._cc[pid] = (self._cc.get(pid, 0) + len(ts) // PKT) & 0xF
        self._file.write(ts)
        self._packets += len(ts) // PKT

    def _write_psi(self):
        from ..utils import mpegts_sections as S
        pmt_pid = self.props["pmt-pid"]
        self._write_section(0, S.Pat(
            transport_stream_id=1,
            programs=[(1, pmt_pid)]).to_bytes())
        first_pid = min(self._pids.values()) if self._pids else 0x41
        pmt = S.Pmt(program_number=1, pcr_pid=first_pid)
        for pad_name in sorted(self._pids):
            pmt.streams.append(S.PmtStream(
                self._types[pad_name], self._pids[pad_name]))
        scte_pid = self.props["scte-35-pid"]
        if scte_pid:
            # splice stream: stream_type 0x86 with the CUEI
            # registration descriptor (SCTE-35 §8.1; reference
            # gst/mpegtsmux/gstmpegtsmux.c scte-35-pid)
            pmt.streams.append(S.PmtStream(
                0x86, scte_pid,
                [S.Descriptor.registration(b"CUEI")]))
        self._write_section(pmt_pid, pmt.to_bytes())
        if self.props["service-name"]:
            sdt = S.Sdt(transport_stream_id=1, original_network_id=1,
                        services=[S.SdtService(
                            service_id=1,
                            descriptors=[S.Descriptor.service(
                                0x01, self.props["provider-name"],
                                self.props["service-name"])])])
            self._write_section(0x11, sdt.to_bytes())

    def send_splice(self, sit) -> None:
        """Queue an SCTE-35 SIT (utils.mpegts_sections.ScteSit) for
        injection on the scte-35-pid — the element-message/event
        analog of the reference mpegtsmux "scte-35" custom event."""
        if not self.props["scte-35-pid"]:
            raise ValueError("mpegtsmux: scte-35-pid not configured")
        self._pending_splices.append(sit)
        if self._file is not None:
            self._flush_splices()

    def _flush_splices(self) -> None:
        pid = self.props["scte-35-pid"]
        while self._pending_splices:
            sit = self._pending_splices.pop(0)
            self._write_section(pid, sit.to_bytes())

    def _write_pes(self, pid: int, stype: int, payload: bytes,
                   pts_ns: Optional[int]):
        pts = None if pts_ns is None else pts_ns * 90000 \
            // 1_000_000_000
        pes = _pes(_SID_FOR_TYPE.get(stype, 0xBD), payload, pts)
        first = True
        pos = 0
        while pos < len(pes):
            pcr = None
            if first and self._packets % 16 == 0 and pts is not None:
                pcr = pts * 300
            chunk = pes[pos:pos + (PKT - 4 - (8 if pcr is not None
                                              else 0))]
            self._file.write(_ts_packet(pid, chunk, first,
                                        self._next_cc(pid), pcr=pcr))
            self._packets += 1
            pos += len(chunk)
            first = False

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        for pad_name, buf in ins.items():
            pid = self._pids[pad_name]
            stype = self._types[pad_name]
            blobs = buf.data if isinstance(buf.data, list) \
                else [buf.data]
            n = len(blobs)
            for k, b in enumerate(blobs):
                raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                       else host_array(b).tobytes())
                if pad_name in self._adts:
                    rate, ch = self._adts[pad_name]
                    raw = _adts_header(len(raw), rate, ch) + raw
                pts = buf.pts
                if pts is not None and buf.duration and n:
                    pts = pts + k * buf.duration // n
                self._write_pes(pid, stype, raw, pts)
        first = next(iter(ins.values()))
        return first.with_(data=np.zeros(1, np.uint8))

    def stop(self):
        if self._file is not None:
            self._file.close()
            self._file = None


@register_element
class TsDemux(SourceElement):
    FACTORY = "tsdemux"
    DESCRIPTION = "Demuxes MPEG2 transport streams"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "transport stream path"),
        "stream": (str, "0", "elementary stream index"),
    }

    # PCR discontinuity threshold (ns): jumps beyond this (or flagged
    # via the adaptation-field discontinuity_indicator) open a new
    # timestamp group (mpegtspacketizer.c pcr-wrap/discont machinery)
    PCR_DISCONT_NS = 1_000_000_000

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._units = None
        self._pos = 0
        self.sections: List = []          # parsed PSI sections
        self.scte35_sits: List[tuple] = []  # (ScteSit, section)
        self.cc_gaps: List[tuple] = []    # (pid, pkt_index, exp, got)
        self.pcr_discontinuities = 0

    def _load(self):
        if self._units is not None:
            return
        from ..utils import mpegts_sections as S
        with open(self.props["location"], "rb") as f:
            data = f.read()
        # PID -> raw PES bytes, in PUSI-delimited units
        pmt_pid = None
        pcr_pid = None
        streams: Dict[int, int] = {}      # pid -> stream_type
        scte_pids: set = set()
        pes_units: Dict[int, List[tuple]] = {}  # (bytes, pkt_i, disc)
        open_unit: Dict[int, bytearray] = {}
        open_meta: Dict[int, tuple] = {}  # pid -> (pkt_index, discont)
        last_cc: Dict[int, int] = {}
        cc_gaps: List[tuple] = []
        pending_discont: Dict[int, bool] = {}
        # PCR timeline: (pkt_index, unwrapped 27 MHz value)
        pcr_obs: List[tuple] = []
        pcr_wrap = (1 << 33) * 300
        pcr_offset = 0
        last_raw_pcr = None
        self.pcr_discontinuities = 0
        pkt_i = -1
        for pos in range(0, len(data) - PKT + 1, PKT):
            pkt_i += 1
            pkt = data[pos:pos + PKT]
            if pkt[0] != 0x47:
                raise ValueError("tsdemux: lost packet sync")
            pusi = bool(pkt[1] & 0x40)
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            afc = (pkt[3] >> 4) & 0x3
            cc = pkt[3] & 0xF
            off = 4
            af_discont = False
            if afc & 0x2:
                af_len = pkt[4]
                off += 1 + af_len
                if af_len >= 1:
                    flags = pkt[5]
                    af_discont = bool(flags & 0x80)
                    if (flags & 0x10) and af_len >= 7 \
                            and (pcr_pid is None or pid == pcr_pid):
                        b = pkt[6:12]
                        base = ((b[0] << 25) | (b[1] << 17)
                                | (b[2] << 9) | (b[3] << 1)
                                | (b[4] >> 7))
                        ext = ((b[4] & 1) << 8) | b[5]
                        raw = base * 300 + ext
                        if last_raw_pcr is None:
                            pass
                        elif af_discont or abs(
                                (raw + pcr_offset)
                                - pcr_obs[-1][1]) * 1000 // 27 \
                                > self.PCR_DISCONT_NS:
                            # wrap first: a backwards jump close to
                            # the 33-bit range is a wraparound, not a
                            # discontinuity
                            if (not af_discont
                                    and last_raw_pcr - raw
                                    > pcr_wrap // 2):
                                pcr_offset += pcr_wrap
                            else:
                                # discontinuity: continue running
                                # time using the previous PCR rate
                                self.pcr_discontinuities += 1
                                prev_unwrapped = pcr_obs[-1][1]
                                if len(pcr_obs) >= 2:
                                    i0, p0, _ = pcr_obs[-2]
                                    i1, p1, _ = pcr_obs[-1]
                                    rate = (p1 - p0) / max(i1 - i0, 1)
                                else:
                                    rate = 0.0
                                est = prev_unwrapped + int(
                                    rate * (pkt_i - pcr_obs[-1][0]))
                                pcr_offset = est - raw
                        pcr_obs.append((pkt_i, raw + pcr_offset, raw))
                        last_raw_pcr = raw
            # continuity counter check (mpegtspacketizer.c CC logic):
            # expected next = prev+1 when the packet carries payload;
            # a repeat of the same cc is a legal duplicate
            if afc & 0x1:
                prev = last_cc.get(pid)
                if prev is not None and cc != ((prev + 1) & 0xF) \
                        and cc != prev:
                    cc_gaps.append((pid, pkt_i, (prev + 1) & 0xF, cc))
                    pending_discont[pid] = True
                    if pid in open_meta:      # gap corrupts open unit
                        open_meta[pid] = (open_meta[pid][0], True)
                last_cc[pid] = cc
            if not (afc & 0x1):
                continue
            payload = pkt[off:]
            if pid == 0 and pusi:                    # PAT
                sec = payload[1 + payload[0]:]
                slen = ((sec[1] & 0x0F) << 8) | sec[2]
                body = sec[8:3 + slen - 4]
                for i in range(0, len(body), 4):
                    prog, pp = struct.unpack(">HH", body[i:i + 4])
                    if prog != 0:
                        pmt_pid = pp & 0x1FFF
            elif pid == pmt_pid and pusi:            # PMT
                sec = payload[1 + payload[0]:]
                slen = ((sec[1] & 0x0F) << 8) | sec[2]
                pcr_pid = ((sec[8] & 0x1F) << 8) | sec[9]
                pinfo = ((sec[10] & 0x0F) << 8) | sec[11]
                body = sec[12 + pinfo:3 + slen - 4]
                i = 0
                while i + 5 <= len(body):
                    stype = body[i]
                    spid = ((body[i + 1] & 0x1F) << 8) | body[i + 2]
                    eslen = ((body[i + 3] & 0x0F) << 8) | body[i + 4]
                    if stype == 0x86:
                        # SCTE-35 splice stream: carries sections,
                        # not PES (SCTE-35 §8; reference tsdemux.c
                        # creates a meta/event source, not a pad)
                        scte_pids.add(spid)
                    else:
                        streams[spid] = stype
                        pes_units.setdefault(spid, [])
                    i += 5 + eslen
            elif pid in streams:
                if pusi:
                    if pid in open_unit and open_unit[pid]:
                        pes_units[pid].append(
                            (bytes(open_unit[pid]),) + open_meta[pid])
                    open_unit[pid] = bytearray(payload)
                    open_meta[pid] = (pkt_i,
                                      pending_discont.pop(pid, False))
                elif pid in open_unit:
                    open_unit[pid] += payload
        for pid, acc in open_unit.items():
            if acc:
                pes_units[pid].append((bytes(acc),) + open_meta[pid])
        self.cc_gaps = cc_gaps

        # second pass: typed PSI sections (PAT/PMT/CAT + DVB SI on
        # their fixed PIDs + SCTE-35 splice PIDs) through the
        # sections library, posted on the bus at start()
        self.sections = []
        self.scte35_sits = []
        si_pids = {0, 0x01, 0x10, 0x11, 0x12, 0x14}
        if pmt_pid is not None:
            si_pids.add(pmt_pid)
        for pid in sorted(si_pids | scte_pids):
            for sec in S.sections_from_packets(data, pid):
                self.sections.append((pid, sec))
                if sec.table_id == S.TABLE_ID_SCTE_SPLICE \
                        and sec.table is not None:
                    self.scte35_sits.append((sec.table, sec))

        pids = sorted(streams)
        sel = int(self.props["stream"])
        if sel >= len(pids):
            raise ValueError(f"tsdemux: no stream {sel}")
        pid = pids[sel]
        self._caps = Caps.from_string(
            _CAPS_FOR_TYPE.get(streams[pid],
                               "application/octet-stream"))
        units = []
        import bisect

        pcr_idx = [o[0] for o in pcr_obs]
        first_pcr = pcr_obs[0][1] if pcr_obs else None
        for pes, start_pkt, discont in pes_units[pid]:
            if pes[:3] != b"\x00\x00\x01":
                continue
            hdr_len = pes[8]
            pts = None
            if pes[7] & 0x80:
                p = pes[9:14]
                pts = (((p[0] >> 1) & 0x7) << 30 | p[1] << 22
                       | (p[2] >> 1) << 15 | p[3] << 7 | p[4] >> 1)
            pts_ns = None
            if pts is not None:
                if first_pcr is not None:
                    # timestamp from the PCR clock (tsdemux.c): take
                    # the PCR observation at-or-before this unit and
                    # express the 33-bit PTS as a signed wrap-relative
                    # distance from that group's RAW PCR, then anchor
                    # on the unwrapped timeline — this handles both
                    # wraparound and discontinuity groups
                    k = bisect.bisect_right(pcr_idx, start_pkt) - 1
                    k = max(k, 0)
                    _, ref_unwrapped, ref_raw = pcr_obs[k]
                    wrap = 1 << 33
                    rel = ((pts - ref_raw // 300 + wrap // 2) % wrap
                           ) - wrap // 2
                    ptsu90 = ref_unwrapped // 300 + rel
                    pts_ns = (ptsu90 - first_pcr // 300) \
                        * 1_000_000_000 // 90000
                else:
                    pts_ns = pts * 1_000_000_000 // 90000
            units.append((pes[9 + hdr_len:], pts_ns, discont))
        self._units = units

    def preview_blob(self) -> Optional[bytes]:
        try:
            self._load()
        except (OSError, ValueError):
            return None
        return self._units[0][0] if self._units else None

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        caps = self._caps if self._units is not None else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0
        self._post_sections()

    def _post_sections(self) -> None:
        """Post every PSI section as an element message (the
        gst_message_new_mpegts_section analog) and re-emit SCTE-35
        SITs as custom downstream events named "scte-35" (reference
        tsdemux.c emits gst_event_new_custom the same way)."""
        root = self
        while getattr(root, "parent", None) is not None:
            root = root.parent
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            for pid, sec in self.sections:
                root.bus.post(Message("element", self.name, {
                    "section": sec, "pid": pid,
                    "section-type": sec.section_type}))
            if self.cc_gaps:
                root.bus.post(Message("warning", self.name, {
                    "name": "ts-continuity",
                    "gaps": list(self.cc_gaps),
                    "count": len(self.cc_gaps)}))
        if self.scte35_sits:
            from ..core.events import Event, EventType
            for sit, sec in self.scte35_sits:
                self.send_event(Event(EventType.CUSTOM_DOWNSTREAM, {
                    "name": "scte-35", "sit": sit,
                    "section": sec}))

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._units):
            return None
        payload, pts_ns, discont = self._units[self._pos]
        self._pos += 1
        from ..core.buffer import BufferFlags
        return Buffer(
            data=np.frombuffer(payload, np.uint8), batch=1,
            pts=pts_ns,
            flags=BufferFlags.DISCONT if discont else 0)


@register_element
class AtscMux(MpegTsMux):
    """atscmux (gst-plugins-bad/gst/mpegtsmux/gstatscmux.c): ATSC
    variant of mpegtsmux.  E-AC3 uses the ATSC stream type 0x87 (vs
    DVB's PES-private 0x06), the program carries the 'GA94'
    registration descriptor, and AC-3 streams get the A/53 'AC-3'
    registration descriptor the reference writes via
    gst_atsc_mux_stream_get_es_descrs."""
    FACTORY = "atscmux"
    DESCRIPTION = "Multiplexes media streams into an ATSC-compliant " \
                  "Transport Stream"

    def negotiate_output(self, in_caps, allowed):
        res = super().negotiate_output(in_caps, allowed)
        for pad_name in self._types:
            s = in_caps[pad_name].fixate()[0]
            if s.name == "audio/x-eac3":
                self._types[pad_name] = 0x87   # ATSC A/52 Annex G
            elif s.name == "audio/x-ac3":
                self._types[pad_name] = 0x81
        return res

    def _write_psi(self):
        from ..utils import mpegts_sections as S
        pmt_pid = self.props["pmt-pid"]
        self._write_section(0, S.Pat(
            transport_stream_id=1,
            programs=[(1, pmt_pid)]).to_bytes())
        first_pid = min(self._pids.values()) if self._pids else 0x41
        pmt = S.Pmt(program_number=1, pcr_pid=first_pid,
                    descriptors=[S.Descriptor.registration(b"GA94")])
        for pad_name in sorted(self._pids):
            stype = self._types[pad_name]
            descs = []
            if stype == 0x81:
                descs.append(S.Descriptor.registration(b"AC-3"))
            elif stype == 0x87:
                descs.append(S.Descriptor.registration(b"EAC3"))
            pmt.streams.append(S.PmtStream(
                stype, self._pids[pad_name], descs))
        self._write_section(pmt_pid, pmt.to_bytes())
