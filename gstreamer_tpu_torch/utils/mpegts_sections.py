"""MPEG-TS PSI sections library — the gst-libs/gst/mpegts analog.

Typed parse/write for the program-specific-information tables carried
in a transport stream, mirroring the reference section API
(gst-plugins-bad/gst-libs/gst/mpegts/gstmpegtssection.c:1 parse,
:gst_mpegts_section_packetize write) as plain dataclasses:

* ISO/IEC 13818-1: PAT, PMT, CAT, TSDT;
* DVB (EN 300 468): NIT, SDT, EIT (present/following + schedule),
  TDT, TOT, BAT, plus the common descriptors (service 0x48,
  short-event 0x4D, network-name 0x40, stream-identifier 0x52,
  ISO-639 language 0x0A, registration 0x05);
* SCTE-35: the Splice Information Table (table_id 0xFC) with
  splice_null / splice_insert / time_signal / splice_schedule
  commands and avail/DTMF/segmentation splice descriptors
  (gst-libs/gst/mpegts/gst-scte-section.c:1).

Every table type round-trips: ``parse_section(sec.to_bytes())``
reproduces the dataclass.  ``tsdemux`` posts parsed sections on the
bus and re-emits SCTE-35 SITs as downstream events; ``mpegtsmux``
accepts SITs for injection on a dedicated PID (stream_type 0x86 with
a CUEI registration descriptor), matching the reference tsdemux /
mpegtsmux "scte-35" event contract
(gst-plugins-bad/gst/mpegtsdemux/tsdemux.c:1,
gst/mpegtsmux/gstmpegtsmux.c:1).

A copy of the JAX package's ``utils/mpegts_sections.py`` (host only).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# table ids (gstmpegtssection.h GstMpegtsSectionTableID)
TABLE_ID_PAT = 0x00
TABLE_ID_CAT = 0x01
TABLE_ID_PMT = 0x02
TABLE_ID_TSDT = 0x03
TABLE_ID_NIT = 0x40
TABLE_ID_NIT_OTHER = 0x41
TABLE_ID_SDT = 0x42
TABLE_ID_SDT_OTHER = 0x46
TABLE_ID_BAT = 0x4A
TABLE_ID_EIT_PF = 0x4E
TABLE_ID_EIT_PF_OTHER = 0x4F
TABLE_ID_TDT = 0x70
TABLE_ID_TOT = 0x73
TABLE_ID_SCTE_SPLICE = 0xFC

# descriptor tags
DESC_REGISTRATION = 0x05
DESC_ISO639_LANGUAGE = 0x0A
DESC_NETWORK_NAME = 0x40
DESC_SERVICE = 0x48
DESC_SHORT_EVENT = 0x4D
DESC_STREAM_IDENTIFIER = 0x52
DESC_LOCAL_TIME_OFFSET = 0x58

# SCTE-35 splice command types (gst-scte-section.h)
SCTE_SPLICE_COMMAND_NULL = 0x00
SCTE_SPLICE_COMMAND_SCHEDULE = 0x04
SCTE_SPLICE_COMMAND_INSERT = 0x05
SCTE_SPLICE_COMMAND_TIME = 0x06
SCTE_SPLICE_COMMAND_BANDWIDTH = 0x07
SCTE_SPLICE_COMMAND_PRIVATE = 0xFF

# SCTE-35 splice descriptor tags (within a SIT)
SCTE_DESC_AVAIL = 0x00
SCTE_DESC_DTMF = 0x01
SCTE_DESC_SEGMENTATION = 0x02
SCTE_DESC_TIME = 0x03
SCTE_DESC_AUDIO = 0x04

_PTS_MASK = (1 << 33) - 1


def mpeg_crc32(data: bytes) -> int:
    """MPEG-2 CRC32 (poly 0x04C11DB7, init all-ones, non-reflected) —
    same polynomial the whole PSI layer uses (ISO 13818-1 Annex A)."""
    from ..elements.mpegts import mpeg_crc32 as _crc
    return _crc(data)


# --------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------

@dataclass
class Descriptor:
    """One (tag, data) descriptor; typed helpers below
    (gstmpegtsdescriptor.c gst_mpegts_descriptor_*)."""
    tag: int
    data: bytes = b""

    def to_bytes(self) -> bytes:
        if len(self.data) > 255:
            raise ValueError("descriptor body exceeds 255 bytes")
        return bytes([self.tag, len(self.data)]) + self.data

    # -- typed constructors -------------------------------------------
    @staticmethod
    def registration(fourcc: bytes, extra: bytes = b"") -> "Descriptor":
        return Descriptor(DESC_REGISTRATION, fourcc[:4] + extra)

    @staticmethod
    def iso639_language(lang: str, audio_type: int = 0) -> "Descriptor":
        return Descriptor(DESC_ISO639_LANGUAGE,
                          lang.encode("ascii")[:3] + bytes([audio_type]))

    @staticmethod
    def network_name(name: str) -> "Descriptor":
        return Descriptor(DESC_NETWORK_NAME, name.encode("latin-1"))

    @staticmethod
    def service(service_type: int, provider: str, name: str
                ) -> "Descriptor":
        p = provider.encode("latin-1")
        n = name.encode("latin-1")
        return Descriptor(DESC_SERVICE, bytes([service_type, len(p)])
                          + p + bytes([len(n)]) + n)

    @staticmethod
    def short_event(lang: str, title: str, text: str) -> "Descriptor":
        t = title.encode("latin-1")
        x = text.encode("latin-1")
        return Descriptor(DESC_SHORT_EVENT, lang.encode("ascii")[:3]
                          + bytes([len(t)]) + t + bytes([len(x)]) + x)

    @staticmethod
    def stream_identifier(component_tag: int) -> "Descriptor":
        return Descriptor(DESC_STREAM_IDENTIFIER, bytes([component_tag]))

    # -- typed accessors ----------------------------------------------
    def as_service(self) -> Tuple[int, str, str]:
        d = self.data
        plen = d[1]
        nlen = d[2 + plen]
        return (d[0], d[2:2 + plen].decode("latin-1"),
                d[3 + plen:3 + plen + nlen].decode("latin-1"))

    def as_short_event(self) -> Tuple[str, str, str]:
        d = self.data
        tlen = d[3]
        xlen = d[4 + tlen]
        return (d[:3].decode("ascii"),
                d[4:4 + tlen].decode("latin-1"),
                d[5 + tlen:5 + tlen + xlen].decode("latin-1"))

    def as_iso639_language(self) -> Tuple[str, int]:
        return self.data[:3].decode("ascii"), self.data[3]


def _write_descriptors(descs: List[Descriptor]) -> bytes:
    return b"".join(d.to_bytes() for d in descs)


def _parse_descriptors(data: bytes) -> List[Descriptor]:
    out = []
    i = 0
    while i + 2 <= len(data):
        tag, ln = data[i], data[i + 1]
        out.append(Descriptor(tag, bytes(data[i + 2:i + 2 + ln])))
        i += 2 + ln
    return out


# --------------------------------------------------------------------
# DVB time coding (EN 300 468 Annex C): 16-bit MJD + 24-bit BCD hhmmss
# --------------------------------------------------------------------

def encode_dvb_time(year: int, month: int, day: int, hour: int,
                    minute: int, second: int) -> bytes:
    if month <= 2:
        lp = 1
    else:
        lp = 0
    mjd = (14956 + day + int((year - 1900 - lp) * 365.25)
           + int((month + 1 + lp * 12) * 30.6001))
    bcd = bytes([(hour // 10) << 4 | hour % 10,
                 (minute // 10) << 4 | minute % 10,
                 (second // 10) << 4 | second % 10])
    return struct.pack(">H", mjd) + bcd


def decode_dvb_time(data: bytes) -> Tuple[int, int, int, int, int, int]:
    mjd = struct.unpack(">H", data[:2])[0]
    yp = int((mjd - 15078.2) / 365.25)
    mp = int((mjd - 14956.1 - int(yp * 365.25)) / 30.6001)
    day = mjd - 14956 - int(yp * 365.25) - int(mp * 30.6001)
    k = 1 if mp in (14, 15) else 0
    year = 1900 + yp + k
    month = mp - 1 - k * 12
    h, m, s = data[2], data[3], data[4]
    return (year, month, day,
            (h >> 4) * 10 + (h & 0xF),
            (m >> 4) * 10 + (m & 0xF),
            (s >> 4) * 10 + (s & 0xF))


def encode_bcd_duration(hours: int, minutes: int, seconds: int) -> bytes:
    return bytes([(hours // 10) << 4 | hours % 10,
                  (minutes // 10) << 4 | minutes % 10,
                  (seconds // 10) << 4 | seconds % 10])


def decode_bcd_duration(data: bytes) -> Tuple[int, int, int]:
    h, m, s = data[0], data[1], data[2]
    return ((h >> 4) * 10 + (h & 0xF), (m >> 4) * 10 + (m & 0xF),
            (s >> 4) * 10 + (s & 0xF))


# --------------------------------------------------------------------
# section framing
# --------------------------------------------------------------------

def _long_section(table_id: int, id_ext: int, body: bytes,
                  version: int = 0, section_number: int = 0,
                  last_section_number: int = 0,
                  current_next: bool = True,
                  private: bool = False) -> bytes:
    """Long-form section: syntax indicator set, id extension /
    version / section numbers, trailing CRC (ISO 13818-1 2.4.4.11)."""
    flags = 0xB000 if not private else 0xF000
    sec = (bytes([table_id])
           + struct.pack(">H", flags | (len(body) + 9))
           + struct.pack(">H", id_ext)
           + bytes([0xC0 | ((version & 0x1F) << 1)
                    | (1 if current_next else 0),
                    section_number, last_section_number])
           + body)
    return sec + struct.pack(">I", mpeg_crc32(sec))


def _short_section(table_id: int, body: bytes,
                   crc: bool = False) -> bytes:
    """Short-form section (syntax indicator 0): TDT, and — with
    private_indicator 0 — the SCTE-35 SIT."""
    if crc:
        sec = (bytes([table_id])
               + struct.pack(">H", 0x7000 | (len(body) + 4)) + body)
        return sec + struct.pack(">I", mpeg_crc32(sec))
    return (bytes([table_id])
            + struct.pack(">H", 0x7000 | len(body)) + body)


@dataclass
class SectionHeader:
    table_id: int
    id_extension: int = 0
    version: int = 0
    section_number: int = 0
    last_section_number: int = 0
    current_next: bool = True


# --------------------------------------------------------------------
# ISO 13818-1 tables
# --------------------------------------------------------------------

@dataclass
class Pat:
    """Program Association Table: transport_stream_id + the
    program→PMT-PID map (gstmpegtssection.c:parse_pat)."""
    transport_stream_id: int = 1
    programs: List[Tuple[int, int]] = field(default_factory=list)
    version: int = 0

    def to_bytes(self) -> bytes:
        body = b"".join(struct.pack(">HH", prog, 0xE000 | pid)
                        for prog, pid in self.programs)
        return _long_section(TABLE_ID_PAT, self.transport_stream_id,
                             body, version=self.version)


@dataclass
class PmtStream:
    stream_type: int
    pid: int
    descriptors: List[Descriptor] = field(default_factory=list)


@dataclass
class Pmt:
    """Program Map Table (gstmpegtssection.c:parse_pmt)."""
    program_number: int = 1
    pcr_pid: int = 0x1FFF
    descriptors: List[Descriptor] = field(default_factory=list)
    streams: List[PmtStream] = field(default_factory=list)
    version: int = 0

    def to_bytes(self) -> bytes:
        pinfo = _write_descriptors(self.descriptors)
        body = struct.pack(">HH", 0xE000 | self.pcr_pid,
                           0xF000 | len(pinfo)) + pinfo
        for s in self.streams:
            es = _write_descriptors(s.descriptors)
            body += (bytes([s.stream_type])
                     + struct.pack(">HH", 0xE000 | s.pid,
                                   0xF000 | len(es)) + es)
        return _long_section(TABLE_ID_PMT, self.program_number, body,
                             version=self.version)


@dataclass
class Cat:
    """Conditional Access Table: just a descriptor loop."""
    descriptors: List[Descriptor] = field(default_factory=list)
    version: int = 0

    def to_bytes(self) -> bytes:
        return _long_section(TABLE_ID_CAT, 0xFFFF,
                             _write_descriptors(self.descriptors),
                             version=self.version)


@dataclass
class Tsdt:
    descriptors: List[Descriptor] = field(default_factory=list)
    version: int = 0

    def to_bytes(self) -> bytes:
        return _long_section(TABLE_ID_TSDT, 0xFFFF,
                             _write_descriptors(self.descriptors),
                             version=self.version)


# --------------------------------------------------------------------
# DVB tables (EN 300 468)
# --------------------------------------------------------------------

@dataclass
class NitStream:
    transport_stream_id: int
    original_network_id: int
    descriptors: List[Descriptor] = field(default_factory=list)


@dataclass
class Nit:
    """Network Information Table (gst-dvb-section.c:parse_nit)."""
    network_id: int = 1
    actual_network: bool = True
    descriptors: List[Descriptor] = field(default_factory=list)
    streams: List[NitStream] = field(default_factory=list)
    version: int = 0

    def to_bytes(self) -> bytes:
        nd = _write_descriptors(self.descriptors)
        loop = b""
        for s in self.streams:
            td = _write_descriptors(s.descriptors)
            loop += struct.pack(">HHH", s.transport_stream_id,
                                s.original_network_id,
                                0xF000 | len(td)) + td
        body = (struct.pack(">H", 0xF000 | len(nd)) + nd
                + struct.pack(">H", 0xF000 | len(loop)) + loop)
        tid = TABLE_ID_NIT if self.actual_network else TABLE_ID_NIT_OTHER
        return _long_section(tid, self.network_id, body,
                             version=self.version, private=True)


@dataclass
class SdtService:
    service_id: int
    eit_schedule: bool = False
    eit_present_following: bool = False
    running_status: int = 4              # running
    free_ca: bool = False
    descriptors: List[Descriptor] = field(default_factory=list)


@dataclass
class Sdt:
    """Service Description Table (gst-dvb-section.c:parse_sdt)."""
    transport_stream_id: int = 1
    original_network_id: int = 1
    actual_ts: bool = True
    services: List[SdtService] = field(default_factory=list)
    version: int = 0

    def to_bytes(self) -> bytes:
        body = struct.pack(">H", self.original_network_id) + b"\xff"
        for s in self.services:
            d = _write_descriptors(s.descriptors)
            flags = (0xFC | (0x02 if s.eit_schedule else 0)
                     | (0x01 if s.eit_present_following else 0))
            body += (struct.pack(">H", s.service_id) + bytes([flags])
                     + struct.pack(
                         ">H", ((s.running_status & 0x7) << 13)
                         | (0x1000 if s.free_ca else 0) | len(d)) + d)
        tid = TABLE_ID_SDT if self.actual_ts else TABLE_ID_SDT_OTHER
        return _long_section(tid, self.transport_stream_id, body,
                             version=self.version, private=True)


@dataclass
class EitEvent:
    event_id: int
    start_time: Tuple[int, int, int, int, int, int] = (2000, 1, 1, 0, 0, 0)
    duration: Tuple[int, int, int] = (0, 30, 0)
    running_status: int = 0
    free_ca: bool = False
    descriptors: List[Descriptor] = field(default_factory=list)


@dataclass
class Eit:
    """Event Information Table, present/following flavour
    (gst-dvb-section.c:parse_eit)."""
    service_id: int = 1
    transport_stream_id: int = 1
    original_network_id: int = 1
    actual_ts: bool = True
    events: List[EitEvent] = field(default_factory=list)
    version: int = 0

    def to_bytes(self) -> bytes:
        body = (struct.pack(">HH", self.transport_stream_id,
                            self.original_network_id)
                + bytes([0, TABLE_ID_EIT_PF]))
        for e in self.events:
            d = _write_descriptors(e.descriptors)
            body += (struct.pack(">H", e.event_id)
                     + encode_dvb_time(*e.start_time)
                     + encode_bcd_duration(*e.duration)
                     + struct.pack(
                         ">H", ((e.running_status & 0x7) << 13)
                         | (0x1000 if e.free_ca else 0) | len(d)) + d)
        tid = TABLE_ID_EIT_PF if self.actual_ts else TABLE_ID_EIT_PF_OTHER
        return _long_section(tid, self.service_id, body,
                             version=self.version, private=True)


@dataclass
class Tdt:
    """Time and Date Table — short section, no CRC."""
    utc_time: Tuple[int, int, int, int, int, int] = (2000, 1, 1, 0, 0, 0)

    def to_bytes(self) -> bytes:
        return _short_section(TABLE_ID_TDT,
                              encode_dvb_time(*self.utc_time))


@dataclass
class Tot:
    """Time Offset Table — short section WITH CRC (EN 300 468 5.2.6)."""
    utc_time: Tuple[int, int, int, int, int, int] = (2000, 1, 1, 0, 0, 0)
    descriptors: List[Descriptor] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        d = _write_descriptors(self.descriptors)
        body = (encode_dvb_time(*self.utc_time)
                + struct.pack(">H", 0xF000 | len(d)) + d)
        return _short_section(TABLE_ID_TOT, body, crc=True)


# --------------------------------------------------------------------
# SCTE-35 Splice Information Table
# --------------------------------------------------------------------

@dataclass
class SpliceComponent:
    """Per-PID splice info (gst-scte-section.h
    GstMpegtsSCTESpliceComponent)."""
    tag: int
    splice_time_specified: bool = False
    splice_time: int = 0                 # 90 kHz, 33 bits
    utc_splice_time: int = 0             # schedule events


@dataclass
class SpliceEvent:
    """One splice_insert / splice_schedule event
    (gst-scte-section.h GstMpegtsSCTESpliceEvent)."""
    insert_event: bool = True
    splice_event_id: int = 0
    splice_event_cancel_indicator: bool = False
    out_of_network_indicator: bool = False
    program_splice_flag: bool = True
    duration_flag: bool = False
    splice_immediate_flag: bool = False
    program_splice_time_specified: bool = False
    program_splice_time: int = 0         # 90 kHz, 33 bits
    utc_splice_time: int = 0
    components: List[SpliceComponent] = field(default_factory=list)
    break_duration_auto_return: bool = False
    break_duration: int = 0              # 90 kHz, 33 bits
    unique_program_id: int = 0
    avail_num: int = 0
    avails_expected: int = 0


def _splice_time(specified: bool, pts: int) -> bytes:
    """splice_time() (SCTE-35 9.4.1)."""
    if specified:
        return bytes([0xFE | ((pts >> 32) & 1)]) \
            + struct.pack(">I", pts & 0xFFFFFFFF)
    return b"\x7f"


def _read_splice_time(d: bytes, i: int) -> Tuple[bool, int, int]:
    if d[i] & 0x80:
        pts = ((d[i] & 1) << 32) | struct.unpack(">I", d[i + 1:i + 5])[0]
        return True, pts, i + 5
    return False, 0, i + 1


@dataclass
class ScteSit:
    """Splice Information Table (SCTE-35 2023 §9.2; reference
    gst-scte-section.c:_parse_sit / gst_mpegts_section_from_scte_sit)."""
    pts_adjustment: int = 0
    protocol_version: int = 0
    encrypted_packet: bool = False
    encryption_algorithm: int = 0
    cw_index: int = 0
    tier: int = 0xFFF
    splice_command_type: int = SCTE_SPLICE_COMMAND_NULL
    splice_time_specified: bool = False   # time_signal commands
    splice_time: int = 0
    splices: List[SpliceEvent] = field(default_factory=list)
    descriptors: List[Descriptor] = field(default_factory=list)
    fully_parsed: bool = True
    private_command: bytes = b""

    # -- convenience constructors (reference gst_mpegts_scte_*_new) --
    @staticmethod
    def null_new() -> "ScteSit":
        return ScteSit(splice_command_type=SCTE_SPLICE_COMMAND_NULL)

    @staticmethod
    def cancel_new(event_id: int) -> "ScteSit":
        return ScteSit(
            splice_command_type=SCTE_SPLICE_COMMAND_INSERT,
            splices=[SpliceEvent(splice_event_id=event_id,
                                 splice_event_cancel_indicator=True)])

    @staticmethod
    def splice_in_new(event_id: int, splice_time_90k: int) -> "ScteSit":
        """Return-to-network at the given 90 kHz time."""
        return ScteSit(
            splice_command_type=SCTE_SPLICE_COMMAND_INSERT,
            splices=[SpliceEvent(
                splice_event_id=event_id,
                out_of_network_indicator=False,
                program_splice_time_specified=True,
                program_splice_time=splice_time_90k & _PTS_MASK)])

    @staticmethod
    def splice_out_new(event_id: int, splice_time_90k: int,
                       duration_90k: int = 0) -> "ScteSit":
        """Go out-of-network (ad break) at the given 90 kHz time."""
        return ScteSit(
            splice_command_type=SCTE_SPLICE_COMMAND_INSERT,
            splices=[SpliceEvent(
                splice_event_id=event_id,
                out_of_network_indicator=True,
                program_splice_time_specified=True,
                program_splice_time=splice_time_90k & _PTS_MASK,
                duration_flag=duration_90k > 0,
                break_duration_auto_return=duration_90k > 0,
                break_duration=duration_90k & _PTS_MASK)])

    @staticmethod
    def time_signal_new(splice_time_90k: Optional[int]) -> "ScteSit":
        return ScteSit(
            splice_command_type=SCTE_SPLICE_COMMAND_TIME,
            splice_time_specified=splice_time_90k is not None,
            splice_time=(splice_time_90k or 0) & _PTS_MASK)

    # -- serialization ------------------------------------------------
    def _command_bytes(self) -> bytes:
        t = self.splice_command_type
        if t == SCTE_SPLICE_COMMAND_NULL:
            return b""
        if t == SCTE_SPLICE_COMMAND_TIME:
            return _splice_time(self.splice_time_specified,
                                self.splice_time)
        if t == SCTE_SPLICE_COMMAND_INSERT:
            ev = self.splices[0]
            out = struct.pack(">I", ev.splice_event_id)
            out += bytes([0xFF if ev.splice_event_cancel_indicator
                          else 0x7F])
            if ev.splice_event_cancel_indicator:
                return out
            flags = ((0x80 if ev.out_of_network_indicator else 0)
                     | (0x40 if ev.program_splice_flag else 0)
                     | (0x20 if ev.duration_flag else 0)
                     | (0x10 if ev.splice_immediate_flag else 0)
                     | 0x0F)
            out += bytes([flags])
            if ev.program_splice_flag and not ev.splice_immediate_flag:
                out += _splice_time(ev.program_splice_time_specified,
                                    ev.program_splice_time)
            if not ev.program_splice_flag:
                out += bytes([len(ev.components)])
                for c in ev.components:
                    out += bytes([c.tag])
                    if not ev.splice_immediate_flag:
                        out += _splice_time(c.splice_time_specified,
                                            c.splice_time)
            if ev.duration_flag:
                dur = ev.break_duration & _PTS_MASK
                out += bytes([(0x80 if ev.break_duration_auto_return
                               else 0) | 0x7E | ((dur >> 32) & 1)]) \
                    + struct.pack(">I", dur & 0xFFFFFFFF)
            out += struct.pack(">HBB", ev.unique_program_id,
                               ev.avail_num, ev.avails_expected)
            return out
        if t == SCTE_SPLICE_COMMAND_SCHEDULE:
            out = bytes([len(self.splices)])
            for ev in self.splices:
                out += struct.pack(">I", ev.splice_event_id)
                out += bytes([0xFF if ev.splice_event_cancel_indicator
                              else 0x7F])
                if ev.splice_event_cancel_indicator:
                    continue
                flags = ((0x80 if ev.out_of_network_indicator else 0)
                         | (0x40 if ev.program_splice_flag else 0)
                         | (0x20 if ev.duration_flag else 0) | 0x1F)
                out += bytes([flags])
                if ev.program_splice_flag:
                    out += struct.pack(">I", ev.utc_splice_time)
                else:
                    out += bytes([len(ev.components)])
                    for c in ev.components:
                        out += bytes([c.tag]) \
                            + struct.pack(">I", c.utc_splice_time)
                if ev.duration_flag:
                    dur = ev.break_duration & _PTS_MASK
                    out += bytes([(0x80 if ev.break_duration_auto_return
                                   else 0) | 0x7E | ((dur >> 32) & 1)])\
                        + struct.pack(">I", dur & 0xFFFFFFFF)
                out += struct.pack(">HBB", ev.unique_program_id,
                                   ev.avail_num, ev.avails_expected)
            return out
        return self.private_command

    def to_bytes(self) -> bytes:
        cmd = self._command_bytes()
        descs = _write_descriptors(self.descriptors)
        pa = self.pts_adjustment & _PTS_MASK
        body = (bytes([self.protocol_version,
                       (0x80 if self.encrypted_packet else 0)
                       | ((self.encryption_algorithm & 0x3F) << 1)
                       | ((pa >> 32) & 1)])
                + struct.pack(">I", pa & 0xFFFFFFFF)
                + bytes([self.cw_index])
                + bytes([(self.tier >> 4) & 0xFF,
                         ((self.tier & 0xF) << 4)
                         | ((len(cmd) >> 8) & 0xF), len(cmd) & 0xFF])
                + bytes([self.splice_command_type]) + cmd
                + struct.pack(">H", len(descs)) + descs)
        return _short_section(TABLE_ID_SCTE_SPLICE, body, crc=True)


def _parse_scte_sit(body: bytes) -> ScteSit:
    sit = ScteSit()
    sit.protocol_version = body[0]
    sit.encrypted_packet = bool(body[1] & 0x80)
    sit.encryption_algorithm = (body[1] >> 1) & 0x3F
    sit.pts_adjustment = ((body[1] & 1) << 32) \
        | struct.unpack(">I", body[2:6])[0]
    sit.cw_index = body[6]
    sit.tier = (body[7] << 4) | (body[8] >> 4)
    cmd_len = ((body[8] & 0xF) << 8) | body[9]
    sit.splice_command_type = body[10]
    i = 11
    cmd_end = i + cmd_len if cmd_len != 0xFFF else None
    t = sit.splice_command_type
    if sit.encrypted_packet:
        sit.fully_parsed = False
        return sit
    if t == SCTE_SPLICE_COMMAND_TIME:
        sit.splice_time_specified, sit.splice_time, i = \
            _read_splice_time(body, i)
    elif t == SCTE_SPLICE_COMMAND_INSERT:
        ev = SpliceEvent()
        ev.splice_event_id = struct.unpack(">I", body[i:i + 4])[0]
        ev.splice_event_cancel_indicator = bool(body[i + 4] & 0x80)
        i += 5
        if not ev.splice_event_cancel_indicator:
            flags = body[i]
            i += 1
            ev.out_of_network_indicator = bool(flags & 0x80)
            ev.program_splice_flag = bool(flags & 0x40)
            ev.duration_flag = bool(flags & 0x20)
            ev.splice_immediate_flag = bool(flags & 0x10)
            if ev.program_splice_flag and not ev.splice_immediate_flag:
                (ev.program_splice_time_specified,
                 ev.program_splice_time, i) = _read_splice_time(body, i)
            if not ev.program_splice_flag:
                nc = body[i]
                i += 1
                for _ in range(nc):
                    c = SpliceComponent(tag=body[i])
                    i += 1
                    if not ev.splice_immediate_flag:
                        (c.splice_time_specified, c.splice_time,
                         i) = _read_splice_time(body, i)
                    ev.components.append(c)
            if ev.duration_flag:
                ev.break_duration_auto_return = bool(body[i] & 0x80)
                ev.break_duration = ((body[i] & 1) << 32) \
                    | struct.unpack(">I", body[i + 1:i + 5])[0]
                i += 5
            (ev.unique_program_id, ev.avail_num,
             ev.avails_expected) = struct.unpack(
                 ">HBB", body[i:i + 4])
            i += 4
        sit.splices.append(ev)
    elif t == SCTE_SPLICE_COMMAND_SCHEDULE:
        n = body[i]
        i += 1
        for _ in range(n):
            ev = SpliceEvent(insert_event=False)
            ev.splice_event_id = struct.unpack(">I", body[i:i + 4])[0]
            ev.splice_event_cancel_indicator = bool(body[i + 4] & 0x80)
            i += 5
            if not ev.splice_event_cancel_indicator:
                flags = body[i]
                i += 1
                ev.out_of_network_indicator = bool(flags & 0x80)
                ev.program_splice_flag = bool(flags & 0x40)
                ev.duration_flag = bool(flags & 0x20)
                if ev.program_splice_flag:
                    ev.utc_splice_time = struct.unpack(
                        ">I", body[i:i + 4])[0]
                    i += 4
                else:
                    nc = body[i]
                    i += 1
                    for _ in range(nc):
                        c = SpliceComponent(tag=body[i])
                        c.utc_splice_time = struct.unpack(
                            ">I", body[i + 1:i + 5])[0]
                        i += 5
                        ev.components.append(c)
                if ev.duration_flag:
                    ev.break_duration_auto_return = bool(body[i] & 0x80)
                    ev.break_duration = ((body[i] & 1) << 32) \
                        | struct.unpack(">I", body[i + 1:i + 5])[0]
                    i += 5
                (ev.unique_program_id, ev.avail_num,
                 ev.avails_expected) = struct.unpack(
                     ">HBB", body[i:i + 4])
                i += 4
            sit.splices.append(ev)
    elif t == SCTE_SPLICE_COMMAND_NULL:
        pass
    else:
        sit.fully_parsed = False
        sit.private_command = bytes(body[i:cmd_end]) \
            if cmd_end is not None else b""
    if cmd_end is not None:
        # 0xFFF means "length not specified" (legacy encoders); any
        # other value authoritatively delimits the command
        i = max(i, cmd_end)
    dlen = struct.unpack(">H", body[i:i + 2])[0]
    sit.descriptors = _parse_descriptors(body[i + 2:i + 2 + dlen])
    return sit


# SCTE segmentation descriptor (SCTE-35 §10.3.3) ----------------------

@dataclass
class SegmentationDescriptor:
    """The splice descriptor DASH/HLS packagers key on
    (segmentation_type_id 0x30/0x31 provider ad start/end, 0x10/0x11
    program start/end...)."""
    segmentation_event_id: int = 0
    cancel: bool = False
    delivery_not_restricted: bool = True
    web_delivery_allowed: bool = True
    no_regional_blackout: bool = True
    archive_allowed: bool = True
    device_restrictions: int = 3
    duration_90k: Optional[int] = None
    upid_type: int = 0
    upid: bytes = b""
    segmentation_type_id: int = 0
    segment_num: int = 0
    segments_expected: int = 0

    def to_descriptor(self) -> Descriptor:
        d = b"CUEI" + struct.pack(">I", self.segmentation_event_id)
        d += bytes([0xFF if self.cancel else 0x7F])
        if not self.cancel:
            flags = (0x80                       # program_segmentation
                     | (0x40 if self.duration_90k is not None else 0)
                     | (0x20 if self.delivery_not_restricted else 0))
            if not self.delivery_not_restricted:
                flags |= ((0x10 if self.web_delivery_allowed else 0)
                          | (0x08 if self.no_regional_blackout else 0)
                          | (0x04 if self.archive_allowed else 0)
                          | (self.device_restrictions & 0x3))
            else:
                flags |= 0x1F
            d += bytes([flags])
            if self.duration_90k is not None:
                d += struct.pack(">Q", self.duration_90k)[3:]  # 40 bits
            d += bytes([self.upid_type, len(self.upid)]) + self.upid
            d += bytes([self.segmentation_type_id, self.segment_num,
                        self.segments_expected])
        return Descriptor(SCTE_DESC_SEGMENTATION, d)

    @staticmethod
    def from_descriptor(desc: Descriptor) -> "SegmentationDescriptor":
        d = desc.data
        if d[:4] != b"CUEI":
            raise ValueError("segmentation descriptor: bad identifier")
        s = SegmentationDescriptor()
        s.segmentation_event_id = struct.unpack(">I", d[4:8])[0]
        s.cancel = bool(d[8] & 0x80)
        if s.cancel:
            return s
        flags = d[9]
        has_dur = bool(flags & 0x40)
        s.delivery_not_restricted = bool(flags & 0x20)
        if not s.delivery_not_restricted:
            s.web_delivery_allowed = bool(flags & 0x10)
            s.no_regional_blackout = bool(flags & 0x08)
            s.archive_allowed = bool(flags & 0x04)
            s.device_restrictions = flags & 0x3
        i = 10
        if has_dur:
            s.duration_90k = int.from_bytes(d[i:i + 5], "big")
            i += 5
        s.upid_type = d[i]
        ulen = d[i + 1]
        s.upid = bytes(d[i + 2:i + 2 + ulen])
        i += 2 + ulen
        s.segmentation_type_id = d[i]
        s.segment_num = d[i + 1]
        s.segments_expected = d[i + 2]
        return s


# --------------------------------------------------------------------
# top-level parse
# --------------------------------------------------------------------

@dataclass
class Section:
    """A parsed section: raw bytes + header + the typed table object
    (the gstmpegtssection.c GstMpegtsSection analog; `table` plays the
    role of the gst_mpegts_section_get_* accessors)."""
    table_id: int
    header: Optional[SectionHeader]
    table: object
    data: bytes

    @property
    def section_type(self) -> str:
        return {TABLE_ID_PAT: "pat", TABLE_ID_PMT: "pmt",
                TABLE_ID_CAT: "cat", TABLE_ID_TSDT: "tsdt",
                TABLE_ID_NIT: "nit", TABLE_ID_NIT_OTHER: "nit",
                TABLE_ID_SDT: "sdt", TABLE_ID_SDT_OTHER: "sdt",
                TABLE_ID_BAT: "bat",
                TABLE_ID_EIT_PF: "eit", TABLE_ID_EIT_PF_OTHER: "eit",
                TABLE_ID_TDT: "tdt", TABLE_ID_TOT: "tot",
                TABLE_ID_SCTE_SPLICE: "scte-sit",
                }.get(self.table_id, "unknown")


def parse_section(data: bytes) -> Section:
    """Parse one complete section (pointer_field NOT included).
    Raises ValueError on truncation or CRC mismatch."""
    if len(data) < 3:
        raise ValueError("section: truncated header")
    table_id = data[0]
    syntax = bool(data[1] & 0x80)
    slen = ((data[1] & 0x0F) << 8) | data[2]
    if len(data) < 3 + slen:
        raise ValueError("section: truncated body")
    data = bytes(data[:3 + slen])

    has_crc = syntax or table_id in (TABLE_ID_TOT, TABLE_ID_SCTE_SPLICE)
    if has_crc:
        if mpeg_crc32(data) != 0:
            # CRC over section incl. its CRC field is 0 when valid
            raise ValueError("section: CRC mismatch")
        payload_end = len(data) - 4
    else:
        payload_end = len(data)

    hdr = None
    if syntax:
        id_ext = struct.unpack(">H", data[3:5])[0]
        hdr = SectionHeader(
            table_id, id_ext, version=(data[5] >> 1) & 0x1F,
            section_number=data[6], last_section_number=data[7],
            current_next=bool(data[5] & 1))
        body = data[8:payload_end]
    else:
        body = data[3:payload_end]

    table: object = None
    if table_id == TABLE_ID_PAT:
        pat = Pat(transport_stream_id=hdr.id_extension,
                  version=hdr.version)
        for i in range(0, len(body) - 3, 4):
            prog, pid = struct.unpack(">HH", body[i:i + 4])
            pat.programs.append((prog, pid & 0x1FFF))
        table = pat
    elif table_id == TABLE_ID_PMT:
        pinfo_len = ((body[2] & 0x0F) << 8) | body[3]
        pmt = Pmt(program_number=hdr.id_extension,
                  pcr_pid=((body[0] & 0x1F) << 8) | body[1],
                  descriptors=_parse_descriptors(
                      body[4:4 + pinfo_len]),
                  version=hdr.version)
        i = 4 + pinfo_len
        while i + 5 <= len(body):
            es_len = ((body[i + 3] & 0x0F) << 8) | body[i + 4]
            pmt.streams.append(PmtStream(
                stream_type=body[i],
                pid=((body[i + 1] & 0x1F) << 8) | body[i + 2],
                descriptors=_parse_descriptors(
                    body[i + 5:i + 5 + es_len])))
            i += 5 + es_len
        table = pmt
    elif table_id == TABLE_ID_CAT:
        table = Cat(descriptors=_parse_descriptors(body),
                    version=hdr.version)
    elif table_id == TABLE_ID_TSDT:
        table = Tsdt(descriptors=_parse_descriptors(body),
                     version=hdr.version)
    elif table_id in (TABLE_ID_NIT, TABLE_ID_NIT_OTHER):
        nd_len = ((body[0] & 0x0F) << 8) | body[1]
        nit = Nit(network_id=hdr.id_extension,
                  actual_network=table_id == TABLE_ID_NIT,
                  descriptors=_parse_descriptors(body[2:2 + nd_len]),
                  version=hdr.version)
        i = 2 + nd_len + 2
        while i + 6 <= len(body):
            td_len = ((body[i + 4] & 0x0F) << 8) | body[i + 5]
            nit.streams.append(NitStream(
                transport_stream_id=struct.unpack(
                    ">H", body[i:i + 2])[0],
                original_network_id=struct.unpack(
                    ">H", body[i + 2:i + 4])[0],
                descriptors=_parse_descriptors(
                    body[i + 6:i + 6 + td_len])))
            i += 6 + td_len
        table = nit
    elif table_id in (TABLE_ID_SDT, TABLE_ID_SDT_OTHER):
        sdt = Sdt(transport_stream_id=hdr.id_extension,
                  original_network_id=struct.unpack(
                      ">H", body[:2])[0],
                  actual_ts=table_id == TABLE_ID_SDT,
                  version=hdr.version)
        i = 3
        while i + 5 <= len(body):
            d_len = ((body[i + 3] & 0x0F) << 8) | body[i + 4]
            sdt.services.append(SdtService(
                service_id=struct.unpack(">H", body[i:i + 2])[0],
                eit_schedule=bool(body[i + 2] & 0x02),
                eit_present_following=bool(body[i + 2] & 0x01),
                running_status=(body[i + 3] >> 5) & 0x7,
                free_ca=bool(body[i + 3] & 0x10),
                descriptors=_parse_descriptors(
                    body[i + 5:i + 5 + d_len])))
            i += 5 + d_len
        table = sdt
    elif table_id in (TABLE_ID_EIT_PF, TABLE_ID_EIT_PF_OTHER):
        eit = Eit(service_id=hdr.id_extension,
                  transport_stream_id=struct.unpack(
                      ">H", body[:2])[0],
                  original_network_id=struct.unpack(
                      ">H", body[2:4])[0],
                  actual_ts=table_id == TABLE_ID_EIT_PF,
                  version=hdr.version)
        i = 6
        while i + 12 <= len(body):
            d_len = ((body[i + 10] & 0x0F) << 8) | body[i + 11]
            eit.events.append(EitEvent(
                event_id=struct.unpack(">H", body[i:i + 2])[0],
                start_time=decode_dvb_time(body[i + 2:i + 7]),
                duration=decode_bcd_duration(body[i + 7:i + 10]),
                running_status=(body[i + 10] >> 5) & 0x7,
                free_ca=bool(body[i + 10] & 0x10),
                descriptors=_parse_descriptors(
                    body[i + 12:i + 12 + d_len])))
            i += 12 + d_len
        table = eit
    elif table_id == TABLE_ID_TDT:
        table = Tdt(utc_time=decode_dvb_time(body))
    elif table_id == TABLE_ID_TOT:
        d_len = ((body[5] & 0x0F) << 8) | body[6]
        table = Tot(utc_time=decode_dvb_time(body[:5]),
                    descriptors=_parse_descriptors(
                        body[7:7 + d_len]))
    elif table_id == TABLE_ID_SCTE_SPLICE:
        table = _parse_scte_sit(body)

    return Section(table_id, hdr, table, data)


def sections_from_packets(data: bytes, pid: int) -> List[Section]:
    """Extract every complete section carried on one PID of a TS blob
    (PUSI + pointer_field reassembly, ISO 13818-1 2.4.4.2)."""
    out: List[Section] = []
    acc = bytearray()
    started = False
    for pos in range(0, len(data) - 187, 188):
        pkt = data[pos:pos + 188]
        if pkt[0] != 0x47:
            continue
        p = ((pkt[1] & 0x1F) << 8) | pkt[2]
        if p != pid:
            continue
        pusi = bool(pkt[1] & 0x40)
        afc = (pkt[3] >> 4) & 0x3
        off = 4
        if afc & 0x2:
            off += 1 + pkt[4]
        if not (afc & 0x1):
            continue
        payload = pkt[off:]
        if pusi:
            ptr = payload[0]
            if started and acc:
                acc += payload[1:1 + ptr]
                _drain_sections(acc, out)
            acc = bytearray(payload[1 + ptr:])
            started = True
        elif started:
            acc += payload
        if started:
            _drain_sections(acc, out)
    return out


def _drain_sections(acc: bytearray, out: List[Section]) -> None:
    while len(acc) >= 3 and acc[0] != 0xFF:
        slen = ((acc[1] & 0x0F) << 8) | acc[2]
        if len(acc) < 3 + slen:
            return
        try:
            out.append(parse_section(bytes(acc[:3 + slen])))
        except ValueError:
            pass
        del acc[:3 + slen]
    if len(acc) and acc[0] == 0xFF:
        acc.clear()


def packetize_section(sec_bytes: bytes, pid: int,
                      cc_start: int = 0) -> bytes:
    """Wrap one section into TS packets with pointer_field 0
    (the gst_mpegts_section_packetize analog)."""
    from ..elements.mpegts import PKT
    payload = b"\x00" + sec_bytes
    out = b""
    cc = cc_start
    pos = 0
    first = True
    while pos < len(payload):
        chunk = payload[pos:pos + PKT - 4]
        hdr = bytes([0x47, (0x40 if first else 0) | ((pid >> 8) & 0x1F),
                     pid & 0xFF, 0x10 | (cc & 0xF)])
        out += hdr + chunk + b"\xff" * (PKT - 4 - len(chunk))
        pos += len(chunk)
        cc += 1
        first = False
    return out
