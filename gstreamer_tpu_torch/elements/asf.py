"""ASF (Advanced Systems Format) — asfmux / asfparse / asfdemux.

References: gst-plugins-bad/gst/asfmux/ — gstasfmux.c (header/
stream-properties/data-object writing, payload packetization),
gstasfobjects.c:24-57 (the Microsoft-registered object GUIDs),
gstasfparse.c (object walk); gst-plugins-ugly/gst/asfdemux/
gstasfdemux.c:1 (payload parsing, stream activation, WMA/WMV caps).

The DATA section uses the real ASF packet structure (ASF spec §5.2):
fixed-size packets, error-correction prefix, payload parsing
information with per-field length types, single and multiple
payloads, replicated data (media-object size + pts), compressed
(sub-payload) payloads, and media objects fragmented across packets.
Interop is oracle-tested both directions against libavformat: files
written here demux with avformat, and WMA/WMV files written by
avformat demux here (tests/test_asf.py).

Muxer profile: PCM (WAVEFORMATEX tag 1) and MJPEG (BITMAPINFOHEADER
fourcc MJPG) inputs, single payload per packet with fragmentation.
Simple Index is not written (documented).

A port of the JAX package's ``elements/asf.py``: asfmux copies each tick
to the host (``host_array``); the demuxers give host arrays that the
pipeline stages on its device.
"""

from __future__ import annotations

import struct
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..audio import format as afmt
from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection,
                            PadPresence, PadTemplate, SourceElement,
                            register_element)
from ..core.structure import Structure
from ..core.value import Fraction


def _guid(a: int, b: int, c: int, rest: int) -> bytes:
    """Guid struct (gstasfobjects.c): LE dword/word/word + BE tail."""
    return struct.pack("<IHH", a, b, c) + rest.to_bytes(8, "big")


GUID_HEADER = _guid(0x75B22630, 0x668E, 0x11CF, 0xA6D900AA0062CE6C)
GUID_FILE_PROPS = _guid(0x8CABDCA1, 0xA947, 0x11CF,
                        0x8EE400C00C205365)
GUID_STREAM_PROPS = _guid(0xB7DC0791, 0xA9B7, 0x11CF,
                          0x8EE600C00C205365)
GUID_HEADER_EXT = _guid(0x5FBF03B5, 0xA92E, 0x11CF,
                        0x8EE300C00C205365)
GUID_HEADER_EXT_RESERVED = _guid(0xABD3D211, 0xA9BA, 0x11CF,
                                 0x8EE600C00C205365)
GUID_EXT_STREAM_PROPS = _guid(0x14E6A5CB, 0xC672, 0x4332,
                              0x8399A96952065B5A)
GUID_AUDIO_MEDIA = _guid(0xF8699E40, 0x5B4D, 0x11CF,
                         0xA8FD00805F5C442B)
GUID_VIDEO_MEDIA = _guid(0xBC19EFC0, 0x5B4D, 0x11CF,
                         0xA8FD00805F5C442B)
GUID_NO_ERROR_CORRECTION = _guid(0x20FB5700, 0x5B55, 0x11CF,
                                 0xA8FD00805F5C442B)
GUID_AUDIO_SPREAD = _guid(0xBFC3CD50, 0x618F, 0x11CF,
                          0x8BB200AA00B4E220)
GUID_DATA = _guid(0x75B22636, 0x668E, 0x11CF, 0xA6D900AA0062CE6C)
GUID_CONTENT_DESC = _guid(0x75B22633, 0x668E, 0x11CF,
                          0xA6D900AA0062CE6C)

_PACKET_SIZE = 3200          # fixed min == max packet size
_PREROLL_MS = 0

# WAVEFORMATEX wFormatTag -> caps (gstasfdemux.c audio caps mapping)
_WMA_TAGS = {0x160: 1, 0x161: 2, 0x162: 3, 0x163: 4}


def _obj(guid: bytes, payload: bytes) -> bytes:
    return guid + struct.pack("<Q", 24 + len(payload)) + payload


# ---------------------------------------------------------------------------
# packet-level writer (muxer side)


class _PacketWriter:
    """Real ASF data packets: single payload per packet, media objects
    fragmented across packets when larger than the packet capacity.

    Layout per packet (ASF spec §5.2): no error correction;
    length-type flags 0x08 (padding = word, packet length implicit =
    file-properties packet size); property flags 0x5D (repl=byte,
    offset=dword, media-object number=byte, stream number=byte)."""

    def __init__(self, packet_size: int = _PACKET_SIZE):
        self.packet_size = packet_size
        self.packets: List[bytes] = []
        self._mon = {}               # stream -> media object number

    # fixed header: flags(1) prop(1) pad(2) time(4) dur(2)
    # payload hdr: snum(1) mon(1) off(4) repl_len(1) repl(8)
    _FIXED = 1 + 1 + 2 + 4 + 2
    _PAYHDR = 1 + 1 + 4 + 1 + 8

    def capacity(self) -> int:
        return self.packet_size - self._FIXED - self._PAYHDR

    def add_object(self, snum: int, pts_ms: int, data: bytes,
                   key: bool = True):
        mon = self._mon.get(snum, 0)
        self._mon[snum] = (mon + 1) & 0xFF
        size = len(data)
        off = 0
        while off < size or (size == 0 and off == 0):
            chunk = data[off:off + self.capacity()]
            payload = bytes([snum | (0x80 if key else 0), mon])
            payload += struct.pack("<IB", off, 8)
            payload += struct.pack("<II", size,
                                   pts_ms + _PREROLL_MS)
            payload += chunk
            pad = self.packet_size - self._FIXED - len(payload)
            # flags 0x10: single payload, no sequence, WORD padding
            # length, implicit packet length (= file-props size)
            head = struct.pack("<BBHIH", 0x10, 0x5D, pad,
                               pts_ms + _PREROLL_MS, 0)
            self.packets.append(head + payload + b"\0" * pad)
            off += len(chunk)
            if size == 0:
                break


# ---------------------------------------------------------------------------
# packet-level parser (demuxer side)


def _varlen(data: bytes, p: int, lt: int) -> Tuple[int, int]:
    if lt == 0:
        return 0, p
    if lt == 1:
        return data[p], p + 1
    if lt == 2:
        return struct.unpack_from("<H", data, p)[0], p + 2
    return struct.unpack_from("<I", data, p)[0], p + 4


def _parse_packet(data: bytes, start: int, packet_size: int):
    """Yield (snum, key, mon, offset_or_pts, mo_size, pts_ms,
    payload) for every payload in one data packet."""
    p = start
    b = data[p]
    if b & 0x80:
        # error correction present: low nibble = EC data length
        p += 1 + (b & 0x0F)
        flags = data[p]
    else:
        flags = b
    p += 1
    prop = data[p]
    p += 1
    multiple = flags & 1
    seq_lt = (flags >> 1) & 3
    pad_lt = (flags >> 3) & 3
    plen_lt = (flags >> 5) & 3
    plen, p = _varlen(data, p, plen_lt)
    _seq, p = _varlen(data, p, seq_lt)
    pad, p = _varlen(data, p, pad_lt)
    send_time = struct.unpack_from("<I", data, p)[0]
    p += 6                                # send time (4) + duration (2)
    repl_lt = prop & 3
    off_lt = (prop >> 2) & 3
    mon_lt = (prop >> 4) & 3
    packet_len = plen if (plen_lt and plen) else packet_size
    end = start + packet_len - pad

    def one(p, explicit_len: Optional[int]):
        snum_b = data[p]
        snum, key = snum_b & 0x7F, bool(snum_b & 0x80)
        p += 1
        mon, p = _varlen(data, p, mon_lt)
        off, p = _varlen(data, p, off_lt)
        rlen, p = _varlen(data, p, repl_lt)
        if rlen == 1:
            # compressed payload: `off` is the pts, one byte of
            # presentation-time delta, then 1-byte-length sub-payloads
            delta = data[p]
            p += 1
            length = explicit_len if explicit_len is not None \
                else end - p
            sub = data[p:p + length]
            p += length
            outs = []
            q = 0
            pts = off
            k = mon
            while q < len(sub):
                ln = sub[q]
                q += 1
                outs.append((snum, key, k & 0xFF, 0, ln,
                             pts - _PREROLL_MS, sub[q:q + ln]))
                q += ln
                pts += delta
                k += 1
            return outs, p
        repl = data[p:p + rlen]
        p += rlen
        mo_size = struct.unpack_from("<I", repl, 0)[0] if rlen >= 4 \
            else 0
        pts = struct.unpack_from("<I", repl, 4)[0] if rlen >= 8 \
            else send_time
        length = explicit_len if explicit_len is not None else end - p
        payload = data[p:p + length]
        p += length
        return [(snum, key, mon, off, mo_size,
                 pts - _PREROLL_MS, payload)], p

    out = []
    if multiple:
        pf = data[p]
        p += 1
        count = pf & 0x3F
        pl_lt = (pf >> 6) & 3
        for _ in range(count):
            # payload length parsed after the replicated data
            snapshot = p
            snum_b = data[p]
            p += 1
            _mon, p = _varlen(data, p, mon_lt)
            _off, p = _varlen(data, p, off_lt)
            rlen, p = _varlen(data, p, repl_lt)
            p += 1 if rlen == 1 else rlen
            ln, p = _varlen(data, p, pl_lt)
            del snum_b
            items, _ = _parse_packet_payload(
                data, snapshot, mon_lt, off_lt, repl_lt, pl_lt, ln,
                send_time)
            out.extend(items)
            p += ln
    else:
        items, _p = one(p, None)
        out.extend(items)
    return out


def _parse_packet_payload(data, p, mon_lt, off_lt, repl_lt, pl_lt,
                          length, send_time):
    """One payload of a multiple-payload packet (explicit length)."""
    snum_b = data[p]
    snum, key = snum_b & 0x7F, bool(snum_b & 0x80)
    p += 1
    mon, p = _varlen(data, p, mon_lt)
    off, p = _varlen(data, p, off_lt)
    rlen, p = _varlen(data, p, repl_lt)
    if rlen == 1:
        delta = data[p]
        p += 1
        _ln, p = _varlen(data, p, pl_lt)   # payload length field
        sub = data[p:p + length]
        outs = []
        q = 0
        pts = off
        k = mon
        while q < len(sub):
            ln = sub[q]
            q += 1
            outs.append((snum, key, k & 0xFF, 0, ln,
                         pts - _PREROLL_MS, sub[q:q + ln]))
            q += ln
            pts += delta
            k += 1
        return outs, p + length
    repl = data[p:p + rlen]
    p += rlen
    _ln, p = _varlen(data, p, pl_lt)       # payload length field
    mo_size = struct.unpack_from("<I", repl, 0)[0] if rlen >= 4 else 0
    pts = struct.unpack_from("<I", repl, 4)[0] if rlen >= 8 \
        else send_time
    payload = data[p:p + length]
    return [(snum, key, mon, off, mo_size, pts - _PREROLL_MS,
             payload)], p + length


def _reassemble(payload_iter):
    """Merge fragmented media objects; yields (snum, pts_ms, key,
    bytes) in arrival order of completion."""
    partial: Dict[Tuple[int, int], List] = {}
    for snum, key, mon, off, mo_size, pts, data in payload_iter:
        if off == 0 and mo_size <= len(data):
            yield snum, pts, key, bytes(data)
            continue
        slot = partial.get((snum, mon))
        if slot is None or off == 0:
            slot = [bytearray(mo_size), 0, pts, key]
            partial[(snum, mon)] = slot
        buf, got, pts0, key0 = slot
        if off + len(data) <= len(buf):
            buf[off:off + len(data)] = data
            slot[1] = got + len(data)
            if slot[1] >= len(buf):
                del partial[(snum, mon)]
                yield snum, pts0, key0, bytes(buf)


# ---------------------------------------------------------------------------
# header-level parse


def _parse_asf(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if data[:16] != GUID_HEADER:
        raise ValueError("asfparse: not an ASF file")
    hdr_size = struct.unpack("<Q", data[16:24])[0]
    nobj = struct.unpack("<I", data[24:28])[0]
    pos = 30
    streams: Dict[int, Dict] = {}
    packet_size = _PACKET_SIZE
    preroll = 0

    def parse_stream_props(body: bytes):
        stype = body[:16]
        tlen = struct.unpack("<I", body[40:44])[0]
        snum = struct.unpack("<H", body[48:50])[0] & 0x7F
        tdata = body[54:54 + tlen]
        if stype == GUID_AUDIO_MEDIA:
            (tag, ch, rate, _bps, balign,
             bits) = struct.unpack("<HHIIHH", tdata[:16])
            cb = struct.unpack("<H", tdata[16:18])[0] \
                if len(tdata) >= 18 else 0
            extra = tdata[18:18 + cb]
            streams[snum] = {
                "kind": "audio", "tag": tag, "channels": ch,
                "rate": rate, "block_align": balign, "bits": bits,
                "codec_data": extra}
        elif stype == GUID_VIDEO_MEDIA:
            w, h = struct.unpack("<II", tdata[:8])
            fmt_len = struct.unpack("<H", tdata[9:11])[0]
            bmih = tdata[11:11 + fmt_len]
            fourcc = bmih[16:20] if len(bmih) >= 20 else b""
            extra = bmih[40:] if len(bmih) > 40 else b""
            streams[snum] = {
                "kind": "video", "width": w, "height": h,
                "fourcc": fourcc, "codec_data": extra}

    for _ in range(nobj):
        guid = data[pos:pos + 16]
        size = struct.unpack("<Q", data[pos + 16:pos + 24])[0]
        body = data[pos + 24:pos + size]
        if guid == GUID_STREAM_PROPS:
            parse_stream_props(body)
        elif guid == GUID_FILE_PROPS:
            # body: file_id(16) size(8) created(8) packets(8)
            # play(8) send(8) preroll_ms(8) flags(4) min(4) max(4)
            preroll = struct.unpack("<Q", body[56:64])[0]
            packet_size = struct.unpack("<I", body[68:72])[0]
        elif guid == GUID_HEADER_EXT:
            # nested objects (extended stream props hold a full
            # stream-properties object for late-activated streams)
            ext_len = struct.unpack("<I", body[18:22])[0]
            ep = 22
            while ep + 24 <= 22 + ext_len:
                eguid = body[ep:ep + 16]
                esize = struct.unpack("<Q",
                                      body[ep + 16:ep + 24])[0]
                if esize < 24:
                    break
                if eguid == GUID_EXT_STREAM_PROPS:
                    ebody = body[ep + 24:ep + esize]
                    # embedded stream-properties object at offset 64
                    if len(ebody) > 88 and \
                            ebody[64:80] == GUID_STREAM_PROPS:
                        parse_stream_props(ebody[88:])
                ep += esize
        pos += size
    # data object
    pos = hdr_size
    if data[pos:pos + 16] != GUID_DATA:
        raise ValueError("asfparse: no data object")
    data_size = struct.unpack("<Q", data[pos + 16:pos + 24])[0]
    npkts = struct.unpack("<Q", data[pos + 40:pos + 48])[0]
    p = pos + 50
    payloads = []
    end = pos + data_size
    count = 0
    while p + 2 < min(end, len(data)) and \
            (npkts == 0 or count < npkts):
        try:
            payloads.extend(_parse_packet(data, p, packet_size))
        except (IndexError, struct.error):
            break
        p += packet_size
        count += 1
    objects = list(_reassemble(iter(payloads)))
    if preroll:
        objects = [(s, max(0, pts - preroll), k, d)
                   for s, pts, k, d in objects]
    return streams, objects


# ---------------------------------------------------------------------------
# elements


@register_element
class AsfMux(AggregatorElement):
    FACTORY = "asfmux"
    DESCRIPTION = "Muxes audio and video into an ASF stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("video_%u", PadDirection.SINK, "image/jpeg",
                    presence=PadPresence.REQUEST),
        PadTemplate("audio_%u", PadDirection.SINK,
                    "audio/x-raw, format=S16LE, layout=interleaved",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, "video/x-ms-asf"),
    ]
    PROPERTIES = {
        "location": (str, "out.asf", "output path"),
        "packet-size": (int, _PACKET_SIZE, "ASF data packet size"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._ainfo: Optional[AudioInfo] = None
        self._vdims = None                   # (w, h, fps)
        self._file = None
        self._writer: Optional[_PacketWriter] = None
        self._dur_ms = 0

    def negotiate_output(self, in_caps, allowed):
        for pad_name, caps in in_caps.items():
            s = caps.fixate()[0]
            if pad_name.startswith("video"):
                fps = s.get("framerate") or Fraction(25, 1)
                self._vdims = (s.get("width") or 0,
                               s.get("height") or 0, fps)
            else:
                self._ainfo = AudioInfo.from_caps_structure(s)
        return Caps.from_string("video/x-ms-asf")

    def start(self):
        self._file = open(self.props["location"], "wb")
        self._writer = _PacketWriter(self.props["packet-size"])
        self._dur_ms = 0

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        for pad_name in sorted(ins):
            buf = ins[pad_name]
            ms = (buf.pts or 0) // 1_000_000
            if pad_name.startswith("video"):
                d = buf.data
                blobs = d if isinstance(d, (list, tuple)) else [d]
                dur_ms = (buf.duration or 0) // 1_000_000
                for k, b in enumerate(blobs):
                    raw = (bytes(b) if isinstance(b,
                                                  (bytes, bytearray))
                           else host_array(b).tobytes())
                    self._writer.add_object(2, ms + k * dur_ms, raw)
                    self._dur_ms = max(self._dur_ms, ms + k * dur_ms)
            else:
                raw = afmt.to_bytes(self._ainfo.finfo,
                                    host_array(buf.data)).tobytes()
                self._writer.add_object(1, ms, raw)
                self._dur_ms = max(self._dur_ms, ms)
        first = next(iter(ins.values()))
        return first.with_(data=np.zeros(1, np.uint8))

    def _stream_props_audio(self, snum: int) -> bytes:
        ai = self._ainfo
        ba = 2 * ai.channels
        wfx = struct.pack("<HHIIHH", 1, ai.channels, ai.rate,
                          ai.rate * ba, ba, 16) + struct.pack("<H", 0)
        body = GUID_AUDIO_MEDIA + GUID_NO_ERROR_CORRECTION
        body += struct.pack("<QIIHI", 0, len(wfx), 0, snum, 0)
        body += wfx
        return _obj(GUID_STREAM_PROPS, body)

    def _stream_props_video(self, snum: int) -> bytes:
        w, h, _fps = self._vdims
        bmih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           0, 0, 0, 0, 0)
        vinfo = struct.pack("<IIBH", w, h, 2, len(bmih)) + bmih
        body = GUID_VIDEO_MEDIA + GUID_NO_ERROR_CORRECTION
        body += struct.pack("<QIIHI", 0, len(vinfo), 0, snum, 0)
        body += vinfo
        return _obj(GUID_STREAM_PROPS, body)

    def stop(self):
        if self._file is None:
            return
        file_id = uuid.uuid4().bytes
        streams = []
        if self._ainfo is not None:
            streams.append(self._stream_props_audio(1))
        if self._vdims is not None:
            streams.append(self._stream_props_video(2))
        packets = self._writer.packets
        psize = self._writer.packet_size
        play_dur = (self._dur_ms + 1000) * 10_000    # 100ns units
        cdesc_title = "gstreamer_tpu asfmux".encode("utf-16-le") \
            + b"\0\0"
        cdesc = _obj(GUID_CONTENT_DESC,
                     struct.pack("<HHHHH", len(cdesc_title),
                                 0, 0, 0, 0) + cdesc_title)
        hext = _obj(GUID_HEADER_EXT,
                    GUID_HEADER_EXT_RESERVED
                    + struct.pack("<HI", 6, 0))

        def build(total: int) -> bytes:
            body = file_id + struct.pack(
                "<QQQQQQIIII", total, 0, len(packets), play_dur,
                play_dur, _PREROLL_MS, 0x02, psize, psize, 0)
            fileprops = _obj(GUID_FILE_PROPS, body)
            children = fileprops + hext + b"".join(streams) + cdesc
            return GUID_HEADER + struct.pack(
                "<QIBB", 24 + 6 + len(children),
                2 + len(streams) + 1 + 1, 0x01, 0x02) + children

        data_hdr = GUID_DATA + struct.pack(
            "<Q", 24 + 26 + len(packets) * psize)
        data_hdr += file_id + struct.pack("<QH", len(packets), 0x0101)
        header = build(0)
        total = len(header) + len(data_hdr) + len(packets) * psize
        header = build(total)
        self._file.write(header)
        self._file.write(data_hdr)
        for pkt in packets:
            self._file.write(pkt)
        self._file.close()
        self._file = None


@register_element
class AsfParse(SourceElement):
    """asfparse/asfdemux (source-style): one stream per instance from
    an .asf/.wmv/.wma file, including libavformat-written files."""
    FACTORY = "asfparse"
    DESCRIPTION = "Parses ASF"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "asf file path"),
        "stream": (str, "video", "video | audio"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._loaded = False
        self._pos = 0

    def _load(self):
        if self._loaded:
            return
        streams, objects = _parse_asf(self.props["location"])
        sel = self.props["stream"]
        snum = None
        for num, info in streams.items():
            if info["kind"] == sel:
                snum = num
                self._sinfo = info
                break
        if snum is None:
            raise ValueError(f"asfparse: no {sel!r} stream")
        self._payloads = [(ms, raw) for n, ms, _k, raw in objects
                          if n == snum]
        self._loaded = True

    def _audio_caps(self) -> Caps:
        si = self._sinfo
        tag = si.get("tag", 1)
        if tag in _WMA_TAGS:
            return Caps([Structure("audio/x-wma", {
                "wmaversion": _WMA_TAGS[tag], "rate": si["rate"],
                "channels": si["channels"],
                "block_align": si["block_align"],
                "bitrate": si["rate"] * 16 * si["channels"]})])
        return Caps([AudioInfo(format="S16LE", rate=si["rate"],
                               channels=si["channels"])
                     .to_caps_structure()])

    def _video_caps(self) -> Caps:
        si = self._sinfo
        w, h = si["width"], si["height"]
        fourcc = si.get("fourcc", b"MJPG")
        if fourcc in (b"WMV1", b"WMV2", b"WMV3"):
            return Caps([Structure("video/x-wmv", {
                "wmvversion": int(chr(fourcc[3])),
                "width": w, "height": h})])
        if (not w or not h) and self._payloads:
            # upstream caps had no dims: read them from the first
            # JPEG SOF (like gstasfdemux's stream activation)
            from .jpegformat import parse_sof, walk_markers
            markers, _, _ = walk_markers(self._payloads[0][1])
            for m, _off, payload in markers:
                if m in (0xC0, 0xC1, 0xC2):
                    sof = parse_sof(payload)
                    w, h = sof["width"], sof["height"]
                    break
        return Caps([Structure("image/jpeg",
                               {"width": w, "height": h})])

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        if not self._loaded:
            caps = Caps.any()
        elif self._sinfo["kind"] == "video":
            caps = self._video_caps()
        else:
            caps = self._audio_caps()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def preview_blob(self) -> Optional[bytes]:
        try:
            self._load()
        except (OSError, ValueError):
            return None
        if self._sinfo["kind"] == "video" and self._payloads:
            return self._payloads[0][1]
        return None

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._load()
        self._pos = 0

    def _meta(self) -> Dict:
        si = self._sinfo
        meta = {}
        if si.get("codec_data"):
            meta["codec_data"] = si["codec_data"]
        if si["kind"] == "audio":
            meta["rate"] = si["rate"]
            meta["channels"] = si["channels"]
            if si.get("block_align"):
                meta["block_align"] = si["block_align"]
        else:
            meta["width"] = si.get("width", 0)
            meta["height"] = si.get("height", 0)
        return meta

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._payloads):
            return None
        si = self._sinfo
        coded = si["kind"] == "video" or si.get("tag", 1) != 1
        if coded:
            take = self._payloads[self._pos:
                                  self._pos + max(1, n_frames)]
            self._pos += len(take)
            blobs = [np.frombuffer(raw, np.uint8) for _, raw in take]
            return Buffer(data=blobs if len(blobs) > 1 else blobs[0],
                          pts=take[0][0] * 1_000_000,
                          batch=len(blobs), meta=self._meta())
        ms, raw = self._payloads[self._pos]
        self._pos += 1
        samples = afmt.from_bytes(
            AudioInfo(format="S16LE", rate=si["rate"],
                      channels=si["channels"]).finfo,
            np.frombuffer(raw, np.uint8), si["channels"])
        return Buffer(data=samples, pts=ms * 1_000_000, batch=1)


@register_element
class AsfDemux(AsfParse):
    """asfdemux — the gst-plugins-ugly/gst/asfdemux element name for
    the same ASF reader (gstasfdemux.c)."""
    FACTORY = "asfdemux"
