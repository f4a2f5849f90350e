"""mpegpsmux / mpegpsdemux — MPEG-2 Program Stream container
(DVD VOB family).

Reference: gst-plugins-bad/gst/mpegpsmux/psmux.c (pack/system-header
writing, PES streams) and gst/mpegdemux/gstmpegdemux.c +
gstpesfilter.c (start-code walk, PES parsing, 0xBD private-1
substreams).

Layout written/read (ISO 13818-1 §2.5):
* pack header 0x000001BA (MPEG-2 form: 48-bit SCR with marker bits,
  22-bit mux rate, stuffing length);
* system header 0x000001BB once after the first pack;
* PES packets 0xE0 (video), 0xC0 (MPEG audio), 0xBD private-1 with
  the DVD substream convention (0x80-0x87 = AC-3, 4-byte header);
* program end 0x000001B9.

The demux mirrors tsdemux's collapsed source convention (location +
stream index/kind selection); carried codecs pair with
avdec_mpeg2video / mpegaudioparse+mpg123audiodec / ac3parse+a52dec /
h264parse+avdec_h264 downstream.

A port of the JAX package's ``elements/mpegps.py`` (host elements; each
tick is copied to the host with ``host_array``).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, SourceElement, register_element)
from .mpegts import _pes

_VIDEO_SID = 0xE0
_AUDIO_SID = 0xC0
_PRIVATE_SID = 0xBD


def _pack_header(scr_90k: int) -> bytes:
    """MPEG-2 pack header (no stuffing)."""
    base = scr_90k & ((1 << 33) - 1)
    ext = 0
    v = (0b01 << 46
         | ((base >> 30) & 0x7) << 43 | 1 << 42
         | ((base >> 15) & 0x7FFF) << 27 | 1 << 26
         | (base & 0x7FFF) << 11 | 1 << 10
         | (ext & 0x1FF) << 1 | 1)
    mux = (50000 << 2) | 0b11
    return (b"\x00\x00\x01\xba" + v.to_bytes(6, "big")
            + mux.to_bytes(3, "big") + bytes([0xF8]))


def _system_header() -> bytes:
    body = (struct.pack(">I", 0x80000000 | (50000 << 9) | 0x100)[1:]
            + bytes([0x04, 0x21, 0x7F])
            + bytes([0xE0, 0xE0, 0x20])      # video bound
            + bytes([0xC0, 0xC0, 0x20]))     # audio bound
    return (b"\x00\x00\x01\xbb" + struct.pack(">H", len(body))
            + body)


@register_element
class MpegPsMux(AggregatorElement):
    FACTORY = "mpegpsmux"
    DESCRIPTION = "Multiplexes media streams into an MPEG Program " \
                  "Stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK,
                    "video/mpeg, systemstream=false; video/x-h264; "
                    "audio/mpeg, mpegversion=1; audio/x-ac3",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC,
                    "video/mpeg, systemstream=true"),
    ]
    PROPERTIES = {"location": (str, "out.mpg", "output path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._file = None
        self._sids: Dict[str, int] = {}
        self._counts: Dict[str, int] = {}

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed):
        nv = na = 0
        self._ac3: Dict[str, bool] = {}
        for pad_name in sorted(in_caps):
            s = in_caps[pad_name].fixate()[0]
            if s.name.startswith("video"):
                self._sids[pad_name] = _VIDEO_SID + nv
                nv += 1
            elif s.name == "audio/x-ac3":
                self._sids[pad_name] = _PRIVATE_SID
                self._ac3[pad_name] = True
            else:
                self._sids[pad_name] = _AUDIO_SID + na
                na += 1
        return Caps.from_string("video/mpeg, systemstream=true, "
                                "mpegversion=2")

    def start(self):
        self._file = open(self.props["location"], "wb")
        self._first = True
        self._counts = {}

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        for pad_name in sorted(ins):
            buf = ins[pad_name]
            sid = self._sids[pad_name]
            blobs = buf.data if isinstance(buf.data, list) \
                else [buf.data]
            n = len(blobs)
            for k, b in enumerate(blobs):
                raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                       else host_array(b).tobytes())
                if self._ac3.get(pad_name):
                    # DVD private-1 substream header (0x80 = AC-3
                    # substream 0, frame count 1, first access unit
                    # offset 1)
                    raw = bytes([0x80, 0x01, 0x00, 0x01]) + raw
                pts = buf.pts
                if pts is not None and buf.duration and n:
                    pts = pts + k * buf.duration // n
                pts90 = (pts * 90000 // 1_000_000_000
                         if pts is not None else 0)
                self._file.write(_pack_header(pts90))
                if self._first:
                    self._file.write(_system_header())
                    self._first = False
                self._file.write(_pes(sid, raw,
                                      pts90 if pts is not None
                                      else None))
        first = next(iter(ins.values()))
        return first.with_(data=np.zeros(1, np.uint8))

    def stop(self):
        if self._file is not None:
            self._file.write(b"\x00\x00\x01\xb9")
            self._file.close()
            self._file = None


def _parse_ps(data: bytes):
    """-> {stream_key: [payload, ...]} where stream_key is the PES
    stream id, or ('bd', substream) for private-1."""
    streams: Dict[object, List[bytes]] = {}
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        i = data.find(b"\x00\x00\x01", pos)
        if i < 0 or i + 4 > n:
            break
        code = data[i + 3]
        pos = i + 4
        if code == 0xBA:                     # pack header
            if pos < n and (data[pos] & 0xC0) == 0x40:   # MPEG-2
                if pos + 10 <= n:
                    stuff = data[pos + 9] & 0x7
                    pos += 10 + stuff
            else:                            # MPEG-1 form: 8 bytes
                pos += 8
        elif code == 0xB9:                   # program end
            break
        elif code in (0xBB, 0xBC, 0xBE, 0xBF):
            if pos + 2 <= n:
                ln = struct.unpack(">H", data[pos:pos + 2])[0]
                pos += 2 + ln
        elif 0xBD == code or 0xC0 <= code <= 0xEF:
            if pos + 2 > n:
                break
            ln = struct.unpack(">H", data[pos:pos + 2])[0]
            body = data[pos + 2:pos + 2 + ln]
            pos += 2 + ln
            if len(body) < 3:
                continue
            # MPEG-2 PES header: flags(2) + header_length
            hlen = body[2]
            payload = body[3 + hlen:]
            key = code
            if code == 0xBD and payload:
                sub = payload[0]
                payload = payload[4:]        # substream hdr
                key = ("bd", sub)
            if payload:
                streams.setdefault(key, []).append(payload)
    return streams


@register_element
class MpegPsDemux(SourceElement):
    """mpegpsdemux (source-style like tsdemux): one elementary
    stream per instance via the `stream` property
    (audio | video | ac3 | stream-id int)."""
    FACTORY = "mpegpsdemux"
    DESCRIPTION = "Demultiplexes MPEG Program Streams"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "program stream path"),
        "stream": (str, "video", "video | audio | ac3 | stream id"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._units = None
        self._pos = 0

    def _load(self):
        if self._units is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        if b"\x00\x00\x01\xba" not in data[:4096]:
            raise ValueError("mpegpsdemux: no pack header")
        streams = _parse_ps(data)
        want = self.props["stream"]
        key = None
        for k in streams:
            if isinstance(k, tuple):
                if want == "ac3" or want == "audio":
                    key = k
                    if want == "ac3":
                        break
            elif _VIDEO_SID <= k <= 0xEF:
                if want == "video" or want == str(k):
                    key = k
                    break
            elif _AUDIO_SID <= k <= 0xDF:
                if want == "audio" or want == str(k):
                    key = k
                    break
        if key is None:
            raise ValueError(f"mpegpsdemux: no {want!r} stream")
        self._units = streams[key]
        blob = b"".join(self._units[:4])
        if isinstance(key, tuple):
            self._caps = Caps.from_string("audio/x-ac3")
        elif key >= _VIDEO_SID:
            if b"\x00\x00\x01\xb3" in blob:
                self._caps = Caps.from_string(
                    "video/mpeg, mpegversion=2, systemstream=false, "
                    "parsed=true")
            else:
                self._caps = Caps.from_string(
                    "video/x-h264, stream-format=byte-stream, "
                    "alignment=au")
        else:
            self._caps = Caps.from_string(
                "audio/mpeg, mpegversion=1, parsed=true")

    def preview_blob(self) -> Optional[bytes]:
        try:
            self._load()
        except (OSError, ValueError):
            return None
        return self._units[0] if self._units else None

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

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._units):
            return None
        take = self._units[self._pos:self._pos + max(1, n_frames)]
        blobs = [np.frombuffer(u, np.uint8) for u in take]
        self._pos += len(take)
        return Buffer(data=blobs if len(blobs) > 1 else blobs[0],
                      batch=len(blobs),
                      meta={"caps": self._caps})


@register_element
class Mplex(MpegPsMux):
    """mplex (gst-plugins-bad/ext/mplex): the classic mjpegtools
    program-stream multiplexer name — same writer."""
    FACTORY = "mplex"
    DESCRIPTION = "High-quality MPEG multiplexer"
