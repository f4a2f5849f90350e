"""midiparse, irtspparse, unixfdsink/unixfdsrc.

References:
* gst-plugins-bad/gst/midi/midiparse.c — Standard MIDI File parsing:
  MThd (format/ntracks/division), MTrk chunks, variable-length delta
  times, running status, meta events (0x51 tempo mapping ticks ->
  ns), output caps audio/x-midi-event with one timestamped event
  buffer per MIDI message (:119-125 caps, :471 MThd, tempo map).
* gst-plugins-bad/gst/pcapparse/gstirtspparse.c — RFC 2326 §10.12
  interleaved framing: '$' + channel + 16-bit length + payload;
  `channel-id` selects the channel.
* gst-plugins-bad/gst/unixfd/ — zero-copy fd passing over a unix
  socket; reduced to a unix-domain SOCK_STREAM byte bridge with the
  same socket-path contract (length-prefixed buffers).

A port of the JAX package's ``elements/midi_irtsp.py``.  unixfdsink sends
each leaf of a buffer (each plane of video) as a record of its own, taken to
the host wherever it lies; unixfdsrc reads a record into one preallocated
buffer (the same bytes).
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)
from .audioparsers import _ParserBase


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    while True:
        b = data[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            return v, pos


def parse_smf(data: bytes) -> Tuple[int, List[List[tuple]]]:
    """-> (division, tracks) with tracks = [(tick, event_bytes)]."""
    if data[:4] != b"MThd":
        raise ValueError("midiparse: not a standard midi file")
    division = int.from_bytes(data[12:14], "big")
    ntracks = int.from_bytes(data[10:12], "big")
    pos = 8 + int.from_bytes(data[4:8], "big")
    tracks = []
    for _ in range(ntracks):
        if data[pos:pos + 4] != b"MTrk":
            break
        size = int.from_bytes(data[pos + 4:pos + 8], "big")
        body = data[pos + 8:pos + 8 + size]
        pos += 8 + size
        events = []
        p = 0
        tick = 0
        running = 0
        while p < len(body):
            delta, p = _read_varlen(body, p)
            tick += delta
            status = body[p]
            if status & 0x80:
                p += 1
                if status < 0xF0:
                    running = status
            else:
                status = running
            if status == 0xFF:                   # meta
                mtype = body[p]
                ln, p2 = _read_varlen(body, p + 1)
                payload = body[p2:p2 + ln]
                events.append((tick, bytes([0xFF, mtype]) + payload))
                p = p2 + ln
            elif status in (0xF0, 0xF7):         # sysex
                ln, p2 = _read_varlen(body, p)
                events.append((tick,
                               bytes([status]) + body[p2:p2 + ln]))
                p = p2 + ln
            else:
                nargs = 1 if (status & 0xF0) in (0xC0, 0xD0) else 2
                events.append((tick, bytes([status])
                               + body[p:p + nargs]))
                p += nargs
        tracks.append(events)
    return division, tracks


def smf_events_with_time(data: bytes) -> List[Tuple[int, bytes]]:
    """Merge tracks; (pts_ns, event) using the tempo map (meta 0x51
    sets us/quarter; default 500000 = 120bpm)."""
    division, tracks = parse_smf(data)
    merged = sorted([(t, ev) for tr in tracks for (t, ev) in tr],
                    key=lambda x: x[0])
    out = []
    tempo = 500000                               # us per quarter note
    last_tick = 0
    ns = 0
    for tick, ev in merged:
        ns += (tick - last_tick) * tempo * 1000 // division
        last_tick = tick
        if ev[:2] == b"\xff\x51" and len(ev) >= 5:
            tempo = int.from_bytes(ev[2:5], "big")
        out.append((ns, ev))
    return out


@register_element
class MidiParse(SourceElement):
    """midiparse (source-style collapse): location -> timestamped
    audio/x-midi-event buffers."""
    FACTORY = "midiparse"
    DESCRIPTION = "Midi Parser Element"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "audio/x-midi-event")]
    PROPERTIES = {"location": (str, "", ".mid file path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._events: Optional[List[Tuple[int, bytes]]] = None
        self._pos = 0

    def _load(self):
        if self._events is None:
            self._events = smf_events_with_time(
                open(self.props["location"], "rb").read())

    def get_caps(self, filter=None):
        caps = Caps.from_string("audio/x-midi-event")
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._events):
            return None
        take = self._events[self._pos:self._pos + max(1, n_frames)]
        self._pos += len(take)
        return Buffer(
            data=[np.frombuffer(ev, np.uint8) for _, ev in take],
            pts=take[0][0], batch=len(take))


@register_element
class IRtspParse(_ParserBase):
    FACTORY = "irtspparse"
    DESCRIPTION = "Parses a raw interleaved RTSP stream"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    _SRC_CAPS = "application/x-rtp"
    PROPERTIES = {"channel-id": (int, 0, "channel to extract")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(4)
        self._payload: Optional[int] = None
        self._post_skip = 0

    def start(self):
        super().start()
        self._payload = None
        self._post_skip = 0

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        if self._payload is not None:
            size = self._payload
            self._payload = None
            self.set_min_frame_size(4)
            return size, 0
        if self._post_skip:
            skip, self._post_skip = self._post_skip, 0
            return 0, skip
        if raw[0] != 0x24:                       # '$'
            nxt = raw.find(b"\x24", 1)
            return 0, (nxt if nxt > 0 else len(raw))
        channel = raw[1]
        length = int.from_bytes(raw[2:4], "big")
        if len(raw) < 4 + length:
            return 0, 0
        if channel != self.props["channel-id"]:
            return 0, 4 + length
        self._payload = length
        self.set_min_frame_size(max(1, length))
        return 0, 4


@register_element
class UnixFdSink(SinkElement):
    FACTORY = "unixfdsink"
    DESCRIPTION = "Unix file descriptor sink"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {"socket-path": (str, "/tmp/gtpu-unixfd", "")}

    def start(self):
        path = self.props["socket-path"]
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(path)
        self._srv.listen(1)
        self._srv.settimeout(5.0)
        self._conn = None
        self._queue: List[bytes] = []

    def stop(self):
        if getattr(self, "_conn", None):
            self._conn.close()
            self._conn = None
        if getattr(self, "_srv", None):
            self._srv.close()
            self._srv = None

    def _ensure_conn(self) -> bool:
        if self._conn is None:
            try:
                self._conn, _ = self._srv.accept()
            except socket.timeout:
                return False
        return True

    def render(self, buf: Buffer) -> str:
        d = buf.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            self._queue.append(raw)
        if self._ensure_conn():
            for raw in self._queue:
                self._conn.sendall(len(raw).to_bytes(8, "little")
                                   + raw)
            self._queue.clear()
        return FlowReturn.OK


@register_element
class UnixFdSrc(SourceElement):
    FACTORY = "unixfdsrc"
    DESCRIPTION = "Unix file descriptor source"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "socket-path": (str, "/tmp/gtpu-unixfd", ""),
        "timeout": (float, 5.0, ""),
        "num-buffers": (int, -1, ""),
    }

    def get_caps(self, filter=None):
        if filter is not None and not filter.is_any:
            return filter
        return Caps.from_string("application/octet-stream")

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        import time as _time
        self._sock = socket.socket(socket.AF_UNIX,
                                   socket.SOCK_STREAM)
        self._sock.settimeout(self.props["timeout"])
        deadline = _time.monotonic() + self.props["timeout"]
        while True:
            try:
                self._sock.connect(self.props["socket-path"])
                break
            except (ConnectionRefusedError, FileNotFoundError):
                if _time.monotonic() >= deadline:
                    raise
                _time.sleep(0.05)
        self._count = 0

    def stop(self):
        if getattr(self, "_sock", None):
            self._sock.close()
            self._sock = None

    def _read(self, n: int) -> Optional[bytearray]:
        out = bytearray(n)
        view = memoryview(out)
        got = 0
        while got < n:
            try:
                k = self._sock.recv_into(view[got:])
            except socket.timeout:
                return None
            if not k:
                return None
            got += k
        return out

    def create(self, n_frames: int) -> Optional[Buffer]:
        lim = self.props["num-buffers"]
        if lim >= 0 and self._count >= lim:
            return None
        hdr = self._read(8)
        if hdr is None:
            return None
        raw = self._read(int.from_bytes(hdr, "little"))
        if raw is None:
            return None
        self._count += 1
        return Buffer(data=np.frombuffer(raw, np.uint8), batch=1)
