"""RTMP — rtmp2src / rtmp2sink plus a minimal relay server.

Clean-room implementation of the Adobe RTMP 1.0 wire protocol
(reference elements: gst-plugins-bad/gst/rtmp2/gstrtmp2src.c,
gstrtmp2sink.c and their rtmpconnection.c/rtmpchunkstream.c/
rtmpmessage.c library).  Covers the full client path: the 1536-byte
handshake, chunk-stream (fmt 0-3 headers, extended timestamps, chunk
size negotiation), AMF0 command messages (connect / createStream /
publish / play, _result / onStatus handling), and FLV-tag media
transport (audio 8 / video 9 / data 18 messages are FLV tag bodies).

rtmp2sink consumes a video/x-flv byte stream (e.g. from filesrc or a
muxer) and publishes it; rtmp2src plays a stream and emits a
video/x-flv byte stream for flvdemux.  `RtmpRelayServer` is a small
single-app server (publish fans out to players) used by the tests and
usable as a lightweight ingest point — the reference keeps the server
side out of scope entirely.

A copy of the JAX package's ``net/rtmp.py``: the same AMF0, chunks and FLV
tags, byte for byte (the handshake's random bytes aside).  The sink copies
each tick's bytes to the host (``host_array``) and takes its source's host
bytes (``HOST_INPUT``).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)

RTMP_VERSION = 3
HANDSHAKE_SIZE = 1536
DEFAULT_CHUNK = 128

MSG_SET_CHUNK_SIZE = 1
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK = 5
MSG_SET_PEER_BW = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20


# ---------------------------------------------------------------------------
# AMF0 (Action Message Format) encode/decode
# ---------------------------------------------------------------------------

def amf0_encode(value) -> bytes:
    if value is None:
        return b"\x05"
    if isinstance(value, bool):
        return b"\x01" + (b"\x01" if value else b"\x00")
    if isinstance(value, (int, float)):
        return b"\x00" + struct.pack(">d", float(value))
    if isinstance(value, str):
        b = value.encode()
        return b"\x02" + struct.pack(">H", len(b)) + b
    if isinstance(value, dict):
        out = b"\x03"
        for k, v in value.items():
            kb = k.encode()
            out += struct.pack(">H", len(kb)) + kb + amf0_encode(v)
        return out + b"\x00\x00\x09"
    raise TypeError(f"amf0: cannot encode {type(value)}")


def amf0_decode(data: bytes, pos: int = 0):
    """-> (value, new_pos)"""
    marker = data[pos]
    pos += 1
    if marker == 0x00:
        return struct.unpack(">d", data[pos:pos + 8])[0], pos + 8
    if marker == 0x01:
        return bool(data[pos]), pos + 1
    if marker == 0x02:
        n = struct.unpack(">H", data[pos:pos + 2])[0]
        return data[pos + 2:pos + 2 + n].decode("utf-8",
                                                "replace"), \
            pos + 2 + n
    if marker in (0x03, 0x08):          # object / ECMA array
        if marker == 0x08:
            pos += 4                     # approximate count
        obj = {}
        while True:
            n = struct.unpack(">H", data[pos:pos + 2])[0]
            key = data[pos + 2:pos + 2 + n].decode("utf-8", "replace")
            pos += 2 + n
            if n == 0 and data[pos] == 0x09:
                return obj, pos + 1
            obj[key], pos = amf0_decode(data, pos)
    if marker == 0x05 or marker == 0x06:  # null / undefined
        return None, pos
    raise ValueError(f"amf0: marker {marker:#x} unsupported")


def amf0_decode_all(data: bytes) -> List:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = amf0_decode(data, pos)
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# Chunk stream
# ---------------------------------------------------------------------------

class ChunkConnection:
    """Message-level read/write over the RTMP chunk stream."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.in_chunk = DEFAULT_CHUNK
        self.out_chunk = DEFAULT_CHUNK
        self._rd: Dict[int, dict] = {}   # per-csid reader state
        self._partial: Dict[int, bytearray] = {}

    # -- handshake -----------------------------------------------------------
    def handshake_client(self):
        c1 = struct.pack(">II", 0, 0) + os.urandom(HANDSHAKE_SIZE - 8)
        self.sock.sendall(bytes([RTMP_VERSION]) + c1)
        s0 = self._recv_exact(1)
        if s0[0] != RTMP_VERSION:
            raise ConnectionError(f"rtmp: bad version {s0[0]}")
        s1 = self._recv_exact(HANDSHAKE_SIZE)
        self._recv_exact(HANDSHAKE_SIZE)       # s2
        self.sock.sendall(s1)                   # c2 echoes s1

    def handshake_server(self):
        c0 = self._recv_exact(1)
        if c0[0] != RTMP_VERSION:
            raise ConnectionError(f"rtmp: bad version {c0[0]}")
        c1 = self._recv_exact(HANDSHAKE_SIZE)
        s1 = struct.pack(">II", 0, 0) + os.urandom(HANDSHAKE_SIZE - 8)
        self.sock.sendall(bytes([RTMP_VERSION]) + s1 + c1)  # s0 s1 s2
        self._recv_exact(HANDSHAKE_SIZE)       # c2

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("rtmp: connection closed")
            buf += part
        return buf

    # -- send ----------------------------------------------------------------
    def send_message(self, csid: int, mtype: int, stream_id: int,
                     timestamp: int, payload: bytes):
        """Type-0 chunk then type-3 continuation chunks."""
        ts = min(timestamp, 0xFFFFFF)
        hdr = bytes([(0 << 6) | csid])
        hdr += struct.pack(">I", ts)[1:]
        hdr += struct.pack(">I", len(payload))[1:]
        hdr += bytes([mtype])
        hdr += struct.pack("<I", stream_id)
        if timestamp >= 0xFFFFFF:
            hdr += struct.pack(">I", timestamp)
        out = hdr + payload[:self.out_chunk]
        pos = self.out_chunk
        while pos < len(payload):
            out += bytes([(3 << 6) | csid])
            if timestamp >= 0xFFFFFF:
                out += struct.pack(">I", timestamp)
            out += payload[pos:pos + self.out_chunk]
            pos += self.out_chunk
        self.sock.sendall(out)

    def set_chunk_size(self, size: int):
        self.send_message(2, MSG_SET_CHUNK_SIZE, 0, 0,
                          struct.pack(">I", size))
        self.out_chunk = size

    def send_command(self, name: str, txid: float, *args,
                     stream_id: int = 0, csid: int = 3):
        payload = amf0_encode(name) + amf0_encode(txid)
        for a in args:
            payload += amf0_encode(a)
        self.send_message(csid, MSG_COMMAND_AMF0, stream_id, 0,
                          payload)

    # -- receive -------------------------------------------------------------
    def read_message(self) -> Tuple[int, int, int, bytes]:
        """-> (msg_type, stream_id, timestamp, payload); handles
        protocol-control messages (chunk size) internally."""
        while True:
            basic = self._recv_exact(1)[0]
            fmt = basic >> 6
            csid = basic & 0x3F
            if csid == 0:
                csid = 64 + self._recv_exact(1)[0]
            elif csid == 1:
                b = self._recv_exact(2)
                csid = 64 + b[0] + b[1] * 256
            st = self._rd.setdefault(csid, {
                "ts": 0, "len": 0, "type": 0, "sid": 0, "delta": 0})
            if fmt == 0:
                b = self._recv_exact(11)
                ts = int.from_bytes(b[0:3], "big")
                st["len"] = int.from_bytes(b[3:6], "big")
                st["type"] = b[6]
                st["sid"] = struct.unpack("<I", b[7:11])[0]
                if ts == 0xFFFFFF:
                    ts = struct.unpack(">I", self._recv_exact(4))[0]
                st["ts"] = ts
                st["delta"] = 0
            elif fmt == 1:
                b = self._recv_exact(7)
                d = int.from_bytes(b[0:3], "big")
                st["len"] = int.from_bytes(b[3:6], "big")
                st["type"] = b[6]
                if d == 0xFFFFFF:
                    d = struct.unpack(">I", self._recv_exact(4))[0]
                st["delta"] = d
                if csid not in self._partial:
                    st["ts"] += d
            elif fmt == 2:
                b = self._recv_exact(3)
                d = int.from_bytes(b, "big")
                if d == 0xFFFFFF:
                    d = struct.unpack(">I", self._recv_exact(4))[0]
                st["delta"] = d
                if csid not in self._partial:
                    st["ts"] += d
            else:                       # fmt 3: continuation or repeat
                if csid not in self._partial:
                    st["ts"] += st["delta"]
            part = self._partial.setdefault(csid, bytearray())
            want = min(self.in_chunk, st["len"] - len(part))
            part += self._recv_exact(want)
            if len(part) < st["len"]:
                continue
            payload = bytes(part)
            del self._partial[csid]
            if st["type"] == MSG_SET_CHUNK_SIZE:
                self.in_chunk = struct.unpack(">I", payload[:4])[0]
                continue
            if st["type"] in (MSG_ACK, MSG_WINDOW_ACK,
                              MSG_SET_PEER_BW, MSG_USER_CONTROL):
                continue
            return st["type"], st["sid"], st["ts"], payload


def _parse_location(location: str) -> Tuple[str, int, str, str]:
    """rtmp://host[:port]/app/stream -> (host, port, app, stream)."""
    if not location.startswith("rtmp://"):
        raise ValueError(f"rtmp: bad location {location!r}")
    rest = location[7:]
    hostport, _, path = rest.partition("/")
    host, _, port = hostport.partition(":")
    app, _, stream = path.partition("/")
    return host, int(port or 1935), app, stream


class _RtmpClient:
    """Shared connect/createStream sequence (rtmpconnection.c)."""

    def __init__(self, location: str):
        self.host, self.port, self.app, self.stream = \
            _parse_location(location)
        self.conn: Optional[ChunkConnection] = None
        self.stream_id = 0

    def connect(self):
        sock = socket.create_connection((self.host, self.port),
                                        timeout=10.0)
        sock.settimeout(10.0)
        self.conn = ChunkConnection(sock)
        self.conn.handshake_client()
        self.conn.set_chunk_size(4096)
        tcurl = f"rtmp://{self.host}:{self.port}/{self.app}"
        self.conn.send_command(
            "connect", 1, {"app": self.app, "tcUrl": tcurl,
                           "flashVer": "GTPU/1.0"})
        self._wait_result("connect")
        self.conn.send_command("createStream", 2, None)
        msg = self._wait_result("createStream")
        self.stream_id = int(msg[3]) if len(msg) > 3 and \
            isinstance(msg[3], float) else 1

    def _wait_result(self, what: str):
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            mtype, sid, ts, payload = self.conn.read_message()
            if mtype != MSG_COMMAND_AMF0:
                continue
            vals = amf0_decode_all(payload)
            if vals and vals[0] == "_result":
                return vals
            if vals and vals[0] == "_error":
                raise ConnectionError(f"rtmp: {what} failed: {vals}")
            if vals and vals[0] == "onStatus":
                info = vals[3] if len(vals) > 3 else {}
                code = (info or {}).get("code", "")
                if "Start" in code:
                    return vals
                if "Failed" in code or "NotFound" in code:
                    raise ConnectionError(f"rtmp: {code}")
        raise TimeoutError(f"rtmp: no response to {what}")

    def close(self):
        if self.conn:
            try:
                self.conn.sock.close()
            except OSError:
                pass
            self.conn = None


# ---------------------------------------------------------------------------
# FLV tag (de)framing
# ---------------------------------------------------------------------------

FLV_HEADER = b"FLV\x01\x05\x00\x00\x00\x09" + b"\x00\x00\x00\x00"


def parse_flv_stream(data: bytes):
    """FLV byte stream -> [(tag_type, timestamp, payload)], leftover.
    Accepts a leading FLV header."""
    pos = 0
    if data[:3] == b"FLV":
        pos = struct.unpack(">I", data[5:9])[0] + 4
    tags = []
    while pos + 11 <= len(data):
        ttype = data[pos]
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        ts = int.from_bytes(data[pos + 4:pos + 7], "big") \
            | (data[pos + 7] << 24)
        end = pos + 11 + size + 4
        if end > len(data):
            break
        tags.append((ttype, ts, data[pos + 11:pos + 11 + size]))
        pos = end
    return tags, data[pos:]


def build_flv_tag(ttype: int, ts: int, payload: bytes) -> bytes:
    tag = bytes([ttype]) + len(payload).to_bytes(3, "big") \
        + (ts & 0xFFFFFF).to_bytes(3, "big") \
        + bytes([(ts >> 24) & 0xFF]) + b"\x00\x00\x00" + payload
    return tag + struct.pack(">I", len(tag))


# ---------------------------------------------------------------------------
# Elements
# ---------------------------------------------------------------------------

@register_element
class Rtmp2Sink(SinkElement):
    """rtmp2sink (gstrtmp2sink.c): publish a video/x-flv stream."""

    FACTORY = "rtmp2sink"
    DESCRIPTION = "Send media as a stream to an RTMP server"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "video/x-flv")]
    PROPERTIES = {
        "location": (str, "", "rtmp://host[:port]/app/stream"),
    }
    HOST_INPUT = True       # takes the source's host bytes

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._client: Optional[_RtmpClient] = None
        self._leftover = b""
        self.sent_tags = 0

    def start(self):
        self._client = _RtmpClient(self.props["location"])
        self._client.connect()
        c = self._client
        c.conn.send_command("publish", 3, None, c.stream,
                            "live", stream_id=c.stream_id, csid=4)
        c._wait_result("publish")
        self._leftover = b""

    def stop(self):
        if self._client:
            self._client.close()
            self._client = None

    def render(self, buf: Buffer) -> str:
        data = buf.data
        if isinstance(data, (tuple, list)):
            raw = b"".join(host_array(p).tobytes() for p in data)
        else:
            raw = host_array(data).tobytes()
        tags, self._leftover = parse_flv_stream(self._leftover + raw)
        c = self._client
        for ttype, ts, payload in tags:
            if ttype not in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
                continue
            csid = {MSG_AUDIO: 6, MSG_VIDEO: 7}.get(ttype, 5)
            c.conn.send_message(csid, ttype, c.stream_id, ts, payload)
            self.sent_tags += 1
        return FlowReturn.OK


@register_element
class Rtmp2Src(SourceElement):
    """rtmp2src (gstrtmp2src.c): play a stream, emit video/x-flv."""

    FACTORY = "rtmp2src"
    DESCRIPTION = "Receive media streamed via RTMP"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "video/x-flv")]
    PROPERTIES = {
        "location": (str, "", "rtmp://host[:port]/app/stream"),
        "timeout": (float, 5.0, "read timeout (s); EOS on expiry"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._client: Optional[_RtmpClient] = None
        self._sent_header = False

    def start(self):
        self._client = _RtmpClient(self.props["location"])
        self._client.connect()
        c = self._client
        c.conn.send_command("play", 3, None, c.stream,
                            stream_id=c.stream_id, csid=4)
        c._wait_result("play")
        c.conn.sock.settimeout(self.props["timeout"])
        self._sent_header = False

    def stop(self):
        if self._client:
            self._client.close()
            self._client = None

    def get_caps(self, filter=None):
        caps = Caps.from_string("video/x-flv")
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def fixate(self, caps: Caps) -> Caps:
        return caps.fixate()

    def create(self, n_frames: int) -> Optional[Buffer]:
        c = self._client
        try:
            mtype, sid, ts, payload = c.conn.read_message()
        except (socket.timeout, ConnectionError, OSError):
            return None
        if mtype == MSG_COMMAND_AMF0:
            vals = amf0_decode_all(payload)
            if vals and vals[0] == "onStatus":
                code = (vals[3] or {}).get("code", "") \
                    if len(vals) > 3 else ""
                if "Stop" in code or "Complete" in code:
                    return None
            return self.create(n_frames)
        if mtype not in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
            return self.create(n_frames)
        out = b"" if self._sent_header else FLV_HEADER
        self._sent_header = True
        out += build_flv_tag(mtype, ts, payload)
        return Buffer(data=np.frombuffer(out, np.uint8), batch=1)


# ---------------------------------------------------------------------------
# Minimal relay server (publish -> players), used by tests
# ---------------------------------------------------------------------------

class RtmpRelayServer:
    """Single-process RTMP relay: accepts connect/createStream, routes
    publish media to all players of the same stream name."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self.port = self._srv.getsockname()[1]
        self._srv.listen(8)
        self._srv.settimeout(0.2)
        self._running = True
        self._players: Dict[str, List[ChunkConnection]] = {}
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        while self._running:
            try:
                sock, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(sock,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, sock: socket.socket):
        sock.settimeout(10.0)
        conn = ChunkConnection(sock)
        try:
            conn.handshake_server()
            role = None
            stream = ""
            while self._running:
                mtype, sid, ts, payload = conn.read_message()
                if mtype == MSG_COMMAND_AMF0:
                    vals = amf0_decode_all(payload)
                    cmd = vals[0]
                    txid = vals[1] if len(vals) > 1 else 0
                    if cmd == "connect":
                        conn.send_message(
                            2, MSG_WINDOW_ACK, 0, 0,
                            struct.pack(">I", 2500000))
                        conn.set_chunk_size(4096)
                        conn.send_command(
                            "_result", txid,
                            {"fmsVer": "GTPU/1.0"},
                            {"level": "status",
                             "code": "NetConnection.Connect.Success"})
                    elif cmd == "createStream":
                        conn.send_command("_result", txid, None, 1.0)
                    elif cmd == "publish":
                        role = "publisher"
                        stream = vals[3]
                        conn.send_command(
                            "onStatus", 0, None,
                            {"level": "status",
                             "code": "NetStream.Publish.Start"},
                            stream_id=1, csid=4)
                    elif cmd == "play":
                        role = "player"
                        stream = vals[3]
                        with self._lock:
                            self._players.setdefault(
                                stream, []).append(conn)
                        conn.send_command(
                            "onStatus", 0, None,
                            {"level": "status",
                             "code": "NetStream.Play.Start"},
                            stream_id=1, csid=4)
                elif mtype in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0) \
                        and role == "publisher":
                    with self._lock:
                        targets = list(self._players.get(stream, []))
                    for p in targets:
                        try:
                            p.send_message(
                                {MSG_AUDIO: 6, MSG_VIDEO: 7}.get(
                                    mtype, 5), mtype, 1, ts, payload)
                        except OSError:
                            with self._lock:
                                if p in self._players.get(stream, []):
                                    self._players[stream].remove(p)
        except (ConnectionError, socket.timeout, OSError,
                ValueError, struct.error):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def close(self):
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass
