"""SRT (Secure Reliable Transport) elements over system libsrt.

Equivalents of the reference SRT elements (reference:
subprojects/gst-plugins-bad/ext/srt/gstsrtsink.c, gstsrtsrc.c,
gstsrtobject.c).  Like the reference — whose elements wrap libsrt —
these bind the system library (ctypes, the same wrapper pattern as
codecs/opus.py); SRT's ARQ/crypto state machine lives in libsrt, the
elements own connection lifecycle, caller/listener/rendezvous modes,
live-mode chunking and the property surface (gstsrtobject.c
gst_srt_object_set_common_params).

srtsink — sends buffer bytes (or packetized RTP lists) as <=1316-byte
live-mode payloads; caller connects out, listener accepts many peers
(multi-client fan-out like tcpserversink).
srtsrc — receives payloads one-buffer-per-message; listener accepts
one caller, caller pulls from its own socket.

A copy of the JAX package's ``net/srt.py``, over the same system libsrt
(the loader tries the same sonames).  Where the library is missing both
packages raise the same ``RuntimeError`` at ``start``.  The sink copies
each tick's bytes to the host (``host_array``).  The port pairs its
``srt_startup`` with an ``srt_cleanup`` at exit: the JAX package never
cleans up, and a process where two callers started libsrt without
cleaning up (both packages, as their tests run) crashes at exit.
"""

from __future__ import annotations

import atexit
import ctypes
import ctypes.util
import socket as _socket
import struct
import threading
import time
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)

# -- libsrt ABI (srt/srt.h) ---------------------------------------------------

SRT_ERROR = -1
SRT_INVALID_SOCK = -1
# SRT_SOCKOPT enum values (stable ABI, srt.h)
SRTO_SNDSYN = 1
SRTO_RCVSYN = 2
SRTO_SNDTIMEO = 13
SRTO_RCVTIMEO = 14
SRTO_REUSEADDR = 15
SRTO_TSBPDMODE = 22
SRTO_LATENCY = 23
SRTO_PASSPHRASE = 26
SRTO_PBKEYLEN = 27
SRTO_CONNTIMEO = 36
SRTO_RCVLATENCY = 43
SRTO_PEERLATENCY = 44
SRTO_STREAMID = 46
SRTO_MESSAGEAPI = 48
SRTO_PAYLOADSIZE = 49
SRTO_TRANSTYPE = 50
SRTT_LIVE = 0

LIVE_PAYLOAD = 1316          # 7 x 188 TS packets; live-mode send cap

_lib = None
_startup_done = False
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    names = [ctypes.util.find_library("srt"), "libsrt.so.1.5",
             "libsrt-gnutls.so.1.5", "libsrt-openssl.so.1.5",
             "libsrt.so"]
    for n in names:
        if not n:
            continue
        try:
            _lib = ctypes.CDLL(n)
            break
        except OSError:
            continue
    if _lib is None:
        return None
    L = _lib
    L.srt_create_socket.restype = ctypes.c_int
    L.srt_getlasterror_str.restype = ctypes.c_char_p
    L.srt_bind.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    L.srt_connect.argtypes = [ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_int]
    L.srt_accept.argtypes = [ctypes.c_int, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_int)]
    L.srt_send.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    L.srt_recvmsg.argtypes = [ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_int]
    L.srt_setsockflag.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int]
    L.srt_getlasterror.argtypes = [ctypes.c_void_p]
    L.srt_getlasterror.restype = ctypes.c_int
    return _lib


def available() -> bool:
    return _load() is not None


def _startup():
    global _startup_done
    with _lock:
        if not _startup_done:
            _load().srt_startup()
            atexit.register(_load().srt_cleanup)
            _startup_done = True


def _err() -> str:
    return _load().srt_getlasterror_str().decode("utf-8", "replace")


def _sockaddr_in(host: str, port: int) -> bytes:
    """struct sockaddr_in for AF_INET (what srt_bind/connect expect)."""
    return struct.pack("<H", _socket.AF_INET) \
        + struct.pack("!H", port) \
        + _socket.inet_aton(_socket.gethostbyname(host)) \
        + b"\x00" * 8


def _set_int(sock: int, opt: int, val: int):
    v = ctypes.c_int(val)
    _load().srt_setsockflag(sock, opt, ctypes.byref(v),
                            ctypes.sizeof(v))


def _set_int64(sock: int, opt: int, val: int):
    v = ctypes.c_int64(val)
    _load().srt_setsockflag(sock, opt, ctypes.byref(v),
                            ctypes.sizeof(v))


def _set_bool(sock: int, opt: int, val: bool):
    v = ctypes.c_int32(1 if val else 0)
    _load().srt_setsockflag(sock, opt, ctypes.byref(v),
                            ctypes.sizeof(v))


def _set_str(sock: int, opt: int, val: str):
    b = val.encode()
    _load().srt_setsockflag(sock, opt, b, len(b))


class _SrtCommon:
    """Shared URI/option handling (gstsrtobject.c analog)."""

    PROPERTIES = {
        "uri": (str, "", "srt://host:port?key=val URI (overrides "
                "address/port/mode)"),
        "address": (str, "127.0.0.1", "remote (caller) or bind "
                    "(listener) address"),
        "port": (int, 7001, "SRT UDP port"),
        "mode": (str, "", "caller|listener (default: sink=caller, "
                 "src=listener)"),
        "latency": (int, 125, "TSBPD latency (ms)"),
        "passphrase": (str, "", "encryption passphrase (10..79 chars)"),
        "pbkeylen": (int, 16, "crypto key length: 16/24/32"),
        "streamid": (str, "", "SRT stream id"),
        "timeout": (float, 5.0, "recv idle timeout (s); EOS on expiry"),
    }

    def _conn_params(self, default_mode: str) -> Tuple[str, int, str]:
        host = self.props["address"]
        port = self.props["port"]
        mode = self.props["mode"] or default_mode
        uri = self.props["uri"]
        if uri:
            u = urlparse(uri)
            if u.hostname:
                host = u.hostname
            if u.port:
                port = u.port
            q = parse_qs(u.query)
            if "mode" in q:
                mode = q["mode"][0]
            if "latency" in q:
                self.props["latency"] = int(q["latency"][0])
            if "passphrase" in q:
                self.props["passphrase"] = q["passphrase"][0]
            if "streamid" in q:
                self.props["streamid"] = q["streamid"][0]
            if not u.hostname and mode == "":
                mode = "listener"
        return host, port, mode

    def _new_socket(self) -> int:
        _startup()
        lib = _load()
        sock = lib.srt_create_socket()
        if sock == SRT_INVALID_SOCK:
            raise RuntimeError(f"srt_create_socket: {_err()}")
        _set_int(sock, SRTO_TRANSTYPE, SRTT_LIVE)
        _set_int(sock, SRTO_LATENCY, self.props["latency"])
        _set_int(sock, SRTO_PAYLOADSIZE, LIVE_PAYLOAD)
        if self.props["passphrase"]:
            _set_int(sock, SRTO_PBKEYLEN, self.props["pbkeylen"])
            _set_str(sock, SRTO_PASSPHRASE, self.props["passphrase"])
        if self.props["streamid"]:
            _set_str(sock, SRTO_STREAMID, self.props["streamid"])
        _set_bool(sock, SRTO_REUSEADDR, True)
        return sock

    def _bind_listen(self, sock: int, host: str, port: int):
        lib = _load()
        sa = _sockaddr_in(host, port)
        if lib.srt_bind(sock, sa, len(sa)) == SRT_ERROR:
            raise RuntimeError(f"srt_bind {host}:{port}: {_err()}")
        if lib.srt_listen(sock, 4) == SRT_ERROR:
            raise RuntimeError(f"srt_listen: {_err()}")

    def _connect(self, sock: int, host: str, port: int,
                 retries: int = 20) -> int:
        """Connect, retrying with a FRESH socket per attempt — an SRT
        socket is single-shot: after a rejected/failed handshake it is
        broken and must not be srt_connect'ed again.  Returns the
        connected socket (which may differ from `sock`)."""
        lib = _load()
        sa = _sockaddr_in(host, port)
        for k in range(retries):
            _set_int(sock, SRTO_CONNTIMEO, 1000)
            if lib.srt_connect(sock, sa, len(sa)) != SRT_ERROR:
                return sock
            err = _err()
            lib.srt_close(sock)
            if k == retries - 1 or "rejected" in err:
                raise RuntimeError(
                    f"srt_connect {host}:{port}: {err}")
            time.sleep(0.1)
            sock = self._new_socket()
        raise RuntimeError(f"srt_connect {host}:{port}: {_err()}")


@register_element
class SRTSink(_SrtCommon, SinkElement):
    """srtsink (gstsrtsink.c): send the stream over SRT.

    Caller mode connects to address:port; listener mode accepts any
    number of callers and fans the stream out to all of them."""

    FACTORY = "srtsink"
    DESCRIPTION = "Send data over the network via SRT"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {**_SrtCommon.PROPERTIES}
    HOST_INPUT = True       # takes the source's host bytes

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._sock: Optional[int] = None
        self._peers: List[int] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._running = False
        self._mode = "caller"
        self._last_send = 0.0

    def start(self):
        if not available():
            raise RuntimeError("srtsink: system libsrt not found")
        host, port, mode = self._conn_params("caller")
        self._mode = mode
        self._sock = self._new_socket()
        if mode == "listener":
            self._bind_listen(self._sock, host, port)
            _set_bool(self._sock, SRTO_RCVSYN, False)  # poll accept
            self._running = True
            self._accept_thread = threading.Thread(
                target=self._accept_loop, daemon=True)
            self._accept_thread.start()
        else:
            self._sock = self._connect(self._sock, host, port)

    def _accept_loop(self):
        lib = _load()
        buf = ctypes.create_string_buffer(128)
        ln = ctypes.c_int(128)
        while self._running:
            peer = lib.srt_accept(self._sock, buf, ctypes.byref(ln))
            if peer == SRT_INVALID_SOCK:
                time.sleep(0.02)
                continue
            self._peers.append(peer)

    def stop(self):
        # linger past the TSBPD latency window so in-flight live-mode
        # packets are released to the peer app before close (closing
        # earlier marks the connection broken and drops them — the
        # reference srtsink equally flushes on EOS)
        if self._last_send:
            grace = self.props["latency"] / 1000.0 + 0.15
            wait = self._last_send + grace - time.monotonic()
            if wait > 0:
                time.sleep(wait)
        self._running = False
        if self._accept_thread:
            self._accept_thread.join(1.0)
            self._accept_thread = None
        lib = _load()
        for p in self._peers:
            lib.srt_close(p)
        self._peers.clear()
        if self._sock is not None:
            lib.srt_close(self._sock)
            self._sock = None

    def _targets(self) -> List[int]:
        if self._mode == "listener":
            return list(self._peers)
        return [self._sock] if self._sock is not None else []

    def render(self, buf: Buffer) -> str:
        data = buf.data
        if isinstance(data, list) and data and isinstance(
                data[0], (bytes, bytearray)):
            chunks = [bytes(p) for p in data]
        else:
            if isinstance(data, (tuple, list)):
                payload = b"".join(host_array(p).tobytes() for p in data)
            else:
                payload = host_array(data).tobytes()
            chunks = [payload[o:o + LIVE_PAYLOAD]
                      for o in range(0, len(payload), LIVE_PAYLOAD)]
        lib = _load()
        self._last_send = time.monotonic()
        dead = []
        for t in self._targets():
            for c in chunks:
                if lib.srt_send(t, c, len(c)) == SRT_ERROR:
                    dead.append(t)
                    break
        for t in dead:
            lib.srt_close(t)
            if t in self._peers:
                self._peers.remove(t)
            if t == self._sock:
                return FlowReturn.ERROR
        return FlowReturn.OK


@register_element
class SRTSrc(_SrtCommon, SourceElement):
    """srtsrc (gstsrtsrc.c): receive an SRT stream; one live-mode
    message per pulled buffer (the udpsrc datagram convention)."""

    FACTORY = "srtsrc"
    DESCRIPTION = "Receive data over the network via SRT"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {**_SrtCommon.PROPERTIES,
                  "caps": (object, None, "caps of the byte stream")}

    def __init__(self, name=None, **props):
        if "caps" in props and isinstance(props["caps"], str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)
        self._sock: Optional[int] = None
        self._conn: Optional[int] = None
        self._mode = "listener"
        self.bound_port: Optional[int] = None

    def start(self):
        if not available():
            raise RuntimeError("srtsrc: system libsrt not found")
        host, port, mode = self._conn_params("listener")
        self._mode = mode
        self._sock = self._new_socket()
        if mode == "listener":
            self._bind_listen(self._sock, host, port)
            self.bound_port = port
        else:
            self._sock = self._connect(self._sock, host, port)
            self._conn = self._sock
            _set_int(self._conn, SRTO_RCVTIMEO, 200)

    def stop(self):
        lib = _load()
        if self._conn is not None and self._conn != self._sock:
            lib.srt_close(self._conn)
        if self._sock is not None:
            lib.srt_close(self._sock)
        self._sock = self._conn = None

    def get_caps(self, filter=None):
        caps = self.props["caps"] or Caps.any()
        if filter is not None:
            caps = caps.intersect(filter) if not caps.is_any else filter
        return caps

    def fixate(self, caps: Caps) -> Caps:
        if caps.is_any:
            caps = Caps.from_string("application/octet-stream")
        return caps.fixate()

    def _accept_one(self) -> bool:
        lib = _load()
        buf = ctypes.create_string_buffer(128)
        ln = ctypes.c_int(128)
        _set_bool(self._sock, SRTO_RCVSYN, False)
        deadline = time.monotonic() + self.props["timeout"]
        while time.monotonic() < deadline:
            peer = lib.srt_accept(self._sock, buf, ctypes.byref(ln))
            if peer != SRT_INVALID_SOCK:
                self._conn = peer
                # accepted sockets inherit the listener's async RCVSYN
                _set_bool(peer, SRTO_RCVSYN, True)
                # short recv slices; create()'s deadline governs EOS
                _set_int(peer, SRTO_RCVTIMEO, 200)
                return True
            time.sleep(0.02)
        return False

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._conn is None and not self._accept_one():
            return None
        lib = _load()
        rbuf = ctypes.create_string_buffer(65536)
        deadline = time.monotonic() + self.props["timeout"]
        while True:
            n = lib.srt_recvmsg(self._conn, rbuf, 65536)
            if n > 0:
                return Buffer(
                    data=np.frombuffer(rbuf.raw[:n], np.uint8),
                    batch=1)
            # connection-class errors (2xxx: lost/none) end the
            # stream; timeouts/spurious wakeups retry in the budget
            code = lib.srt_getlasterror(None)
            if 2000 <= code < 3000 or time.monotonic() >= deadline:
                return None                  # closed/idle -> EOS
            time.sleep(0.005)
