"""TCP/UDP transport elements.

Equivalents of the reference's socket elements
(subprojects/gst-plugins-base/gst/tcp/ — gsttcpserversink.c,
gsttcpclientsrc.c, gsttcpserversrc.c, gsttcpclientsink.c;
gst-plugins-good/gst/udp/ — gstudpsink.c, gstudpsrc.c).

Like the reference, these move the raw BYTE stream: buffers are
flattened to bytes on send and arrive as byte buffers that a parser
(rawvideoparse/rawaudioparse/BaseParse subclass) re-frames downstream.
These elements cover host-side ingest/egress over IP.

A copy of the JAX package's ``net/transport.py``. The sinks copy each tick
to the host (``host_array``); the sources give host bytes that the pipeline
stages on its device unless their peers take host bytes.
"""

from __future__ import annotations

import socket
import threading
from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)


def _buffer_bytes(buf: Buffer) -> bytes:
    data = buf.data
    if isinstance(data, (tuple, list)):
        return b"".join(host_array(p).tobytes() for p in data)
    return host_array(data).tobytes()


@register_element
class TCPServerSink(SinkElement):
    """tcpserversink: listen and stream buffer bytes to every connected
    client (gsttcpserversink.c + multisocketsink semantics)."""
    FACTORY = "tcpserversink"
    DESCRIPTION = "Send data as a server over the network via TCP"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "host": (str, "127.0.0.1", "bind address"),
        "port": (int, 4953, "port (0 = ephemeral)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._srv: Optional[socket.socket] = None
        self._clients: List[socket.socket] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._running = False
        self.bound_port: Optional[int] = None

    def start(self):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.props["host"], self.props["port"]))
        self.bound_port = self._srv.getsockname()[1]
        self._srv.listen(8)
        self._srv.settimeout(0.1)
        self._running = True

        def accept_loop():
            while self._running:
                try:
                    c, _ = self._srv.accept()
                    self._clients.append(c)
                except socket.timeout:
                    continue
                except OSError:
                    return

        self._accept_thread = threading.Thread(target=accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def stop(self):
        self._running = False
        if self._accept_thread:
            self._accept_thread.join(1.0)
        for c in self._clients:
            try:
                c.close()
            except OSError:
                pass
        self._clients.clear()
        if self._srv:
            self._srv.close()
            self._srv = None

    def render(self, buf: Buffer) -> str:
        payload = _buffer_bytes(buf)
        dead = []
        for c in self._clients:
            try:
                c.sendall(payload)
            except OSError:
                dead.append(c)
        for c in dead:
            self._clients.remove(c)
        return FlowReturn.OK


@register_element
class TCPClientSink(SinkElement):
    """tcpclientsink: connect and stream buffer bytes."""
    FACTORY = "tcpclientsink"
    DESCRIPTION = "Send data as a client over the network via TCP"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "host": (str, "127.0.0.1", ""),
        "port": (int, 4953, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._sock: Optional[socket.socket] = None

    def start(self):
        self._sock = socket.create_connection(
            (self.props["host"], self.props["port"]), timeout=5.0)

    def stop(self):
        if self._sock:
            self._sock.close()
            self._sock = None

    def render(self, buf: Buffer) -> str:
        try:
            self._sock.sendall(_buffer_bytes(buf))
            return FlowReturn.OK
        except OSError:
            return FlowReturn.ERROR


class _SocketSrcBase(SourceElement):
    PROPERTIES = {
        "host": (str, "127.0.0.1", ""),
        "port": (int, 4953, ""),
        "blocksize": (int, 65536, "bytes per pulled buffer"),
        "caps": (object, None, "caps of the byte stream"),
        "timeout": (float, 5.0, "read timeout (s); EOS on expiry"),
    }

    def __init__(self, name=None, **props):
        if "caps" in props and isinstance(props["caps"], str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)

    def get_caps(self, filter=None):
        caps = self.props["caps"] or Caps.any()
        if filter is not None:
            caps = caps.intersect(filter) if not caps.is_any else filter
        return caps

    def fixate(self, caps: Caps) -> Caps:
        if caps.is_any:
            caps = Caps.from_string("application/octet-stream")
        return caps.fixate()

    def _recv(self) -> Optional[bytes]:
        raise NotImplementedError

    def create(self, n_frames: int) -> Optional[Buffer]:
        data = self._recv()
        if not data:
            return None
        return Buffer(data=np.frombuffer(data, np.uint8), batch=1)


@register_element
class TCPClientSrc(_SocketSrcBase):
    """tcpclientsrc: connect and pull the byte stream."""
    FACTORY = "tcpclientsrc"
    DESCRIPTION = "Receive data as a client over the network via TCP"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]

    def start(self):
        self._sock = socket.create_connection(
            (self.props["host"], self.props["port"]), timeout=5.0)
        self._sock.settimeout(self.props["timeout"])

    def stop(self):
        if getattr(self, "_sock", None):
            self._sock.close()
            self._sock = None

    def _recv(self):
        try:
            return self._sock.recv(self.props["blocksize"])
        except socket.timeout:
            return None


@register_element
class TCPServerSrc(_SocketSrcBase):
    """tcpserversrc: listen, accept ONE client, pull its byte stream."""
    FACTORY = "tcpserversrc"
    DESCRIPTION = "Receive data as a server over the network via TCP"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]

    def start(self):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.props["host"], self.props["port"]))
        self.bound_port = self._srv.getsockname()[1]
        self._srv.listen(1)
        self._srv.settimeout(self.props["timeout"])
        self._conn = None

    def stop(self):
        for s in (getattr(self, "_conn", None), getattr(self, "_srv", None)):
            if s:
                s.close()
        self._conn = self._srv = None

    def _recv(self):
        if self._conn is None:
            try:
                self._conn, _ = self._srv.accept()
                self._conn.settimeout(self.props["timeout"])
            except socket.timeout:
                return None
        try:
            return self._conn.recv(self.props["blocksize"])
        except socket.timeout:
            return None


@register_element
class UDPSink(SinkElement):
    """udpsink: buffer bytes as datagrams, chunked to the MTU."""
    FACTORY = "udpsink"
    DESCRIPTION = "Send data over the network via UDP"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "host": (str, "127.0.0.1", ""),
        "port": (int, 4951, ""),
        "mtu": (int, 1400, "max datagram payload"),
    }

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def stop(self):
        if getattr(self, "_sock", None):
            self._sock.close()
            self._sock = None

    def render(self, buf: Buffer) -> str:
        addr = (self.props["host"], self.props["port"])
        data = buf.data
        if isinstance(data, list) and data and isinstance(
                data[0], (bytes, bytearray)):
            # packetized payload (RTP): one datagram per packet,
            # boundaries preserved
            for pkt in data:
                self._sock.sendto(pkt, addr)
            return FlowReturn.OK
        payload = _buffer_bytes(buf)
        mtu = self.props["mtu"]
        for off in range(0, len(payload), mtu):
            self._sock.sendto(payload[off:off + mtu], addr)
        return FlowReturn.OK


@register_element
class UDPSrc(_SocketSrcBase):
    """udpsrc: one datagram per pulled buffer."""
    FACTORY = "udpsrc"
    DESCRIPTION = "Receive data over the network via UDP"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.props["host"], self.props["port"]))
        self.bound_port = self._sock.getsockname()[1]
        self._sock.settimeout(self.props["timeout"])

    def stop(self):
        if getattr(self, "_sock", None):
            self._sock.close()
            self._sock = None

    def _recv(self):
        try:
            data, _ = self._sock.recvfrom(65536)
            return data
        except socket.timeout:
            return None
