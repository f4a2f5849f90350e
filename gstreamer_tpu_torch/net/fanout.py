"""Fan-out network sinks + socket source.

Clean-room analogs of:
* multiudpsink (gst-plugins-good/gst/udp/gstmultiudpsink.c): one
  datagram stream duplicated to N host:port clients, with add/remove
  at runtime (`clients` property, `add`/`remove` API).
* dynudpsink (gstdynudpsink.c): destination chosen per buffer from
  buffer meta (falls back to properties).
* multisocketsink / multifdsink
  (gst-plugins-base/gst/tcp/gstmultisocketsink.c, gstmultifdsink.c):
  byte stream duplicated to every added socket/fd; slow or dead
  clients are dropped, mirroring the reference's recover policy
  "remove the client" reduction.
* socketsrc (gst-plugins-base/gst/tcp/gstsocketsrc.c): reads from an
  application-provided connected socket object.

A copy of the JAX package's ``net/fanout.py``, over the port's
``net/transport.py``.  The sinks copy each tick's bytes to the host
(``_buffer_bytes``), as udpsink does.
"""

from __future__ import annotations

import socket
from typing import Dict, List, Tuple


from ..core.buffer import Buffer, FlowReturn
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            register_element)
from .transport import _SocketSrcBase, _buffer_bytes


def _packets(buf: Buffer) -> List[bytes]:
    data = buf.data
    if isinstance(data, list) and data and isinstance(
            data[0], (bytes, bytearray)):
        return [bytes(p) for p in data]
    return [_buffer_bytes(buf)]


@register_element
class MultiUdpSink(SinkElement):
    """multiudpsink (gstmultiudpsink.c): duplicate each datagram to
    every client in `clients` ("host:port,host:port")."""
    FACTORY = "multiudpsink"
    DESCRIPTION = "Send data over the network via UDP to multiple " \
                  "recipients"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "clients": (str, "", "comma-separated host:port list"),
        "mtu": (int, 1400, "max datagram payload"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._clients: List[Tuple[str, int]] = []
        # stats per client, like the reference's "add" signal counters
        self.bytes_sent: Dict[Tuple[str, int], int] = {}

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._clients = []
        for spec in (self.props["clients"] or "").split(","):
            spec = spec.strip()
            if spec:
                host, port = spec.rsplit(":", 1)
                self._clients.append((host, int(port)))
        self.bytes_sent = {c: 0 for c in self._clients}

    def stop(self):
        if getattr(self, "_sock", None):
            self._sock.close()
            self._sock = None

    def add(self, host: str, port: int) -> None:
        c = (host, int(port))
        if c not in self._clients:
            self._clients.append(c)
            self.bytes_sent.setdefault(c, 0)

    def remove(self, host: str, port: int) -> None:
        c = (host, int(port))
        if c in self._clients:
            self._clients.remove(c)

    def render(self, buf: Buffer) -> str:
        mtu = self.props["mtu"]
        for payload in _packets(buf):
            chunks = ([payload] if len(payload) <= mtu else
                      [payload[o:o + mtu]
                       for o in range(0, len(payload), mtu)])
            for chunk in chunks:
                for c in list(self._clients):
                    try:
                        self._sock.sendto(chunk, c)
                        self.bytes_sent[c] = \
                            self.bytes_sent.get(c, 0) + len(chunk)
                    except OSError:
                        self.remove(*c)
        return FlowReturn.OK


@register_element
class DynUdpSink(SinkElement):
    """dynudpsink (gstdynudpsink.c): per-buffer destination from
    buffer meta ("host"/"port"), falling back to the properties."""
    FACTORY = "dynudpsink"
    DESCRIPTION = "Send data over the network via UDP with packet " \
                  "destinations picked up dynamically"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "host": (str, "127.0.0.1", "fallback destination host"),
        "port": (int, 4951, "fallback destination port"),
    }

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def stop(self):
        if getattr(self, "_sock", None):
            self._sock.close()
            self._sock = None

    def render(self, buf: Buffer) -> str:
        meta = buf.meta or {}
        addr = (meta.get("host", self.props["host"]),
                int(meta.get("port", self.props["port"])))
        try:
            for payload in _packets(buf):
                self._sock.sendto(payload, addr)
            return FlowReturn.OK
        except OSError:
            return FlowReturn.ERROR


class _MultiStreamSinkBase(SinkElement):
    """Shared multisocketsink/multifdsink body: duplicate the byte
    stream to every registered client, dropping dead ones."""
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._clients: List = []
        self.bytes_served = 0

    def start(self):
        pass

    def stop(self):
        self._clients = []

    def _send(self, client, data: bytes) -> bool:
        raise NotImplementedError

    def render(self, buf: Buffer) -> str:
        data = b"".join(_packets(buf))
        self.bytes_served += len(data)
        for client in list(self._clients):
            if not self._send(client, data):
                self._clients.remove(client)     # recover policy: drop
        return FlowReturn.OK


@register_element
class MultiSocketSink(_MultiStreamSinkBase):
    """multisocketsink (gstmultisocketsink.c): add() takes connected
    socket objects."""
    FACTORY = "multisocketsink"
    DESCRIPTION = "Send data to multiple sockets"

    def add(self, sock) -> None:
        self._clients.append(sock)

    def remove(self, sock) -> None:
        if sock in self._clients:
            self._clients.remove(sock)

    def _send(self, client, data: bytes) -> bool:
        try:
            client.sendall(data)
            return True
        except OSError:
            return False


@register_element
class MultiFdSink(_MultiStreamSinkBase):
    """multifdsink (gstmultifdsink.c): add() takes raw file
    descriptors."""
    FACTORY = "multifdsink"
    DESCRIPTION = "Send data to multiple file descriptors"

    def add(self, fd: int) -> None:
        self._clients.append(int(fd))

    def remove(self, fd: int) -> None:
        if int(fd) in self._clients:
            self._clients.remove(int(fd))

    def _send(self, client, data: bytes) -> bool:
        import os
        try:
            off = 0
            while off < len(data):
                off += os.write(client, data[off:])
            return True
        except OSError:
            return False


@register_element
class SocketSrc(_SocketSrcBase):
    """socketsrc (gstsocketsrc.c): pulls from an application-provided
    connected socket (`socket` property); unlike tcpclientsrc it never
    connects by itself."""
    FACTORY = "socketsrc"
    DESCRIPTION = "Receive data from a socket"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = dict(_SocketSrcBase.PROPERTIES)
    PROPERTIES["socket"] = (object, None, "connected socket object")

    def start(self):
        self._sock = self.props["socket"]
        if self._sock is None:
            raise RuntimeError("socketsrc: no socket given")
        self._sock.settimeout(self.props["timeout"])

    def stop(self):
        self._sock = None                        # caller owns the socket

    def _recv(self):
        try:
            return self._sock.recv(self.props["blocksize"])
        except socket.timeout:
            return None
