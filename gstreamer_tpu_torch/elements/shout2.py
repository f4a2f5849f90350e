"""shout2send — Icecast source client.

Reference: gst-plugins-good/ext/shout2/gstshout2.c wraps libshout;
here the source protocol is spoken directly: HTTP PUT (Icecast 2.4+)
with Basic auth and the ice-* metadata headers, falling back to the
legacy SOURCE method when the server rejects PUT.  The media payload
is the raw muxed stream bytes (Ogg/MP3/WebM), exactly what libshout
sends.

A port of the JAX package's ``elements/shout2.py``: each buffer is taken to
the host wherever it lies."""

from __future__ import annotations

import base64
import socket
from typing import Optional

import numpy as np

from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            register_element)

_CONTENT_TYPES = {
    "application/ogg": "application/ogg",
    "audio/ogg": "application/ogg",
    "audio/mpeg": "audio/mpeg",
    "video/webm": "video/webm",
    "audio/webm": "audio/webm",
}


@register_element
class Shout2Send(SinkElement):
    FACTORY = "shout2send"
    DESCRIPTION = "Sends data to an icecast server"
    PAD_TEMPLATES = [PadTemplate(
        "sink", PadDirection.SINK,
        "application/ogg; audio/ogg; audio/mpeg; video/webm; "
        "audio/webm")]
    PROPERTIES = {
        "ip": (str, "127.0.0.1", "icecast server address"),
        "port": (int, 8000, "icecast server port"),
        "mount": (str, "/stream.ogg", "mount point"),
        "username": (str, "source", "source username"),
        "password": (str, "hackme", "source password"),
        "streamname": (str, "", "ice-name header"),
        "description": (str, "", "ice-description header"),
        "genre": (str, "", "ice-genre header"),
        "public": (bool, False, "ice-public header"),
        "protocol": (str, "put", "put | source (legacy)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._sock: Optional[socket.socket] = None
        self._content_type = "application/ogg"
        self.bytes_sent = 0

    def set_info(self, incaps, outcaps):
        name = incaps[0].name
        self._content_type = _CONTENT_TYPES.get(name,
                                                "application/ogg")

    def start(self):
        mount = self.props["mount"]
        if not mount.startswith("/"):
            mount = "/" + mount
        auth = base64.b64encode(
            f"{self.props['username']}:{self.props['password']}"
            .encode()).decode()
        method = ("PUT" if self.props["protocol"] == "put"
                  else "SOURCE")
        headers = [
            f"{method} {mount} HTTP/1.1",
            f"Host: {self.props['ip']}:{self.props['port']}",
            f"Authorization: Basic {auth}",
            "User-Agent: gstreamer-tpu/1.0",
            f"Content-Type: {self._content_type}",
            "ice-public: " + ("1" if self.props["public"] else "0"),
        ]
        for prop, hdr in (("streamname", "ice-name"),
                          ("description", "ice-description"),
                          ("genre", "ice-genre")):
            if self.props[prop]:
                headers.append(f"{hdr}: {self.props[prop]}")
        if method == "PUT":
            headers.append("Expect: 100-continue")
        self._sock = socket.create_connection(
            (self.props["ip"], self.props["port"]), timeout=10.0)
        self._sock.sendall(("\r\n".join(headers)
                            + "\r\n\r\n").encode())
        self._sock.settimeout(10.0)
        resp = b""
        while b"\r\n\r\n" not in resp:
            part = self._sock.recv(4096)
            if not part:
                raise ConnectionError("shout2send: server closed")
            resp += part
        status = resp.split(b"\r\n", 1)[0].decode("ascii", "replace")
        code = int(status.split()[1])
        if code == 401:
            raise ConnectionError("shout2send: authentication failed")
        if code not in (100, 200):
            raise ConnectionError(f"shout2send: server said {status}")
        self.bytes_sent = 0

    def stop(self):
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def render(self, buf: Buffer) -> str:
        data = buf.data
        if isinstance(data, (tuple, list)):
            raw = b"".join(host_array(p).tobytes() for p in data)
        else:
            raw = host_array(data).tobytes()
        try:
            self._sock.sendall(raw)
        except OSError:
            return FlowReturn.ERROR
        self.bytes_sent += len(raw)
        return FlowReturn.OK
