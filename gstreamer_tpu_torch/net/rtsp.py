"""RTSP protocol library — GstRTSPMessage / gstrtspdefs /
GstRTSPTransport / GstRTSPUrl equivalents.

Reference: subprojects/gst-plugins-base/gst-libs/gst/rtsp/
(gstrtspmessage.c message model, gstrtspdefs.c status/method tables,
gstrtsptransport.c transport-header parse/serialize :260-560,
gstrtspurl.c rtsp:// URL splitting).  Reduced to the RTSP/1.0 surface
the server and source element use: request/response framing with
case-insensitive headers, Content-Length bodies, and the RTP/AVP
unicast UDP transport.

A copy of the JAX package's ``net/rtsp.py``. Host code only: nothing in it
touches a device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

RTSP_VERSION = "RTSP/1.0"

STATUS_CODES = {
    100: "Continue", 200: "OK", 201: "Created",
    300: "Multiple Choices", 301: "Moved Permanently", 302: "Move Temporarily",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 406: "Not Acceptable",
    415: "Unsupported Media Type", 451: "Parameter Not Understood",
    453: "Not Enough Bandwidth", 454: "Session Not Found",
    455: "Method Not Valid in This State", 456: "Header Field Not Valid",
    457: "Invalid Range", 459: "Aggregate Operation Not Allowed",
    461: "Unsupported Transport", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
    505: "RTSP Version Not Supported", 551: "Option Not Supported",
}

METHODS = ("OPTIONS", "DESCRIBE", "ANNOUNCE", "SETUP", "PLAY", "PAUSE",
           "TEARDOWN", "GET_PARAMETER", "SET_PARAMETER", "REDIRECT",
           "RECORD")


class Headers:
    """Case-insensitive ordered header map (gstrtspmessage.c field list)."""

    def __init__(self):
        self._items: List[Tuple[str, str]] = []

    def add(self, key: str, value: str) -> None:
        self._items.append((key, str(value)))

    def set(self, key: str, value: str) -> None:
        self.remove(key)
        self.add(key, value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        kl = key.lower()
        for k, v in self._items:
            if k.lower() == kl:
                return v
        return default

    def remove(self, key: str) -> None:
        kl = key.lower()
        self._items = [(k, v) for k, v in self._items if k.lower() != kl]

    def items(self):
        return list(self._items)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None


@dataclass
class RTSPMessage:
    """A parsed request or response (gstrtspmessage.h GstRTSPMsgType)."""
    kind: str = "request"              # "request" | "response"
    method: str = ""
    uri: str = ""
    status: int = 200
    reason: str = "OK"
    version: str = RTSP_VERSION
    headers: Headers = field(default_factory=Headers)
    body: bytes = b""

    # -- constructors (gst_rtsp_message_new_request/_response) -------------
    @classmethod
    def request(cls, method: str, uri: str) -> "RTSPMessage":
        return cls(kind="request", method=method, uri=uri)

    @classmethod
    def response(cls, status: int, request: Optional["RTSPMessage"] = None
                 ) -> "RTSPMessage":
        m = cls(kind="response", status=status,
                reason=STATUS_CODES.get(status, "Unknown"))
        if request is not None:
            cseq = request.headers.get("CSeq")
            if cseq is not None:
                m.headers.set("CSeq", cseq)
            session = request.headers.get("Session")
            if session is not None:
                m.headers.set("Session", session)
        return m

    def serialize(self) -> bytes:
        if self.kind == "request":
            start = f"{self.method} {self.uri} {self.version}"
        else:
            start = f"{self.version} {self.status} {self.reason}"
        lines = [start]
        headers = Headers()
        headers._items = self.headers.items()
        if self.body and "Content-Length" not in headers:
            headers.add("Content-Length", str(len(self.body)))
        for k, v in headers.items():
            lines.append(f"{k}: {v}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode() + self.body


def parse_message(data: bytes) -> Tuple[Optional[RTSPMessage], int]:
    """Parse one message from `data`; returns (message, bytes_consumed)
    or (None, 0) when the buffer does not yet hold a complete message."""
    head_end = data.find(b"\r\n\r\n")
    if head_end < 0:
        return None, 0
    head = data[:head_end].decode("latin-1")
    lines = head.split("\r\n")
    start = lines[0].split(" ", 2)
    msg = RTSPMessage()
    if start[0].startswith("RTSP/"):
        msg.kind = "response"
        msg.version = start[0]
        msg.status = int(start[1])
        msg.reason = start[2] if len(start) > 2 else ""
    else:
        msg.kind = "request"
        msg.method = start[0]
        msg.uri = start[1] if len(start) > 1 else ""
        msg.version = start[2] if len(start) > 2 else RTSP_VERSION
    for line in lines[1:]:
        k, _, v = line.partition(":")
        if k:
            msg.headers.add(k.strip(), v.strip())
    clen = int(msg.headers.get("Content-Length", "0") or "0")
    total = head_end + 4 + clen
    if len(data) < total:
        return None, 0
    msg.body = data[head_end + 4:total]
    return msg, total


@dataclass
class RTSPTransport:
    """Transport header (gstrtsptransport.c): RTP/AVP unicast/UDP."""
    protocol: str = "RTP/AVP"
    unicast: bool = True
    client_port: Tuple[int, int] = (0, 0)
    server_port: Tuple[int, int] = (0, 0)
    ssrc: Optional[int] = None
    destination: Optional[str] = None
    interleaved: Optional[Tuple[int, int]] = None
    ttl: Optional[int] = None
    mode: Optional[str] = None           # PLAY / RECORD (RFC 2326 12.39)
    port: Tuple[int, int] = (0, 0)       # multicast port pair

    @classmethod
    def parse(cls, text: str) -> "RTSPTransport":
        t = cls()
        parts = text.split(";")
        t.protocol = parts[0].strip()
        for p in parts[1:]:
            p = p.strip()
            if p == "unicast":
                t.unicast = True
            elif p == "multicast":
                t.unicast = False
            elif p.startswith("client_port="):
                a, _, b = p[12:].partition("-")
                t.client_port = (int(a), int(b or int(a) + 1))
            elif p.startswith("server_port="):
                a, _, b = p[12:].partition("-")
                t.server_port = (int(a), int(b or int(a) + 1))
            elif p.startswith("ssrc="):
                t.ssrc = int(p[5:], 16)
            elif p.startswith("destination="):
                t.destination = p[12:]
            elif p.startswith("interleaved="):
                a, _, b = p[12:].partition("-")
                t.interleaved = (int(a), int(b or int(a) + 1))
            elif p.startswith("ttl="):
                t.ttl = int(p[4:])
            elif p.startswith("mode="):
                t.mode = p[5:].strip('"').upper()
            elif p.startswith("port="):
                a, _, b = p[5:].partition("-")
                t.port = (int(a), int(b or int(a) + 1))
        return t

    def to_string(self) -> str:
        out = [self.protocol, "unicast" if self.unicast else "multicast"]
        if self.destination:
            out.append(f"destination={self.destination}")
        if self.client_port != (0, 0):
            out.append(f"client_port={self.client_port[0]}-"
                       f"{self.client_port[1]}")
        if self.server_port != (0, 0):
            out.append(f"server_port={self.server_port[0]}-"
                       f"{self.server_port[1]}")
        if self.port != (0, 0):
            out.append(f"port={self.port[0]}-{self.port[1]}")
        if self.ttl is not None:
            out.append(f"ttl={self.ttl}")
        if self.interleaved is not None:
            out.append(f"interleaved={self.interleaved[0]}-"
                       f"{self.interleaved[1]}")
        if self.mode is not None:
            out.append(f"mode={self.mode}")
        if self.ssrc is not None:
            out.append(f"ssrc={self.ssrc:08X}")
        return ";".join(out)

    @property
    def is_tcp(self) -> bool:
        return ("TCP" in self.protocol.upper()
                or self.interleaved is not None)


@dataclass
class RTSPUrl:
    """rtsp:// URL (gstrtspurl.c)."""
    host: str = "127.0.0.1"
    port: int = 554
    abspath: str = "/"
    user: Optional[str] = None
    password: Optional[str] = None

    @classmethod
    def parse(cls, location: str) -> "RTSPUrl":
        if "://" in location:
            _, _, rest = location.partition("://")
        else:
            rest = location
        hostport, slash, path = rest.partition("/")
        user = password = None
        if "@" in hostport:
            userinfo, _, hostport = hostport.rpartition("@")
            user, _, password = userinfo.partition(":")
            password = password or None
        host, _, port = hostport.partition(":")
        return cls(host=host or "127.0.0.1",
                   port=int(port) if port else 554,
                   abspath="/" + path if slash else "/",
                   user=user, password=password)
