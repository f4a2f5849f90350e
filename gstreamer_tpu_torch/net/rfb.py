"""rfbsrc — VNC/RFB client source (clean-room RFB 3.8 per RFC 6143).

Reference: gst-plugins-bad/gst/librfb/ (gstrfbsrc.c + rfbdecoder.c)
— connects to a VNC server, requests framebuffer updates and turns
the rectangles into raw video frames.

Protocol (RFC 6143): version handshake ("RFB 003.008\\n"), security
negotiation (None=1; VNC auth is accepted but refused like the
reference without a password), ClientInit(shared), ServerInit
(width/height/pixel-format/name), then SetPixelFormat (RGBx 32bpp),
SetEncodings (Raw, CopyRect) and FramebufferUpdateRequest per output
frame.  Raw and CopyRect encodings are decoded; the framebuffer
persists across updates (incremental requests).

A copy of the JAX package's ``net/rfb.py``.  The source gives host RGBx
planes, which the pipeline stages on its device.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional

import numpy as np

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SourceElement,
                            register_element)
from ..core.structure import Structure
from ..core.value import Fraction

ENC_RAW = 0
ENC_COPYRECT = 1


def _recv_all(sk: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        part = sk.recv(n - len(out))
        if not part:
            raise ConnectionError("rfbsrc: server closed")
        out += part
    return out


@register_element
class RfbSrc(SourceElement):
    """rfbsrc: capture a remote VNC framebuffer as RGBx video."""
    FACTORY = "rfbsrc"
    DESCRIPTION = "Creates a video stream from a VNC server"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "video/x-raw, format=RGBx")]
    PROPERTIES = {
        "host": (str, "127.0.0.1", "VNC server host"),
        "port": (int, 5900, "VNC server port"),
        "shared": (bool, True, "share the desktop with others"),
        "incremental": (bool, True, "incremental update requests"),
        "view-only": (bool, False, "only view the desktop"),
        "num-buffers": (int, -1, "frames before EOS (-1 = forever)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._sk: Optional[socket.socket] = None
        self._fb: Optional[np.ndarray] = None
        self._wh = (0, 0)
        self.server_name = ""
        self._count = 0

    # -- protocol ----------------------------------------------------------
    def _handshake(self):
        sk = socket.create_connection(
            (self.props["host"], self.props["port"]), timeout=10.0)
        sk.settimeout(10.0)
        ver = _recv_all(sk, 12)
        if not ver.startswith(b"RFB "):
            raise ConnectionError("rfbsrc: not an RFB server")
        sk.sendall(b"RFB 003.008\n")
        nsec = _recv_all(sk, 1)[0]
        if nsec == 0:
            ln = struct.unpack(">I", _recv_all(sk, 4))[0]
            raise ConnectionError(
                "rfbsrc: " + _recv_all(sk, ln).decode("utf-8",
                                                      "replace"))
        secs = _recv_all(sk, nsec)
        if 1 not in secs:
            raise ConnectionError(
                "rfbsrc: server requires authentication")
        sk.sendall(bytes([1]))                    # security: None
        result = struct.unpack(">I", _recv_all(sk, 4))[0]
        if result != 0:
            raise ConnectionError("rfbsrc: security handshake failed")
        sk.sendall(bytes([1 if self.props["shared"] else 0]))
        w, h = struct.unpack(">HH", _recv_all(sk, 4))
        _recv_all(sk, 16)                         # server pixel format
        nlen = struct.unpack(">I", _recv_all(sk, 4))[0]
        self.server_name = _recv_all(sk, nlen).decode(
            "utf-8", "replace")
        self._wh = (w, h)
        self._fb = np.zeros((h, w, 4), np.uint8)
        # SetPixelFormat: 32bpp depth-24 little-endian true-colour RGBx
        pf = struct.pack(">BBBBHHHBBBxxx", 32, 24, 0, 1,
                         255, 255, 255, 0, 8, 16)
        sk.sendall(b"\x00\x00\x00\x00" + pf)
        # SetEncodings: Raw + CopyRect
        sk.sendall(struct.pack(">BxH", 2, 2)
                   + struct.pack(">ii", ENC_COPYRECT, ENC_RAW))
        self._sk = sk

    def _request_update(self, incremental: bool):
        w, h = self._wh
        self._sk.sendall(struct.pack(">BBHHHH", 3,
                                     1 if incremental else 0,
                                     0, 0, w, h))

    def _read_update(self):
        sk = self._sk
        while True:
            mtype = _recv_all(sk, 1)[0]
            if mtype == 0:                        # FramebufferUpdate
                _recv_all(sk, 1)
                nrect = struct.unpack(">H", _recv_all(sk, 2))[0]
                for _ in range(nrect):
                    x, y, w, h, enc = struct.unpack(
                        ">HHHHi", _recv_all(sk, 12))
                    if enc == ENC_RAW:
                        raw = _recv_all(sk, w * h * 4)
                        self._fb[y:y + h, x:x + w] = np.frombuffer(
                            raw, np.uint8).reshape(h, w, 4)
                    elif enc == ENC_COPYRECT:
                        sx, sy = struct.unpack(">HH",
                                               _recv_all(sk, 4))
                        self._fb[y:y + h, x:x + w] = \
                            self._fb[sy:sy + h, sx:sx + w].copy()
                    else:
                        raise ValueError(
                            f"rfbsrc: unhandled encoding {enc}")
                return
            if mtype == 2:                        # Bell
                continue
            if mtype == 3:                        # ServerCutText
                _recv_all(sk, 3)
                ln = struct.unpack(">I", _recv_all(sk, 4))[0]
                _recv_all(sk, ln)
                continue
            if mtype == 1:                        # SetColourMapEntries
                _recv_all(sk, 3)
                n = struct.unpack(">H", _recv_all(sk, 2))[0]
                _recv_all(sk, 6 * n)
                continue
            raise ValueError(f"rfbsrc: unknown message {mtype}")

    # -- element -------------------------------------------------------------
    def get_caps(self, filter=None):
        if self._sk is None:
            try:
                self._handshake()
            except OSError:
                return Caps.from_string("video/x-raw, format=RGBx")
        w, h = self._wh
        caps = Caps([Structure("video/x-raw", {
            "format": "RGBx", "width": w, "height": h,
            "framerate": Fraction(30, 1)})])
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        if self._sk is None:
            self._handshake()
        self._count = 0

    def stop(self):
        if self._sk:
            try:
                self._sk.close()
            except OSError:
                pass
            self._sk = None

    def create(self, n_frames: int) -> Optional[Buffer]:
        limit = self.props["num-buffers"]
        if limit >= 0 and self._count >= limit:
            return None
        try:
            self._request_update(self.props["incremental"]
                                 and self._count > 0)
            self._read_update()
        except (OSError, ConnectionError, ValueError):
            return None
        self._count += 1
        frame = self._fb
        planes = tuple(np.ascontiguousarray(frame[None, :, :, c])
                       for c in range(4))
        return Buffer(data=planes, batch=1,
                      pts=(self._count - 1) * 33_333_333,
                      duration=33_333_333)
