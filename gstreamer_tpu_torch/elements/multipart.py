"""multipartmux / multipartdemux — MIME multipart streams (the
MJPEG-over-HTTP container) + id3demux.

References:
* gst-plugins-good/gst/multipart/multipartmux.c:516 — each part is
  "--BOUNDARY\\r\\nContent-Type: <mime>\\r\\n
   Content-Length: <n>\\r\\n\\r\\n<payload>\\r\\n";
  output caps multipart/x-mixed-replace with the boundary
  (multipartmux.c:468), default boundary "ThisRandomString".
* multipartdemux.c — boundary auto-detection from the first "--"
  line, per-part Content-Type selects the output caps.  Collapsed to
  pull-mode (one element = one stream) like the other demuxers here.
* gst-plugins-good/gst/id3demux/ — strips ID3v2 header / ID3v1
  trailer, posts the parsed TagList, passes the remaining stream.

A port of the JAX package's ``elements/multipart.py``.  multipartmux takes
its sources' host bytes (``HOST_INPUT_PADS``); multipartdemux, id3demux and
apedemux give host bytes, which a peer that takes them (jpegdec, a parser)
gets unstaged.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, SourceElement, register_element)


@register_element
class MultipartMux(AggregatorElement):
    FACTORY = "multipartmux"
    DESCRIPTION = "Mux multiple streams into a multipart stream"
    HOST_ELEMENT = True
    HOST_INPUT_PADS = ("sink_",)       # each part's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK, Caps.any(),
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC,
                    "multipart/x-mixed-replace"),
    ]
    PROPERTIES = {"boundary": (str, "ThisRandomString", "")}

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed):
        self._mimes = {n: c.fixate()[0].name
                       for n, c in in_caps.items()}
        s = Caps.from_string("multipart/x-mixed-replace")[0].copy()
        s["boundary"] = self.props["boundary"]
        return Caps([s])

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        out = bytearray()
        for pad_name in sorted(ins):
            buf = ins[pad_name]
            mime = self._mimes[pad_name]
            blobs = buf.data if isinstance(buf.data, list) \
                else [buf.data]
            for b in blobs:
                payload = (bytes(b) if isinstance(b, (bytes, bytearray))
                           else host_array(b).tobytes())
                out += (f"--{self.props['boundary']}\r\n"
                        f"Content-Type: {mime}\r\n"
                        f"Content-Length: {len(payload)}\r\n\r\n"
                        ).encode()
                out += payload
                out += b"\r\n"
        first = next(iter(ins.values()))
        return first.with_(
            data=np.frombuffer(bytes(out), np.uint8), batch=1)


def parse_multipart(data: bytes, boundary: Optional[str] = None):
    """-> (boundary, [(mime, payload_bytes)])."""
    if boundary is None:
        if not data.startswith(b"--"):
            raise ValueError("multipart: no boundary at start")
        boundary = data[2:data.index(b"\r\n")].decode()
    marker = f"--{boundary}".encode()
    parts = []
    pos = 0
    while True:
        i = data.find(marker, pos)
        if i < 0:
            break
        hdr_end = data.find(b"\r\n\r\n", i)
        if hdr_end < 0:
            break
        headers = data[i + len(marker):hdr_end].decode(
            "latin1").split("\r\n")
        mime, length = "application/octet-stream", None
        for h in headers:
            if ":" in h:
                k, v = h.split(":", 1)
                if k.strip().lower() == "content-type":
                    mime = v.strip()
                elif k.strip().lower() == "content-length":
                    length = int(v.strip())
        body = hdr_end + 4
        if length is not None:
            payload = data[body:body + length]
            pos = body + length
        else:
            nxt = data.find(marker, body)
            payload = data[body:nxt if nxt > 0 else len(data)]
            payload = payload.rstrip(b"\r\n")
            pos = body + len(payload)
        parts.append((mime, payload))
    return boundary, parts


@register_element
class MultipartDemux(SourceElement):
    """multipartdemux (pull-mode collapse): splits a multipart file
    into its payload stream."""
    FACTORY = "multipartdemux"
    DESCRIPTION = "Demultiplex multipart streams"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "multipart file path"),
        "boundary": (str, "", "boundary (auto-detected if empty)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._parts: Optional[List] = None
        self._pos = 0

    def _load(self):
        if self._parts is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        _, self._parts = parse_multipart(
            data, self.props["boundary"] or None)
        if not self._parts:
            raise ValueError("multipartdemux: no parts found")
        self._mime = self._parts[0][0]

    def preview_blob(self) -> Optional[bytes]:
        try:
            self._load()
        except (OSError, ValueError):
            return None
        return self._parts[0][1]

    def get_caps(self, filter=None):
        try:
            self._load()
        except (OSError, ValueError):
            return Caps.any()
        caps = Caps.from_string(self._mime)
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._parts):
            return None
        take = self._parts[self._pos:self._pos + max(1, n_frames)]
        self._pos += len(take)
        return Buffer(data=[p for _, p in take], batch=len(take))


@register_element
class Id3Demux(SourceElement):
    """id3demux (gstid3demux.c, pull-mode collapse): strip ID3v2/v1
    tags from a file, post the TagList, expose the remaining bytes."""
    FACTORY = "id3demux"
    DESCRIPTION = "Read and output ID3v1 and ID3v2 tags"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"location": (str, "", "tagged file path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._payload = None
        self._tags = None
        self._done = False

    def _load(self):
        if self._payload is not None:
            return
        from ..utils.tagreaders import parse_id3v2
        with open(self.props["location"], "rb") as f:
            data = f.read()
        tags = None
        if data[:3] == b"ID3" and len(data) >= 10:
            size = ((data[6] & 0x7F) << 21 | (data[7] & 0x7F) << 14
                    | (data[8] & 0x7F) << 7 | (data[9] & 0x7F))
            tags = parse_id3v2(data[:10 + size])
            data = data[10 + size:]
        if len(data) >= 128 and data[-128:-125] == b"TAG":
            data = data[:-128]      # ID3v1 trailer
        self._payload = data
        self._tags = tags

    def get_caps(self, filter=None):
        try:
            self._load()
        except OSError:
            return Caps.any()
        from ..utils.typefind import type_find_data
        try:
            res = type_find_data(self._payload[:4096])
            mime = res[0] if isinstance(res, tuple) else res
            caps = Caps.from_string(mime) if mime else Caps.any()
        except Exception:
            caps = Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._done = False
        if self._tags:
            root = self
            while getattr(root, "parent", None) is not None:
                root = root.parent
            if hasattr(root, "bus"):
                from ..core.pipeline import Message
                tags = getattr(self._tags, "_tags", self._tags)
                root.bus.post(Message("tag", self.name, dict(tags)))

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._done:
            return None
        self._done = True
        return Buffer(data=np.frombuffer(self._payload, np.uint8),
                      batch=1)


@register_element
class ApeDemux(SourceElement):
    """apedemux (gst-plugins-good/gst/apetag/gstapedemux.c,
    pull-mode collapse): strip APEv1/v2 tags from the file start or
    end, post the parsed TagList, expose the remaining bytes."""
    FACTORY = "apedemux"
    DESCRIPTION = "Read and output APE tags"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"location": (str, "", "tagged file path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._payload = None
        self._tags = None
        self._done = False

    @staticmethod
    def _parse_ape(data: bytes, count: int):
        """APE tag items region -> dict."""
        import struct as _s
        tags = {}
        pos = 0
        for _ in range(count):
            if pos + 8 > len(data):
                break
            vsize, iflags = _s.unpack("<II", data[pos:pos + 8])
            pos += 8
            end = data.find(b"\0", pos)
            if end < 0:
                break
            key = data[pos:end].decode("latin1").lower()
            pos = end + 1
            val = data[pos:pos + vsize]
            pos += vsize
            if not iflags & 0x6:             # UTF-8 text item
                tags[key] = val.decode("utf-8", "replace")
        return tags

    def _load(self):
        if self._payload is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        tags = {}
        if data[:8] == b"APETAGEX":
            # header at start: size covers items + footer
            size = int.from_bytes(data[12:16], "little")
            count = int.from_bytes(data[16:20], "little")
            tags = self._parse_ape(data[32:32 + size], count)
            data = data[32 + size:]
        elif len(data) >= 32 and data[-32:-24] == b"APETAGEX":
            size = int.from_bytes(data[-20:-16], "little")
            flags = int.from_bytes(data[-12:-8], "little")
            # size covers items + footer; +32 only when a header
            # precedes the items (flag bit 31)
            count = int.from_bytes(data[-16:-12], "little")
            total = size + (32 if flags & (1 << 31) else 0)
            items = data[len(data) - size:len(data) - 32]
            tags = self._parse_ape(items, count)
            data = data[:len(data) - total]
        self._payload = data
        self._tags = tags

    def get_caps(self, filter=None):
        try:
            self._load()
        except OSError:
            return Caps.any()
        from ..utils.typefind import type_find_data
        try:
            res = type_find_data(self._payload[:4096])
            mime = res[0] if isinstance(res, tuple) else res
            caps = Caps.from_string(mime) if mime else Caps.any()
        except Exception:
            caps = Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._done = False
        if self._tags:
            root = self
            while getattr(root, "parent", None) is not None:
                root = root.parent
            if hasattr(root, "bus"):
                from ..core.pipeline import Message
                root.bus.post(Message("tag", self.name,
                                      dict(self._tags)))

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._done:
            return None
        self._done = True
        return Buffer(data=np.frombuffer(self._payload, np.uint8),
                      batch=1)
