"""SDP (Session Description Protocol, RFC 4566) parsing/serialization.

A slice of the reference SDP library
(gst-plugins-base/gst-libs/gst/sdp/gstsdpmessage.c): parse/produce
session descriptions, including the rtpmap attribute handling used to
pair SDP with the RTP elements (net/rtp.py) for stream setup.

A copy of the JAX package's ``net/sdp.py``. Host code only: the elements
wrap the port's udpsrc / udpsink.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class SDPMedia:
    media: str = ""                 # audio | video | ...
    port: int = 0
    proto: str = "RTP/AVP"
    formats: List[str] = field(default_factory=list)
    attributes: List[Tuple[str, str]] = field(default_factory=list)
    connection: str = ""

    def get_attribute_val(self, key: str) -> Optional[str]:
        for k, v in self.attributes:
            if k == key:
                return v
        return None

    def rtpmaps(self) -> Dict[int, Tuple[str, int, int]]:
        """pt -> (encoding, clock-rate, channels) from a=rtpmap."""
        out = {}
        for k, v in self.attributes:
            if k != "rtpmap":
                continue
            pt, enc = v.split(" ", 1)
            parts = enc.split("/")
            name = parts[0]
            rate = int(parts[1]) if len(parts) > 1 else 0
            ch = int(parts[2]) if len(parts) > 2 else 1
            out[int(pt)] = (name, rate, ch)
        return out


@dataclass
class SDPMessage:
    version: str = "0"
    origin: str = ""
    session_name: str = ""
    connection: str = ""
    times: List[str] = field(default_factory=list)
    attributes: List[Tuple[str, str]] = field(default_factory=list)
    medias: List[SDPMedia] = field(default_factory=list)

    @classmethod
    def parse(cls, text: str) -> "SDPMessage":
        """gst_sdp_message_parse_buffer."""
        msg = cls()
        cur: Optional[SDPMedia] = None
        for line in text.splitlines():
            line = line.strip()
            if len(line) < 2 or line[1] != "=":
                continue
            key, val = line[0], line[2:]
            if key == "v":
                msg.version = val
            elif key == "o":
                msg.origin = val
            elif key == "s":
                msg.session_name = val
            elif key == "c":
                if cur is not None:
                    cur.connection = val
                else:
                    msg.connection = val
            elif key == "t":
                msg.times.append(val)
            elif key == "m":
                parts = val.split()
                cur = SDPMedia(media=parts[0], port=int(parts[1]),
                               proto=parts[2], formats=parts[3:])
                msg.medias.append(cur)
            elif key == "a":
                k, _, v = val.partition(":")
                target = cur.attributes if cur is not None \
                    else msg.attributes
                target.append((k, v))
        return msg

    def as_text(self) -> str:
        """gst_sdp_message_as_text."""
        lines = [f"v={self.version}"]
        if self.origin:
            lines.append(f"o={self.origin}")
        lines.append(f"s={self.session_name or ' '}")
        if self.connection:
            lines.append(f"c={self.connection}")
        for t in (self.times or ["0 0"]):
            lines.append(f"t={t}")
        for k, v in self.attributes:
            lines.append(f"a={k}:{v}" if v else f"a={k}")
        for m in self.medias:
            lines.append(f"m={m.media} {m.port} {m.proto} "
                         + " ".join(m.formats))
            if m.connection:
                lines.append(f"c={m.connection}")
            for k, v in m.attributes:
                lines.append(f"a={k}:{v}" if v else f"a={k}")
        return "\r\n".join(lines) + "\r\n"


def media_to_caps(media: SDPMedia, pt: int):
    """gst_sdp_media_get_caps_from_media: build application/x-rtp caps
    with the rtpmap fields."""
    from ..core.caps import Caps

    maps = media.rtpmaps()
    enc, rate, ch = maps.get(pt, ("", 0, 1))
    s = (f"application/x-rtp, media=(string){media.media}, "
         f"payload=(int){pt}")
    if enc:
        s += f", encoding-name=(string){enc}"
    if rate:
        s += f", clock-rate=(int){rate}"
    if ch > 1:
        s += f", channels=(int){ch}"
    return Caps.from_string(s)


# ---------------------------------------------------------------------------
# Elements: sdpdemux / sdpsrc (gst-plugins-bad/gst/sdp/gstsdpdemux.c)
# and rtpsrc / rtpsink (gst-plugins-bad/gst/rtp/gstrtpsrc.c /
# gstrtpsink.c) — rtp:// URI convenience over udpsrc/udpsink; the
# sdp elements collapse the per-media receive chain into a
# source-style element with rtpmap-derived application/x-rtp caps.
# ---------------------------------------------------------------------------

from urllib.parse import parse_qs, urlparse  # noqa: E402

import numpy as np  # noqa: E402

from ..core.buffer import Buffer  # noqa: E402
from ..core.caps import Caps  # noqa: E402
from ..core.element import (PadDirection, PadTemplate,  # noqa: E402
                            SinkElement, SourceElement,
                            element_factory_make, register_element)
from ..core.structure import Structure  # noqa: E402


@register_element
class SdpDemux(SourceElement):
    """sdpdemux (source-style): reads an SDP file, receives the
    selected media section's RTP packets via an inner udpsrc and
    emits them with rtpmap-derived caps."""
    FACTORY = "sdpdemux"
    DESCRIPTION = "Receive data over the network via SDP"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "application/x-rtp")]
    PROPERTIES = {
        "location": (str, "", "path to .sdp file"),
        "media": (str, "", "audio|video (first match; '' = first)"),
        "timeout": (float, 0.5, "udp read timeout (s)"),
        "num-buffers": (int, -1, "stop after n reads (-1 = timeout)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._inner = None
        self._media = None

    def _sdp_text(self) -> str:
        return open(self.props["location"]).read()

    def _load(self):
        if self._media is not None:
            return
        msg = SDPMessage.parse(self._sdp_text())
        want = self.props["media"]
        for m in msg.medias:
            if not want or m.media == want:
                self._media = m
                break
        if self._media is None:
            raise ValueError(f"sdpdemux: no media {want!r} in SDP")

    def _caps(self) -> "Caps":
        pt = int(self._media.formats[0]) if self._media.formats \
            else 96
        return media_to_caps(self._media, pt)

    def get_caps(self, filter=None):
        try:
            self._load()
        except (OSError, ValueError):
            return Caps.from_string("application/x-rtp")
        caps = self._caps()
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._load()
        self._inner = element_factory_make(
            "udpsrc", port=self._media.port,
            timeout=self.props["timeout"])
        self._inner.start()
        self._count = 0

    def stop(self):
        if self._inner is not None:
            self._inner.stop()
            self._inner = None

    def create(self, n_frames):
        lim = self.props["num-buffers"]
        if lim >= 0 and self._count >= lim:
            return None
        buf = self._inner.create(n_frames)
        if buf is not None:
            self._count += 1
            buf = buf.with_(meta=dict(buf.meta or {},
                                      caps=self._caps()))
        return buf


@register_element
class SdpSrc(SdpDemux):
    """sdpsrc (gstsdpsrc.c): sdp:// URI or inline `sdp` property."""
    FACTORY = "sdpsrc"
    DESCRIPTION = "Stream RTP based on an SDP"
    PROPERTIES = dict(SdpDemux.PROPERTIES,
                      sdp=(str, "", "inline SDP text"))

    def _sdp_text(self) -> str:
        if self.props["sdp"]:
            return self.props["sdp"].replace("\\n", "\n")
        loc = self.props["location"]
        if loc.startswith("sdp://"):
            loc = loc[6:]
        return open(loc).read()


@register_element
class RtpSink(SinkElement):
    """rtpsink: rtp://host:port URI over udpsink."""
    FACTORY = "rtpsink"
    DESCRIPTION = "RTP packet sender"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "application/x-rtp")]
    PROPERTIES = {"uri": (str, "rtp://127.0.0.1:5004", "")}

    def start(self):
        u = urlparse(self.props["uri"])
        self._inner = element_factory_make(
            "udpsink", host=u.hostname or "127.0.0.1",
            port=u.port or 5004)
        self._inner.start()

    def stop(self):
        if getattr(self, "_inner", None):
            self._inner.stop()
            self._inner = None

    def render(self, buf):
        return self._inner.render(buf)


@register_element
class RtpSrc(SourceElement):
    """rtpsrc: rtp://@:port receiver over udpsrc; caps from the
    `caps` property or URI query (?media=...&clock-rate=...)."""
    FACTORY = "rtpsrc"
    DESCRIPTION = "RTP packet receiver"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "application/x-rtp")]
    PROPERTIES = {
        "uri": (str, "rtp://0.0.0.0:5004", ""),
        "caps": (object, None, "stream caps"),
        "timeout": (float, 0.5, ""),
        "num-buffers": (int, -1, ""),
    }

    def get_caps(self, filter=None):
        caps = self.props["caps"]
        if caps is not None:
            if not isinstance(caps, Caps):
                caps = Caps.from_string(str(caps))
        else:
            u = urlparse(self.props["uri"])
            f = {}
            for k, v in parse_qs(u.query).items():
                f[k] = (int(v[0]) if v[0].isdigit() else v[0])
            caps = Caps([Structure("application/x-rtp", f)])
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        u = urlparse(self.props["uri"])
        self._inner = element_factory_make(
            "udpsrc", host=(u.hostname if u.hostname
                            not in (None, "") else "0.0.0.0"),
            port=u.port or 5004, timeout=self.props["timeout"])
        self._inner.start()
        self._count = 0

    def stop(self):
        if getattr(self, "_inner", None):
            self._inner.stop()
            self._inner = None

    def create(self, n_frames):
        lim = self.props["num-buffers"]
        if lim >= 0 and self._count >= lim:
            return None
        buf = self._inner.create(n_frames)
        if buf is not None:
            self._count += 1
        return buf
