"""Subtitle overlay/parsing batch + APEv2 mux + bpmdetect + rtpdec.

Clean-room reductions of:
* subtitleoverlay (gst-plugins-base/gst/playback/
  gstsubtitleoverlay.c): overlays a parsed text subtitle stream onto
  video — here an aggregator with video + subtitle sinks using the
  textoverlay bitmap renderer.
* ttmlparse / ttmlrender (gst-plugins-bad/ext/ttml/gstttmlparse.c,
  gstttmlrender.c): EBU-TT-D <p begin end> cues to timed text
  buffers; render = the same overlay against video.
* avisubtitle (gst-plugins-good/gst/avi/gstavisubtitle.c): extracts
  the SRT payload from a 'GAB2' attachment stream.
* apev2mux (gst-plugins-good/ext/taglib/gstapev2mux.cc): prepends an
  APEv2 tag to the stream, id3v2mux-style.
* bpmdetect (gst-plugins-bad/ext/soundtouch/gstbpmdetect.cc):
  passthrough audio filter that estimates beats-per-minute from the
  onset-energy autocorrelation and surfaces it as a tag.
* rtpdec (gst-plugins-good/gst/rtsp/gstrtpdec.c): the legacy no-RTCP
  RTP session used as rtspsrc fallback — same collapsed session as
  rtpbin here.

A port of the JAX package's ``elements/subtitles_extra.py``.  The text of
subtitleoverlay and ttmlrender stays host bytes (the ``text`` pad takes its
source's bytes unstaged); a tick with text to draw copies its planes to the
host once, blends every frame there exactly as the JAX package does (float64
numpy) and moves the planes back to the video's device in one copy; a tick
without text passes the video's tensors as they are.  The byte parsers take
their source's host bytes (``HOST_INPUT``); bpmdetect reads each tick's
samples on the host and sums each hop with numpy, as the JAX package does.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection,
                            PadTemplate, TransformElement,
                            register_element)
from ..net.rtpmanager import RtpBin
from .textoverlay import render_text_argb


def _flat(data) -> bytes:
    """A buffer's leaves as one byte string: bytes as they are, a text leaf
    (subparse's cues) in UTF-8, an array's bytes.  The JAX package casts a
    text leaf to uint8 and raises (ROADMAP.md section 3)."""
    blobs = data if isinstance(data, (list, tuple)) else [data]
    return b"".join(
        b if isinstance(b, (bytes, bytearray))
        else b.encode("utf-8") if isinstance(b, str)
        else host_array(b).ravel().astype(np.uint8).tobytes()
        for b in blobs)


class _TextOverlayAggBase(AggregatorElement):
    """Shared video+text aggregator: blend the current text bitmap
    onto the bottom-center of I420 frames (gstsubtitleoverlay.c
    collapsed: parse upstream, render here)."""
    HOST_ELEMENT = True
    HOST_INPUT_PADS = ("text",)        # text; the video pad takes media
    PROPERTIES = {
        "font-size": (int, 18, "bitmap font size"),
        "ypad": (int, 25, "bottom padding"),
    }

    def negotiate_output(self, in_caps, allowed):
        return in_caps.get("video")

    def _text_of(self, sub: Buffer) -> str:
        return _flat(sub.data).decode("utf-8", errors="replace")

    def host_aggregate(self, ins: Dict[str, Buffer]
                       ) -> Optional[Buffer]:
        video = ins.get("video")
        if video is None:
            return None
        sub = ins.get("text")
        if sub is None:
            return video
        text = self._text_of(sub).strip()
        if not text:
            return video
        bmp = render_text_argb(text, self.props["font-size"])
        a = bmp[..., 0].astype(np.float64) / 255.0
        planes = [np.array(host_array(p)) for p in video.data]
        n = planes[0].shape[0] if planes[0].ndim == 3 else 1
        for k in range(n):
            Y = planes[0][k] if planes[0].ndim == 3 else planes[0]
            H, W = Y.shape
            bh, bw = bmp.shape[:2]
            x0 = max(0, (W - bw) // 2)
            y0 = max(0, H - bh - self.props["ypad"])
            h2 = min(bh, H - y0)
            w2 = min(bw, W - x0)
            if h2 <= 0 or w2 <= 0:
                continue
            reg = Y[y0:y0 + h2, x0:x0 + w2].astype(np.float64)
            lum = (0.299 * bmp[:h2, :w2, 1]
                   + 0.587 * bmp[:h2, :w2, 2]
                   + 0.114 * bmp[:h2, :w2, 3])
            Y[y0:y0 + h2, x0:x0 + w2] = np.clip(
                reg * (1 - a[:h2, :w2]) + lum * a[:h2, :w2],
                0, 255).astype(np.uint8)
        return video.with_(data=device_planes(planes, video.data))


@register_element
class SubtitleOverlay(_TextOverlayAggBase):
    """subtitleoverlay (gstsubtitleoverlay.c): plain text renders via
    the bitmap overlay; ASS/SSA input autoplugs the assrender path
    (the reference picks assrender by rank for these caps)."""
    FACTORY = "subtitleoverlay"
    DESCRIPTION = "Overlays a video stream with subtitles"
    PAD_TEMPLATES = [
        PadTemplate("video", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("text", PadDirection.SINK,
                    "text/x-raw, format=utf8; application/x-ass; "
                    "application/x-ssa"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._ass = None

    def negotiate_output(self, in_caps, allowed):
        text = in_caps.get("text")
        if text is not None and len(text) and text[0].name in (
                "application/x-ass", "application/x-ssa"):
            from .assrender import AssRender
            self._ass = AssRender(name=self.name + "_assrender")
            self._ass.negotiate_output(in_caps, allowed)
        return in_caps.get("video")

    def host_aggregate(self, ins):
        if self._ass is not None:
            return self._ass.host_aggregate(ins)
        return super().host_aggregate(ins)


_TTML_TIME = re.compile(
    r"(?:(\d+):)?(\d+):(\d+(?:\.\d+)?)|(\d+(?:\.\d+)?)s")


def _ttml_ns(t: str) -> Optional[int]:
    m = _TTML_TIME.fullmatch(t.strip())
    if not m:
        return None
    if m.group(4) is not None:
        return int(float(m.group(4)) * 1e9)
    h = int(m.group(1) or 0)
    return int((h * 3600 + int(m.group(2)) * 60
                + float(m.group(3))) * 1e9)


def parse_ttml(doc: bytes) -> List[dict]:
    """<p begin end> cues -> [{pts, duration, text}]
    (gstttmlparse.c ttml_parse analog; namespace-agnostic walk)."""
    import xml.etree.ElementTree as ET
    cues = []
    try:
        root = ET.fromstring(doc.decode("utf-8", errors="replace"))
    except ET.ParseError:
        return cues
    for el in root.iter():
        if not el.tag.endswith("}p") and el.tag != "p":
            continue
        t0 = _ttml_ns(el.get("begin", ""))
        t1 = _ttml_ns(el.get("end", ""))
        if t0 is None:
            continue
        text = "".join(el.itertext()).strip()
        # <br/> elements render as newlines in itertext()-joined form
        if text:
            cues.append({"pts": t0,
                         "duration": (t1 - t0) if t1 else 0,
                         "text": text})
    return cues


@register_element
class TtmlParse(TransformElement):
    """ttmlparse (gstttmlparse.c): TTML/EBU-TT-D documents to timed
    text buffers."""
    FACTORY = "ttmlparse"
    DESCRIPTION = "Parses TTML subtitle files"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/ttml+xml"),
        PadTemplate("src", PadDirection.SRC,
                    "text/x-raw, format=utf8"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("text/x-raw, format=utf8")
               if direction == PadDirection.SINK
               else Caps.from_string("application/ttml+xml"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        cues = parse_ttml(_flat(buf.data))
        if not cues:
            return None
        data = [np.frombuffer(c["text"].encode(), np.uint8)
                for c in cues]
        return buf.with_(data=data if len(data) > 1 else data[0],
                         pts=cues[0]["pts"],
                         duration=cues[0]["duration"],
                         batch=len(data))


@register_element
class TtmlRender(_TextOverlayAggBase):
    """ttmlrender (gstttmlrender.c): TTML against video — document
    parsed in place, first active cue rendered."""
    FACTORY = "ttmlrender"
    DESCRIPTION = "Renders TTML subtitles onto video"
    PAD_TEMPLATES = [
        PadTemplate("video", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("text", PadDirection.SINK,
                    "application/ttml+xml"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420"),
    ]

    def _text_of(self, sub: Buffer) -> str:
        cues = parse_ttml(_flat(sub.data))
        return cues[0]["text"] if cues else ""


@register_element
class AviSubtitle(TransformElement):
    """avisubtitle (gstavisubtitle.c): 'GAB2' attachment blobs carry a
    UTF-16 name chunk (id 2) and the SRT file chunk (id 4)."""
    FACTORY = "avisubtitle"
    DESCRIPTION = "Parse avi subtitle stream"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/x-subtitle-avi"),
        PadTemplate("src", PadDirection.SRC, "application/x-subtitle"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-subtitle")
               if direction == PadDirection.SINK
               else Caps.from_string("application/x-subtitle-avi"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        raw = _flat(buf.data)
        if raw[:4] != b"GAB2" or len(raw) < 5:
            raise ValueError("avisubtitle: no GAB2 magic")
        pos = 5                                  # magic + \0
        srt = None
        while pos + 6 <= len(raw):
            cid, ln = struct.unpack("<HI", raw[pos:pos + 6])
            body = raw[pos + 6:pos + 6 + ln]
            pos += 6 + ln
            if cid == 4:                         # subtitle file
                srt = body
        if srt is None:
            raise ValueError("avisubtitle: no subtitle chunk")
        return buf.with_(data=np.frombuffer(srt, np.uint8), batch=1)


@register_element
class Apev2Mux(TransformElement):
    """apev2mux (gstapev2mux.cc): prepends an APEv2 tag (header +
    items + no footer needed for streaming) to the byte stream."""
    FACTORY = "apev2mux"
    DESCRIPTION = "Adds an APEv2 header to the beginning of files"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/mpeg; audio/x-flac; application/x-apetag"),
        PadTemplate("src", PadDirection.SRC, "application/x-apetag"),
    ]
    PROPERTIES = {
        "tags": (str, "", "taglist string (title=x,artist=y)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._written = False

    def start(self):
        self._written = False

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-apetag")
               if direction == PadDirection.SINK
               else Caps.from_string("audio/mpeg"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def _tag_blob(self) -> bytes:
        items = b""
        count = 0
        for kv in (self.props["tags"] or "").split(","):
            k, _, v = kv.partition("=")
            if not k.strip():
                continue
            key = k.strip().title().encode()
            val = v.strip().strip('"').encode()
            items += struct.pack("<II", len(val), 0) + key \
                + b"\x00" + val
            count += 1
        size = 32 + len(items)                   # footer-inclusive size
        hdr = (b"APETAGEX" + struct.pack("<I", 2000)
               + struct.pack("<I", size)
               + struct.pack("<I", count)
               + struct.pack("<I", 0xA0000000)   # header, has header
               + bytes(8))
        ftr = (b"APETAGEX" + struct.pack("<I", 2000)
               + struct.pack("<I", size)
               + struct.pack("<I", count)
               + struct.pack("<I", 0x80000000)
               + bytes(8))
        return hdr + items + ftr

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None or self._written:
            return buf
        self._written = True
        return buf.with_(data=np.frombuffer(
            self._tag_blob() + _flat(buf.data), np.uint8), batch=1)


@register_element
class BpmDetect(TransformElement):
    """bpmdetect (gstbpmdetect.cc, reduced): passthrough that
    estimates tempo from the autocorrelation of the onset-energy
    envelope; result surfaces as `bpm` (tag event analog)."""
    FACTORY = "bpmdetect"
    DESCRIPTION = "Detect the BPM of an audio stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=F32LE, channels=1"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=F32LE, channels=1"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._env: List[float] = []
        self._rate = 44100
        self.bpm = 0.0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "audio/x-raw, format=F32LE, channels=1")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        if incaps is not None and len(incaps):
            self._rate = int(incaps[0].get("rate", 44100))

    def start(self):
        self._env = []
        self.bpm = 0.0

    _HOP = 512

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        x = host_array(buf.data).astype(np.float32, copy=False).ravel()
        for off in range(0, len(x) - self._HOP + 1, self._HOP):
            self._env.append(float(np.sum(
                x[off:off + self._HOP] ** 2)))
        self._estimate()
        return buf

    def _estimate(self) -> None:
        env = np.asarray(self._env, np.float64)
        if env.size < 64:
            return
        env = np.diff(env)
        env = np.maximum(env, 0)                 # onset energy
        if not env.any():
            return
        env = env - env.mean()
        ac = np.correlate(env, env, "full")[env.size - 1:]
        hop_rate = self._rate / self._HOP        # envelope frames/s
        lo = max(1, int(hop_rate * 60 / 240))    # 240 BPM
        hi = min(ac.size - 1, int(hop_rate * 60 / 40))  # 40 BPM
        if hi <= lo:
            return
        lag = lo + int(np.argmax(ac[lo:hi + 1]))
        self.bpm = 60.0 * hop_rate / lag


@register_element
class RtpDec(RtpBin):
    """rtpdec (gstrtpdec.c): the legacy RTCP-less RTP decoder used by
    rtspsrc interop — the same collapsed session element here."""
    FACTORY = "rtpdec"
    DESCRIPTION = "Accepts raw RTP and RTCP packets and sends them " \
                  "forward"
