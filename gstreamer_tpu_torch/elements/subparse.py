"""subparse — subtitle parsing (the full gstsubparse.c format
family: SRT, WebVTT, MicroDVD, MPL2, TMPlayer, SAMI, SubViewer,
MPSub, LRC, QTtext, DKS) and wavenc.

References: gst-plugins-base/gst/subparse/gstsubparse.c (format
autodetection + per-format parsers -> timed text/x-raw buffers);
gst-plugins-good/gst/wavenc/gstwavenc.c (RIFF/WAVE header writer).

A port of the JAX package's ``elements/subparse.py``.  subparse takes its
source's host bytes (``HOST_INPUT``: a subtitle file is not staged on the
card) and gives each cue's text as a Python string; encodebin writes
through the port's wavenc or y4menc.
"""

from __future__ import annotations

import re
import struct
from typing import List, Optional, Tuple

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            TransformElement, register_element)

_SRT_TIME = re.compile(
    r"(\d+):(\d\d):(\d\d)[,.](\d{1,3})\s*-->\s*"
    r"(\d+):(\d\d):(\d\d)[,.](\d{1,3})")


def _ts(h, m, s, ms) -> int:
    return ((int(h) * 3600 + int(m) * 60 + int(s)) * 1000
            + int(ms)) * 1_000_000


def parse_srt(text: str) -> List[Tuple[int, int, str]]:
    """(start_ns, end_ns, text) cues from SubRip text."""
    cues = []
    for block in re.split(r"\n\s*\n", text.strip()):
        lines = block.strip().splitlines()
        if not lines:
            continue
        # optional numeric index line
        if lines and lines[0].strip().isdigit():
            lines = lines[1:]
        if not lines:
            continue
        m = _SRT_TIME.search(lines[0])
        if not m:
            continue
        start = _ts(*m.groups()[:4])
        end = _ts(*m.groups()[4:])
        cues.append((start, end, "\n".join(lines[1:]).strip()))
    return cues


def parse_vtt(text: str) -> List[Tuple[int, int, str]]:
    """WebVTT cues (header line stripped; same arrow syntax)."""
    text = text.strip()
    if text.startswith("WEBVTT"):
        text = text.split("\n", 1)[1] if "\n" in text else ""
    return parse_srt(text)


def parse_microdvd(text: str,
                   fps: float = 24000 / 1001
                   ) -> List[Tuple[int, int, str]]:
    """MicroDVD {start}{end} frame-based cues; a leading {1}{1}fps
    line overrides the framerate (gstsubparse.c parse_mdvdsub)."""
    cues = []
    for line in text.splitlines():
        m = re.match(r"\{(\d+)\}\{(\d+)\}(.*)", line.strip())
        if not m:
            continue
        a, b, body = int(m.group(1)), int(m.group(2)), m.group(3)
        if a == 1 and b == 1:
            try:
                fps = float(body.strip().replace(",", "."))
                continue
            except ValueError:
                pass
        body = re.sub(r"\{[^}]*\}", "", body)
        cues.append((int(a / fps * 1e9), int(b / fps * 1e9),
                     body.replace("|", "\n").strip()))
    return cues


def parse_mpl2(text: str) -> List[Tuple[int, int, str]]:
    """MPL2 [start][end] decisecond cues (parse_mpl2)."""
    cues = []
    for line in text.splitlines():
        m = re.match(r"\[(\d+)\]\[(\d+)\](.*)", line.strip())
        if m:
            cues.append((int(m.group(1)) * 100_000_000,
                         int(m.group(2)) * 100_000_000,
                         m.group(3).replace("|", "\n").strip()))
    return cues


def parse_tmplayer(text: str) -> List[Tuple[int, int, str]]:
    """TMPlayer h:mm:ss: cues; each runs until the next (or +4 s)."""
    raw = []
    for line in text.splitlines():
        m = re.match(r"(\d+):(\d\d):(\d\d)[:=](.*)", line.strip())
        if m:
            start = _ts(m.group(1), m.group(2), m.group(3), 0)
            raw.append((start, m.group(4).replace("|", "\n").strip()))
    cues = []
    for i, (start, body) in enumerate(raw):
        end = raw[i + 1][0] if i + 1 < len(raw) \
            else start + 4_000_000_000
        if body:
            cues.append((start, end, body))
    return cues


def parse_sami(text: str) -> List[Tuple[int, int, str]]:
    """SAMI <SYNC Start=ms> blocks; &nbsp; closes the previous cue
    (parse_sami reduced: tags stripped)."""
    raw = []
    for m in re.finditer(r"<SYNC[^>]*Start\s*=\s*\"?(\d+)\"?[^>]*>"
                         r"(.*?)(?=<SYNC|</BODY|\Z)",
                         text, re.IGNORECASE | re.DOTALL):
        start = int(m.group(1)) * 1_000_000
        body = re.sub(r"<[^>]+>", "", m.group(2))
        body = body.replace("&nbsp;", "").strip()
        raw.append((start, body))
    cues = []
    for i, (start, body) in enumerate(raw):
        end = raw[i + 1][0] if i + 1 < len(raw) \
            else start + 4_000_000_000
        if body:
            cues.append((start, end, body))
    return cues


_SUBVIEWER_TIME = re.compile(
    r"(\d+):(\d\d):(\d\d)\.(\d\d)\s*,\s*(\d+):(\d\d):(\d\d)\.(\d\d)")


def parse_subviewer(text: str) -> List[Tuple[int, int, str]]:
    """SubViewer hh:mm:ss.cc,hh:mm:ss.cc cue pairs, [br] breaks."""
    cues = []
    blocks = re.split(r"\n\s*\n", text)
    for block in blocks:
        lines = block.strip().splitlines()
        for i, line in enumerate(lines):
            m = _SUBVIEWER_TIME.search(line)
            if m:
                g = m.groups()
                start = _ts(g[0], g[1], g[2], int(g[3]) * 10)
                end = _ts(g[4], g[5], g[6], int(g[7]) * 10)
                body = "\n".join(lines[i + 1:]).replace("[br]", "\n")
                if body.strip():
                    cues.append((start, end, body.strip()))
                break
    return cues


def parse_mpsub(text: str) -> List[Tuple[int, int, str]]:
    """MPSub FORMAT=TIME: 'gap duration' float pairs with relative
    timing (parse_mpsub)."""
    cues = []
    t = 0.0
    pend = None
    for line in text.splitlines():
        line = line.strip()
        m = re.match(r"(-?\d+(?:\.\d+)?)\s+(-?\d+(?:\.\d+)?)$", line)
        if m:
            if pend is not None:
                cues.append(pend)
            gap, dur = float(m.group(1)), float(m.group(2))
            t += gap
            pend = (int(t * 1e9), int((t + dur) * 1e9), "")
            t += dur
        elif pend is not None and line and not line.startswith(
                ("FORMAT", "#")):
            s, e, body = pend
            pend = (s, e, (body + "\n" + line).strip())
    if pend is not None and pend[2]:
        cues.append(pend)
    return [c for c in cues if c[2]]


def parse_lrc(text: str) -> List[Tuple[int, int, str]]:
    """LRC [mm:ss.xx] lyric lines; each runs until the next."""
    raw = []
    for line in text.splitlines():
        for m in re.finditer(r"\[(\d+):(\d\d)(?:\.(\d+))?\]", line):
            frac = (m.group(3) or "0").ljust(3, "0")[:3]
            start = (int(m.group(1)) * 60 + int(m.group(2))) \
                * 1_000_000_000 + int(frac) * 1_000_000
            body = re.sub(r"\[[^\]]*\]", "", line).strip()
            if body:
                raw.append((start, body))
    raw.sort()
    cues = []
    for i, (start, body) in enumerate(raw):
        end = raw[i + 1][0] if i + 1 < len(raw) \
            else start + 4_000_000_000
        cues.append((start, end, body))
    return cues


def parse_qttext(text: str) -> List[Tuple[int, int, str]]:
    """QTtext [hh:mm:ss.xx] timestamps (parse_qttext reduced)."""
    raw = []
    for m in re.finditer(
            r"\[(\d+):(\d\d):(\d\d)\.(\d+)\]\s*\n?([^\[]*)", text):
        start = _ts(m.group(1), m.group(2), m.group(3),
                    int(m.group(4).ljust(3, "0")[:3]))
        body = re.sub(r"\{[^}]*\}", "", m.group(5)).strip()
        raw.append((start, body))
    cues = []
    for i, (start, body) in enumerate(raw):
        end = raw[i + 1][0] if i + 1 < len(raw) \
            else start + 4_000_000_000
        if body:
            cues.append((start, end, body))
    return cues


def parse_dks(text: str) -> List[Tuple[int, int, str]]:
    """DKS [H:MM:SS]text lines; each runs until the next."""
    raw = []
    for line in text.splitlines():
        m = re.match(r"\[(\d+):(\d\d):(\d\d)\](.*)", line.strip())
        if m:
            raw.append((_ts(m.group(1), m.group(2), m.group(3), 0),
                        m.group(4).replace("[br]", "\n").strip()))
    cues = []
    for i, (start, body) in enumerate(raw):
        end = raw[i + 1][0] if i + 1 < len(raw) \
            else start + 4_000_000_000
        if body:
            cues.append((start, end, body))
    return cues


def detect_sub_format(text: str) -> str:
    """Format autodetection (gstsubparse.c sub_parse_data_format)."""
    t = text.lstrip()
    if t.startswith("WEBVTT"):
        return "vtt"
    if t.startswith("FORMAT=TIME") or "\nFORMAT=TIME" in t[:256]:
        return "mpsub"
    if re.search(r"<SAMI", t[:256], re.IGNORECASE):
        return "sami"
    if t.startswith("{QTtext}"):
        return "qttext"
    if "[INFORMATION]" in t[:256].upper():
        return "subviewer"
    if re.match(r"\{\d+\}\{\d+\}", t):
        return "microdvd"
    if re.match(r"\[\d+\]\[\d+\]", t):
        return "mpl2"
    if "-->" in t[:1024]:
        return "srt"
    if re.match(r"\[\d\d?:\d\d[.\]]", t):
        return "lrc"
    if re.match(r"\[\d+:\d\d:\d\d\]", t):
        return "dks"
    if re.match(r"\d+:\d\d:\d\d[:=]", t):
        return "tmplayer"
    return "srt"


_SUB_PARSERS = {
    "srt": parse_srt, "vtt": parse_vtt, "microdvd": parse_microdvd,
    "mpl2": parse_mpl2, "tmplayer": parse_tmplayer,
    "sami": parse_sami, "subviewer": parse_subviewer,
    "mpsub": parse_mpsub, "lrc": parse_lrc, "qttext": parse_qttext,
    "dks": parse_dks,
}


@register_element
class SubParse(TransformElement):
    """subparse: byte stream -> timed text buffers (one per cue)."""
    FACTORY = "subparse"
    DESCRIPTION = "Parses subtitle files into text buffers"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "text/x-raw, format=utf8"),
    ]

    _decouple = True                     # EOS drain flushes held cues

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._acc = b""
        self._emitted = 0

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("text/x-raw, format=utf8")
               if direction == PadDirection.SINK else Caps.any())
        if filter is not None:
            res = res.intersect(filter)
        return res

    def start(self):
        self._acc = b""
        self._emitted = 0

    @property
    def _pending_buf(self):
        return True if self._acc else None

    def _emit(self, new, base: Buffer) -> Optional[Buffer]:
        if not new:
            return None
        self._emitted += len(new)
        start, end, _ = new[0]
        return base.with_(data=[t for (_, _, t) in new],
                          pts=start, duration=end - start,
                          batch=len(new),
                          meta=dict(base.meta or {}, cues=new))

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:                  # EOS drain: flush held cues
            text = self._acc.decode("utf-8", errors="replace")
            cues = _SUB_PARSERS[detect_sub_format(text)](text)
            return self._emit(cues[self._emitted:],
                              Buffer(data=[], batch=0))
        data = buf.data
        leaves = data if isinstance(data, (tuple, list)) else (data,)
        for leaf in leaves:
            self._acc += host_array(leaf).tobytes()
        text = self._acc.decode("utf-8", errors="replace")
        cues = _SUB_PARSERS[detect_sub_format(text)](text)
        new = cues[self._emitted:]
        # hold back the final cue when the text may still be growing
        # (no trailing terminator); the EOS drain flushes it
        if new and not text.endswith(("\n", "\r", ".")) \
                and len(new) > 1:
            new = new[:-1]
        return self._emit(new, buf)


@register_element
class EncodeBin(SinkElement):
    """encodebin (gst-plugins-base/gst/encoding/gstencodebin.c):
    profile-driven output construction — the encoding profile picks the
    muxer/encoder chain.  Covers the containers the framework writes
    (WAV via wavenc, YUV4MPEG via y4menc)."""
    FACTORY = "encodebin"
    DESCRIPTION = "Convenience encoding/muxing element (profile-driven)"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "profile": (object, None, "EncodingProfile or spec string"),
        "location": (str, "out.bin", "output path"),
    }

    _SINKS = {
        "audio/x-wav": "wavenc",
        "application/x-yuv4mpeg": "y4menc",
        "video/x-yuv4mpeg": "y4menc",
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._inner = None

    def _profile_format(self):
        from ..utils.pbutils import EncodingProfile, profile_from_string
        p = self.props["profile"]
        if isinstance(p, str):
            p = profile_from_string(p)
        if p is None:
            raise ValueError("encodebin requires a profile")
        return p.format[0].name

    def transform_caps(self, direction, caps, filter=None):
        res = caps
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        from ..core.element import element_factory_make
        fmt = self._profile_format()
        factory = self._SINKS.get(fmt)
        if factory is None:
            raise ValueError(f"encodebin: unsupported profile format "
                             f"{fmt!r} (supported: {list(self._SINKS)})")
        self._inner = element_factory_make(
            factory, location=self.props["location"])
        self._inner.set_info(incaps, None)

    def start(self):
        if self._inner is not None:
            self._inner.start()

    def stop(self):
        if self._inner is not None:
            self._inner.stop()

    def render(self, buf: Buffer) -> str:
        return self._inner.render(buf)
