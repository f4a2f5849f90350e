"""Remaining parser / tag elements.

Clean-room reductions of:
* h263parse (gst-plugins-bad/gst/videoparsers/gsth263parse.c):
  frames split at the 22-bit H.263 picture start code.
* h266parse (gsth266parse.c): VVC Annex-B NAL walk, AU split at
  AUD/PH/parameter-set NALs after a VCL NAL.
* vc1parse (gstvc1parse.c): BDU start codes, frames at BDU 0x0D with
  preceding sequence/entry-point headers attached.
* diracparse (gstdiracparse.c): 'BBCD' parse-info units framed via
  next_parse_offset.
* jpeg2000parse (gstjpeg2000parse.c): SOC..EOC codestream framing.
* oggparse (gst-plugins-base/ext/ogg/gstoggparse.c): re-emits whole
  Ogg pages ('OggS' capture pattern + segment table).
* matroskaparse (gst-plugins-good/gst/matroska/matroska-parse.c):
  EBML-checked passthrough framing of a Matroska byte stream.
* vorbisparse / vorbistag (gst-plugins-base/ext/vorbis/
  gstvorbisparse.c, gstvorbistag.c): packetized Vorbis caps from the
  identification header; vorbistag rewrites the comment header.
* flactag (gst-plugins-good/ext/flac/gstflactag.c): rewrites the
  VORBIS_COMMENT metadata block of a FLAC stream in place.
* id3metaparse: ID3v2 strip + tag surfacing (the tag side of
  gst-plugins-good/gst/id3demux/ as a parse-style element).
* ssaparse (gst-plugins-base/gst/subparse/gstssaparse.c): SSA/ASS
  dialogue events to text buffers.
* goom (gst-plugins-good/gst/goom/gstgoom.c): registered over the
  goom2k1 visualizer core.

A port of the JAX package's ``elements/moreparsers.py``.  Every parser
takes its source's host bytes (``HOST_INPUT``, as ``videoparsers``); goom
is registered over the port's goom2k1.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate,
                            TransformElement, register_element)
from .audioparsers import _ParserBase
from .videoparsers import _nal_positions


@register_element
class H263Parse(_ParserBase):
    """h263parse (gsth263parse.c): picture start code = 17 zero bits
    + '10000' — bytes 00 00 then a byte whose top 6 bits are
    100000."""
    FACTORY = "h263parse"
    DESCRIPTION = "Parses H.263 streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-h263, variant=itu, parsed=true"),
    ]
    _SRC_CAPS = "video/x-h263, variant=itu, parsed=true"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(6)

    @staticmethod
    def _psc(raw: bytes, start: int) -> int:
        pos = start
        while True:
            i = raw.find(b"\x00\x00", pos)
            if i < 0 or i + 2 >= len(raw):
                return -1
            if (raw[i + 2] & 0xFC) == 0x80:
                return i
            pos = i + 1

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        first = self._psc(raw, 0)
        if first < 0:
            return 0, max(0, len(raw) - 3)
        if first > 0:
            return 0, first
        nxt = self._psc(raw, 3)
        if nxt > 0:
            return nxt, 0
        if self.draining:
            return len(raw), 0
        return 0, 0


@register_element
class H266Parse(_ParserBase):
    """h266parse (gsth266parse.c): AU split at AUD/PH/VPS/SPS/PPS
    NALs once a VCL NAL was seen (VVC NAL type = byte1 >> 3; VCL
    types 0..12)."""
    FACTORY = "h266parse"
    DESCRIPTION = "Parses H.266/VVC streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-h266, stream-format=byte-stream, "
                    "alignment=au"),
    ]
    _SRC_CAPS = ("video/x-h266, stream-format=byte-stream, "
                 "alignment=au")

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(6)

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        nals = _nal_positions(raw)
        if not nals:
            return 0, max(0, len(raw) - 2)
        if nals[0] > (1 if raw[0] == 0 else 0):
            lead = nals[0] - (1 if raw[nals[0] - 1] == 0 else 0)
            if lead > 0:
                return 0, lead
        saw_vcl = False
        for off in nals:
            p = off + 3
            if p + 1 >= len(raw):
                break
            ntype = raw[p + 1] >> 3
            if saw_vcl and ntype in (14, 15, 16, 19, 20):
                return off - (1 if raw[off - 1] == 0 else 0), 0
            if ntype <= 12:
                saw_vcl = True
        if self.draining and saw_vcl:
            return len(raw), 0
        return 0, 0


@register_element
class Vc1Parse(_ParserBase):
    """vc1parse (gstvc1parse.c): BDUs at 00 00 01 xx; a frame BDU is
    0x0D, with any preceding sequence (0x0F) / entry-point (0x0E)
    headers attached to the frame that follows."""
    FACTORY = "vc1parse"
    DESCRIPTION = "Parses VC1 streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-wmv, wmvversion=3, format=WVC1"),
    ]
    _SRC_CAPS = "video/x-wmv, wmvversion=3, format=WVC1"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(5)

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        first = raw.find(b"\x00\x00\x01")
        if first < 0:
            return 0, max(0, len(raw) - 2)
        if first > 0:
            return 0, first
        saw_frame = False
        pos = 0
        while True:
            nxt = raw.find(b"\x00\x00\x01", pos + 3)
            if nxt < 0:
                break
            bdu = raw[pos + 3] if pos + 3 < len(raw) else 0
            if bdu == 0x0D:
                saw_frame = True
            nbdu = raw[nxt + 3] if nxt + 3 < len(raw) else 0
            if saw_frame and nbdu in (0x0D, 0x0E, 0x0F):
                return nxt, 0
            pos = nxt
        if self.draining:
            return len(raw), 0
        return 0, 0


@register_element
class DiracParse(_ParserBase):
    """diracparse (gstdiracparse.c): 13-byte parse-info headers
    ('BBCD' + parse code + next_parse_offset + prev_parse_offset)
    frame the stream via next_parse_offset."""
    FACTORY = "diracparse"
    DESCRIPTION = "Parses Dirac streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-dirac, parsed=true"),
    ]
    _SRC_CAPS = "video/x-dirac, parsed=true"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(13)

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        i = raw.find(b"BBCD")
        if i < 0:
            return 0, max(0, len(raw) - 3)
        if i > 0:
            return 0, i
        next_off = struct.unpack(">I", raw[5:9])[0]
        if next_off == 0:                        # end-of-sequence unit
            return 13, 0
        if len(raw) >= next_off:
            return next_off, 0
        if self.draining:
            return len(raw), 0
        return 0, 0


@register_element
class Jpeg2000Parse(_ParserBase):
    """jpeg2000parse (gstjpeg2000parse.c): frames a J2K codestream
    from SOC (FF4F FF51) to EOC (FFD9)."""
    FACTORY = "jpeg2000parse"
    DESCRIPTION = "Parses JPEG 2000 files"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "image/x-jpc, parsed=true"),
    ]
    _SRC_CAPS = "image/x-jpc, parsed=true"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(8)

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        i = raw.find(b"\xff\x4f\xff\x51")
        if i < 0:
            return 0, max(0, len(raw) - 3)
        if i > 0:
            return 0, i
        end = raw.find(b"\xff\xd9", 4)
        if end >= 0:
            return end + 2, 0
        if self.draining:
            return len(raw), 0
        return 0, 0


@register_element
class OggParse(_ParserBase):
    """oggparse (gstoggparse.c): one output frame per Ogg page —
    27-byte header + segment table + body."""
    FACTORY = "oggparse"
    DESCRIPTION = "parse ogg streams into pages"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, "application/ogg"),
    ]
    _SRC_CAPS = "application/ogg"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(27)

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        i = raw.find(b"OggS")
        if i < 0:
            return 0, max(0, len(raw) - 3)
        if i > 0:
            return 0, i
        nseg = raw[26]
        hdr_len = 27 + nseg
        if len(raw) < hdr_len:
            return 0, 0
        body = sum(raw[27:hdr_len])
        total = hdr_len + body
        if len(raw) >= total:
            return total, 0
        if self.draining:
            return len(raw), 0
        return 0, 0


@register_element
class MatroskaParse(TransformElement):
    """matroskaparse (matroska-parse.c, reduced): EBML-checked
    passthrough that stamps video/x-matroska caps on the byte
    stream."""
    FACTORY = "matroskaparse"
    DESCRIPTION = "Parses Matroska/WebM streams into frames"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, "video/x-matroska"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._checked = False

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("video/x-matroska")
               if direction == PadDirection.SINK else Caps.any())
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._checked = False

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        if not self._checked:
            d = buf.data
            head = bytes(host_array(
                d[0] if isinstance(d, (list, tuple)) else d
            ).ravel()[:4].astype(np.uint8))
            if head != b"\x1aE\xdf\xa3":
                raise ValueError("matroskaparse: no EBML header")
            self._checked = True
        return buf


def _vorbis_packets(buf: Buffer) -> List[bytes]:
    d = buf.data
    if isinstance(d, (list, tuple)):
        return [bytes(host_array(x).ravel().astype(np.uint8).tobytes())
                for x in d]
    return [bytes(host_array(d).ravel().astype(np.uint8).tobytes())]


@register_element
class VorbisParse(TransformElement):
    """vorbisparse (gstvorbisparse.c): packetized Vorbis passthrough;
    the identification header (packet type 1) supplies rate/channels
    caps."""
    FACTORY = "vorbisparse"
    DESCRIPTION = "parse raw vorbis streams"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-vorbis"),
        PadTemplate("src", PadDirection.SRC, "audio/x-vorbis"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.rate = 0
        self.channels = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("audio/x-vorbis")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def _inspect(self, pkt: bytes) -> bytes:
        if len(pkt) > 29 and pkt[0] == 1 and pkt[1:7] == b"vorbis":
            self.channels = pkt[11]
            self.rate = struct.unpack("<I", pkt[12:16])[0]
        return pkt

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        pkts = [self._inspect(p) for p in _vorbis_packets(buf)]
        data = [np.frombuffer(p, np.uint8) for p in pkts]
        return buf.with_(data=data if len(data) > 1 else data[0])


@register_element
class VorbisTag(VorbisParse):
    """vorbistag (gstvorbistag.c): rewrites the comment header
    (packet type 3) from the `tags` property ("KEY=value;KEY=value"),
    preserving the framing bit and vendor string."""
    FACTORY = "vorbistag"
    DESCRIPTION = "Retags vorbis streams"
    PROPERTIES = {
        "tags": (str, "", "semicolon-separated KEY=value comments"),
    }

    def _inspect(self, pkt: bytes) -> bytes:
        pkt = super()._inspect(pkt)
        if not (len(pkt) > 7 and pkt[0] == 3
                and pkt[1:7] == b"vorbis" and self.props["tags"]):
            return pkt
        vlen = struct.unpack("<I", pkt[7:11])[0]
        vendor = pkt[11:11 + vlen]
        comments = [c for c in self.props["tags"].split(";") if c]
        out = bytearray(b"\x03vorbis")
        out += struct.pack("<I", len(vendor)) + vendor
        out += struct.pack("<I", len(comments))
        for c in comments:
            cb = c.encode()
            out += struct.pack("<I", len(cb)) + cb
        out += b"\x01"                           # framing bit
        return bytes(out)


@register_element
class FlacTag(TransformElement):
    """flactag (gstflactag.c): rewrites the VORBIS_COMMENT metadata
    block (type 4) of a FLAC byte stream from the `tags` property;
    audio frames pass through untouched."""
    FACTORY = "flactag"
    DESCRIPTION = "Rewrite tags in a FLAC file"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-flac"),
        PadTemplate("src", PadDirection.SRC, "audio/x-flac"),
    ]
    PROPERTIES = {
        "tags": (str, "", "semicolon-separated KEY=value comments"),
    }
    _decouple = True

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._acc = bytearray()
        self._headers_done = False

    @property
    def _pending_buf(self):
        return True if (self._acc and not self._headers_done) else None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("audio/x-flac")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._acc = bytearray()
        self._headers_done = False

    def _comment_block(self) -> bytes:
        comments = [c for c in self.props["tags"].split(";") if c]
        body = struct.pack("<I", 0)              # empty vendor
        body += struct.pack("<I", len(comments))
        for c in comments:
            cb = c.encode()
            body += struct.pack("<I", len(cb)) + cb
        return body

    def _rewrite(self, stream: bytes) -> bytes:
        if stream[:4] != b"fLaC":
            return stream
        out = bytearray(b"fLaC")
        pos = 4
        blocks = []                              # (type, body)
        while pos + 4 <= len(stream):
            hdr = stream[pos]
            btype = hdr & 0x7F
            last = bool(hdr & 0x80)
            ln = int.from_bytes(stream[pos + 1:pos + 4], "big")
            blocks.append((btype, stream[pos + 4:pos + 4 + ln]))
            pos += 4 + ln
            if last:
                break
        rest = stream[pos:]
        if self.props["tags"]:
            body = self._comment_block()
            replaced = False
            for i, (t, _b) in enumerate(blocks):
                if t == 4:
                    blocks[i] = (4, body)
                    replaced = True
            if not replaced:
                blocks.append((4, body))
        for i, (t, b) in enumerate(blocks):
            hdr = t | (0x80 if i == len(blocks) - 1 else 0)
            out += bytes([hdr]) + len(b).to_bytes(3, "big") + b
        return bytes(out) + rest

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            if self._headers_done or not self._acc:
                return None
            out = self._rewrite(bytes(self._acc))
            self._acc = bytearray()
            self._headers_done = True
            return Buffer(data=np.frombuffer(out, np.uint8), batch=1)
        if self._headers_done:
            return buf
        d = buf.data
        for blob in (d if isinstance(d, (list, tuple)) else [d]):
            self._acc += host_array(blob).ravel().astype(
                np.uint8).tobytes()
        return None


@register_element
class Id3MetaParse(TransformElement):
    """id3metaparse: strips a leading ID3v2 tag, surfaces it as
    buffer meta `id3` and passes the remaining stream through (the
    parse-shaped side of gst/id3demux/gstid3demux.c)."""
    FACTORY = "id3metaparse"
    DESCRIPTION = "Parse ID3 metadata into tags"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._checked = False
        self.tags = {}

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.any()
        if filter is not None:
            res = filter
        return res

    def fixate_caps(self, direction, caps, othercaps):
        if getattr(othercaps, "_any", False):
            return Caps.from_string("application/octet-stream")
        return othercaps.fixate()

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._checked = False
        self.tags = {}

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        if self._checked:
            return buf
        self._checked = True
        d = buf.data
        raw = host_array(
            d[0] if isinstance(d, (list, tuple)) else d
        ).ravel().astype(np.uint8).tobytes()
        if raw[:3] == b"ID3" and len(raw) >= 10:
            size = ((raw[6] & 0x7F) << 21) | ((raw[7] & 0x7F) << 14) \
                | ((raw[8] & 0x7F) << 7) | (raw[9] & 0x7F)
            from ..utils.tagreaders import parse_id3v2
            try:
                self.tags = parse_id3v2(raw[:10 + size]) or {}
            except Exception:
                self.tags = {}
            rest = raw[10 + size:]
            return buf.with_(
                data=np.frombuffer(rest, np.uint8),
                meta=dict(buf.meta or {}, id3=self.tags))
        return buf


@register_element
class SsaParse(TransformElement):
    """ssaparse (gstssaparse.c): SSA/ASS 'Dialogue:' events to
    pango-markup-free text buffers; styling override blocks {\\...}
    are stripped like the reference's gst_ssa_parse_remove_override_
    codes."""
    FACTORY = "ssaparse"
    DESCRIPTION = "Parses SSA subtitle streams"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/x-ssa"),
        PadTemplate("src", PadDirection.SRC,
                    "text/x-raw, format=utf8"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("text/x-raw, format=utf8")
               if direction == PadDirection.SINK
               else Caps.from_string("application/x-ssa"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    @staticmethod
    def _ts(t: str) -> int:
        h, m, s = t.split(":")
        return int((int(h) * 3600 + int(m) * 60 + float(s)) * 1e9)

    @staticmethod
    def _strip_overrides(text: str) -> str:
        out = []
        depth = 0
        for ch in text:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth = max(0, depth - 1)
            elif depth == 0:
                out.append(ch)
        return "".join(out)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        d = buf.data
        raw = host_array(
            d[0] if isinstance(d, (list, tuple)) else d
        ).ravel().astype(np.uint8).tobytes()
        texts = []
        pts = None
        dur = None
        for line in raw.decode("utf-8", errors="replace").splitlines():
            if not line.startswith("Dialogue:"):
                continue
            parts = line[len("Dialogue:"):].split(",", 9)
            if len(parts) < 10:
                continue
            start, end, text = parts[1].strip(), parts[2].strip(), \
                parts[9]
            text = self._strip_overrides(text).replace("\\N", "\n")
            try:
                t0, t1 = self._ts(start), self._ts(end)
            except ValueError:
                continue
            if pts is None:
                pts, dur = t0, t1 - t0
            texts.append(text)
        if not texts:
            return None
        data = [np.frombuffer(t.encode(), np.uint8) for t in texts]
        return buf.with_(data=data if len(data) > 1 else data[0],
                         pts=pts, duration=dur, batch=len(data))


# goom — the reference's main goom plugin (gst/goom/gstgoom.c); the
# 2k1 variant already implements the shared visualizer core here.
from .goom2k1 import Goom2k1  # noqa: E402


@register_element
class Goom(Goom2k1):
    FACTORY = "goom"
    DESCRIPTION = "Takes frames of data and outputs video frames " \
                  "based on the goom filter"
