"""OGM stream parsers + ogg-in-avi.

Clean-room rebuilds of:
* ogmvideoparse / ogmaudioparse / ogmtextparse
  (gst-plugins-base/ext/ogg/gstogmparse.c): parse the OGM stream
  header packet (0x01 + "video\\0\\0\\0" / "audio\\0\\0\\0" /
  "text\\0\\0\\0\\0" + the 52-byte stream_header: subtype fourcc,
  time_unit, samples_per_unit, default_len, buffersize,
  bits_per_sample + per-kind fields at offsets 44/46/48) and strip
  the per-packet OGM framing: first byte flags (bit0 = header
  packet, bits 7..6 + bit1 = length-byte count, bit3 = keyframe),
  little-endian sample count, then payload.  Timestamps run on the
  granulepos counter exactly like gst_ogm_parse_data_packet.
* oggaviparse (gstoggaviparse.c): the DirectShow ogg-in-avi vorbis
  framing — the first AVI chunk carries the three vorbis headers as
  [count][len0..][len1..] lacing, later chunks are raw packets.

A port of the JAX package's ``elements/ogm.py``: the parsers take their
source's host bytes (``HOST_INPUT``) and give host bytes.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, BufferFlags, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

# subtype fourcc -> caps (gst_riff-ish mapping for the common codecs)
_VIDEO_FOURCC = {
    b"XVID": "video/mpeg, mpegversion=4, systemstream=false",
    b"DIVX": "video/mpeg, mpegversion=4, systemstream=false",
    b"DX50": "video/mpeg, mpegversion=4, systemstream=false",
    b"MP42": "video/x-msmpeg, msmpegversion=42",
    b"MP43": "video/x-msmpeg, msmpegversion=43",
    b"H264": "video/x-h264, stream-format=byte-stream",
    b"theo": "video/x-theora",
}
_AUDIO_TAG = {
    0x0055: "audio/mpeg, mpegversion=1, layer=3",
    0x2000: "audio/x-ac3",
    0x0001: "audio/x-raw, format=S16LE",
    0x6771: "audio/x-vorbis",
}


class _OgmParseBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    KIND = b"video\x00\x00\x00"
    PROPERTIES = {}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._hdr = None
        self._granulepos = 0
        self._caps = None

    def transform_caps(self, direction, caps, filter=None):
        res = (self._caps or Caps.any()) \
            if direction == PadDirection.SINK \
            else self.sink_pads()[0].template_caps
        if filter is not None and not res.is_any:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._hdr = None
        self._granulepos = 0

    def _parse_header(self, data: bytes) -> None:
        # 0x01 <streamtype[8]> <subtype[4]> size time_unit
        # samples_per_unit default_len buffersize bits_per_sample ...
        sub = data[9:13]
        self._hdr = {
            "subtype": sub,
            "time_unit": struct.unpack("<q", data[17:25])[0],
            "samples_per_unit": struct.unpack("<q", data[25:33])[0],
            "bits_per_sample": struct.unpack("<i", data[41:45])[0],
        }
        if self.KIND.startswith(b"video"):
            w, h = struct.unpack("<ii", data[45:53])
            base = _VIDEO_FOURCC.get(
                sub, f"video/x-ogm-unknown, fourcc=(string)"
                     f"{sub.decode('latin1')}")
            self._caps = Caps.from_string(
                f"{base}, width={w}, height={h}")
        elif self.KIND.startswith(b"audio"):
            ch, _align = struct.unpack("<hh", data[45:49])
            try:
                codec_id = int(sub.decode("latin1"), 16)
            except ValueError:
                codec_id = 0
            base = _AUDIO_TAG.get(codec_id, "audio/x-ogm-unknown")
            rate = self._hdr["samples_per_unit"]
            self._caps = Caps.from_string(
                f"{base}, rate={rate}, channels={max(ch, 1)}")
        else:
            self._caps = Caps.from_string("text/x-raw, format=utf8")

    def _data_packet(self, data: bytes):
        if data[0] & 0x01:
            return None                     # header/comment packet
        nlen = ((data[0] & 0xC0) >> 6) | ((data[0] & 0x02) << 1)
        keyframe = bool(data[0] & 0x08)
        xsize = 0
        for n in range(nlen, 0, -1):
            xsize = (xsize << 8) | data[n]
        payload = data[1 + nlen:]
        hdr = self._hdr
        if self.KIND.startswith(b"video") \
                or self.KIND.startswith(b"text"):
            samples = 1 if self.KIND.startswith(b"video") else xsize
            ts = self._granulepos * hdr["time_unit"] * 100
            if self.KIND.startswith(b"text"):
                payload = payload.rstrip(b"\0")
        else:
            samples = xsize
            ts = self._granulepos * 1_000_000_000 \
                // max(hdr["samples_per_unit"], 1)
        self._granulepos += samples
        return payload, ts, keyframe

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        d = buf.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        out = []
        pts = None
        flags = 0
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).ravel().astype(np.uint8)
                   .tobytes())
            if not raw:
                continue
            if raw[0] == 0x01 and raw[1:9] == self.KIND:
                self._parse_header(raw)
                continue
            if self._hdr is None:
                continue
            r = self._data_packet(raw)
            if r is None:
                continue
            payload, ts, key = r
            if payload:
                if pts is None:
                    pts = ts
                    if not key:
                        flags |= BufferFlags.DELTA_UNIT
                out.append(np.frombuffer(payload, np.uint8))
        if not out:
            return None
        return buf.with_(data=out if len(out) > 1 else out[0],
                         pts=pts, batch=len(out), flags=flags)


@register_element
class OgmVideoParse(_OgmParseBase):
    FACTORY = "ogmvideoparse"
    DESCRIPTION = "parse an OGM video header and stream"
    KIND = b"video\x00\x00\x00"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/x-ogm-video"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]


@register_element
class OgmAudioParse(_OgmParseBase):
    FACTORY = "ogmaudioparse"
    DESCRIPTION = "parse an OGM audio header and stream"
    KIND = b"audio\x00\x00\x00"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/x-ogm-audio"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]


@register_element
class OgmTextParse(_OgmParseBase):
    FACTORY = "ogmtextparse"
    DESCRIPTION = "parse an OGM text header and stream"
    KIND = b"text\x00\x00\x00\x00"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/x-ogm-text"),
        PadTemplate("src", PadDirection.SRC,
                    "text/x-raw, format=utf8"),
    ]


@register_element
class OggAviParse(TransformElement):
    """oggaviparse (gstoggaviparse.c): vorbis-in-AVI chunks back to
    proper vorbis packets — the first chunk carries the 3 headers
    with [count][laced lengths] framing."""
    FACTORY = "oggaviparse"
    DESCRIPTION = "parse an ogg avi stream into pages (for Vorbis " \
                  "in AVI)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/x-ogg-avi"),
        PadTemplate("src", PadDirection.SRC, "audio/x-vorbis"),
    ]
    PROPERTIES = {}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._got_headers = False

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("audio/x-vorbis")
               if direction == PadDirection.SINK
               else Caps.from_string("application/x-ogg-avi"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._got_headers = False

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        d = buf.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        out = []
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).ravel().astype(np.uint8)
                   .tobytes())
            if not raw:
                continue
            if not self._got_headers:
                # [n-1][lace sizes (255-continued)] then packets
                n = raw[0] + 1
                pos = 1
                sizes = []
                for _ in range(n - 1):
                    sz = 0
                    while True:
                        v = raw[pos]
                        pos += 1
                        sz += v
                        if v != 255:
                            break
                    sizes.append(sz)
                for sz in sizes:
                    out.append(np.frombuffer(raw[pos:pos + sz],
                                             np.uint8))
                    pos += sz
                out.append(np.frombuffer(raw[pos:], np.uint8))
                self._got_headers = True
            else:
                out.append(np.frombuffer(raw, np.uint8))
        if not out:
            return None
        return buf.with_(data=out if len(out) > 1 else out[0],
                         batch=len(out))
