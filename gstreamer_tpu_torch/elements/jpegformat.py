"""jpegformat — jpegparse / jifmux.

Ports of gst-plugins-bad/gst/jpegformat/:
* jpegparse (gstjpegparse.c): frames a JPEG byte stream at SOI..EOI
  (walking marker segments, skipping entropy-coded scan data), parses
  the SOF header into width/height/sof-marker and the
  colorspace/sampling strings from the component IDs + JFIF/Adobe
  APP markers (gstjpegparse.c:330-430, subsampling map :268-293).
* jifmux (gstjifmux.c): re-muxes a JPEG image's marker segments —
  JFIF APP0 first (inserted if missing for YUV/grayscale images,
  version 1.2, zero density, :480-503), an Exif APP1 serialized from
  the stream's tags (replace-or-insert after APP0, :527-570), an XMP
  APP1 packet (:573-608), and a COM segment from the
  comment/description/title tag inserted before the frame header
  (:611-626). Reduced scope vs the reference: the Exif writer
  serializes the string tags (description/artist/copyright/datetime)
  as a minimal little-endian TIFF rather than libgsttag's full table.

A copy of the JAX package's ``elements/jpegformat.py`` on the port's
``audioparsers._ParserBase``; the bytes are taken to the host
(``host_array``).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.structure import Structure
from .audioparsers import _ParserBase

SOI, EOI, SOS, COM, DQT, DRI, DAC, DHT = (
    0xD8, 0xD9, 0xDA, 0xFE, 0xDB, 0xDD, 0xCC, 0xC4)
APP0, APP1, APP14 = 0xE0, 0xE1, 0xEE
_SOF_MARKERS = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
                0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}
_STANDALONE = {0x01, SOI, EOI} | set(range(0xD0, 0xD8))   # TEM/RST

# gstjpegparse.c:268-293 (h0,h1,h2,v0,v1,v2) -> sampling string
_SUBSAMPLING_MAP = {
    (1, 1, 1, 1, 1, 1): "YCbCr-4:4:4",
    (2, 2, 2, 1, 1, 1): "YCbCr-4:4:4",
    (3, 3, 3, 1, 1, 1): "YCbCr-4:4:4",
    (1, 1, 1, 2, 2, 2): "YCbCr-4:4:4",
    (1, 1, 1, 3, 3, 3): "YCbCr-4:4:4",
    (1, 1, 1, 2, 1, 1): "YCbCr-4:4:0",
    (2, 2, 2, 2, 1, 1): "YCbCr-4:4:0",
    (1, 1, 1, 4, 2, 2): "YCbCr-4:4:0",
    (2, 1, 1, 1, 1, 1): "YCbCr-4:2:2",
    (2, 1, 1, 2, 2, 2): "YCbCr-4:2:2",
    (4, 2, 2, 1, 1, 1): "YCbCr-4:2:2",
    (2, 1, 1, 2, 1, 1): "YCbCr-4:2:0",
    (4, 1, 1, 1, 1, 1): "YCbCr-4:1:1",
    (4, 1, 1, 2, 1, 1): "YCbCr-4:1:0",
}


def walk_markers(data: bytes) -> Tuple[List[Tuple[int, int, bytes]],
                                       Optional[bytes], bool]:
    """Walk marker segments from the SOI at data[0].

    Returns (markers, scan_data, complete): markers are
    (marker, seg_offset, payload) without length bytes; scan_data is
    the entropy-coded bytes between SOS header and EOI (None until
    SOS seen); complete=True when EOI was reached."""
    markers: List[Tuple[int, int, bytes]] = []
    pos = 0
    n = len(data)
    while pos + 1 < n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in _STANDALONE:
            markers.append((marker, pos, b""))
            if marker == EOI:
                return markers, None, True
            pos += 2
            continue
        if pos + 4 > n:
            break
        seglen = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if pos + 2 + seglen > n:
            break
        payload = data[pos + 4:pos + 2 + seglen]
        markers.append((marker, pos, payload))
        pos += 2 + seglen
        if marker == SOS:
            # entropy data runs to the next non-stuffed, non-RST marker
            scan_start = pos
            while pos + 1 < n:
                if data[pos] == 0xFF and data[pos + 1] not in (0x00,) \
                        and not (0xD0 <= data[pos + 1] <= 0xD7):
                    scan = data[scan_start:pos]
                    if data[pos + 1] == EOI:
                        markers.append((EOI, pos, b""))
                        return markers, scan, True
                    break
                pos += 1
            else:
                break
    return markers, None, False


def parse_sof(payload: bytes) -> dict:
    """SOF segment -> precision/height/width/components (B.2.2)."""
    prec, h, w, ncomp = struct.unpack(">BHHB", payload[:6])
    comps = []
    for i in range(ncomp):
        cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 0xF, "tq": tq})
    return {"precision": prec, "width": w, "height": h, "components": comps}


def _classify(sof: dict, marker: int, jfif: bool,
              adobe: Optional[int]) -> Tuple[Optional[str], Optional[str]]:
    """colorspace/sampling strings (gstjpegparse.c:330-430)."""
    comps = sof["components"]
    if len(comps) == 1:
        return "GRAY", "GRAYSCALE"
    if len(comps) == 3:
        key = (comps[0]["h"], comps[1]["h"], comps[2]["h"],
               comps[0]["v"], comps[1]["v"], comps[2]["v"])
        yuv = _SUBSAMPLING_MAP.get(key)
        if jfif:
            return "sYUV", yuv
        if adobe is not None:
            if adobe == 0:
                return "sRGB", "RGB"
            return "sYUV", yuv
        cids = (comps[0]["id"], comps[1]["id"], comps[2]["id"])
        if cids == (1, 2, 3):
            return "sYUV", yuv
        if cids == (ord("R"), ord("G"), ord("B")):
            return "sRGB", "RGB"
        return "sYUV", yuv
    if len(comps) == 4:
        if adobe == 0:
            return "CMYK", None
        return "YCCK", None
    return None, None


@register_element
class JpegParse(_ParserBase):
    FACTORY = "jpegparse"
    DESCRIPTION = "Parse JPEG images into single-frame buffers"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "image/jpeg"),
        PadTemplate("src", PadDirection.SRC, "image/jpeg, parsed=true"),
    ]
    _SRC_CAPS = "image/jpeg, parsed=true"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(4)
        self.info: Optional[dict] = None

    def start(self):
        super().start()
        self.info = None

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        soi = raw.find(b"\xff\xd8")
        if soi < 0:
            return 0, max(0, len(raw) - 1)
        if soi > 0:
            return 0, soi
        markers, _, complete = walk_markers(raw)
        if not complete:
            return 0, 0
        jfif = False
        adobe = None
        sof = None
        sof_marker = None
        end = 0
        for marker, off, payload in markers:
            if marker == APP0 and payload[:5] == b"JFIF\0":
                jfif = True
            elif marker == APP14 and payload[:6] == b"Adobe\0" \
                    and len(payload) >= 12:
                adobe = payload[11]
            elif marker in _SOF_MARKERS:
                sof = parse_sof(payload)
                sof_marker = marker
            elif marker == EOI:
                end = off + 2
        if sof is not None:
            cs, samp = _classify(sof, sof_marker, jfif, adobe)
            self.info = {"width": sof["width"], "height": sof["height"],
                         "sof-marker": sof_marker - 0xC0,
                         "colorspace": cs, "sampling": samp}
        return end, 0

    def pre_push_frame(self, buf):
        if self.info:
            f = {"parsed": True, "width": self.info["width"],
                 "height": self.info["height"],
                 "sof-marker": self.info["sof-marker"]}
            if self.info["colorspace"]:
                f["colorspace"] = self.info["colorspace"]
            if self.info["sampling"]:
                f["sampling"] = self.info["sampling"]
            buf = buf.with_(meta=dict(
                buf.meta or {}, caps=Caps([Structure("image/jpeg", f)])))
        return buf


# ---------------------------------------------------------------------------
# jifmux
# ---------------------------------------------------------------------------

# minimal EXIF/TIFF string tags (gstjifmux.c delegates to libgsttag)
_EXIF_STRING_TAGS = [("description", 0x010E), ("datetime", 0x0132),
                     ("artist", 0x013B), ("copyright", 0x8298)]


def build_exif_app1(tags: Dict[str, str]) -> Optional[bytes]:
    """'Exif\\0\\0' + little-endian TIFF with ASCII tags."""
    entries = [(tid, (tags[name] + "\0").encode("latin-1", "replace"))
               for name, tid in _EXIF_STRING_TAGS if tags.get(name)]
    if not entries:
        return None
    n = len(entries)
    ifd_size = 2 + n * 12 + 4
    data_off = 8 + ifd_size
    tail = b""
    body = struct.pack("<H", n)
    for tid, val in entries:
        if len(val) <= 4:
            inline = val.ljust(4, b"\0")
            body += struct.pack("<HHI4s", tid, 2, len(val), inline)
        else:
            body += struct.pack("<HHII", tid, 2, len(val),
                                data_off + len(tail))
            tail += val
    body += struct.pack("<I", 0)                 # next-IFD offset
    tiff = b"II*\0" + struct.pack("<I", 8) + body + tail
    return b"Exif\0\0" + tiff


_XMP_NS = b"http://ns.adobe.com/xap/1.0/\0"


def build_xmp_app1(tags: Dict[str, str]) -> Optional[bytes]:
    desc = tags.get("description") or tags.get("comment") \
        or tags.get("title")
    if not desc:
        return None
    packet = (
        '<?xpacket begin="﻿" id="W5M0MpCehiHzreSzNTczkc9d"?>'
        '<x:xmpmeta xmlns:x="adobe:ns:meta/">'
        '<rdf:RDF xmlns:rdf='
        '"http://www.w3.org/1999/02/22-rdf-syntax-ns#">'
        '<rdf:Description rdf:about="" '
        'xmlns:dc="http://purl.org/dc/elements/1.1/">'
        '<dc:description>%s</dc:description>'
        '</rdf:Description></rdf:RDF></x:xmpmeta>'
        '<?xpacket end="w"?>' % desc)
    return _XMP_NS + packet.encode("utf-8")


# gstjifmux.c:483-496 — JFIF 1.2, density unit 0, aspect 0/1 x 0/1
_DEFAULT_JFIF = b"JFIF\0" + bytes([1, 2, 0, 0, 1, 0, 1, 0, 0])


@register_element
class JifMux(TransformElement):
    FACTORY = "jifmux"
    DESCRIPTION = "Remuxes JPEG images with markers and tags"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "image/jpeg"),
        PadTemplate("src", PadDirection.SRC, "image/jpeg"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._tags: Dict[str, str] = {}

    def start(self):
        self._tags = {}

    def sink_event(self, pad, event) -> bool:
        if getattr(event, "type", None) == "tag":
            tl = event.data.get("tags")
            if tl is not None:
                for k in ("comment", "description", "title", "artist",
                          "copyright", "datetime"):
                    v = tl.get(k)
                    if v is not None:
                        self._tags[k] = str(v)
        return super().sink_event(pad, event)

    def _mangle(self, blob: bytes) -> bytes:
        markers, scan, complete = walk_markers(blob)
        if not complete or scan is None:
            return blob
        # drop SOI/EOI bookkeeping; keep ordered payload segments
        segs = [(m, p) for m, off, p in markers if m not in (SOI, EOI)]
        jfif_i = exif_i = xmp_i = com_i = sof_i = None
        yuvish = False
        for i, (m, p) in enumerate(segs):
            if m == APP0 and p[:5] == b"JFIF\0":
                yuvish = True
                if jfif_i is None:
                    jfif_i = i
            elif m == APP1 and p[:6] in (b"EXIF\0\0", b"Exif\0\0"):
                if exif_i is None:
                    exif_i = i
            elif m == APP1 and p[:29] == _XMP_NS:
                if xmp_i is None:
                    xmp_i = i
            elif m == COM:
                if com_i is None:
                    com_i = i
            elif m in _SOF_MARKERS:
                if sof_i is None:
                    sof_i = i
                yuvish = yuvish or len(parse_sof(p)["components"]) in (1, 3)
        if jfif_i is None and yuvish:
            segs.insert(0, (APP0, _DEFAULT_JFIF))
            jfif_i = 0
            exif_i = exif_i + 1 if exif_i is not None else None
            xmp_i = xmp_i + 1 if xmp_i is not None else None
            com_i = com_i + 1 if com_i is not None else None
            sof_i = sof_i + 1 if sof_i is not None else None
        exif = build_exif_app1(self._tags)
        if exif is not None:
            if exif_i is not None:
                segs[exif_i] = (APP1, exif)
            else:
                at = (jfif_i + 1) if jfif_i is not None else 0
                segs.insert(at, (APP1, exif))
                exif_i = at
                xmp_i = xmp_i + 1 if xmp_i is not None \
                    and xmp_i >= at else xmp_i
                com_i = com_i + 1 if com_i is not None \
                    and com_i >= at else com_i
                sof_i = sof_i + 1 if sof_i is not None \
                    and sof_i >= at else sof_i
        xmp = build_xmp_app1(self._tags)
        if xmp is not None:
            if xmp_i is not None:
                segs[xmp_i] = (APP1, xmp)
            else:
                at = (exif_i + 1 if exif_i is not None else
                      (jfif_i + 1 if jfif_i is not None else 0))
                segs.insert(at, (APP1, xmp))
                com_i = com_i + 1 if com_i is not None \
                    and com_i >= at else com_i
                sof_i = sof_i + 1 if sof_i is not None \
                    and sof_i >= at else sof_i
        com = self._tags.get("comment") or self._tags.get("description") \
            or self._tags.get("title")
        if com:
            at = sof_i if sof_i is not None else len(segs)
            segs.insert(at, (COM, com.encode("utf-8") + b"\0"))
        out = bytearray(b"\xff\xd8")
        for m, p in segs:
            out += bytes([0xFF, m])
            if p or m not in _STANDALONE:
                out += struct.pack(">H", len(p) + 2) + p
        out += scan
        out += b"\xff\xd9"
        return bytes(out)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        blobs = buf.data if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        out = []
        for b in blobs:
            raw = bytes(b) if isinstance(b, (bytes, bytearray)) \
                else host_array(b).tobytes()
            out.append(np.frombuffer(self._mangle(raw), np.uint8))
        data = out[0] if len(out) == 1 and not isinstance(
            buf.data, (list, tuple)) else out
        return buf.with_(data=data)
