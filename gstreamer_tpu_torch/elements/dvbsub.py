"""DVB subtitles — dvbsubenc and dvbsuboverlay.

Reference: gst-plugins-bad/gst/dvbsubenc/ (gstdvbsubenc.c encodes an
AYUV overlay into ETSI EN 300 743 segment streams) and
gst-plugins-bad/gst/dvbsuboverlay/ (dvb-sub.c parses the segments,
gstdvbsuboverlay.c blends the regions over video).

Reduced profile, one region per display set, 4-bit/pixel code
strings (up to 16 palette colours):
* segments: page composition (0x10), region composition (0x11),
  CLUT definition (0x12), object data (0x13), end of display set
  (0x80), each framed sync(0x0F) type page_id len;
* the pixel-data RLE uses the EN 300 743 §7.2.5.2 4-bit forms
  (single pixel, colour-0 runs, 4..7 / 9..24 / 25..280 runs);
* CLUT entries carry Y, Cr, Cb, T; T=0 means opaque per the spec
  (transparency is inverted alpha).

A port of the JAX package's ``elements/dvbsub.py``.  The display sets stay
host bytes (dvbsuboverlay's text pad takes its source's bytes unstaged);
dvbsubenc reads a host copy of the first frame; dvbsuboverlay copies the
tick's planes to the host when it has a region to blend and moves them
back to the video's device in one copy, and passes the video's tensors as
they are otherwise.  dvbsubenc also takes the pipeline's AYUV component
planes, which the reference's reads as four frames of one plane
(ROADMAP.md section 3).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection,
                            PadTemplate, TransformElement,
                            register_element)

SYNC = 0x0F
SEG_PAGE = 0x10
SEG_REGION = 0x11
SEG_CLUT = 0x12
SEG_OBJECT = 0x13
SEG_END = 0x80


# ---------------------------------------------------------------------------
# 4-bit/pixel code strings (EN 300 743 §7.2.5.2)
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def put(self, value: int, n: int):
        for k in range(n - 1, -1, -1):
            self.bits.append((value >> k) & 1)

    def bytes_aligned(self) -> bytes:
        bits = self.bits + [0] * ((8 - len(self.bits) % 8) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _encode_4bit_row(row: np.ndarray) -> bytes:
    w = _BitWriter()
    n = len(row)
    x = 0
    while x < n:
        color = int(row[x])
        run = 1
        while x + run < n and row[x + run] == color:
            run += 1
        left = run
        while left > 0:
            if left >= 25:
                r = min(left, 280)
                w.put(0, 4)
                w.put(0b1111, 4)          # '11' + switch 3
                w.put(r - 25, 8)
                w.put(color, 4)
            elif left >= 9:
                r = min(left, 24)
                w.put(0, 4)
                w.put(0b1110, 4)          # '11' + switch 2
                w.put(r - 9, 4)
                w.put(color, 4)
            elif left >= 4 and left <= 7:
                r = left
                w.put(0, 4)
                w.put(0b10, 2)
                w.put(r - 4, 2)
                w.put(color, 4)
            elif left == 8:
                r = 7
                w.put(0, 4)
                w.put(0b10, 2)
                w.put(r - 4, 2)
                w.put(color, 4)
            elif color == 0 and left >= 3:
                r = left
                w.put(0, 4)
                w.put(0, 1)
                w.put(r - 2, 3)
            elif color == 0 and left == 2:
                r = 2
                w.put(0, 4)
                w.put(0b1101, 4)
            elif color == 0:
                r = 1
                w.put(0, 4)
                w.put(0b1100, 4)
            else:
                r = 1
                w.put(color, 4)
            left -= r
        x += run
    w.put(0, 4)
    w.put(0, 1)
    w.put(0, 3)                            # end of string
    return w.bytes_aligned()


def decode_4bit_string(data: bytes, width: int):
    """-> (row ndarray, bytes consumed)."""
    pos = 0          # bit position
    out = np.zeros(width, np.uint8)
    x = 0

    def bits(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        return v

    while True:
        v = bits(4)
        if v != 0:
            if x < width:
                out[x] = v
            x += 1
            continue
        if bits(1) == 0:
            r = bits(3)
            if r == 0:
                break                      # end of string
            run, color = r + 2, 0
        else:
            if bits(1) == 0:
                run = bits(2) + 4
                color = bits(4)
            else:
                sw = bits(2)
                if sw == 0:
                    run, color = 1, 0
                elif sw == 1:
                    run, color = 2, 0
                elif sw == 2:
                    run = bits(4) + 9
                    color = bits(4)
                else:
                    run = bits(8) + 25
                    color = bits(4)
        end = min(x + run, width)
        out[x:end] = color
        x += run
    return out, (pos + 7) >> 3


# ---------------------------------------------------------------------------
# Segment (de)framing
# ---------------------------------------------------------------------------

def _segment(seg_type: int, page_id: int, payload: bytes) -> bytes:
    return bytes([SYNC, seg_type]) + struct.pack(">HH", page_id,
                                                 len(payload)) \
        + payload


def encode_display_set(image: np.ndarray, palette, x: int, y: int,
                       page_id: int = 1) -> bytes:
    """AYUV palette-indexed image -> one DVB display set.

    image: (h, w) palette indices (0 = transparent by convention);
    palette: list of (A, Y, Cb, Cr)."""
    h, w = image.shape
    region_id, clut_id, object_id = 0, 0, 0
    # page composition: timeout, version/state, region block
    page = bytes([30, (0 << 4) | (0x2 << 2)])      # mode change
    page += bytes([region_id, 0]) + struct.pack(">HH", x, y)
    segs = _segment(SEG_PAGE, page_id, page)
    # region composition
    reg = bytes([region_id, (0 << 4) | 0x08])      # version, fill
    reg += struct.pack(">HH", w, h)
    reg += bytes([(0x2 << 5) | (0x1 << 2), clut_id, 0, 0x3 << 2])
    reg += struct.pack(">H", object_id)
    reg += bytes([0x00 << 6]) + b"\x00\x00\x00"    # pos 0,0
    segs += _segment(SEG_REGION, page_id, reg[:len(reg) - 0])
    # CLUT definition (4-bit entries, full range)
    clut = bytes([clut_id, 0])
    for k, (a, yy, cb, cr) in enumerate(palette):
        clut += bytes([k, 0x2 << 5 | 0x1,          # 4-bit, full range
                       yy, cr, cb, 255 - a])       # T = 255 - alpha
    segs += _segment(SEG_CLUT, page_id, clut)
    # object data: top field = even lines, bottom = odd lines
    top = b"".join(bytes([0x11]) + _encode_4bit_row(image[r])
                   for r in range(0, h, 2))
    bot = b"".join(bytes([0x11]) + _encode_4bit_row(image[r])
                   for r in range(1, h, 2))
    obj = struct.pack(">H", object_id) + bytes([0])
    obj += struct.pack(">HH", len(top), len(bot)) + top + bot
    segs += _segment(SEG_OBJECT, page_id, obj)
    segs += _segment(SEG_END, page_id, b"")
    return segs


def decode_display_set(data: bytes):
    """DVB segment stream -> dict(x, y, image (h,w,4) AYUV) or None."""
    pos = 0
    page_region: Optional[Tuple[int, int]] = None
    region_size = None
    clut: Dict[int, Tuple[int, int, int, int]] = {}
    top = bot = b""
    while pos + 6 <= len(data):
        if data[pos] != SYNC:
            break
        seg_type = data[pos + 1]
        _page_id, length = struct.unpack(">HH", data[pos + 2:pos + 6])
        payload = data[pos + 6:pos + 6 + length]
        pos += 6 + length
        if seg_type == SEG_PAGE and len(payload) >= 8:
            page_region = struct.unpack(">HH", payload[4:8])
        elif seg_type == SEG_REGION and len(payload) >= 6:
            region_size = struct.unpack(">HH", payload[2:6])
        elif seg_type == SEG_CLUT:
            p = 2
            while p + 6 <= len(payload):
                k = payload[p]
                yy, cr, cb, t = payload[p + 2:p + 6]
                clut[k] = (255 - t, yy, cb, cr)
                p += 6
        elif seg_type == SEG_OBJECT and len(payload) >= 7:
            tl, bl = struct.unpack(">HH", payload[3:7])
            body = payload[7:]
            top = body[:tl]
            bot = body[tl:tl + bl]
        elif seg_type == SEG_END:
            break
    if region_size is None or page_region is None:
        return None
    w, h = region_size

    def field_rows(blob):
        rows = []
        p = 0
        while p < len(blob) and blob[p] == 0x11:
            row, used = decode_4bit_string(blob[p + 1:], w)
            rows.append(row)
            p += 1 + used
        return rows

    trows = field_rows(top)
    brows = field_rows(bot)
    idx = np.zeros((h, w), np.uint8)
    for r in range(0, h, 2):
        if r // 2 < len(trows):
            idx[r] = trows[r // 2]
    for r in range(1, h, 2):
        if r // 2 < len(brows):
            idx[r] = brows[r // 2]
    img = np.zeros((h, w, 4), np.uint8)
    for k, (a, yy, cb, cr) in clut.items():
        img[idx == k] = (a, yy, cb, cr)
    return {"x": page_region[0], "y": page_region[1], "image": img,
            "indices": idx}


# ---------------------------------------------------------------------------
# Elements
# ---------------------------------------------------------------------------

_DEFAULT_PALETTE = [(0, 16, 128, 128),       # 0: transparent
                    (255, 235, 128, 128),    # 1: white
                    (255, 16, 128, 128),     # 2: black
                    (255, 145, 54, 34)]      # 3: yellow-ish


@register_element
class DvbSubEnc(TransformElement):
    """dvbsubenc (gstdvbsubenc.c): AYUV overlay frames -> DVB
    subtitle display sets (subpicture/x-dvb)."""

    FACTORY = "dvbsubenc"
    DESCRIPTION = "DVB subtitle encoder"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format=AYUV"),
        PadTemplate("src", PadDirection.SRC, "subpicture/x-dvb"),
    ]
    PROPERTIES = {"x": (int, 0, "region x"), "y": (int, 0,
                                                   "region y")}

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            return Caps.from_string("subpicture/x-dvb")
        return Caps.from_string("video/x-raw, format=AYUV")

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        d = buf.data
        if isinstance(d, (tuple, list)):
            # the pipeline's AYUV component planes: the first frame's
            img = np.stack([host_array(p[0] if p.ndim == 3 else p)
                            for p in d])
        else:
            img = host_array(d)
            if img.ndim == 4:
                img = img[0]
        # (4, h, w) AYUV -> palette quantisation (exact-match greedy)
        a, yy, cb, cr = (img[k].astype(np.int32) for k in range(4))
        h, w = a.shape
        pixels = np.stack([a, yy, cb, cr], -1).reshape(-1, 4)
        palette: List[Tuple[int, int, int, int]] = [(0, 16, 128, 128)]
        idx = np.zeros(h * w, np.uint8)
        for i, p in enumerate(map(tuple, pixels)):
            if p[0] < 16:
                idx[i] = 0
                continue
            if p not in palette:
                if len(palette) >= 16:
                    # nearest existing colour
                    d = [sum((int(x) - int(yv)) ** 2
                             for x, yv in zip(p, q))
                         for q in palette]
                    idx[i] = int(np.argmin(d))
                    continue
                palette.append(p)
            idx[i] = palette.index(p)
        blob = encode_display_set(idx.reshape(h, w), palette,
                                  self.props["x"], self.props["y"])
        return buf.with_(data=np.frombuffer(blob, np.uint8), batch=1)


@register_element
class DvbSubOverlay(AggregatorElement):
    """dvbsuboverlay (gstdvbsuboverlay.c, reduced): parse
    subpicture/x-dvb display sets and alpha-blend the region over
    I420 video at its page position."""

    FACTORY = "dvbsuboverlay"
    DESCRIPTION = "Renders DVB subtitles on top of video"
    HOST_ELEMENT = True
    HOST_INPUT_PADS = ("text",)        # bytes; the video pad takes media
    PAD_TEMPLATES = [
        PadTemplate("video", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("text", PadDirection.SINK, "subpicture/x-dvb"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420"),
    ]
    PROPERTIES = {}

    def negotiate_output(self, in_caps, allowed):
        return in_caps.get("video")

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        video = ins.get("video")
        if video is None:
            return None
        sub = ins.get("text")
        if sub is None:
            return video
        spu = decode_display_set(
            np.asarray(host_array(sub.data), np.uint8).tobytes())
        if spu is None:
            return video
        planes = [np.array(host_array(p)) for p in video.data]
        img = spu["image"]
        a = img[..., 0].astype(np.float64) / 255.0
        x0, y0 = spu["x"], spu["y"]
        n = planes[0].shape[0] if planes[0].ndim == 3 else 1
        for k in range(n):
            Y = planes[0][k] if planes[0].ndim == 3 else planes[0]
            H, W = Y.shape
            h2 = min(img.shape[0], H - y0)
            w2 = min(img.shape[1], W - x0)
            if h2 <= 0 or w2 <= 0:
                continue
            reg = Y[y0:y0 + h2, x0:x0 + w2].astype(np.float64)
            Y[y0:y0 + h2, x0:x0 + w2] = np.clip(
                reg * (1 - a[:h2, :w2])
                + img[:h2, :w2, 1] * a[:h2, :w2], 0, 255
            ).astype(np.uint8)
            for pi, ci in ((1, 2), (2, 3)):
                Cp = planes[pi][k] if planes[pi].ndim == 3 \
                    else planes[pi]
                ah = a[:h2:2, :w2:2]
                sch = img[:h2:2, :w2:2, ci].astype(np.float64)
                cy0, cx0 = y0 // 2, x0 // 2
                ch2, cw2 = ah.shape
                regc = Cp[cy0:cy0 + ch2,
                          cx0:cx0 + cw2].astype(np.float64)
                Cp[cy0:cy0 + ch2, cx0:cx0 + cw2] = np.clip(
                    regc * (1 - ah) + sch * ah, 0, 255
                ).astype(np.uint8)
        return video.with_(data=device_planes(planes, video.data))
