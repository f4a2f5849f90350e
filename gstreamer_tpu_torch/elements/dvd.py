"""DVD elements: dvdlpcmdec, dvdsubdec, dvdspu.

References: gst-plugins-ugly/gst/dvdlpcmdec/gstdvdlpcmdec.c (LPCM
audio with the DVD 20/24-bit sample packing), gst-plugins-ugly/gst/
dvdsub/gstdvdsubdec.c (SPU subpicture RLE + DCSQ control sequences),
gst-plugins-bad/gst/dvdspu/gstdvdspu.c (subpicture overlay onto
video).  Reduced: LPCM supports 16/24-bit 48/96 kHz; dvdsubdec
renders each SPU packet to one AYUV image; dvdspu alpha-blends that
image over I420 video (aggregator style).

A port of the JAX package's ``elements/dvd.py``.  dvdlpcmdec, dvdsubdec and
dvdsubparse take their source's host bytes unstaged; the decoded samples
and AYUV images go to the pipeline's device, dvdsubparse's packets stay
host bytes.  dvdspu copies the tick's planes and the subpicture to the
host, blends there and moves the planes back to the video's device in
one copy; without a subpicture it passes the video's tensors as they
are.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, device_array, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection,
                            PadTemplate, TransformElement,
                            register_element)
from ..device import resolve

# -- dvdlpcmdec --------------------------------------------------------------

_LPCM_RATES = {0: 48000, 1: 96000, 2: 44100, 3: 32000}


@register_element
class DvdLpcmDec(TransformElement):
    """dvdlpcmdec (gstdvdlpcmdec.c): DVD LPCM -> interleaved S16.

    audio/x-private1-lpcm buffers carry a 3-byte PES header remnant
    (frame count + first-access-unit pointer) then the 2 audio frame
    info bytes (quantization/frequency/channels + dynamic range);
    audio/x-lpcm relies on caps.  24-bit groups store two 16-bit MSB
    samples per channel followed by the packed LSBs (the DVD-Video
    sample layout)."""

    FACTORY = "dvdlpcmdec"
    DESCRIPTION = "Decode DVD LPCM frames into standard PCM"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-private1-lpcm; audio/x-lpcm"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=S16LE, layout=interleaved"),
    ]
    PROPERTIES = {}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._private1 = True
        self._rate = 48000
        self._channels = 2
        self._width = 16

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            return Caps.from_string(
                "audio/x-raw, format=S16LE, layout=interleaved")
        return Caps.from_string("audio/x-private1-lpcm; audio/x-lpcm")

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        self._private1 = s.name == "audio/x-private1-lpcm"
        if s.get("rate"):
            self._rate = int(s.get("rate"))
        if s.get("channels"):
            self._channels = int(s.get("channels"))
        if s.get("width"):
            self._width = int(s.get("width"))

    def _parse_header(self, data: bytes) -> bytes:
        """Consume the private1 header; update stream params."""
        if not self._private1:
            return data
        # frame-count byte + 2-byte first access unit pointer
        info = data[3]
        dyn = data[4]
        del dyn
        quant = info >> 6
        self._width = {0: 16, 1: 20, 2: 24}.get(quant, 16)
        self._rate = _LPCM_RATES[(info >> 4) & 0x3]
        self._channels = (info & 0x7) + 1
        return data[5:]

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        raw = np.asarray(host_array(buf.data), np.uint8).tobytes()
        raw = self._parse_header(raw)
        ch = self._channels
        if self._width == 16:
            n = len(raw) // (2 * ch) * (2 * ch)
            samples = np.frombuffer(raw[:n], ">i2").astype(np.int16)
            pcm = samples.reshape(-1, ch)
        elif self._width == 24:
            # group: 2 samples x ch of 16 MSBs, then 2*ch LSB bytes
            group = 6 * ch
            n = len(raw) // group * group
            g = np.frombuffer(raw[:n], np.uint8).reshape(-1, group)
            msb = g[:, :4 * ch].copy().view(">i2").astype(np.int32)
            lsb = g[:, 4 * ch:].astype(np.int32)
            full = (msb << 8) | lsb
            # two interleaved sample rows per group
            pcm24 = full.reshape(-1, 2, ch).reshape(-1, ch)
            pcm = (pcm24 >> 8).astype(np.int16)
        else:
            raise ValueError(f"dvdlpcmdec: width {self._width} "
                             "not supported")
        return buf.with_(data=device_array(pcm, resolve(self.device)),
                         batch=1)


# -- dvdsubdec ---------------------------------------------------------------

# default CLUT: 4 grey levels in YUV
_DEFAULT_CLUT = [(16, 128, 128), (235, 128, 128),
                 (128, 128, 128), (80, 128, 128)]


def _parse_rle_line(data: bytes, nib_off: int, width: int):
    """One SPU RLE line starting at nibble offset; returns (colors,
    next nibble offset).  Nibble codes grow 4->16 bits; run 0 fills
    the rest of the line (gstdvdsubdec.c gst_dvd_sub_dec_parse_rle)."""

    def nibble(k):
        b = data[k >> 1]
        return (b >> 4) if (k & 1) == 0 else (b & 0xF)

    out = np.zeros(width, np.uint8)
    x = 0
    k = nib_off
    while x < width:
        v = nibble(k)
        k += 1
        if v < 0x4:
            v = (v << 4) | nibble(k)
            k += 1
            if v < 0x10:
                v = (v << 4) | nibble(k)
                k += 1
                if v < 0x40:
                    v = (v << 4) | nibble(k)
                    k += 1
        run = v >> 2
        color = v & 0x3
        if run == 0:
            run = width - x
        run = min(run, width - x)
        out[x:x + run] = color
        x += run
    if k & 1:
        k += 1          # byte-align at end of line
    return out, k


def decode_spu(packet: bytes, clut=None):
    """Decode one SPU packet -> dict(x, y, image AYUV (h, w, 4)) or
    None for a stop-display packet (gstdvdsubdec.c control parse)."""
    clut = clut or _DEFAULT_CLUT
    if len(packet) < 4:
        return None
    size, ctrl_off = struct.unpack(">HH", packet[:4])
    size = min(size, len(packet))
    palette = [0, 1, 2, 3]
    alpha = [0, 15, 15, 15]
    area = (0, 0, 0, 0)
    top_off = bot_off = 0
    display = False
    pos = ctrl_off
    prev = -1
    while 0 <= pos < size and pos != prev:
        prev = pos
        _delay, next_off = struct.unpack(">HH", packet[pos:pos + 4])
        p = pos + 4
        while p < size:
            cmd = packet[p]
            p += 1
            if cmd == 0x00:            # forced start
                display = True
            elif cmd == 0x01:          # start display
                display = True
            elif cmd == 0x02:          # stop display
                display = False
            elif cmd == 0x03:          # SET_COLOR
                b0, b1 = packet[p], packet[p + 1]
                palette = [b1 & 0xF, b1 >> 4, b0 & 0xF, b0 >> 4]
                p += 2
            elif cmd == 0x04:          # SET_CONTR (alpha)
                b0, b1 = packet[p], packet[p + 1]
                alpha = [b1 & 0xF, b1 >> 4, b0 & 0xF, b0 >> 4]
                p += 2
            elif cmd == 0x05:          # SET_DAREA
                b = packet[p:p + 6]
                sx = (b[0] << 4) | (b[1] >> 4)
                ex = ((b[1] & 0xF) << 8) | b[2]
                sy = (b[3] << 4) | (b[4] >> 4)
                ey = ((b[4] & 0xF) << 8) | b[5]
                area = (sx, sy, ex, ey)
                p += 6
            elif cmd == 0x06:          # SET_DSPXA
                top_off, bot_off = struct.unpack(">HH",
                                                 packet[p:p + 4])
                p += 4
            elif cmd == 0xFF:
                break
            else:
                break
        if next_off == pos:
            break
        pos = next_off
    if not display or area[2] <= area[0] or area[3] <= area[1]:
        return None
    sx, sy, ex, ey = area
    w = ex - sx + 1
    h = ey - sy + 1
    idx = np.zeros((h, w), np.uint8)
    k_top = top_off * 2
    k_bot = bot_off * 2
    for row in range(h):
        if row % 2 == 0:
            idx[row], k_top = _parse_rle_line(packet, k_top, w)
        else:
            idx[row], k_bot = _parse_rle_line(packet, k_bot, w)
    # palette index -> AYUV via CLUT + contrast nibbles
    img = np.zeros((h, w, 4), np.uint8)
    for c in range(4):
        mask = idx == c
        y, u, v = clut[palette[c] & 0x3] if palette[c] < 4 \
            else clut[palette[c] % 4]
        a = alpha[c] * 17          # 0..15 -> 0..255
        img[mask] = (a, y, u, v)
    return {"x": sx, "y": sy, "image": img}


@register_element
class DvdSubDec(TransformElement):
    """dvdsubdec (gstdvdsubdec.c): subpicture-unit packets -> AYUV
    overlay images (one buffer per displayed SPU)."""

    FACTORY = "dvdsubdec"
    DESCRIPTION = "Decodes DVD subtitles into AYUV video frames"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "subpicture/x-dvd"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=AYUV"),
    ]
    PROPERTIES = {}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.last_region: Optional[Tuple[int, int]] = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            return Caps.from_string("video/x-raw, format=AYUV")
        return Caps.from_string("subpicture/x-dvd")

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        pkt = np.asarray(host_array(buf.data), np.uint8).tobytes()
        spu = decode_spu(pkt)
        if spu is None:
            return None
        self.last_region = (spu["x"], spu["y"])
        img = spu["image"]            # (h, w, 4) AYUV
        return buf.with_(data=device_array(np.transpose(img, (2, 0, 1))[None],
                                           resolve(self.device)),
                         batch=1)


# -- dvdspu ------------------------------------------------------------------

@register_element
class DvdSpu(AggregatorElement):
    """dvdspu (gstdvdspu.c, reduced): alpha-blend the subpicture
    stream (AYUV images from dvdsubdec, positioned via its
    last_region or centered) over I420 video."""

    FACTORY = "dvdspu"
    DESCRIPTION = "Parses subpicture and blends it on video"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("video", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("subpicture", PadDirection.SINK,
                    "video/x-raw, format=AYUV"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420"),
    ]
    PROPERTIES = {"x": (int, -1, "overlay x (-1 = centered)"),
                  "y": (int, -1, "overlay y (-1 = bottom)")}

    def negotiate_output(self, in_caps, allowed):
        return in_caps.get("video")

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        video = ins.get("video")
        if video is None:
            return None
        sub = ins.get("subpicture")
        if sub is None:
            return video
        planes = [np.array(host_array(p)) for p in video.data]
        simg = host_array(sub.data)
        if simg.ndim == 4:
            simg = simg[0]             # (4, h, w)
        a = simg[0].astype(np.float64) / 255.0
        sy_, su_, sv_ = simg[1], simg[2], simg[3]
        for k in range(planes[0].shape[0] if planes[0].ndim == 3
                       else 1):
            Y = planes[0][k] if planes[0].ndim == 3 else planes[0]
            H, W = Y.shape
            h, w = a.shape
            x0 = self.props["x"]
            y0 = self.props["y"]
            if x0 < 0:
                x0 = max(0, (W - w) // 2)
            if y0 < 0:
                y0 = max(0, H - h - H // 10)
            h2 = min(h, H - y0)
            w2 = min(w, W - x0)
            if h2 <= 0 or w2 <= 0:
                continue
            reg = Y[y0:y0 + h2, x0:x0 + w2].astype(np.float64)
            Y[y0:y0 + h2, x0:x0 + w2] = np.clip(
                reg * (1 - a[:h2, :w2]) + sy_[:h2, :w2]
                * a[:h2, :w2], 0, 255).astype(np.uint8)
            # chroma at half resolution
            for pi, sc in ((1, su_), (2, sv_)):
                Cp = planes[pi][k] if planes[pi].ndim == 3 \
                    else planes[pi]
                ah = a[:h2:2, :w2:2]
                sch = sc[:h2:2, :w2:2].astype(np.float64)
                cy0, cx0 = y0 // 2, x0 // 2
                ch2, cw2 = ah.shape
                regc = Cp[cy0:cy0 + ch2,
                          cx0:cx0 + cw2].astype(np.float64)
                Cp[cy0:cy0 + ch2, cx0:cx0 + cw2] = np.clip(
                    regc * (1 - ah) + sch * ah, 0, 255
                ).astype(np.uint8)
        return video.with_(data=device_planes(planes, video.data))


@register_element
class DvdSubParse(TransformElement):
    """dvdsubparse (gst-plugins-ugly/gst/dvdsub/gstdvdsubparse.c):
    accumulate subpicture/x-dvd fragments into complete SPU packets.
    The first two bytes of an SPU packet give its total size; output
    buffers are whole packets with parsed=true caps."""
    FACTORY = "dvdsubparse"
    DESCRIPTION = "Parses and packetizes DVD subtitle streams"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "subpicture/x-dvd"),
        PadTemplate("src", PadDirection.SRC,
                    "subpicture/x-dvd, parsed=(boolean)true"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._acc = b""
        self._pts = None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "subpicture/x-dvd, parsed=(boolean)true"
            if direction == PadDirection.SINK else "subpicture/x-dvd")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._acc = b""
        self._pts = None

    def host_process(self, buf):
        if buf is None:
            return None
        d = buf.data
        raw = (b"".join(host_array(x).tobytes() for x in d)
               if isinstance(d, (tuple, list))
               else (bytes(d) if isinstance(d, (bytes, bytearray))
                     else host_array(d).tobytes()))
        if not self._acc:
            self._pts = buf.pts
        self._acc += raw
        pkts = []
        while len(self._acc) >= 2:
            size = (self._acc[0] << 8) | self._acc[1]
            if size == 0 or len(self._acc) < size:
                break
            pkts.append(self._acc[:size])
            self._acc = self._acc[size:]
        if not pkts:
            return None
        out = buf.with_(data=[np.frombuffer(p, np.uint8) for p in pkts],
                        pts=self._pts)
        self._pts = None
        return out
