"""Small format elements: pnmenc/pnmdec, auparse/auenc (Sun AU),
aiffparse/aiffmux.

References:
* gst-plugins-bad/gst/pnm/ — netpbm P4/P5/P6 (raw bitmap/gray/RGB)
  and the P1-P3 ASCII variants on the decode side.
* gst-plugins-good/gst/auparse/gstauparse.c — ".snd" header
  (offset/size/encoding/rate/channels BE), encodings 1 = G.711 mu-law,
  27 = A-law, 2 = S8, 3 = S16BE, 6 = F32BE (:262-345).  The writer
  (auenc analog; the reference pairs auparse with external writers)
  emits the same header.
* gst-plugins-bad/gst/aiff/ — FORM/AIFF with COMM (channels, frames,
  bits, 80-bit IEEE extended sample rate) and SSND chunks, big-endian
  PCM payload.

All three collapse to the established location-based source/sink
conventions (wavparse/wavenc precedent).

A port of the JAX package's ``elements/simple_formats.py``.  pnmenc copies the
tick's planes to the host and gives host bytes; pnmdec takes its source's
host bytes unstaged and moves the decoded planes to the pipeline's device
in one copy; the parsers are sources whose host arrays the pipeline
stages; the writers copy each tick's samples to the host.
"""

from __future__ import annotations

import math
import struct
from typing import List, Optional

import numpy as np

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, TransformElement,
                            register_element)
from ..device import resolve
from ..video.info import VideoInfo

# ---------------------------------------------------------------------------
# PNM
# ---------------------------------------------------------------------------


def pnm_encode(planes, fmt: str) -> bytes:
    """(R,G,B)|(GRAY,) uint8 planes -> raw PPM/PGM bytes."""
    if fmt == "RGB":
        r, g, b = planes[:3]
        h, w = r.shape
        body = np.stack([r, g, b], -1).astype(np.uint8).tobytes()
        return f"P6\n{w} {h}\n255\n".encode() + body
    g = planes[0]
    h, w = g.shape
    return f"P5\n{w} {h}\n255\n".encode() + g.astype(
        np.uint8).tobytes()


def pnm_decode(data: bytes):
    """-> ((h,w[,3]) array, 'RGB'|'GRAY8')."""
    if data[:1] != b"P" or len(data) < 2:
        raise ValueError("pnm: bad magic")
    kind = int(chr(data[1]))
    pos = 2

    def token():
        nonlocal pos
        while pos < len(data):
            c = data[pos:pos + 1]
            if c == b"#":
                nl = data.find(b"\n", pos)
                pos = nl + 1 if nl >= 0 else len(data)
            elif c.isspace():
                pos += 1
            else:
                break
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        return data[start:pos]

    w = int(token())
    h = int(token())
    maxval = 1 if kind in (1, 4) else int(token())
    if kind in (1, 2, 3):                      # ASCII
        vals = []
        need = w * h * (3 if kind == 3 else 1)
        while len(vals) < need:
            vals.append(int(token()))
        arr = np.array(vals, np.int64)
    elif kind == 4:                            # raw bitmap
        pos += 1
        rowbytes = (w + 7) // 8
        bits = np.unpackbits(np.frombuffer(
            data[pos:pos + rowbytes * h], np.uint8).reshape(h, rowbytes),
            axis=1)[:, :w]
        arr = bits.astype(np.int64).ravel()
    else:                                      # raw P5/P6
        pos += 1
        need = w * h * (3 if kind == 6 else 1)
        arr = np.frombuffer(data[pos:pos + need], np.uint8) \
            .astype(np.int64)
    if maxval != 255 and kind not in (1, 4):
        arr = arr * 255 // maxval
    elif kind in (1, 4):
        arr = (1 - arr) * 255                  # PBM: 1 = black
    if kind in (3, 6):
        return arr.reshape(h, w, 3).astype(np.uint8), "RGB"
    return arr.reshape(h, w).astype(np.uint8), "GRAY8"


@register_element
class PnmEnc(TransformElement):
    FACTORY = "pnmenc"
    DESCRIPTION = "Encodes images into portable pixmap or graymap " \
                  "(PNM) format"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format={ RGB, GRAY8 }"),
        PadTemplate("src", PadDirection.SRC, "image/pnm"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("image/pnm")
               if direction == PadDirection.SINK
               else self.sink_pads()[0].template_caps)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        planes = [host_array(p) for p in (
            buf.data if isinstance(buf.data, (list, tuple))
            else [buf.data])]
        batch = planes[0].shape[0]
        fmt = self._info.format
        blobs = [pnm_encode([p[k] for p in planes], fmt)
                 for k in range(batch)]
        return buf.with_(data=blobs)


@register_element
class PnmDec(TransformElement):
    FACTORY = "pnmdec"
    DESCRIPTION = "Decodes images in portable pixmap/graymap/bitmap " \
                  "(PNM) format"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "image/pnm"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ RGB, GRAY8 }"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = self.src_pads()[0].template_caps
            peek = None
            pads = self.sink_pads()
            if pads and pads[0].peer is not None:
                up = pads[0].peer.element
                pb = getattr(up, "preview_blob", None)
                if pb:
                    peek = pb()
                else:
                    loc = getattr(up, "props", {}).get("location", "")
                    if loc:
                        try:
                            peek = open(loc, "rb").read()
                        except OSError:
                            peek = None
            if peek:
                try:
                    arr, fmt = pnm_decode(peek)
                    h, w = arr.shape[:2]
                    res = Caps.from_string(
                        f"video/x-raw, format={fmt}, width={w}, "
                        f"height={h}, framerate=[0/1,2147483647/1]")
                except ValueError:
                    pass
        else:
            res = Caps.from_string("image/pnm")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        # dimensions may be unknown until the first decoded image
        # (mid-pipeline pnmenc ! pnmdec); frames carry their own shape
        pass

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        blobs = buf.data if isinstance(buf.data, list) else [buf.data]
        frames = []
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            arr, fmt = pnm_decode(raw)
            frames.append(arr)
        arr = np.stack(frames)
        if arr.ndim == 4:                      # RGB
            data = tuple(arr[..., c] for c in range(3))
        else:
            data = (arr,)
        data = device_planes(data, resolve(self.device))
        return Buffer(data=data, pts=buf.pts, duration=buf.duration,
                      batch=len(frames))


# ---------------------------------------------------------------------------
# Sun AU
# ---------------------------------------------------------------------------

_AU_ENCODINGS = {1: ("audio/x-mulaw", None), 27: ("audio/x-alaw", None),
                 2: ("audio/x-raw", "S8"), 3: ("audio/x-raw", "S16BE"),
                 6: ("audio/x-raw", "F32BE")}
_AU_FROM_FMT = {"S8": 2, "S16BE": 3, "F32BE": 6}


@register_element
class AuParse(SourceElement):
    """auparse (gstauparse.c, pull-mode collapse)."""
    FACTORY = "auparse"
    DESCRIPTION = "Parse an .au file into raw audio"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"location": (str, "", ".au file path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._payload = None
        self._done = False

    def _load(self):
        if self._payload is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        if data[:4] != b".snd":
            raise ValueError("auparse: bad magic")
        offset, size, enc, rate, channels = struct.unpack(
            ">IIIII", data[4:24])
        if enc not in _AU_ENCODINGS:
            raise ValueError(f"auparse: unsupported encoding {enc}")
        mt, fmt = _AU_ENCODINGS[enc]
        self._rate, self._channels = rate, channels
        payload = data[offset:offset + size if size != 0xFFFFFFFF
                       else len(data)]
        if mt == "audio/x-raw":
            self._caps = Caps([AudioInfo(
                format=fmt, rate=rate,
                channels=channels).to_caps_structure()])
            from ..audio import format as afmt
            info = AudioInfo(format=fmt, rate=rate, channels=channels)
            arr = afmt.from_bytes(info.finfo,
                                  np.frombuffer(payload, np.uint8),
                                  channels)
            if arr.dtype.byteorder == ">":
                arr = arr.astype(arr.dtype.newbyteorder("="))
            self._payload = arr
        else:
            self._caps = Caps.from_string(
                f"{mt}, rate={rate}, channels={channels}")
            self._payload = np.frombuffer(
                payload, np.uint8).reshape(-1, channels)

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        caps = self._caps if self._payload is not None else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._done = False

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._done:
            return None
        self._done = True
        return Buffer(data=self._payload, batch=1,
                      duration=len(self._payload) * 1_000_000_000
                      // self._rate)


@register_element
class AuEnc(SinkElement):
    """Sun AU writer (the header format of gstauparse.c, inverted)."""
    FACTORY = "auenc"
    DESCRIPTION = "Encode audio into the Sun AU format"
    PAD_TEMPLATES = [PadTemplate(
        "sink", PadDirection.SINK,
        "audio/x-raw, format={ S8, S16BE }, layout=interleaved; "
        "audio/x-mulaw; audio/x-alaw")]
    PROPERTIES = {"location": (str, "out.au", "output path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._chunks: List[bytes] = []

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        self._mt = s.name
        self._rate = s["rate"]
        self._channels = s["channels"]
        if self._mt == "audio/x-raw":
            self._ainfo = AudioInfo.from_caps_structure(s)
            self._enc = _AU_FROM_FMT[self._ainfo.format]
        else:
            self._enc = 1 if self._mt == "audio/x-mulaw" else 27

    def start(self):
        self._chunks = []

    def render(self, buf: Buffer) -> str:
        x = host_array(buf.data)
        if self._mt == "audio/x-raw":
            from ..audio import format as afmt
            self._chunks.append(
                afmt.to_bytes(self._ainfo.finfo, x).tobytes())
        else:
            self._chunks.append(x.astype(np.uint8).tobytes())
        return "ok"

    def stop(self):
        if not self._chunks:
            return
        payload = b"".join(self._chunks)
        hdr = b".snd" + struct.pack(
            ">IIIII", 24, len(payload), self._enc, self._rate,
            self._channels)
        with open(self.props["location"], "wb") as f:
            f.write(hdr + payload)
        self._chunks = []


# ---------------------------------------------------------------------------
# AIFF
# ---------------------------------------------------------------------------

def _float80_encode(v: float) -> bytes:
    """IEEE 754 extended 80-bit (AIFF sample rate field)."""
    if v == 0:
        return b"\0" * 10
    sign = 0
    if v < 0:
        sign = 0x8000
        v = -v
    m, e = math.frexp(v)
    exp = e - 1 + 16383
    mant = int(m * (1 << 64))
    return struct.pack(">HQ", sign | exp, mant)


def _float80_decode(b: bytes) -> float:
    se, mant = struct.unpack(">HQ", b[:10])
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    v = mant / float(1 << 64) * 2.0 ** (exp - 16383 + 1)
    return -v if se & 0x8000 else v


@register_element
class AiffMux(SinkElement):
    """aiffmux (gst-plugins-bad/gst/aiff/aiffmux.c)."""
    FACTORY = "aiffmux"
    DESCRIPTION = "Multiplex raw audio into AIFF"
    PAD_TEMPLATES = [PadTemplate(
        "sink", PadDirection.SINK,
        "audio/x-raw, format={ S8, S16BE, S24BE, S32BE }, "
        "layout=interleaved")]
    PROPERTIES = {"location": (str, "out.aiff", "output path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._chunks: List[bytes] = []

    def set_info(self, incaps, outcaps):
        self._ainfo = AudioInfo.from_caps_structure(incaps[0])

    def start(self):
        self._chunks = []

    def render(self, buf: Buffer) -> str:
        from ..audio import format as afmt
        x = host_array(buf.data)
        self._chunks.append(
            afmt.to_bytes(self._ainfo.finfo, x).tobytes())
        return "ok"

    def stop(self):
        if not self._chunks:
            return
        ai = self._ainfo
        payload = b"".join(self._chunks)
        bits = ai.finfo.width
        frames = len(payload) // (ai.channels * (bits // 8))
        comm = (struct.pack(">hIh", ai.channels, frames, bits)
                + _float80_encode(float(ai.rate)))
        ssnd = struct.pack(">II", 0, 0) + payload
        body = (b"AIFF"
                + b"COMM" + struct.pack(">I", len(comm)) + comm
                + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
        with open(self.props["location"], "wb") as f:
            f.write(b"FORM" + struct.pack(">I", len(body)) + body)
        self._chunks = []


@register_element
class AiffParse(SourceElement):
    """aiffparse (pull-mode collapse)."""
    FACTORY = "aiffparse"
    DESCRIPTION = "Parse a .aiff file into raw audio"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"location": (str, "", "aiff file path"),
                  "blocksize": (int, 4096, "frames per buffer")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._samples = None
        self._pos = 0

    def _load(self):
        if self._samples is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
            raise ValueError("aiffparse: bad FORM header")
        pos = 12
        comm = ssnd = None
        while pos + 8 <= len(data):
            tag = data[pos:pos + 4]
            size = struct.unpack(">I", data[pos + 4:pos + 8])[0]
            body = data[pos + 8:pos + 8 + size]
            if tag == b"COMM":
                comm = body
            elif tag == b"SSND":
                off = struct.unpack(">I", body[:4])[0]
                ssnd = body[8 + off:]
            pos += 8 + size + (size & 1)
        if comm is None or ssnd is None:
            raise ValueError("aiffparse: missing COMM/SSND")
        channels, frames, bits = struct.unpack(">hIh", comm[:8])
        rate = int(round(_float80_decode(comm[8:18])))
        fmt = {8: "S8", 16: "S16BE", 24: "S24BE", 32: "S32BE"}[bits]
        info = AudioInfo(format=fmt, rate=rate, channels=channels)
        from ..audio import format as afmt
        arr = afmt.from_bytes(info.finfo,
                              np.frombuffer(ssnd, np.uint8), channels)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("="))
        self._samples = arr[:frames]
        self._ainfo = info

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError, KeyError):
                return Caps.any()
        caps = (Caps([self._ainfo.to_caps_structure()])
                if self._samples is not None else Caps.any())
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._samples):
            return None
        take = self.props["blocksize"]
        chunk = self._samples[self._pos:self._pos + take]
        rate = self._ainfo.rate
        pts = self._pos * 1_000_000_000 // rate
        self._pos += len(chunk)
        return Buffer(data=chunk, batch=1, pts=pts,
                      duration=len(chunk) * 1_000_000_000 // rate)
