"""Image codec elements: pngenc/pngdec, jpegenc/jpegdec.

Reference: gst-plugins-good/ext/libpng (gstpngenc.c, gstpngdec.c) and
ext/jpeg (gstjpegenc.c, gstjpegdec.c).  The codecs themselves are the
native implementations in gstreamer_tpu.codecs (PNG over zlib, baseline
JPEG with device-side DCT/IDCT matmuls).

Encoders emit one encoded image per frame (a list of byte blobs per
batch — multifilesink writes one file each, filesink concatenates).
Decoders take whole-image buffers (multifilesrc's one-file-per-buffer
convention, or an accumulated filesrc stream split on image signatures)
and negotiate their output caps by peeking at the upstream location,
like the other header-driven parsers here.

The JAX package's ``elements/image_codecs.py`` on torch: jpegdec decodes
the entropy of a buffer's images on the host, then runs the IDCT of all of
them in one call on the pipeline's device, where the planes stay (the
scans of a tick decode in parallel threads); jpegenc
transforms on the device and codes on the host; pngdec's planes go to the
device, pngenc's come to the host.  ``native_decodes`` counts the images
whose scan the native entropy coder decoded."""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

import torch

from ..codecs.jpeg import decode_entropy, decode_transform, jpeg_encode
from ..codecs.png import PNG_SIG, png_decode, png_encode
from ..core.buffer import Buffer, host_array
from ..device import resolve
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo


def _png_header(data: bytes):
    """(format, w, h) from IHDR without a full decode."""
    if bytes(data[:8]) != PNG_SIG:
        return None
    w, h = struct.unpack(">II", data[16:24])
    depth, ct = data[24], data[25]
    fmt = {0: "GRAY8", 2: "RGB", 6: "RGBA"}.get(ct)
    if depth != 8 or fmt is None:
        return None
    return fmt, w, h


def _jpeg_header(data: bytes):
    """(format, w, h) from the SOF0/1 marker."""
    data = bytes(data)
    if data[:2] != b"\xFF\xD8":
        return None
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker in (0xC0, 0xC1):
            payload = data[pos + 4:pos + 2 + length]
            _, h, w, nc = struct.unpack(">BHHB", payload[:6])
            if nc == 1:
                return "GRAY8", w, h
            samp = payload[7]
            return ("I420" if samp == 0x22 else "Y444"), w, h
        pos += 2 + length
    return None


def _peek_upstream(elem) -> Optional[bytes]:
    """Read the first image from a linked filesrc/multifilesrc."""
    pads = elem.sink_pads()
    if not pads or pads[0].peer is None:
        return None
    up = pads[0].peer.element
    peek = getattr(up, "preview_blob", None)
    if peek is not None:            # demuxers expose the first sample
        blob = peek()
        if blob:
            return blob
    loc = getattr(up, "props", {}).get("location", "")
    if not loc:
        return None
    if "%" in loc:
        loc = loc % getattr(up, "props", {}).get("index", 0)
    if not os.path.exists(loc):
        return None
    with open(loc, "rb") as f:
        return f.read()


def _blobs_of(buf: Buffer) -> List[bytes]:
    if isinstance(buf.data, list):
        return [b if isinstance(b, (bytes, bytearray))
                else host_array(b).tobytes() for b in buf.data]
    return [host_array(buf.data).tobytes()]


class _ImageDecBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PROPERTIES = {
        "framerate": (object, None, "output framerate hint"),
    }
    MIME = ""

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._peeked = None
        self._frame_idx = 0

    def _header_of(self, data):
        raise NotImplementedError

    def _decode(self, data):
        """-> (planes tuple, fmt, w, h)"""
        raise NotImplementedError

    def _decode_all(self, blobs):
        """-> one (planes tuple, fmt, w, h) a blob"""
        return [self._decode(b) for b in blobs]

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = None
            if self._peeked is None:
                self._peeked = _peek_upstream(self)
            if self._peeked is not None:
                hdr = self._header_of(self._peeked)
                if hdr:
                    fmt, w, h = hdr
                    res = Caps.from_string(
                        f"video/x-raw, format={fmt}, width={w}, "
                        f"height={h}, framerate=[0/1,2147483647/1]")
            if res is None:
                res = self.src_pads()[0].template_caps
        else:
            res = Caps.from_string(self.MIME)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(outcaps[0])

    def start(self):
        self._frame_idx = 0

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        frames = [planes for planes, _, _, _ in
                  self._decode_all(_blobs_of(buf))]
        if not frames:
            return None

        def stack(comp):
            if isinstance(comp[0], torch.Tensor):
                return torch.stack(comp)
            return torch.from_numpy(np.stack(comp)).to(resolve(self.device))
        data = tuple(stack([f[c] for f in frames])
                     for c in range(len(frames[0])))
        info = self._info
        fps = info.fps
        if fps and fps.num:
            pts = self._frame_idx * 1_000_000_000 * fps.denom // fps.num
            dur = 1_000_000_000 * fps.denom // fps.num
        else:
            pts, dur = buf.pts, buf.duration
        self._frame_idx += len(frames)
        return Buffer(data=data, pts=pts, duration=dur, batch=len(frames))


@register_element
class PngEnc(TransformElement):
    """pngenc (gstpngenc.c equivalent, native codec)."""
    FACTORY = "pngenc"
    DESCRIPTION = "Encode a video frame to a .png image"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format={ RGB, RGBA, GRAY8 }"),
        PadTemplate("src", PadDirection.SRC, "image/png"),
    ]
    PROPERTIES = {"compression-level": (int, 6, "zlib level 0-9")}

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("image/png") \
            if direction == PadDirection.SINK \
            else self.sink_pads()[0].template_caps
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        info = self._info
        planes = [host_array(p) for p in buf.data]
        out = []
        for k in range(buf.batch):
            if info.format == "GRAY8":
                img = planes[0][k]
            else:
                img = np.stack([p[k] for p in planes], axis=-1)
            out.append(png_encode(img, info.format,
                                  self.props["compression-level"]))
        return buf.with_(data=out)


@register_element
class PngDec(_ImageDecBase):
    """pngdec (gstpngdec.c equivalent, native codec)."""
    FACTORY = "pngdec"
    DESCRIPTION = "Decode a png video frame to a raw image"
    MIME = "image/png"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "image/png"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ RGB, RGBA, GRAY8 }"),
    ]

    def _header_of(self, data):
        return _png_header(data)

    def _decode(self, blob):
        fmt, img = png_decode(blob)
        if fmt == "GRAY8":
            planes = (img[..., 0],)
        else:
            planes = tuple(img[..., c] for c in range(img.shape[-1]))
        return planes, fmt, img.shape[1], img.shape[0]


@register_element
class JpegEnc(TransformElement):
    """jpegenc (gstjpegenc.c equivalent, native baseline codec with
    device-side DCT)."""
    FACTORY = "jpegenc"
    DESCRIPTION = "Encode images in the JPEG format"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format={ I420, Y444, GRAY8 }"),
        PadTemplate("src", PadDirection.SRC, "image/jpeg"),
    ]
    PROPERTIES = {"quality": (int, 85, "encoding quality 1-100")}

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("image/jpeg") \
            if direction == PadDirection.SINK \
            else self.sink_pads()[0].template_caps
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        info = self._info
        planes = buf.data
        sub = {"I420": "420", "Y444": "444", "GRAY8": "gray"}[info.format]
        out = []
        for k in range(buf.batch):
            if sub == "gray":
                frame = (planes[0][k],)
            else:
                frame = (planes[0][k], planes[1][k], planes[2][k])
            out.append(jpeg_encode(
                frame, info.width, info.height,
                quality=self.props["quality"],
                subsampling="420" if sub == "gray" else sub,
                device=self.device))
        return buf.with_(data=out)


@register_element
class JpegDec(_ImageDecBase):
    """jpegdec (gstjpegdec.c equivalent, native baseline codec with
    device-side IDCT)."""
    FACTORY = "jpegdec"
    DESCRIPTION = "Decode images from JPEG format"
    MIME = "image/jpeg"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "image/jpeg"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ I420, Y444, GRAY8 }"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.native_decodes = 0

    def _header_of(self, data):
        return _jpeg_header(data)

    def _decode_all(self, blobs):
        # one thread a scan: the native coder runs without the GIL (a
        # ctypes call releases it), so a tick's images decode in parallel
        workers = max(1, min(len(blobs), os.cpu_count() or 1))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            coded = list(pool.map(decode_entropy, blobs))
        self.native_decodes += sum(c.native for c in coded)
        out = []
        for planes, w, h, sub in decode_transform(coded, resolve(self.device)):
            fmt = {"gray": "GRAY8", "420": "I420", "444": "Y444"}[sub]
            # crop chroma planes to the caps' subsampled sizes
            if fmt == "I420":
                cw, ch = -(-w // 2), -(-h // 2)
                planes = (planes[0], planes[1][:ch, :cw],
                          planes[2][:ch, :cw])
            out.append((planes, fmt, w, h))
        return out