"""xingmux — add a Xing VBR header to MP3 streams.

Port of gst-plugins-good/gst/xingmux/gstxingmux.c: buffers the framed
MP3 stream (mpegaudioparse output), then emits a Xing header frame
followed by the music frames.  The header frame reuses the stream's
first frame header with the smallest bitrate whose frame fits
4 + xing_offset + 16 + 100 bytes (:274-285), xing_offset = 32/17
(MPEG1 stereo/mono) or 17/9 (MPEG2) side-info sizes, and carries the
FRAMES (+1 for the header frame itself), BYTES and 100-entry TOC
fields (:321-383).  Existing Xing/Info/VBRI header frames at the
stream start are dropped (:243-252).

A port of the JAX package's ``elements/xingmux.py``: it takes the frames as
host bytes and gives host bytes.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from .audioparsers import mp3_frame_info

FRAME_FIELD = 1
BYTES_FIELD = 2
TOC_FIELD = 4


def _xing_offset(hdr: bytes) -> int:
    ver_code = (hdr[1] >> 3) & 0x3
    mode = (hdr[3] >> 6) & 0x3
    if ver_code == 0b11:                 # MPEG1
        return 17 if mode == 3 else 32
    return 9 if mode == 3 else 17


def _spf(version: int, layer: int) -> int:
    if layer == 1:
        return 384
    if layer == 2 or version == 1:
        return 1152
    return 576


def generate_xing_frame(first_hdr: bytes, n_frames: int,
                        n_bytes: int, toc: Optional[bytes]) -> bytes:
    """Build the header frame (generate_xing_header :254-383)."""
    base = bytearray(first_hdr[:4])
    for bitrate in range(1, 0xF):
        base[2] = (base[2] & 0x0F) | (bitrate << 4)
        info = mp3_frame_info(bytes(base))
        if info is None:
            continue
        size = info[0]
        off = _xing_offset(bytes(base))
        if size >= 4 + off + 4 + 4 + 4 + 4 + 100:
            break
    else:
        raise ValueError("xingmux: no usable bitrate")
    frame = bytearray(size)
    frame[:4] = base
    pos = 4 + off
    frame[pos:pos + 4] = b"Xing"
    pos += 4
    flags = FRAME_FIELD | BYTES_FIELD | (TOC_FIELD if toc else 0)
    frame[pos:pos + 4] = struct.pack(">I", flags)
    pos += 4
    frame[pos:pos + 4] = struct.pack(">I", n_frames)
    pos += 4
    frame[pos:pos + 4] = struct.pack(">I", n_bytes)
    pos += 4
    if toc:
        frame[pos:pos + 100] = toc
    return bytes(frame)


@register_element
class XingMux(TransformElement):
    FACTORY = "xingmux"
    DESCRIPTION = "Adds a Xing header to the beginning of a VBR MP3 file"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/mpeg, mpegversion=1"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/mpeg, mpegversion=1"),
    ]

    _decouple = True

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frames: List[bytes] = []

    def start(self):
        self._frames = []

    @property
    def _pending_buf(self):
        return True if self._frames else None

    def set_info(self, incaps, outcaps):
        pass

    @staticmethod
    def _is_vbr_header(frame: bytes) -> bool:
        info = mp3_frame_info(frame[:4])
        if info is None:
            return False
        off = 4 + _xing_offset(frame[:4])
        return (frame[off:off + 4] in (b"Xing", b"Info")
                or frame[36:40] == b"VBRI")

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:                     # EOS: emit header + stream
            if not self._frames:
                return None
            first = self._frames[0]
            info = mp3_frame_info(first[:4])
            _, version, layer, rate, _ = info
            spf = _spf(version, layer)
            total_bytes = sum(len(f) for f in self._frames)
            n_frames = len(self._frames) + 1
            # duration-proportional TOC over the frame byte offsets
            offs = np.cumsum([0] + [len(f) for f in self._frames[:-1]])
            toc = bytearray(100)
            nf = len(self._frames)
            for percent in range(100):
                idx = min(nf - 1, (percent * nf) // 100)
                toc[percent] = min(255, int(offs[idx]) * 256
                                   // max(total_bytes, 1))
            hdr_frame = generate_xing_frame(
                first, n_frames, total_bytes + 0, bytes(toc))
            # BYTES counts the whole stream incl. the header frame
            hdr_frame = generate_xing_frame(
                first, n_frames, total_bytes + len(hdr_frame),
                bytes(toc))
            out = [hdr_frame] + self._frames
            self._frames = []
            return Buffer(data=[np.frombuffer(f, np.uint8)
                                for f in out], batch=len(out))
        if isinstance(buf.data, list):
            blobs = buf.data
        else:
            arr = host_array(buf.data)
            # equal-size frames arrive stacked along the batch axis
            blobs = ([arr[k] for k in range(arr.shape[0])]
                     if arr.ndim == 2 and buf.batch == arr.shape[0]
                     else [arr])
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            if not self._frames and self._is_vbr_header(raw):
                continue                   # drop existing VBR headers
            self._frames.append(raw)
        return None
