"""FLIC (.fli/.flc) animation decoder.

Port of gst-plugins-good/gst/flx/ (gstflxdec.c, flx_color.c):
* 128-byte header (size/magic/frames/width/height/depth/flags/speed),
  magics 0xAF11 (FLI), 0xAF12 (FLC);
* frame chunks (type 0xF1FA) containing subchunks:
  COLOR256(4)/COLOR64(11, 6-bit <<2 scale) palette packs,
  BRUN(15) byte-RLE keyframes (per-line, signed counts),
  LC/DELTA_FLI(12) line deltas (skip + signed RLE),
  SS2/DELTA_FLC(7) word deltas with 0xC000 line-skip and last-pixel
  opcodes, BLACK(13), COPY(16);
* 8-bit palette indices mapped through the running 768-byte palette
  (flx_colorspace_convert).

Returns per-frame (h, w) palette-index arrays + per-frame RGB
palettes so the element can emit RGB planes; the per-frame ms delay
comes from the header `speed`.

A copy of the JAX package's ``codecs/flic.py`` (host numpy), with one
difference: a COLOR256 / COLOR64 pack whose count byte is 0 holds 256
colours, and the port reads their 768 bytes (gstflxdec.c's
flx_decode_color); the JAX package reads none and raises ``ValueError`` on
such a pack, the usual full palette of a FLIC file (ROADMAP.md section 3).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

FLI_MAGIC = 0xAF11
FLC_MAGIC = 0xAF12

FRAME_TYPE = 0xF1FA
SS2 = 7
COLOR256 = 4
COLOR64 = 11
LC = 12
BLACK = 13
BRUN = 15
COPY = 16


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def u8(self):
        v = self.d[self.p]
        self.p += 1
        return v

    def s8(self):
        v = self.u8()
        return v - 256 if v >= 128 else v

    def u16(self):
        v = struct.unpack_from("<H", self.d, self.p)[0]
        self.p += 2
        return v

    def u32(self):
        v = struct.unpack_from("<I", self.d, self.p)[0]
        self.p += 4
        return v

    def bytes(self, n):
        v = self.d[self.p:self.p + n]
        if len(v) != n:
            raise ValueError("flx: truncated chunk")
        self.p += n
        return v


def _decode_color(r: _Reader, palette: np.ndarray, scale: int):
    packs = r.u16()
    for _ in range(packs):
        indx = r.u8()
        count = r.u8()
        actual = 256 if count == 0 else count
        data = np.frombuffer(r.bytes(actual * 3), np.uint8)
        vals = (data.astype(np.uint16) << scale).astype(np.uint8)
        palette[indx * 3:indx * 3 + actual * 3] = vals[:actual * 3]


def _decode_brun(r: _Reader, w: int, h: int) -> np.ndarray:
    out = np.zeros(h * w, np.uint8)
    pos = 0
    for _ in range(h):
        r.u8()                       # legacy packet count, unused
        row = w
        while row:
            count = r.s8()
            if count <= 0:
                count = -count
                if count > row:
                    raise ValueError("flx: BRUN literal overruns row")
                out[pos:pos + count] = np.frombuffer(
                    r.bytes(count), np.uint8)
            else:
                if count > row:
                    raise ValueError("flx: BRUN run overruns row")
                out[pos:pos + count] = r.u8()
            pos += count
            row -= count
    return out.reshape(h, w)


def _decode_delta_fli(r: _Reader, prev: np.ndarray) -> np.ndarray:
    h, w = prev.shape
    out = prev.copy().reshape(-1)
    start_line = r.u16()
    lines = r.u16()
    if start_line + lines > h:
        raise ValueError("flx: FLI delta too many lines")
    line_start = w * start_line
    for _ in range(lines):
        pos = line_start
        for _ in range(r.u8()):
            pos += r.u8()            # skip
            count = r.s8()
            if count < 0:            # note: inverted vs BRUN
                count = -count
                if pos - line_start + count > w:
                    raise ValueError("flx: FLI line too long")
                out[pos:pos + count] = r.u8()
            else:
                if pos - line_start + count > w:
                    raise ValueError("flx: FLI line too long")
                out[pos:pos + count] = np.frombuffer(
                    r.bytes(count), np.uint8)
            pos += count
        line_start += w
    return out.reshape(h, w)


def _decode_delta_flc(r: _Reader, prev: np.ndarray) -> np.ndarray:
    h, w = prev.shape
    out = prev.copy().reshape(-1)
    lines = r.u16()
    if lines > h:
        raise ValueError("flx: FLC delta too many lines")
    start_l = lines
    cur_line = 0
    while lines:
        pos = w * (start_l - lines)
        while True:
            opcode = r.u16()
            if (opcode & 0xC000) == 0:
                break
            if (opcode & 0xC000) == 0xC000:
                skip = 0x10000 - opcode
                if skip > h:
                    raise ValueError("flx: FLC skip too big")
                start_l += skip
                pos += w * skip
            else:                    # last-pixel opcode
                pos += w
                out[pos] = opcode & 0xFF
                pos += 1
        line_off = pos
        for _ in range(opcode):
            pos += r.u8()
            count = r.s8()
            if count < 0:            # replicate word run
                count = -count
                word = r.bytes(2)
                if (pos - line_off) + 2 * count > w:
                    raise ValueError("flx: FLC line too long")
                rep = np.frombuffer(word * count, np.uint8)
                out[pos:pos + 2 * count] = rep
                pos += 2 * count
            else:
                if (pos - line_off) + 2 * count > w:
                    raise ValueError("flx: FLC line too long")
                out[pos:pos + 2 * count] = np.frombuffer(
                    r.bytes(2 * count), np.uint8)
                pos += 2 * count
        lines -= 1
    return out.reshape(h, w)


def decode(data: bytes):
    """-> (frames [(h,w) uint8], palettes [(256,3) uint8],
    speed_ms, (w, h))."""
    if len(data) < 128:
        raise ValueError("flx: truncated header")
    size, magic, nframes, w, h, depth, flags, speed = struct.unpack_from(
        "<IHHHHHHI", data, 0)
    if magic not in (FLI_MAGIC, FLC_MAGIC):
        raise ValueError(f"flx: bad magic {magic:#x}")
    if magic == FLI_MAGIC:
        speed = speed * 1000 // 70   # FLI speed is in 1/70 s jiffies
    palette = np.zeros(768, np.uint8)
    frames: List[np.ndarray] = []
    palettes: List[np.ndarray] = []
    cur = np.zeros((h, w), np.uint8)
    pos = 128
    while pos + 6 <= len(data) and len(frames) < nframes:
        fsize, ftype = struct.unpack_from("<IH", data, pos)
        if ftype != FRAME_TYPE:
            pos += fsize + (fsize & 1)
            continue
        chunks = struct.unpack_from("<H", data, pos + 6)[0]
        cpos = pos + 16
        for _ in range(chunks):
            csize, ctype = struct.unpack_from("<IH", data, cpos)
            r = _Reader(data[cpos + 6:cpos + csize])
            if ctype == COLOR64:
                _decode_color(r, palette, 2)
            elif ctype == COLOR256:
                _decode_color(r, palette, 0)
            elif ctype == BRUN:
                cur = _decode_brun(r, w, h)
            elif ctype == LC:
                cur = _decode_delta_fli(r, cur)
            elif ctype == SS2:
                cur = _decode_delta_flc(r, cur)
            elif ctype == BLACK:
                cur = np.zeros((h, w), np.uint8)
            elif ctype == COPY:
                cur = np.frombuffer(
                    r.bytes(w * h), np.uint8).reshape(h, w).copy()
            cpos += csize + (csize & 1)
        frames.append(cur.copy())
        palettes.append(palette.reshape(256, 3).copy())
        pos += fsize + (fsize & 1)
    return frames, palettes, speed, (w, h)
