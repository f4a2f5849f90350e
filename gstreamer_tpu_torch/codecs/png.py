"""PNG codec (RFC 2083 / ISO 15948), self-implemented over zlib.

Covers the raw-frame family the framework uses: 8-bit greyscale
(color type 0), RGB (2) and RGBA (6), non-interlaced.  The encoder
uses libpng's default adaptive per-row filter heuristic (minimum sum
of absolute values); the decoder reverses all five filter types.
Capability row: gst-plugins-good/ext/libpng (gstpngenc.c:1,
gstpngdec.c:1 wrap libpng; this is a native reimplementation).

A copy of the JAX package's ``codecs/png.py`` (host numpy and zlib).
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIG = b"\x89PNG\r\n\x1a\n"

COLOR_TYPE = {"GRAY8": 0, "RGB": 2, "RGBA": 6}
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
FORMAT_OF = {0: "GRAY8", 2: "RGB", 6: "RGBA"}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + tag + payload \
        + struct.pack(">I", crc)


def _filter_rows(img: np.ndarray) -> bytes:
    """Adaptive filtering: for each row compute all five candidates and
    pick the one with the minimum sum of absolute differences (libpng's
    PNG_FILTER_HEURISTIC_MSAD default)."""
    h, w, c = img.shape
    raw = img.astype(np.int16)
    prev = np.zeros((w, c), np.int16)
    out = bytearray()
    for y in range(h):
        row = raw[y]
        left = np.zeros_like(row)
        left[1:] = row[:-1]
        upleft = np.zeros_like(row)
        upleft[1:] = prev[:-1]
        cands = {
            0: row,
            1: (row - left) & 0xFF,
            2: (row - prev) & 0xFF,
            3: (row - ((left + prev) >> 1)) & 0xFF,
        }
        # Paeth predictor
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, upleft))
        cands[4] = (row - pred) & 0xFF
        best, best_sum = 0, None
        for ftype, data in cands.items():
            # MSAD treats filtered bytes as signed deltas
            s = int(np.minimum(data & 0xFF, 256 - (data & 0xFF)).sum())
            if best_sum is None or s < best_sum:
                best, best_sum = ftype, s
        out.append(best)
        out.extend(cands[best].astype(np.uint8).tobytes())
        prev = row
    return bytes(out)


def png_encode(img: np.ndarray, fmt: str = None,
               compression: int = 6) -> bytes:
    """img: (H, W) gray or (H, W, C) uint8."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if fmt is None:
        fmt = {1: "GRAY8", 3: "RGB", 4: "RGBA"}[c]
    ct = COLOR_TYPE[fmt]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ct, 0, 0, 0)
    idat = zlib.compress(_filter_rows(img), compression)
    return (PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    stride = w * c
    rows = data.reshape(h, 1 + stride)
    out = np.zeros((h, w, c), np.uint8)
    prev = np.zeros((w, c), np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        row = rows[y, 1:].reshape(w, c).astype(np.int32)
        if ftype == 0:
            cur = row
        elif ftype == 1:        # Sub: cumulative sum along x
            cur = np.cumsum(row, axis=0) & 0xFF
        elif ftype == 2:        # Up
            cur = (row + prev) & 0xFF
        elif ftype == 3:        # Average
            cur = np.zeros_like(row)
            left = np.zeros(c, np.int32)
            for x in range(w):
                cur[x] = (row[x] + ((left + prev[x]) >> 1)) & 0xFF
                left = cur[x]
        elif ftype == 4:        # Paeth
            cur = np.zeros_like(row)
            left = np.zeros(c, np.int32)
            upleft = np.zeros(c, np.int32)
            for x in range(w):
                p = left + prev[x] - upleft
                pa = np.abs(p - left)
                pb = np.abs(p - prev[x])
                pc = np.abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prev[x], upleft))
                cur[x] = (row[x] + pred) & 0xFF
                left = cur[x]
                upleft = prev[x]
        else:
            raise ValueError(f"png: bad filter type {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def png_decode(data: bytes) -> Tuple[str, np.ndarray]:
    """Returns (format, (H, W, C) uint8 array)."""
    if bytes(data[:8]) != PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    w = h = None
    ct = depth = None
    idat = bytearray()
    data = bytes(data)
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ct, comp, filt, inter = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or ct not in FORMAT_OF:
                raise ValueError(f"png: unsupported depth/type "
                                 f"{depth}/{ct}")
            if inter:
                raise ValueError("png: Adam7 interlace not supported")
        elif tag == b"IDAT":
            idat.extend(payload)
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    c = CHANNELS[ct]
    img = _unfilter(raw, h, w, c)
    return FORMAT_OF[ct], img
