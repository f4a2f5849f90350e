"""Smoke codec — JPEG-based conditional-replenishment video.

Clean-room port of gst-plugins-good/ext/jpeg/smokecodec.c +
smokeformat.h: packet layout (IDX_TYPE..OFFS_PICT, :29-38), ID packet
(0x80 + "smoke" + version 0.1.0, :360-376), keyframe decision from
per-16x16 luma SSD vs the reference frame against `threshold`
(abs_diff :327-343, default 4000 :199), changed-block list as BE u16
indices, mosaic packing of changed blocks into the smallest
blocks_w x blocks_h grid (find_best_size :286-324), JPEG quality
maxq*60/100 for keyframes else maxq - (maxq-minq)*blocks/max (:484-
490), and the block scatter on decode (:484-560 decode loop).  The
JPEG payload uses our own codec (codecs/jpeg.py) instead of libjpeg;
streams are self-consistent, not byte-identical to libjpeg output
(lossy content differs; structure identical).

A copy of the JAX package's ``codecs/smoke.py`` over the port's
``codecs/jpeg.py``: the JPEG transforms run on the codec's ``device`` (CUDA
unless the caller names another), the block bookkeeping on the host.  One
difference: the change test of an inter frame reads the whole 16x16 blocks
only, as smokecodec.c's loop over blocks_w x blocks_h does; the JAX
package's reshape of the whole plane raises ``ValueError`` where a side is
no multiple of 16 (1080 lines; ROADMAP.md section 3)."""

from __future__ import annotations

import math
import struct
from typing import List, Optional, Tuple

import numpy as np

from .jpeg import jpeg_decode, jpeg_encode

TYPE_ID = 0x80
TYPE_DATA = 0x40
FLAG_KEYFRAME = 1 << 0

IDX_TYPE = 0
IDX_WIDTH = 1
IDX_HEIGHT = 3
IDX_FPS_NUM = 5
IDX_FPS_DENOM = 9
IDX_FLAGS = 13
IDX_NUM_BLOCKS = 14
IDX_SIZE = 16
OFFS_PICT = 18

ID_STRING = b"smoke"


def encode_id() -> bytes:
    return bytes([TYPE_ID]) + ID_STRING + bytes([0, 1, 0])


def parse_id(data: bytes) -> bool:
    return (len(data) >= 9 and data[0] == TYPE_ID
            and data[1:6] == ID_STRING)


def find_best_size(blocks: int) -> Tuple[int, int]:
    """smokecodec.c:286-324 exact."""
    sqchng = math.ceil(math.sqrt(blocks))
    w = h = sqchng
    free = w * h - blocks
    best, bestw = free, w
    while w < 256:
        if free < best:
            best, bestw = free, w
            if free == 0:
                break
        if free < w:
            w += 1
            free += h
        while free >= w:
            h -= 1
            free -= w
    return bestw, (blocks + best) // bestw


class SmokeEncoder:
    def __init__(self, width: int, height: int, fps_num: int = 25,
                 fps_denom: int = 1, qmin: int = 10, qmax: int = 85,
                 threshold: int = 4000, keyframe_rate: int = 25,
                 device=None):
        self.width = width
        self.height = height
        self.fps = (fps_num, fps_denom)
        self.qmin, self.qmax = qmin, qmax
        self.threshold = threshold
        self.keyframe_rate = keyframe_rate
        self._ref: Optional[Tuple[np.ndarray, ...]] = None
        self._count = 0
        self.device = device

    def encode(self, planes, force_key: bool = False) -> bytes:
        y, u, v = [np.asarray(p, np.uint8) for p in planes]
        w, h = self.width, self.height
        bw_full, bh_full = w // 16, h // 16
        max_blocks = bw_full * bh_full
        key = (force_key or self._ref is None
               or self._count % max(1, self.keyframe_rate) == 0)
        changed: List[int] = []
        if not key:
            ry = self._ref[0][:bh_full * 16, :bw_full * 16].astype(np.int64)
            d = y[:bh_full * 16, :bw_full * 16].astype(np.int64) - ry
            ssd = (d * d).reshape(bh_full, 16, bw_full, 16) \
                .sum(axis=(1, 3)).ravel()
            changed = [int(i) for i in
                       np.nonzero(ssd >= self.threshold)[0]]
            if len(changed) == max_blocks:
                key = True
                changed = []
        if key:
            encoding = max_blocks
            quality = (self.qmax * 60) // 100
            bw, bh = bw_full, bh_full
        else:
            encoding = len(changed)
            quality = self.qmax - ((self.qmax - self.qmin)
                                   * len(changed)) // max_blocks
            if encoding:
                bw, bh = find_best_size(encoding)
            else:
                bw = bh = 0

        header = bytearray(OFFS_PICT)
        header[IDX_TYPE] = TYPE_DATA
        struct.pack_into(">H", header, IDX_WIDTH, w)
        struct.pack_into(">H", header, IDX_HEIGHT, h)
        struct.pack_into(">I", header, IDX_FPS_NUM, self.fps[0])
        struct.pack_into(">I", header, IDX_FPS_DENOM, self.fps[1])
        header[IDX_FLAGS] = FLAG_KEYFRAME if key else 0
        struct.pack_into(">H", header, IDX_NUM_BLOCKS,
                         0 if key else len(changed))
        block_list = b"".join(struct.pack(">H", b) for b in changed)

        jpeg = b""
        if encoding > 0:
            my = np.zeros((bh * 16, bw * 16), np.uint8)
            mu = np.zeros((bh * 8, bw * 8), np.uint8)
            mv = np.zeros((bh * 8, bw * 8), np.uint8)
            ids = range(max_blocks) if key else changed
            for i, pos in enumerate(ids):
                x, yb = pos % bw_full, pos // bw_full
                dx, dy = i % bw, i // bw
                my[dy * 16:dy * 16 + 16, dx * 16:dx * 16 + 16] = \
                    y[yb * 16:yb * 16 + 16, x * 16:x * 16 + 16]
                mu[dy * 8:dy * 8 + 8, dx * 8:dx * 8 + 8] = \
                    u[yb * 8:yb * 8 + 8, x * 8:x * 8 + 8]
                mv[dy * 8:dy * 8 + 8, dx * 8:dx * 8 + 8] = \
                    v[yb * 8:yb * 8 + 8, x * 8:x * 8 + 8]
            jpeg = jpeg_encode((my, mu, mv), bw * 16, bh * 16,
                               quality=max(1, quality),
                               device=self.device)
        size = (len(jpeg) + 3) & ~3
        struct.pack_into(">H", header, IDX_SIZE, size & 0xFFFF)
        out = bytes(header) + block_list + jpeg \
            + b"\0" * (size - len(jpeg))
        self._ref = (y.copy(), u.copy(), v.copy())
        self._count += 1
        return out


class SmokeDecoder:
    def __init__(self, device=None):
        self.device = device
        self._ref: Optional[List[np.ndarray]] = None
        self.width = 0
        self.height = 0
        self.fps = (0, 1)

    def decode(self, data: bytes) -> Tuple[np.ndarray, ...]:
        if data[IDX_TYPE] == TYPE_ID:
            raise ValueError("smoke: ID packet, no picture")
        w = struct.unpack_from(">H", data, IDX_WIDTH)[0]
        h = struct.unpack_from(">H", data, IDX_HEIGHT)[0]
        self.fps = (struct.unpack_from(">I", data, IDX_FPS_NUM)[0],
                    struct.unpack_from(">I", data, IDX_FPS_DENOM)[0])
        flags = data[IDX_FLAGS]
        nblocks = struct.unpack_from(">H", data, IDX_NUM_BLOCKS)[0]
        self.width, self.height = w, h
        if self._ref is None or self._ref[0].shape != (h, w):
            self._ref = [np.zeros((h, w), np.uint8),
                         np.full((h // 2, w // 2), 128, np.uint8),
                         np.full((h // 2, w // 2), 128, np.uint8)]
        bw_full = w // 16
        key = bool(flags & FLAG_KEYFRAME)
        decoding = (bw_full * (h // 16)) if key else nblocks
        if decoding > 0:
            pict = data[OFFS_PICT + nblocks * 2:]
            planes = jpeg_decode(bytes(pict), device=self.device)[0]
            mos = [p.cpu().numpy() for p in planes]
            my, mu, mv = mos[0], mos[1], mos[2]
            bw = my.shape[1] // 16
            for i in range(decoding):
                if key:
                    pos = i
                else:
                    pos = struct.unpack_from(">H", data,
                                             OFFS_PICT + i * 2)[0]
                x, yb = pos % bw_full, pos // bw_full
                dx, dy = i % bw, i // bw
                self._ref[0][yb * 16:yb * 16 + 16,
                             x * 16:x * 16 + 16] = \
                    my[dy * 16:dy * 16 + 16, dx * 16:dx * 16 + 16]
                self._ref[1][yb * 8:yb * 8 + 8, x * 8:x * 8 + 8] = \
                    mu[dy * 8:dy * 8 + 8, dx * 8:dx * 8 + 8]
                self._ref[2][yb * 8:yb * 8 + 8, x * 8:x * 8 + 8] = \
                    mv[dy * 8:dy * 8 + 8, dx * 8:dx * 8 + 8]
        return tuple(p.copy() for p in self._ref)
