"""IEC 61937 payloading (SPDIF passthrough of compressed audio).

Exact port of gst-plugins-base/gst-libs/gst/audio/gstaudioiec61937.c:
frame sizes per stream type (:76) and the Pa/Pb/Pc/Pd burst header +
byte-swapped payload copy (:160-367).  Stream parameters arrive as a
small dict instead of GstAudioRingBufferSpec caps fields.

A copy of the JAX package's ``audio/iec61937.py``: a burst is host bytes,
byte for byte the same.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

HEADER_SIZE = 8
PAYLOAD_SIZE_AC3 = 1536 * 4
PAYLOAD_SIZE_EAC3 = 6144 * 4
PAYLOAD_SIZE_AAC = 1024 * 4


def frame_size(kind: str, fields: Optional[Dict] = None) -> int:
    """gst_audio_iec61937_frame_size; 0 = cannot payload."""
    f = fields or {}
    if kind == "ac3":
        return PAYLOAD_SIZE_AC3
    if kind == "eac3":
        return PAYLOAD_SIZE_EAC3
    if kind == "dts":
        dts = f.get("frame-size", 0)
        iec = f.get("block-size", 0) * 4
        if iec >= dts + HEADER_SIZE:
            return iec
        return 0
    if kind == "mpeg":
        version = f.get("mpegaudioversion", 0)
        layer = f.get("layer", 0)
        channels = f.get("channels", 2)
        rate = f.get("rate", 48000)
        if not version or not layer or version == 3 or channels > 2:
            return 0
        if version == 1 and layer == 1:
            frames = 384
        elif version == 2 and layer == 1 and rate <= 12000:
            frames = 768
        elif version == 2 and layer == 2 and rate <= 12000:
            frames = 2304
        else:
            frames = 1152
        return frames * 4
    if kind in ("aac", "mpeg2-aac", "mpeg4-aac"):
        return PAYLOAD_SIZE_AAC
    return 0


def payload(src: bytes, kind: str, fields: Optional[Dict] = None,
            big_endian_out: bool = False) -> Optional[bytes]:
    """gst_audio_iec61937_payload: one compressed frame -> one IEC burst
    (little-endian hosts byte-swap, matching SPDIF's 16-bit framing)."""
    f = fields or {}
    src = bytes(src)
    n = len(src)
    total = frame_size(kind, fields)
    if total == 0 or total < n + HEADER_SIZE:
        return None
    # logical big-endian header bytes
    hdr = bytearray(8)
    hdr[0], hdr[1], hdr[2], hdr[3] = 0xF8, 0x72, 0x4E, 0x1F
    if kind == "ac3":
        if n < 6:
            return None
        hdr[4] = src[5] & 0x7          # bsmod
        hdr[5] = 1                     # data type 1
        bits = n * 8
        hdr[6], hdr[7] = (bits >> 8) & 0xFF, bits & 0xFF
    elif kind == "eac3":
        hdr[4] = 0
        hdr[5] = 21
        hdr[6], hdr[7] = (n >> 8) & 0xFF, n & 0xFF     # size in BYTES
    elif kind == "dts":
        blocksize = f.get("block-size", 0)
        if not n or not blocksize:
            return None
        hdr[4] = 0
        hdr[5] = 11 + blocksize // 1024   # type I-III
        bits = (n * 8) & 0xFFFF
        hdr[6], hdr[7] = bits >> 8, bits & 0xFF
    elif kind == "mpeg":
        version = f.get("mpegaudioversion", 0)
        layer = f.get("layer", 0)
        rate = f.get("rate", 48000)
        if version <= 0 or layer <= 0:
            return None
        hdr[4] = 0
        if version == 1 and layer == 1:
            hdr[5] = 0x04
        elif (version == 1 and layer in (2, 3)) or \
                (version == 2 and rate >= 12000):
            hdr[5] = 0x05
        elif version == 2 and layer == 1 and rate < 12000:
            hdr[5] = 0x08
        elif version == 2 and layer == 2 and rate < 12000:
            hdr[5] = 0x09
        elif version == 2 and layer == 3 and rate < 12000:
            hdr[5] = 0x0A
        else:
            return None
        bits = (n * 8) & 0xFFFF
        hdr[6], hdr[7] = bits >> 8, bits & 0xFF
    elif kind in ("aac", "mpeg2-aac", "mpeg4-aac"):
        if n < 7:
            return None
        num_rd_blks = (src[6] & 0x03) + 1
        hdr[4] = 0
        if num_rd_blks == 1:
            hdr[5] = 0x07
        elif num_rd_blks == 2:
            hdr[5] = 0x13
        elif num_rd_blks == 4:
            hdr[5] = 0x33
        else:
            return None
        bits = (((n + 1) & ~1) * 8) & 0xFFFF
        hdr[6], hdr[7] = bits >> 8, bits & 0xFF
    else:
        return None

    out = bytearray(total)
    body = bytearray(hdr) + src
    if big_endian_out:
        out[:len(body)] = body
    else:
        # 16-bit byte swap (gstaudioiec61937.c:349)
        b = np.frombuffer(bytes(body), np.uint8)
        if b.size % 2:
            b = np.concatenate([b, np.zeros(1, np.uint8)])
        sw = b.reshape(-1, 2)[:, ::-1].reshape(-1)
        out[:sw.size] = sw.tobytes()
    return bytes(out)
