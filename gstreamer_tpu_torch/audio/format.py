"""Audio sample-format registry and canonical pack/unpack on torch tensors.

A copy of the JAX package's ``audio/format.py`` format table (reference:
gst-libs/gst/audio/audio-format.c; ORC kernels gstaudiopack.orc:
audio_orc_unpack_u8 :2, audio_orc_unpack_s16 :61, audio_orc_s32_to_double
:412, audio_orc_double_to_s32 :420) with ``unpack`` / ``pack`` /
``s32_to_double`` / ``double_to_s32`` rewritten on torch tensors of
(..., frames, channels).  Canonical compute dtypes are ``torch.int32``
(full-scale replication, bit-exact with the ORC kernels; the arithmetic runs
in ``torch.int64``) and ``torch.float64``.  Torch has no uint16 arithmetic:
U16 samples widen to int64 on unpack, and ``torch.uint16`` is only the final
cast of ``pack``.

The host byte layout (``from_bytes`` / ``to_bytes``: endianness, packed
24-bit, interleave) is a copy of the reference's numpy code; ``to_bytes``
also takes a tensor, which it brings to the host first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass(frozen=True)
class AudioFormatInfo:
    name: str
    is_integer: bool
    is_signed: bool
    endianness: str          # "le" | "be" | "none"
    width: int               # bits per stored sample
    depth: int               # meaningful bits
    unpack_format: str       # "S32" | "F64"

    @property
    def is_float(self) -> bool:
        return not self.is_integer


def _i(name, signed, end, width, depth):
    return AudioFormatInfo(name, True, signed, end, width, depth, "S32")


def _f(name, end, width):
    return AudioFormatInfo(name, False, True, end, width, width, "F64")


FORMATS: Dict[str, AudioFormatInfo] = {
    "S8": _i("S8", True, "none", 8, 8),
    "U8": _i("U8", False, "none", 8, 8),
    "S16LE": _i("S16LE", True, "le", 16, 16),
    "S16BE": _i("S16BE", True, "be", 16, 16),
    "U16LE": _i("U16LE", False, "le", 16, 16),
    "U16BE": _i("U16BE", False, "be", 16, 16),
    "S24_32LE": _i("S24_32LE", True, "le", 32, 24),
    "S24_32BE": _i("S24_32BE", True, "be", 32, 24),
    "S24LE": _i("S24LE", True, "le", 24, 24),
    "S24BE": _i("S24BE", True, "be", 24, 24),
    "S20LE": _i("S20LE", True, "le", 32, 20),
    "S18LE": _i("S18LE", True, "le", 24, 18),
    "S32LE": _i("S32LE", True, "le", 32, 32),
    "S32BE": _i("S32BE", True, "be", 32, 32),
    "U32LE": _i("U32LE", False, "le", 32, 32),
    "F32LE": _f("F32LE", "le", 32),
    "F32BE": _f("F32BE", "be", 32),
    "F64LE": _f("F64LE", "le", 64),
    "F64BE": _f("F64BE", "be", 64),
}

# native-endian aliases used in caps (S16 == S16LE on this platform)
ALIASES = {"S16": "S16LE", "U16": "U16LE", "S24_32": "S24_32LE",
           "S24": "S24LE", "S32": "S32LE", "U32": "U32LE",
           "F32": "F32LE", "F64": "F64LE"}


def format_info(name: str) -> AudioFormatInfo:
    name = ALIASES.get(name, name)
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown audio format {name!r}") from None


def native_dtype(fmt: AudioFormatInfo) -> torch.dtype:
    """The tensor dtype a format's samples are stored in."""
    if fmt.is_float:
        return torch.float32 if fmt.width == 32 else torch.float64
    if fmt.width == 8:
        return torch.int8 if fmt.is_signed else torch.uint8
    if fmt.width == 16:
        return torch.int16 if fmt.is_signed else torch.uint16
    return torch.int32


# ---------------------------------------------------------------------------
# Canonical unpack/pack.  samples: integer formats arrive as tensors of their
# native dtype (int16/uint8/int32...); canonical is int32 (replicated to full
# scale per the ORC kernels) or float64.
# ---------------------------------------------------------------------------

def unpack(fmt: AudioFormatInfo, samples: torch.Tensor) -> torch.Tensor:
    """samples (native dtype) -> canonical int32 (full-scale) or float64.

    Exact ORC semantics (gstaudiopack.orc):
      S8: splat(b) ^ 0x00808080      U8: splat(b) ^ 0x80000000
      S16: (w<<16)|(w^0x8000)        U16: ((w<<16)|w) ^ 0x80000000
      S24/S24_32: v << 8             S20: v << 12   S18: v << 14
      U32: v ^ 0x80000000            S32: identity
    """
    if fmt.is_float:
        return samples.to(torch.float64)
    s = samples.to(torch.int64)
    if fmt.width == 8:
        v = (s & 0xFF) * 0x01010101
        v = v ^ (0x80000000 if not fmt.is_signed else 0x00808080)
    elif fmt.width == 16:
        w = s & 0xFFFF
        v = (w << 16) | w
        v = v ^ (0x80000000 if not fmt.is_signed else 0x8000)
    elif fmt.depth < 32:
        v = (s & ((1 << fmt.depth) - 1)) << (32 - fmt.depth)
        if not fmt.is_signed:
            v = v ^ 0x80000000
    else:
        v = s & 0xFFFFFFFF
        if not fmt.is_signed:
            v = v ^ 0x80000000
    v = v & 0xFFFFFFFF
    v = torch.where(v >= (1 << 31), v - (1 << 32), v)
    return v.to(torch.int32)


def pack(fmt: AudioFormatInfo, canon: torch.Tensor) -> torch.Tensor:
    """canonical (int32 or float64) -> native dtype samples."""
    integer = canon.dtype in (torch.int32, torch.int64)
    if fmt.is_float:
        if integer:
            canon = s32_to_double(canon)
        return canon.to(native_dtype(fmt))
    if not integer:
        canon = double_to_s32(canon)
    c = canon.to(torch.int64)
    shift = 32 - fmt.width if fmt.width < 32 else 0
    if fmt.name.startswith(("S24_32", "S20", "S18")):
        shift = 32 - fmt.depth
    v = c >> shift
    if not fmt.is_signed:
        v = v + (1 << (fmt.width - 1))
    return v.to(native_dtype(fmt))


def s32_to_double(s: torch.Tensor) -> torch.Tensor:
    """audio_orc_s32_to_double: d = s / 2147483648.0"""
    return s.to(torch.float64) / 2147483648.0


def double_to_s32(d: torch.Tensor) -> torch.Tensor:
    """audio_orc_double_to_s32: C truncation of d*2^31 with positive
    overflow clamped to INT32_MAX (gstaudiopack-dist.c:6227)."""
    t = torch.trunc(d * 2147483648.0)
    return torch.clamp(t, -2147483648.0, 2147483647.0).to(torch.int32)


# host byte-layout (interleaved)
_NP_DTYPES = {
    "S8": "i1", "U8": "u1",
    "S16LE": "<i2", "S16BE": ">i2", "U16LE": "<u2", "U16BE": ">u2",
    "S24_32LE": "<i4", "S24_32BE": ">i4", "S32LE": "<i4", "S32BE": ">i4",
    "U32LE": "<u4", "S20LE": "<i4", "F32LE": "<f4", "F32BE": ">f4",
    "F64LE": "<f8", "F64BE": ">f8",
}


def from_bytes(fmt: AudioFormatInfo, data: np.ndarray, channels: int):
    """Interleaved bytes -> (frames, channels) native-dtype numpy array."""
    data = np.asarray(data, np.uint8)
    if fmt.name in ("S24LE", "S24BE", "S18LE"):
        b = data.reshape(-1, 3)
        if fmt.endianness == "le":
            v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
        else:
            v = (b[:, 2].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 0].astype(np.int32) << 16))
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        return v.reshape(-1, channels)
    arr = data.view(np.dtype(_NP_DTYPES[fmt.name]))
    return arr.reshape(-1, channels)


def to_bytes(fmt: AudioFormatInfo, samples) -> np.ndarray:
    """(frames, channels) samples (numpy or a tensor) -> interleaved
    bytes, flat uint8."""
    if isinstance(samples, torch.Tensor):
        samples = samples.cpu().numpy()
    samples = np.asarray(samples)
    if fmt.name in ("S24LE", "S24BE", "S18LE"):
        v = samples.astype(np.int32).reshape(-1)
        out = np.empty((v.size, 3), np.uint8)
        if fmt.endianness == "le":
            out[:, 0] = v & 0xFF
            out[:, 1] = (v >> 8) & 0xFF
            out[:, 2] = (v >> 16) & 0xFF
        else:
            out[:, 2] = v & 0xFF
            out[:, 1] = (v >> 8) & 0xFF
            out[:, 0] = (v >> 16) & 0xFF
        return out.reshape(-1)
    return samples.astype(np.dtype(_NP_DTYPES[fmt.name])).reshape(-1).view(
        np.uint8)
