"""G.711 mu-law / A-law companding on torch tensors (and numpy arrays).

A port of the JAX package's ``audio/law.py`` (references: gst-plugins-good
gst/law/mulaw-conversion.c:34-122, alaw-encode.c:241-305,
alaw-decode.c:96-113).  The same elementwise integer expressions, in int32,
on a tensor's device; a numpy array takes the numpy branch, as host callers
of the reference do.

* mu-law encode: BIAS 0x84, CLIP 32635, the exponent as the highest set
  bit of ``(mag + BIAS) >> 7``.  The C code negates in gint16 and compares
  the uint16 reinterpretation with CLIP, so -32768 becomes 32768 > CLIP:
  ``(-x) & 0xFFFF`` here.
* mu-law decode: the exponent table is ``(0x84 << e) - 0x84``.
* A-law encode: val_seg's segment search as the bit length of ``pcm >> 8``,
  mask 0xD5 / 0x55; -32768 is limited to 0x7FFF.
* A-law decode: the algorithmic form of the default table.
"""

from __future__ import annotations

import numpy as np
import torch

_BIAS = 0x84
_CLIP = 32635


class _Np:
    """The numpy spellings of the few operations below."""
    int32 = np.int32

    @staticmethod
    def cast(x, dtype):
        return np.asarray(x).astype(dtype)

    where = staticmethod(np.where)
    minimum = staticmethod(np.minimum)
    maximum = staticmethod(np.maximum)


class _Torch:
    int32 = torch.int32

    @staticmethod
    def cast(x, dtype):
        return x.to(dtype)

    where = staticmethod(torch.where)
    minimum = staticmethod(torch.clamp_max)
    maximum = staticmethod(torch.clamp_min)


def _ops(x):
    return _Np if isinstance(x, np.ndarray) else _Torch


def _out(ops, x, dtype: str):
    return (x.astype(dtype) if ops is _Np
            else x.to(getattr(torch, dtype)))


def mulaw_encode(x):
    """int16 linear -> uint8 mu-law (mulaw-conversion.c:34)."""
    ops = _ops(x)
    xi = ops.cast(x, ops.int32)
    sign = (xi >> 8) & 0x80
    # the C code negates in gint16 (wraps at -32768), then compares the
    # uint16 reinterpretation with CLIP
    mag = ops.where(sign != 0, (-xi) & 0xFFFF, xi)
    mag = ops.minimum(mag, _CLIP)
    s = mag + _BIAS
    t = (s >> 7) & 0xFF
    # exp_lut[t]: the index of the highest set bit (0 for t in {0, 1})
    exponent = sum(ops.cast(t >= (1 << k), ops.int32) for k in range(1, 8))
    mantissa = (s >> (exponent + 3)) & 0x0F
    byte = ~(sign | (exponent << 4) | mantissa) & 0xFF
    return _out(ops, byte, "uint8")


def mulaw_decode(u):
    """uint8 mu-law -> int16 linear (mulaw-conversion.c:101)."""
    ops = _ops(u)
    b = (~ops.cast(u, ops.int32)) & 0xFF
    sign = b & 0x80
    exponent = (b >> 4) & 0x07
    mantissa = b & 0x0F
    # table {0,132,396,924,1980,4092,8316,16764} == (0x84 << e) - 0x84
    linear = ((_BIAS << exponent) - _BIAS) + (mantissa << (exponent + 3))
    return _out(ops, ops.where(sign != 0, -linear, linear), "int16")


def alaw_encode(x):
    """int16 linear -> uint8 A-law (alaw-encode.c:241-305)."""
    ops = _ops(x)
    xi = ops.cast(x, ops.int32)
    neg = xi < 0
    mask = ops.where(neg, 0x55, 0xD5)
    pcm = ops.where(neg, ops.minimum(-xi, 0x7FFF), xi)
    # val_seg(): the bit length of pcm >> 8 (alaw-encode.c:263-278)
    v = pcm >> 8
    seg = sum(ops.cast(v >= (1 << k), ops.int32) for k in range(7))
    aval = ops.where(pcm < 256, pcm >> 4,
                     (seg << 4) | ((pcm >> (seg + 3)) & 0x0F))
    return _out(ops, (aval ^ mask) & 0xFF, "uint8")


def alaw_decode(u):
    """uint8 A-law -> int16 linear (alaw-decode.c:96-113)."""
    ops = _ops(u)
    a = ops.cast(u, ops.int32) ^ 0x55
    t = a & 0x7F
    seg = (t >> 4) & 0x07
    small = (t << 4) + 8
    big = (((t & 0x0F) << 4) + 0x108) << ops.maximum(seg - 1, 0)
    mag = ops.where(t < 16, small, big)
    return _out(ops, ops.where((a & 0x80) != 0, mag, -mag), "int16")
