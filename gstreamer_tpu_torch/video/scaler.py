"""Separable video resampler: tap planning (host) and exact scaling (torch).

The planner (Resampler, make_resampler, convert_coeff, tap_matrix) is a copy
of the JAX package's ``video/scaler.py`` (gst_video_resampler_init and
resampler_convert_coeff of video-resampler.c / video-scaler.c).  The
application functions owe the integer result of video_orc_resample_*_u8:
``clamp((sum tap_s16 * px + 4095) >> 12, 0, maxv)`` per pass.  The JAX
package reaches it on the TPU MXU by splitting the taps into bf16 hi/lo
limbs; here the product is taken in float64, where every partial sum is an
integer far below 2**53 and so exact in any summation order (float64 has no
TF32 or reduced-precision mode to guard against).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _xp

METHOD_NEAREST = "nearest"
METHOD_LINEAR = "linear"
METHOD_CUBIC = "cubic"
METHOD_SINC = "sinc"
METHOD_LANCZOS = "lanczos"

DEFAULT_CUBIC_B = 1.0 / 3.0
DEFAULT_CUBIC_C = 1.0 / 3.0
DEFAULT_ENVELOPE = 2.0
DEFAULT_SHARPNESS = 1.0
DEFAULT_SHARPEN = 0.0
DEFAULT_MAX_TAPS = 128

SCALE_U8 = 12                       # video-scaler.c:70
SCALE_ROUND_U8 = (1 << SCALE_U8) - 1   # the ORC kernel adds 4095 (orc:2373)


def _sinc(x: float) -> float:
    if x == 0:
        return 1.0
    return math.sin(math.pi * x) / (math.pi * x)


def _envelope(x: float) -> float:
    if x <= -1 or x >= 1:
        return 0.0
    return _sinc(x)


@dataclass
class Resampler:
    """Float taps (exact port of gst_video_resampler_init)."""

    in_size: int
    out_size: int
    max_taps: int
    offset: np.ndarray          # (out_size,) int32 — first source sample
    taps: np.ndarray            # (out_size, max_taps) float64

    # quantized view (filled lazily)
    _taps_s16: Optional[np.ndarray] = None
    _heaviest: Optional[int] = None

    def taps_s16(self, precision: int = SCALE_U8) -> np.ndarray:
        if self._taps_s16 is None:
            self._taps_s16 = np.stack(
                [convert_coeff(t, precision) for t in self.taps])
        return self._taps_s16

    def heaviest(self, precision: int = SCALE_U8) -> int:
        """Largest sum of |tap| over one output sample: bounds the
        accumulator of a scale pass."""
        if self._heaviest is None:
            self._heaviest = int(
                np.abs(self.taps_s16(precision).astype(np.int64))
                .sum(axis=1).max())
        return self._heaviest


def make_resampler(method: str, in_size: int, out_size: int,
                   n_taps: int = 0, shift: float = 0.0,
                   cubic_b: float = DEFAULT_CUBIC_B,
                   cubic_c: float = DEFAULT_CUBIC_C,
                   envelope: float = DEFAULT_ENVELOPE,
                   sharpness: float = DEFAULT_SHARPNESS,
                   sharpen: float = DEFAULT_SHARPEN,
                   max_taps_opt: int = DEFAULT_MAX_TAPS,
                   half_taps: bool = False) -> Resampler:
    """gst_video_resampler_init (video-resampler.c:343)."""
    assert in_size > 0 and out_size > 0

    scale_factor = in_size / float(out_size)
    fx = (1.0 / scale_factor) * sharpness if scale_factor > 1.0 else 1.0 * sharpness

    n_taps = min(n_taps, max_taps_opt) if n_taps else 0

    if method == METHOD_NEAREST:
        env = envelope
        if n_taps == 0:
            n_taps = 1
    elif method == METHOD_LINEAR:
        env = 1.0
    elif method == METHOD_CUBIC:
        env = 2.0
    elif method in (METHOD_SINC, METHOD_LANCZOS):
        env = envelope
    else:
        raise ValueError(f"unknown resampler method {method!r}")

    if n_taps == 0:
        dx = math.ceil(2.0 * env / fx)
        n_taps = max(0, min(int(dx), max_taps_opt))
    if half_taps and n_taps > 3:
        # GST_VIDEO_RESAMPLER_FLAG_HALF_TAPS (video-resampler.c:414)
        n_taps //= 2
    fx = 2.0 * env / n_taps
    ex = 2.0 / n_taps

    if n_taps > in_size:
        n_taps = in_size

    max_taps = n_taps
    tap_offs = (max_taps - 1) // 2
    corr = 0.0 if max_taps == 1 else 0.5

    def get_tap(l: int, xi: int, x: float) -> float:
        xl = xi + l
        if method == METHOD_NEAREST:
            return 1.0
        if method == METHOD_LINEAR:
            a = abs(x - xl) * fx
            return 1.0 - a if a < 1.0 else 0.0
        if method == METHOD_CUBIC:
            a = abs(x - xl) * fx
            a2, a3 = a * a, a * a * a
            b, c = cubic_b, cubic_c
            if a <= 1.0:
                return ((12.0 - 9.0 * b - 6.0 * c) * a3 +
                        (-18.0 + 12.0 * b + 6.0 * c) * a2 + (6.0 - 2.0 * b)) / 6.0
            if a <= 2.0:
                return ((-b - 6.0 * c) * a3 +
                        (6.0 * b + 30.0 * c) * a2 +
                        (-12.0 * b - 48.0 * c) * a + (8.0 * b + 24.0 * c)) / 6.0
            return 0.0
        if method == METHOD_SINC:
            return _sinc((x - xl) * fx)
        # lanczos
        env_v = _envelope((x - xl) * ex)
        return (_sinc((x - xl) * fx) - sharpen) * env_v

    offset = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, max_taps), np.float64)

    for j in range(out_size):
        ox = (0.5 + j - shift) / out_size
        x = ox * in_size - corr
        x = min(max(x, 0.0), in_size - 1)
        xi = math.floor(x - tap_offs)

        offset[j] = xi
        t = np.array([get_tap(l, xi, x) for l in range(max_taps)])
        t /= t.sum()

        # fold out-of-range taps into the edges (resampler_calculate_taps)
        if xi < 0:
            sh = -xi
            t[sh] += t[:sh].sum()
            t[: max_taps - sh] = t[sh:].copy()
            t[max_taps - sh:] = 0
            offset[j] += sh
        if xi > in_size - max_taps:
            sh = xi - (in_size - max_taps)
            # fold the sh out-of-range tail taps into the last valid tap,
            # then shift the whole filter right by sh and zero the head
            t[max_taps - sh - 1] += t[max_taps - sh:].sum()
            shifted = np.zeros_like(t)
            shifted[sh:] = t[: max_taps - sh]
            t = shifted
            offset[j] -= sh

        taps[j] = t

    return Resampler(in_size, out_size, max_taps,
                     offset.astype(np.int64), taps)


def make_resampler_interlaced(method: str, in_size: int, out_size: int,
                              n_taps: int = 0, **kw) -> Resampler:
    """GST_VIDEO_SCALER_FLAG_INTERLACED (video-scaler.c:229): build two
    half-size field resamplers (top shifted +0.5*out/in with HALF_TAPS,
    bottom shifted -0.5*out/in with the top's tap count) and zip them
    (resampler_zip: output row i uses field resampler i&1 at row i/2,
    source offset doubled onto the field's lines)."""
    shift = (0.5 * out_size) / in_size
    t_in = (in_size + 1) // 2
    t_out = (out_size + 1) // 2
    tr = make_resampler(method, t_in, t_out, n_taps, shift=shift,
                        half_taps=True, **kw)
    br = make_resampler(method, in_size - t_in, out_size - t_out,
                        tr.max_taps, shift=-shift, **kw)
    assert br.max_taps == tr.max_taps
    max_taps = tr.max_taps
    offset = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, max_taps), np.float64)
    for i in range(out_size):
        r = br if (i & 1) else tr
        offset[i] = r.offset[i // 2] * 2 + (i & 1)
        taps[i] = r.taps[i // 2]
    return Resampler(in_size, out_size, max_taps, offset, taps)


def convert_coeff(src: np.ndarray, precision: int) -> np.ndarray:
    """resampler_convert_coeff (video-scaler.c:339): round float taps to
    int with a bisected bias so they sum exactly to 2^precision."""
    multiplier = float(1 << precision)
    l_offset, h_offset, offset = 0.0, 1.0, 0.5
    dest = np.zeros(len(src), np.int64)
    for _ in range(64):
        dest = np.floor(offset + src * multiplier).astype(np.int64)
        s = int(dest.sum())
        if s == (1 << precision):
            break
        if l_offset == h_offset:
            break
        if s < (1 << precision):
            if offset > l_offset:
                l_offset = offset
            offset += (h_offset - l_offset) / 2
        else:
            if offset < h_offset:
                h_offset = offset
            offset -= (h_offset - l_offset) / 2
    return dest.astype(np.int16)


# ---------------------------------------------------------------------------
# Application.
# ---------------------------------------------------------------------------

def tap_matrix(res: Resampler, precision: int = SCALE_U8) -> np.ndarray:
    """Dense (out_size, in_size) int tap matrix (zeros elsewhere).

    Offsets after edge fold-in are guaranteed within [0, in_size-max_taps],
    so scatter never clips."""
    m = np.zeros((res.out_size, res.in_size), np.int32)
    ts16 = res.taps_s16(precision)
    for j in range(res.out_size):
        o = int(res.offset[j])
        m[j, o:o + res.max_taps] = ts16[j]
    return m


def _exact_product(xp, x, mt: np.ndarray, wide: bool = False):
    """x (..., K) integer array times mt (K, N) integer taps, exactly:
    int64 under numpy; under torch int32 (an 8-bit sample times any row of
    S16 taps stays far below 2**31), or int64 where the caller says the
    sums need it (`wide`)."""
    if xp is np:
        return (np.asarray(x, np.float64) @ mt.astype(np.float64)
                ).astype(np.int64)
    return (_xp.astype(xp, x, "float64")
            @ _xp.const(xp, mt, "float64", x)
            ).to(torch.int64 if wide else torch.int32)


def _round(xp, acc, precision: int, value_bits: int):
    maxv = (1 << value_bits) - 1
    out = _xp.clip(xp, (acc + ((1 << precision) - 1)) >> precision, 0, maxv)
    return out if xp is np else out.to(torch.int32)


def scale_axis_exact(xp, img, axis: int, res: Resampler,
                     precision: int = SCALE_U8, value_bits: int = 8):
    """Exact scaling along `axis`:
    out = clamp((sum_j tap_s16[j]*src[offset+j] + 4095) >> 12)
    (video_orc_resample_scaletaps_u8/u16, video-orc.orc:2370,2507)."""
    ax = axis if axis >= 0 else img.ndim + axis
    m = tap_matrix(res, precision)
    src = xp.moveaxis(img, ax, -1)
    # 16-bit samples overflow an int32 sum only under taps with large
    # negative lobes (lanczos held to 2 taps): checked on the host, once
    # for a resampler
    wide = (((1 << value_bits) - 1) * res.heaviest(precision)
            >= (1 << 31) - (1 << precision))
    out = _round(xp, _exact_product(xp, src, m.T, wide), precision,
                 value_bits)
    return xp.moveaxis(out, -1, ax)


def scale_rows_split_exact(xp, even, odd, res: Resampler,
                           precision: int = SCALE_U8, value_bits: int = 8):
    """Vertical scale where the input rows arrive as separate even/odd
    planes (each (..., in/2, W)): the contraction splits by row parity
    BEFORE the fixed-point rounding, so
        acc = even @ T[:, 0::2].T + odd @ T[:, 1::2].T
    is bit-identical to scaling the interleaved plane."""
    m = tap_matrix(res, precision)
    me, mo = m[:, 0::2], m[:, 1::2]
    even = xp.moveaxis(even[..., :me.shape[1], :], -2, -1)
    odd = xp.moveaxis(odd[..., :mo.shape[1], :], -2, -1)
    acc = _exact_product(xp, even, me.T) + _exact_product(xp, odd, mo.T)
    return xp.moveaxis(_round(xp, acc, precision, value_bits), -1, -2)


def scale_cols_split_exact(xp, even, odd, res: Resampler,
                           precision: int = SCALE_U8, value_bits: int = 8):
    """Horizontal scale where the input columns arrive as separate
    even/odd phase planes (each (..., H, ceil(in/2) / floor(in/2))):
        acc = even @ T[:, 0::2].T + odd @ T[:, 1::2].T
    bit-identical to scaling the interleaved plane (the parity split
    happens before the (acc+4095)>>12 rounding)."""
    m = tap_matrix(res, precision)
    me, mo = m[:, 0::2], m[:, 1::2]
    acc = (_exact_product(xp, even[..., :me.shape[1]], me.T)
           + _exact_product(xp, odd[..., :mo.shape[1]], mo.T))
    return _round(xp, acc, precision, value_bits)
