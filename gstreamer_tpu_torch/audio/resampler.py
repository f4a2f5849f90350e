"""Polyphase FIR audio resampler on torch tensors.

A copy of the JAX package's ``audio/resampler.py`` host code (reference:
gst-libs/gst/audio/audio-resampler.c — methods nearest/linear/cubic/
Blackman-Nuttall/Kaiser(default) :95; Kaiser quality table :61-73; beta
from attenuation :928; get_kaiser_tap :206; full-mode phase taps
GET_TAPS_FULL_FUNC; the interpolated filter mode :1100-1168; per-phase
DC-exact integer taps MAKE_CONVERT_TAPS_INT_FUNC, Q15 for S16 and Q31 for
S32; inner product rounding (acc + 2^(prec-1)) >> prec with clamp
INNER_PRODUCT_INT_FULL_FUNC :614; rates reduced by gcd :1524): the tap
tables, ``taps_for``, ``out_frames_for``, ``latency`` and the numpy gold
``resample_ref``.  ``resample_fn`` and ``resample_fn_phased`` are rewritten
on torch.

Device route (``_block_product``): the output sequence repeats its phases
every ``out_red`` outputs while the input advances ``in_red`` frames, so a
block of whole periods is one product of the input window under the block
with a fixed banded matrix, which holds every phase's taps in its column.
The windows overlap by less than the block's own step (a step of at least
two filter lengths), so the product never materialises the reference's
(outputs, taps) gather.  One matrix, built on the host for start phase 0
with one spare period, serves every start phase as a slice
(``_block_slice``).  Where that matrix would be large (phase counts in the
thousands) the plain route loops over the taps instead (``_tap_loop``).

Exactness: every product runs in float64.  S16 samples times Q15 taps are
integers below 2^30 and every partial sum stays below 2^53, so the result
is exact in any summation order.  S32 samples are split into a high and a
low 16-bit limb: each limb's sums stay below 2^53 (checked on the host), and
the int64 recombination equals the reference's int64 sum, wraparound
included.  F32 samples are multiplied and summed in float64 and rounded to
float32 once, so TF32 never applies; the result is closer to the exact sum
than the reference's float32 accumulation.

The device is explicit: ``AudioResampler(..., device=None)`` runs on CUDA
and raises without a card; the functions it returns refuse a tensor on
another device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve

METHOD_NEAREST = "nearest"
METHOD_LINEAR = "linear"
METHOD_CUBIC = "cubic"
METHOD_BLACKMAN_NUTTALL = "blackman-nuttall"
METHOD_KAISER = "kaiser"

# quality -> oversample (audio-resampler.c:49)
OVERSAMPLE_QUALITIES = [4, 4, 4, 8, 8, 16, 16, 16, 16, 32, 32]

# (cutoff, downsample_cutoff_factor, stopband_attenuation, transition_bw)
KAISER_QUALITIES = [
    (0.860, 0.96511, 60, 0.7),     # 8 taps
    (0.880, 0.96591, 65, 0.29),    # 16
    (0.910, 0.96923, 70, 0.145),   # 32
    (0.920, 0.97600, 80, 0.105),   # 48
    (0.940, 0.97979, 85, 0.087),   # 64 (default)
    (0.940, 0.98085, 95, 0.077),   # 80
    (0.945, 0.99471, 100, 0.068),  # 96
    (0.950, 1.0, 105, 0.055),      # 128
    (0.960, 1.0, 110, 0.045),      # 160
    (0.968, 1.0, 115, 0.039),      # 192
    (0.975, 1.0, 120, 0.0305),     # 256
]

BLACKMAN_QUALITIES = [
    (8, 0.5), (16, 0.6), (24, 0.72), (32, 0.8), (48, 0.85), (64, 0.90),
    (80, 0.92), (96, 0.933), (128, 0.950), (148, 0.955), (160, 0.960),
]

DEFAULT_QUALITY = 4
PRECISION = {"s16": 15, "s32": 31}
DTYPES = ("s16", "s32", "f32", "f64")
# entries of a block matrix (float64) above which the tap loop runs
_BLOCK_MAX = 1 << 22


def _bessel_i0(x: float) -> float:
    """Modified Bessel I0 (the reference uses netlib dbesi0; numpy's A&S
    polynomial agrees to ~1e-15 relative, far below tap quantization)."""
    return float(np.i0(x))


def _sinc_pi(y: float, fc: float) -> float:
    return fc if y == 0.0 else math.sin(y * fc) / y


def get_kaiser_tap(x: float, n_taps: int, fc: float, beta: float) -> float:
    y = math.pi * x
    s = _sinc_pi(y, fc)
    w = 2.0 * x / n_taps
    return s * _bessel_i0(beta * math.sqrt(max(1 - w * w, 0)))


def get_blackman_nuttall_tap(x: float, n_taps: int, fc: float) -> float:
    y = math.pi * x
    s = _sinc_pi(y, fc)
    w = 2.0 * y / n_taps + math.pi
    return s * (0.3635819 - 0.4891775 * math.cos(w)
                + 0.1365995 * math.cos(2 * w)
                - 0.0106411 * math.cos(3 * w))


def get_linear_tap(x: float, n_taps: int) -> float:
    return ((n_taps + 1) // 2 * 2) / 2 - abs(x)


def get_cubic_tap(x: float, n_taps: int, b: float, c: float) -> float:
    a = abs(x * 4.0) / n_taps
    a2, a3 = a * a, a ** 3
    if a <= 1.0:
        return ((12 - 9 * b - 6 * c) * a3 + (-18 + 12 * b + 6 * c) * a2
                + (6 - 2 * b)) / 6.0
    if a <= 2.0:
        return ((-b - 6 * c) * a3 + (6 * b + 30 * c) * a2
                + (-12 * b - 48 * c) * a + (8 * b + 24 * c)) / 6.0
    return 0.0


def convert_taps_int(tmp: np.ndarray, weight: float, precision: int) -> np.ndarray:
    """MAKE_CONVERT_TAPS_INT_FUNC: DC-exact bisection to sum 2^prec - 1."""
    one = (1 << precision) - 1
    mult = float(one)
    l_off, h_off, off = 0.0, 1.0, 0.5
    dest = None
    for _ in range(32):
        dest = np.floor(off + tmp * mult / weight).astype(np.int64)
        s = int(dest.sum())
        if s == one:
            break
        if l_off == h_off:
            break
        if s < one:
            if off > l_off:
                l_off = off
            off += (h_off - l_off) / 2
        else:
            if off < h_off:
                h_off = off
            off -= (h_off - l_off) / 2
    return dest


@dataclass
class AudioResampler:
    method: str
    in_rate: int
    out_rate: int
    quality: int = DEFAULT_QUALITY
    cubic_b: float = 1.0
    cubic_c: float = 0.0
    # filter construction (audio-resampler.c:1100-1168): "full" builds
    # every phase from the sinc directly; "interpolated" builds a small
    # oversampled table and interpolates per-phase taps from it (the
    # variable-rate / huge-phase-count mode); "auto" per the reference
    # heuristic (out_rate <= oversample or memory under 1 MiB -> full)
    filter_mode: str = "auto"
    filter_interpolation: str = "cubic"   # linear | cubic
    filter_oversample: int = 8
    device: Any = None

    def __post_init__(self):
        self.device = resolve(self.device)
        g = math.gcd(self.in_rate, self.out_rate)
        self.in_red = self.in_rate // g
        self.out_red = self.out_rate // g
        self._loaded: Dict[str, np.ndarray] = {}
        self._blocks: Dict[str, Any] = {}
        self._calculate_taps()

    # -- tap generation (resampler_calculate_taps port) -------------------
    def _calculate_taps(self):
        method = self.method
        cutoff = 0.0
        beta = 0.0
        scale = True
        if method == METHOD_NEAREST:
            n_taps = 2
            scale = False
        elif method == METHOD_LINEAR:
            n_taps = 2
        elif method == METHOD_CUBIC:
            n_taps = 4
        elif method == METHOD_BLACKMAN_NUTTALL:
            n_taps, cutoff = BLACKMAN_QUALITIES[self.quality]
        elif method == METHOD_KAISER:
            q = KAISER_QUALITIES[self.quality]
            fc = q[0]
            if self.out_rate < self.in_rate:
                fc *= q[1]
            A = q[2]
            tr_bw = q[3]
            if A > 50:
                beta = 0.1102 * (A - 8.7)
            elif A >= 21:
                beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21)
            dw = 2 * math.pi * tr_bw
            n_taps = int((A - 8.0) / (2.285 * dw)) + 1
            cutoff = fc
        else:
            raise ValueError(f"unknown method {method!r}")

        if self.out_rate < self.in_rate and scale:
            cutoff = cutoff * self.out_rate / self.in_rate
            n_taps = (n_taps * self.in_rate) // self.out_rate

        if method in (METHOD_KAISER, METHOD_BLACKMAN_NUTTALL):
            n_taps = (n_taps + 7) & ~7     # GST_ROUND_UP_8

        self.n_taps = n_taps
        self.cutoff = cutoff
        self.beta = beta
        self.n_phases = self.out_red

        # oversample for the interpolated table (:1119-1142)
        mult = 2
        ov = self.filter_oversample
        while ov > 1:
            if mult * self.out_rate >= self.in_rate:
                break
            mult *= 2
            ov >>= 1
        if self.filter_interpolation == "linear":
            ov *= 11
        self.oversample = ov

        mode = self.filter_mode
        if mode == "auto":
            # bps=4 (the float32 compute layout) in the memory heuristic
            if self.out_rate <= ov or 4 * n_taps * self.out_rate < 1048576:
                mode = "full"
            else:
                mode = "interpolated"
        if method == "nearest":
            mode = "full"
        self.effective_filter_mode = mode

        if mode == "interpolated":
            isize = 2 if self.filter_interpolation == "linear" else 4
            # rows at x = -n/2 + i/ov for i in [-1, ov+isize): the cubic
            # window brackets the target between rows offset and offset+1
            # with one row of margin on each side
            self.base_taps_f64 = np.stack([
                self._make_taps_at(-(n_taps // 2) + i / ov)
                for i in range(-1, ov + isize)])
            self.taps_f64 = np.stack([
                self._interp_phase_f64(p) for p in range(self.n_phases)])
        else:
            self.base_taps_f64 = None
            self.taps_f64 = np.stack([
                self._make_phase_taps(p) for p in range(self.n_phases)])

    # -- interpolated-mode helpers (GET_TAPS_FULL_FUNC :529-550) ----------
    def _interp_geometry(self, phase: int):
        pos = phase * self.oversample
        offset = (self.oversample - 1) - pos // self.n_phases
        frac = pos % self.n_phases
        return offset, frac

    def _interp_coeffs(self, frac: int):
        """make_coeff_gdouble_linear/_cubic (:333,:360)."""
        x = frac / self.n_phases
        if self.filter_interpolation == "linear":
            return np.array([x, 1.0 - x])
        x2, x3 = x * x, x * x * x
        c0 = 0.16667 * (x3 - x)
        c1 = x + 0.5 * (x2 - x3)
        c3 = -0.33333 * x + 0.5 * x2 - 0.16667 * x3
        c2 = 1.0 - c0 - c1 - c3
        return np.array([c0, c1, c2, c3])

    def _interp_phase_f64(self, phase: int) -> np.ndarray:
        offset, frac = self._interp_geometry(phase)
        ic = self._interp_coeffs(frac)
        # base_taps row i lives at array index i+1 (leading margin row);
        # linear brackets rows [offset, offset+1], cubic [offset-1..+2]
        start = (offset + 1) if self.filter_interpolation == "linear" \
            else offset
        rows = self.base_taps_f64[start:start + len(ic)]
        return (ic[:, None] * rows).sum(axis=0)

    def _make_phase_taps(self, phase: int) -> np.ndarray:
        return self._make_taps_at(1.0 - self.n_taps / 2
                                  - phase / self.n_phases)

    def _make_taps_at(self, x0: float) -> np.ndarray:
        n = self.n_taps
        t = np.empty(n, np.float64)
        for i in range(n):
            x = x0 + i
            if self.method == METHOD_KAISER:
                t[i] = get_kaiser_tap(x, n, self.cutoff, self.beta)
            elif self.method == METHOD_BLACKMAN_NUTTALL:
                t[i] = get_blackman_nuttall_tap(x, n, self.cutoff)
            elif self.method == METHOD_LINEAR:
                t[i] = get_linear_tap(x, n)
            elif self.method == METHOD_CUBIC:
                t[i] = get_cubic_tap(x, n, self.cubic_b, self.cubic_c)
            else:  # nearest
                t[i] = 1.0 if i == n // 2 else 0.0
        return t

    def taps_for(self, dtype: str) -> np.ndarray:
        """(n_phases, n_taps) taps in the compute dtype.
        s16/s32: DC-exact ints; f32/f64: weight-normalized floats.  Taps
        given to ``load_taps`` take the place of the computed ones."""
        if dtype in self._loaded:
            return self._loaded[dtype].copy()
        w = self.taps_f64.sum(axis=1)
        if dtype in ("s16", "s32"):
            prec = PRECISION[dtype]
            return np.stack([
                convert_taps_int(self.taps_f64[p], w[p], prec)
                for p in range(self.n_phases)])
        out = self.taps_f64 / w[:, None]
        return out.astype(np.float32 if dtype == "f32" else np.float64)

    # -- geometry ---------------------------------------------------------
    def out_frames_for(self, in_frames: int, samp_index: int = 0,
                       samp_phase: int = 0) -> int:
        """How many outputs are computable from in_frames inputs such that
        the full tap window is available."""
        need = self.n_taps
        # closed form: idx_j = (j*in_red + ph0)//out_red + idx0
        # last valid j satisfies idx_j + need <= in_frames
        lhs = (in_frames - samp_index - need) * self.out_red - samp_phase
        if lhs < 0:
            return 0
        return lhs // self.in_red + 1

    def latency(self) -> int:
        """gst_audio_resampler_get_in_frames latency = n_taps/2."""
        return self.n_taps // 2

    # -- application ------------------------------------------------------
    def resample_ref(self, samples: np.ndarray, dtype: str,
                     samp_phase: int = 0,
                     n_out: Optional[int] = None) -> np.ndarray:
        """Numpy gold: sequential phase loop, exact integer rounding.
        samples: (frames, channels) int32 (s16/s32 full-scale canonical is
        NOT used here — the element resamples in the stream format) or
        float.  Returns (out_frames, channels)."""
        taps = self.taps_for(dtype)
        if n_out is None:
            n_out = self.out_frames_for(len(samples),
                                        samp_phase=samp_phase)
        channels = samples.shape[1]
        out = np.zeros((n_out, channels),
                       np.int64 if dtype in ("s16", "s32") else samples.dtype)
        idx, ph = samp_phase // self.out_red, samp_phase % self.out_red
        prec = PRECISION.get(dtype)
        lim = 1 << (15 if dtype == "s16" else 31)
        for j in range(n_out):
            window = samples[idx:idx + self.n_taps].astype(
                np.int64 if prec else samples.dtype)
            acc = (window * taps[ph][:, None]).sum(axis=0)
            if prec:
                acc = (acc + (1 << (prec - 1))) >> prec
                acc = np.clip(acc, -lim, lim - 1)
            out[j] = acc
            ph += self.in_red
            idx += ph // self.out_red
            ph %= self.out_red
        if prec:
            out = out.astype(np.int16 if dtype == "s16" else np.int32)
        return out

    # -- interop ----------------------------------------------------------
    def load_taps(self, arrays: Dict[str, np.ndarray]) -> None:
        """Run on the taps of another resampler (``interop.resampler_arrays``
        of either package's AudioResampler): its rates and tap count must
        be this one's."""
        for key in ("in_red", "out_red", "n_taps"):
            if int(arrays[key]) != getattr(self, key):
                raise ValueError(f"load_taps: {key} {int(arrays[key])} is "
                                 f"not this resampler's {getattr(self, key)}")
        self._loaded = {dt: np.asarray(arrays[f"taps.{dt}"])
                        for dt in DTYPES if f"taps.{dt}" in arrays}
        self._blocks.clear()

    # -- application on torch ---------------------------------------------
    def resample_fn(self, dtype: str, in_frames: int, channels: int):
        """fn(x) for chunks of a fixed length: x (..., in_frames, channels)
        on the resampler's device -> (..., out_frames_for(in_frames),
        channels), from start phase 0."""
        n_out = self.out_frames_for(in_frames)

        def fn(x):
            if tuple(x.shape[-2:]) != (in_frames, channels):
                raise ValueError(f"resample_fn: want (..., {in_frames}, "
                                 f"{channels}), got {tuple(x.shape)}")
            return self._resample(x, dtype, 0, n_out)

        return fn

    def resample_fn_phased(self, dtype: str, in_frames: int, n_out: int):
        """fn(x, ph0): like resample_fn with the start phase as an argument
        (the cross-chunk phase continuity of gst_audio_resampler_resample,
        audio-resampler.c:1750); n_out outputs."""
        def fn(x, ph0):
            if x.shape[-2] != in_frames:
                raise ValueError(f"resample_fn_phased: want {in_frames} "
                                 f"frames, got {x.shape[-2]}")
            return self._resample(x, dtype, int(ph0), n_out)

        return fn

    def _resample(self, x: torch.Tensor, dtype: str, ph0: int,
                  n_out: int) -> torch.Tensor:
        dev = self.device
        if x.device.type != dev.type or (
                dev.index is not None and x.device.index != dev.index):
            raise ValueError(f"AudioResampler on {dev} got a tensor on "
                             f"{x.device}; move it first")
        if dtype not in DTYPES:
            raise ValueError(f"unknown resampler dtype {dtype!r}")
        *lead, n_in, ch = x.shape
        # one row per (chunk, channel): (rows, frames)
        rows = x.movedim(-1, -2).reshape(-1, n_in)
        if dtype == "s32":
            v = rows.to(torch.int64)
            parts = (v >> 16, v & 0xFFFF)     # high limb signed, low in [0, 2^16)
        else:
            parts = (rows,)
        acc = [self._products(p, dtype, ph0, n_out) for p in parts]
        if dtype in PRECISION:
            prec = PRECISION[dtype]
            lim = 1 << (15 if dtype == "s16" else 31)
            a = acc[0].to(torch.int64)
            if dtype == "s32":
                a = a * (1 << 16) + acc[1].to(torch.int64)
            a = (a + (1 << (prec - 1))) >> prec
            out = torch.clamp(a, -lim, lim - 1).to(
                torch.int16 if dtype == "s16" else torch.int32)
        else:
            out = acc[0].to(torch.float32 if dtype == "f32"
                            else torch.float64)
        return out.reshape(*lead, ch, n_out).movedim(-2, -1).contiguous()

    def _products(self, v, dtype, ph0, n_out):
        """(rows, frames) -> (rows, n_out) sums of tap products: float64,
        or int64 from the tap loop for integer dtypes; integer inputs give
        exact integers."""
        if n_out <= 0:
            return torch.zeros((v.shape[0], 0), dtype=torch.float64,
                               device=v.device)
        table = self._block_table(dtype)
        if "m" not in table:
            return self._tap_loop(v, table["taps"], ph0, n_out)
        return self._block_product(v.to(torch.float64), table, ph0, n_out)

    def _block_table(self, dtype: str):
        """The banded matrix of one block from start phase 0 with one spare
        period, on the device, with its geometry; where it would exceed
        _BLOCK_MAX entries, only the taps (for the tap loop).  Cached per
        dtype."""
        if dtype not in self._blocks:
            up, down, n = self.out_red, self.in_red, self.n_taps
            periods = -(-2 * n // down)        # input step >= 2 filters
            outs = periods * up                # outputs per block
            # rows of the window the latest start phase needs
            width = (up - 1 + (outs - 1) * down) // up + n
            cols = outs + up - 1
            nrows = (up - 1) * down // up + width
            taps = self.taps_for(dtype)
            table = dict(taps=taps)
            if nrows * cols <= _BLOCK_MAX:
                taps = taps.astype(np.float64)
                if dtype == "s32":
                    worst = np.abs(taps).sum(axis=1).max() * (1 << 16)
                    if worst >= 2.0 ** 53:
                        raise ValueError("s32 taps too large for exact "
                                         "16-bit limb products")
                tot = np.arange(cols, dtype=np.int64) * down
                base, phase = tot // up, tot % up
                m = np.zeros((nrows, cols))
                m[base[:, None] + np.arange(n), np.arange(cols)[:, None]] = \
                    taps[phase]
                table.update(m=torch.as_tensor(m, device=self.device),
                             outs=outs, step=periods * down, width=width,
                             inv=pow(down, -1, up) if up > 1 else 0)
            self._blocks[dtype] = table
        return self._blocks[dtype]

    def _block_slice(self, table, ph0: int) -> torch.Tensor:
        """The (width, outs) block matrix for start phase ph0: the outputs
        of the phase-0 table from the first one whose phase is ph0, rows
        shifted by the input frames before it."""
        up, down = self.out_red, self.in_red
        first = ph0 * table["inv"] % up
        shift = (first * down - ph0) // up
        return table["m"][shift:shift + table["width"],
                          first:first + table["outs"]]

    def _block_product(self, v, table, ph0, n_out):
        outs, step, width = table["outs"], table["step"], table["width"]
        n_blocks = -(-n_out // outs)
        need = (n_blocks - 1) * step + width
        if v.shape[-1] < need:
            v = F.pad(v, (0, need - v.shape[-1]))
        windows = v[:, :need].unfold(-1, width, step)   # (rows, blocks, width)
        out = torch.matmul(windows, self._block_slice(table, ph0))
        return out.reshape(v.shape[0], -1)[:, :n_out]

    def _tap_loop(self, v, taps, ph0, n_out):
        """The plain route: one gathered product per tap, summed in int64
        for integer taps (wrapping as the reference's int64 sums do) or in
        float64."""
        tot = ph0 + np.arange(n_out, dtype=np.int64) * self.in_red
        idx = torch.as_tensor(tot // self.out_red, device=v.device)
        wide = torch.int64 if taps.dtype.kind == "i" else torch.float64
        taps = torch.as_tensor(taps[tot % self.out_red], device=v.device
                               ).to(wide)
        v = v.to(wide)
        acc = torch.zeros((v.shape[0], n_out), dtype=wide, device=v.device)
        for t in range(self.n_taps):
            acc += v.index_select(-1, idx + t) * taps[:, t]
        return acc
