"""FFT library — GstFFT equivalent.

Reference: subprojects/gst-plugins-base/gst-libs/gst/fft/ (Kiss-FFT
wrappers gstffts16/s32/f32/f64 — forward real FFT of n samples to n/2+1
complex values, unscaled; inverse unscaled (caller divides by n);
window functions gst_fft_*_window: hamming/hann/bartlett/blackman).

A copy of the JAX package's ``audio/fft.py``: host code, the transform
is the ``xp`` module's ``fft.rfft`` (the spectrum element passes numpy);
integer variants mirror the reference's fixed-point API surface by
scaling through float.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

WINDOW_RECTANGULAR = "rectangular"
WINDOW_HAMMING = "hamming"
WINDOW_HANN = "hann"
WINDOW_BARTLETT = "bartlett"
WINDOW_BLACKMAN = "blackman"


def window(xp, n: int, kind: str):
    """gst_fft_*_window coefficients (gstfftf64.c:gst_fft_f64_window)."""
    i = xp.arange(n)
    a = 2.0 * math.pi * i / n
    if kind == WINDOW_RECTANGULAR:
        return xp.ones(n)
    if kind == WINDOW_HAMMING:
        return 0.53836 - 0.46164 * xp.cos(a)
    if kind == WINDOW_HANN:
        return 0.5 - 0.5 * xp.cos(a)
    if kind == WINDOW_BARTLETT:
        return 1.0 - xp.abs((2.0 * i - n) / n)
    if kind == WINDOW_BLACKMAN:
        return 0.42 - 0.5 * xp.cos(a) + 0.08 * xp.cos(2 * a)
    raise ValueError(f"unknown window {kind!r}")


class FFT:
    """Real FFT context (GstFFTF64 etc.).  len must be even (the
    reference requires even lengths)."""

    def __init__(self, length: int, inverse: bool = False):
        if length % 2:
            raise ValueError("FFT length must be even")
        self.length = length
        self.inverse = inverse

    def fft(self, xp, timedata, win: Optional[str] = None):
        """(..., n) real -> (..., n/2+1) complex, unscaled (KissFFT
        convention)."""
        if timedata.shape[-1] != self.length:
            raise ValueError("bad input length")
        x = timedata
        if win and win != WINDOW_RECTANGULAR:
            x = x * window(xp, self.length, win)
        return xp.fft.rfft(x)

    def ifft(self, xp, freqdata):
        """(..., n/2+1) complex -> (..., n) real, unscaled by n (the
        caller divides, matching gst_fft_f64_inverse_fft docs)."""
        return xp.fft.irfft(freqdata, n=self.length) * self.length


def magnitude_db(xp, freqdata, nfft: int, decibels: bool = True):
    """Helper mirroring the spectrum element's magnitude computation."""
    mag = xp.abs(freqdata) / (nfft / 2)
    if decibels:
        return 20 * xp.log10(xp.maximum(mag, 1e-20))
    return mag
