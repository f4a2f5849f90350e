"""IIR equalizer — exact port of the reference band filters.

A host copy of the JAX package's ``audio/equalizer.py`` (numpy and scipy).

Reference: subprojects/gst-plugins-good/gst/equalizer/gstiirequalizer.c —
arg_to_scale 10^(dB/40) :421, calculate_omega :427, calculate_bw :442,
setup_peak_filter :469, setup_low_shelf_filter :507,
setup_high_shelf_filter :547, band layout (log-spaced 20..20000 Hz,
first band low-shelf / last high-shelf / middle peak) :683-696,
biquad recurrence one_step :727:

    y[n] = a0 x[n] + a1 x[n-1] + a2 x[n-2] + b1 y[n-1] + b2 y[n-2]

Bands cascade in series per channel.  The recurrence runs per buffer via
scipy.signal.lfilter with carried state (equivalent direct-form II
transposed; coefficients mapped b=[a0,a1,a2], a=[1,-b1,-b2]).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

LOWEST_FREQ = 20.0
HIGHEST_FREQ = 20000.0


def _arg_to_scale(arg: float) -> float:
    return 10.0 ** (arg / 40.0)


def _omega(freq: float, rate: int) -> float:
    if freq / rate >= 0.5:
        return math.pi
    if freq <= 0.0:
        return 0.0
    return 2.0 * math.pi * (freq / rate)


def _bw(width: float, rate: int) -> float:
    if width / rate >= 0.5:
        return math.pi - 0.00000001
    if width <= 0.0:
        return 0.0
    return 2.0 * math.pi * (width / rate)


@dataclass
class Band:
    freq: float
    width: float
    gain: float = 0.0
    type: str = "peak"        # peak | low-shelf | high-shelf
    a0: float = 1.0
    a1: float = 0.0
    a2: float = 0.0
    b1: float = 0.0
    b2: float = 0.0

    def setup(self, rate: int):
        gain = _arg_to_scale(self.gain)
        omega = _omega(self.freq, rate)
        bw = _bw(self.width, rate)
        if bw == 0.0:
            self.a0, self.a1, self.a2 = 1.0, 0.0, 0.0
            self.b1 = self.b2 = 0.0
            return
        alpha = math.tan(bw / 2.0)
        if self.type == "peak":
            alpha1 = alpha * gain
            alpha2 = alpha / gain
            b0 = 1.0 + alpha2
            self.a0 = (1.0 + alpha1) / b0
            self.a1 = (-2.0 * math.cos(omega)) / b0
            self.a2 = (1.0 - alpha1) / b0
            self.b1 = (2.0 * math.cos(omega)) / b0
            self.b2 = -(1.0 - alpha2) / b0
        elif self.type == "low-shelf":
            egm, egp = gain - 1.0, gain + 1.0
            delta = 2.0 * math.sqrt(gain) * alpha
            b0 = egp + egm * math.cos(omega) + delta
            self.a0 = ((egp - egm * math.cos(omega) + delta) * gain) / b0
            self.a1 = ((egm - egp * math.cos(omega)) * 2.0 * gain) / b0
            self.a2 = ((egp - egm * math.cos(omega) - delta) * gain) / b0
            self.b1 = ((egm + egp * math.cos(omega)) * 2.0) / b0
            self.b2 = -((egp + egm * math.cos(omega) - delta)) / b0
        else:   # high-shelf
            egm, egp = gain - 1.0, gain + 1.0
            delta = 2.0 * math.sqrt(gain) * alpha
            b0 = egp - egm * math.cos(omega) + delta
            self.a0 = ((egp + egm * math.cos(omega) + delta) * gain) / b0
            self.a1 = ((egm + egp * math.cos(omega)) * -2.0 * gain) / b0
            self.a2 = ((egp + egm * math.cos(omega) - delta) * gain) / b0
            self.b1 = ((egm - egp * math.cos(omega)) * -2.0) / b0
            self.b2 = -((egp - egm * math.cos(omega) - delta)) / b0


def make_bands(n: int) -> List[Band]:
    """gst_iir_equalizer_compute_frequencies (:683): log-spaced bands."""
    step = (HIGHEST_FREQ / LOWEST_FREQ) ** (1.0 / n)
    bands = []
    f0 = LOWEST_FREQ
    for i in range(n):
        f1 = f0 * step
        t = ("low-shelf" if i == 0
             else "high-shelf" if i == n - 1 else "peak")
        bands.append(Band(freq=f0 + (f1 - f0) / 2.0, width=f1 - f0, type=t))
        f0 = f1
    return bands


class IirEqualizer:
    """Cascaded biquads with carried per-channel history."""

    def __init__(self, n_bands: int, rate: int, channels: int):
        self.bands = make_bands(n_bands)
        self.rate = rate
        self.channels = channels
        self._zi: Optional[List[np.ndarray]] = None

    def set_gain(self, idx: int, gain_db: float):
        self.bands[idx].gain = gain_db
        self.bands[idx].setup(self.rate)

    def setup(self):
        for b in self.bands:
            b.setup(self.rate)
        self._zi = None

    def reset(self):
        self._zi = None

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: (frames, channels) float64 -> filtered float64."""
        from scipy.signal import lfilter

        if self._zi is None:
            self._zi = [np.zeros((2, self.channels)) for _ in self.bands]
        y = np.asarray(x, np.float64)
        for k, band in enumerate(self.bands):
            b = [band.a0, band.a1, band.a2]
            a = [1.0, -band.b1, -band.b2]
            y, self._zi[k] = lfilter(b, a, y, axis=0, zi=self._zi[k])
        return y
