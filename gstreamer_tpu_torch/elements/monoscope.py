"""monoscope — the classic trigger-stabilized oscilloscope visualizer.

Port of gst-plugins-good/gst/monoscope/:
* convolve_match (convolve.c:279-363): find the 256-sample window of
  the 512-sample input best matching the running average, by
  maximizing sum(input[p+j] * (avg_eq[j] - mean)); first maximizer
  wins (the reference's Karatsuba convolution is an evaluation
  strategy, not a semantic — its own debug block compares against
  this direct form).
* monoscope_update (monoscope.c:89-168): avg_eq = (win + avg_eq) >> 1,
  avgMax += max/4 - avgMax/4 (C truncating int division), column bars
  colored green->yellow->red by height (colors_init :58-73), dotted
  16px grid.  Fixed 256x128 canvas.

A copy of the JAX package's ``elements/monoscope.py`` on the port's
AudioVisualizerElement (host rasteriser, one upload a tick).
"""

from __future__ import annotations

import numpy as np

from ..core.caps import Caps
from ..core.element import PadDirection, register_element
from .visualizers import SINK_CAPS, AudioVisualizerElement

WIDTH, HEIGHT = 256, 128
SMALL, BIG = 256, 512

SRC_CAPS_MONO = ("video/x-raw, format=BGRx, width=256, height=128, "
                 "framerate=[1/1,2147483647/1]")


def _colors() -> np.ndarray:
    """colors_init (monoscope.c:58): green->yellow->red ramp."""
    hq = HEIGHT // 4
    hq1 = hq - 1
    hh1 = HEIGHT // 2 - 1
    scl = 256.0 / hq
    colors = np.zeros(HEIGHT // 2, np.uint32)
    for i in range(hq):
        colors[i] = (int(i * scl) << 16) + (255 << 8)
        colors[i + hq1] = (255 << 16) + (int((hq1 - i) * scl) << 8)
    colors[hh1] = (40 << 16) + (75 << 8)
    return colors


def convolve_match(avg_eq: np.ndarray, window: np.ndarray) -> int:
    """Direct-form convolve_match: corr[k] maximized, first winner."""
    mean = float(avg_eq.astype(np.float64).sum()) / SMALL
    right = avg_eq.astype(np.float64) - mean
    x = window.astype(np.float64)
    # corr[k] for k = 0..SMALL inclusive
    best_p, best = 0, None
    for k in range(SMALL + 1):
        c = float(np.dot(x[k:k + SMALL], right))
        if best is None or c > best:
            best, best_p = c, k
    return best_p


@register_element
class Monoscope(AudioVisualizerElement):
    FACTORY = "monoscope"
    DESCRIPTION = "Displays a highly stabilised waveform of audio input"
    PROPERTIES = dict(AudioVisualizerElement.PROPERTIES,
                      shader=(str, "none", "monoscope clears itself"))

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            SRC_CAPS_MONO if direction == PadDirection.SINK
            else SINK_CAPS)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def setup(self):
        self._req_spf = max(self._spf, BIG)
        self._avg_eq = np.zeros(SMALL, np.int64)
        self._avg_max = 0
        self._palette = _colors()

    def render(self, canvas: np.ndarray, data: np.ndarray) -> None:
        mono = data[:, 0].astype(np.int64)
        window = np.zeros(BIG, np.int64)
        window[:min(BIG, len(mono))] = mono[:BIG]

        p = convolve_match(self._avg_eq, window)
        this_eq = window[p:p + SMALL]
        avg = (this_eq + self._avg_eq) >> 1       # arithmetic shift
        self._avg_eq = avg
        mx = max(int(np.abs(avg).max()), 1)
        # C ints truncate toward zero; both operands non-negative here
        self._avg_max += mx // 4 - self._avg_max // 4

        hh = HEIGHT // 2
        hh1 = hh - 1
        factor = hh / self._avg_max if self._avg_max else 1.0

        view = canvas[:HEIGHT * WIDTH]
        view[:] = 0
        foo = np.clip((avg * factor).astype(np.int64), -hh1, hh1)
        for i in range(WIDTH):
            f = int(foo[i])
            bar = i + (f + hh) * WIDTH
            if 0 < bar < WIDTH * HEIGHT:
                if f < 0:
                    for h in range(-f + 1):
                        view[bar + h * WIDTH] = self._palette[h]
                else:
                    for h in range(f + 1):
                        view[bar - h * WIDTH] = self._palette[h]
        # dotted grid (monoscope.c:150-163)
        gray = self._palette[hh1]
        grid = view.reshape(HEIGHT, WIDTH)
        for i in range(16, HEIGHT, 16):
            grid[i, 0:WIDTH:2] = gray
            if i == hh:
                grid[i, 1:WIDTH:2] = gray
        for i in range(16, WIDTH, 16):
            grid[0:HEIGHT:2, i] = gray
