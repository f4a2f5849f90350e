"""bs2b — Bauer stereophonic-to-binaural crossfeed for headphones.

Reference: gst-plugins-bad/ext/bs2b/gstbs2b.c wraps libbs2b; the
underlying algorithm (Boris Mikhaylov's public-domain bs2b filter) is
implemented clean-room here: a one-pole lowpass feeds the opposite
channel, a one-pole/one-zero high-boost keeps the direct path, and
the sum is renormalized — coefficients derived from the crossfeed
level (cut frequency + feed dB) exactly as libbs2b's init().  A host copy
of the JAX package's ``elements/bs2b.py``: the samples go to the host
(scipy's ``lfilter``) and the output returns to their device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from .audiofx import device_samples

# presets: (cut frequency Hz, feed level dB) — libbs2b's
# BS2B_DEFAULT/CMOY/JMEIER_CLEVEL
PRESETS = {"default": (700, 4.5), "cmoy": (700, 6.0),
           "jmeier": (650, 9.5)}


def _coeffs(fcut: float, feed_db: float, rate: int):
    gb_lo = feed_db * -5.0 / 6.0 - 3.0
    gb_hi = feed_db / 6.0 - 3.0
    g_lo = 10.0 ** (gb_lo / 20.0)
    g_hi = 1.0 - 10.0 ** (gb_hi / 20.0)
    fc_hi = fcut * 2.0 ** ((gb_lo - 20.0 * math.log10(g_hi)) / 12.0)
    x = math.exp(-2.0 * math.pi * fcut / rate)
    b1_lo, a0_lo = x, g_lo * (1.0 - x)
    x = math.exp(-2.0 * math.pi * fc_hi / rate)
    b1_hi = x
    a0_hi = 1.0 - g_hi * (1.0 - x)
    a1_hi = -x
    gain = 1.0 / (1.0 - g_hi + g_lo)
    return (b1_lo, a0_lo), (b1_hi, a0_hi, a1_hi), gain


@register_element
class Bs2b(TransformElement):
    """bs2b: crossfeed left<->right with frequency-dependent level."""
    FACTORY = "bs2b"
    DESCRIPTION = "Improve headphone listening of stereo audio " \
                  "records using the bs2b library"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=F32LE, channels=2"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=F32LE, channels=2"),
    ]
    PROPERTIES = {
        "fcut": (int, 700, "lowpass cut frequency (Hz)"),
        "feed": (float, 4.5, "feed level (dB)"),
        "preset": (str, "", "default | cmoy | jmeier (overrides "
                            "fcut/feed)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._rate = 48000
        self._zi_lo = None

    def set_info(self, incaps, outcaps):
        r = incaps[0].get("rate")
        if isinstance(r, int) and r > 0:
            self._rate = r
        self._zi_lo = None

    def start(self):
        self._zi_lo = None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        from scipy.signal import lfilter
        x = host_array(buf.data).astype(np.float64)
        if x.ndim != 2 or x.shape[1] != 2:
            return buf
        fcut, feed = self.props["fcut"], self.props["feed"]
        if self.props["preset"] in PRESETS:
            fcut, feed = PRESETS[self.props["preset"]]
        (b1_lo, a0_lo), (b1_hi, a0_hi, a1_hi), gain = _coeffs(
            fcut, feed, self._rate)
        if self._zi_lo is None:
            self._zi_lo = [np.zeros(1), np.zeros(1),
                           np.zeros(1), np.zeros(1)]
        lo = np.empty_like(x)
        hi = np.empty_like(x)
        for c in range(2):
            lo[:, c], self._zi_lo[c] = lfilter(
                [a0_lo], [1.0, -b1_lo], x[:, c], zi=self._zi_lo[c])
            hi[:, c], self._zi_lo[2 + c] = lfilter(
                [a0_hi, a1_hi], [1.0, -b1_hi], x[:, c],
                zi=self._zi_lo[2 + c])
        out = np.empty_like(x)
        out[:, 0] = (hi[:, 0] + lo[:, 1]) * gain
        out[:, 1] = (hi[:, 1] + lo[:, 0]) * gain
        return buf.with_(data=device_samples(buf, out.astype(np.float32)))
