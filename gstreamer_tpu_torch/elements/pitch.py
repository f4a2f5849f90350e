"""pitch — SoundTouch-style pitch/tempo/rate shifter.

A host copy of the JAX package's ``elements/pitch.py`` over the port's
scaletempo: the samples go to the host and the output returns to their
device.

Reference: gst-plugins-bad/ext/soundtouch/gstpitch.cc — F32 audio,
properties pitch/tempo/rate/output-rate (:143-166).  SoundTouch
decomposes the effect into a WSOLA time-stretcher (TDStretch) plus a
linear-interpolation rate transposer; this port does the same with
our scaletempo WSOLA (gstscaletempo.c math) as the stretcher:

* WSOLA scale s = tempo / pitch      (duration x pitch/tempo, pitch kept)
* transposer step q = pitch * rate   (duration / (pitch*rate), pitch x q)
* net: duration x 1/(tempo*rate), pitch x (pitch*rate) — the
  SoundTouch contract.  `output-rate` adds a further transposer
  factor (the reference retimes the segment; the batched model
  resamples to the same effect on the sample stream).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from .scaletempo import Scaletempo

_F32 = ("audio/x-raw, format=F32LE, rate=[8000,192000], "
        "channels=[1,2], layout=interleaved")


@register_element
class Pitch(TransformElement):
    FACTORY = "pitch"
    DESCRIPTION = "Control the pitch of an audio stream"
    HOST_ELEMENT = True
    _decouple = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _F32),
        PadTemplate("src", PadDirection.SRC, _F32),
    ]
    PROPERTIES = {
        "pitch": (float, 1.0, "audio stream pitch"),
        "tempo": (float, 1.0, "audio stream tempo"),
        "rate": (float, 1.0, "audio stream rate"),
        "output-rate": (float, 1.0, "output rate on downstream side"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._stretch: Optional[Scaletempo] = None
        self._frac = 0.0
        self._tail: Optional[np.ndarray] = None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(_F32)
        out = []
        for s in caps:
            ns = res[0].copy()
            for k in ("rate", "channels"):
                if k in s.fields:
                    ns[k] = s[k]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._incaps = incaps
        s = self._wsola_scale()
        if s != 1.0:
            self._stretch = Scaletempo(rate=s)
            self._stretch.set_info(incaps, incaps)
            self._stretch.start()
        else:
            self._stretch = None

    def _wsola_scale(self) -> float:
        return self.props["tempo"] / self.props["pitch"]

    def _step(self) -> float:
        return (self.props["pitch"] * self.props["rate"]
                * self.props["output-rate"])

    def start(self):
        self._frac = 0.0
        self._tail = None

    def flush(self):
        self.start()
        if self._stretch is not None:
            self._stretch.flush()

    @property
    def _pending_buf(self):
        return True if self._tail is not None else None

    def _transpose(self, x: np.ndarray) -> np.ndarray:
        """Linear-interpolation rate transposer (SoundTouch
        RateTransposer): read position advances by `step` per output
        sample, with one-sample history carried between buffers."""
        step = self._step()
        if step == 1.0:
            return x
        if self._tail is not None:
            x = np.concatenate([self._tail, x], axis=0)
            base = 1.0 - self._frac if self._frac > 0 else 0.0
        n = x.shape[0]
        if n < 2:
            self._tail = x
            return x[:0]
        start = self._frac
        pos = start + np.arange(
            0, max(0.0, (n - 1 - start)) / step + 1) * step
        pos = pos[pos <= n - 1 + 1e-9]
        i = np.minimum(pos.astype(np.int64), n - 2)
        f = (pos - i)[:, None].astype(x.dtype)
        out = x[i] * (1 - f) + x[i + 1] * f
        consumed = pos[-1] if len(pos) else start
        nxt = consumed + step
        self._frac = float(nxt - (n - 1))
        self._tail = x[n - 1:n]
        return out

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:                          # EOS drain
            self._tail = None
            return None
        x = host_array(buf.data)
        if self._stretch is not None:
            sbuf = self._stretch.host_process(buf)
            if sbuf is None:
                return None
            x = host_array(sbuf.data)
            buf = sbuf
        out = self._transpose(x if x.ndim == 2 else x[:, None])
        if out.shape[0] == 0:
            return None
        if x.ndim == 1:
            out = out[:, 0]
        rate = self._incaps[0]["rate"]
        return buf.with_(data=device_array(out, buf.data),
                         duration=out.shape[0] * 1_000_000_000
                         // rate)
