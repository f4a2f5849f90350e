"""Property animation -- control sources and bindings.

A copy of the JAX package's ``core/controller.py`` (host only; reference:
subprojects/gstreamer/gst/gstcontrolsource.c / gstcontrolbinding.c and
libs/gst/controller: interpolation, trigger and LFO control sources):
element properties sampled from a time-varying source.

A property an element lists in ``DYNAMIC_PROPS`` and that has a control
source (``Element.set_control_source``) becomes a per-tick input of the
element's ``make_dyn_fn``: the port's ``Pipeline.tick`` samples it at the
tick's timestamp as a float32 and no rebuild happens.  ``Controller``
applies bindings on the host at tick boundaries (per-buffer granularity,
like the reference's sync_values on buffer timestamps).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import List, Tuple


class ControlSource:
    def value_at(self, ts_ns: int) -> float:
        raise NotImplementedError


class InterpolationControlSource(ControlSource):
    """GstInterpolationControlSource: none/linear/cubic between keyframes."""

    def __init__(self, mode: str = "linear"):
        self.mode = mode
        self._points: List[Tuple[int, float]] = []

    def set(self, ts_ns: int, value: float) -> None:
        ts_list = [p[0] for p in self._points]
        i = bisect.bisect_left(ts_list, ts_ns)
        if i < len(self._points) and self._points[i][0] == ts_ns:
            self._points[i] = (ts_ns, value)
        else:
            self._points.insert(i, (ts_ns, value))

    def unset(self, ts_ns: int) -> None:
        self._points = [p for p in self._points if p[0] != ts_ns]

    def value_at(self, ts_ns: int) -> float:
        pts = self._points
        if not pts:
            return 0.0
        ts_list = [p[0] for p in pts]
        i = bisect.bisect_right(ts_list, ts_ns)
        if i == 0:
            return pts[0][1]
        if i >= len(pts):
            return pts[-1][1]
        if self.mode == "none":
            return pts[i - 1][1]
        t0, v0 = pts[i - 1]
        t1, v1 = pts[i]
        f = (ts_ns - t0) / (t1 - t0)
        return v0 + (v1 - v0) * f


class LFOControlSource(ControlSource):
    """GstLFOControlSource: sine/square/saw/triangle oscillator."""

    def __init__(self, waveform: str = "sine", frequency: float = 1.0,
                 amplitude: float = 1.0, offset: float = 0.5,
                 timeshift: int = 0):
        self.waveform = waveform
        self.frequency = frequency
        self.amplitude = amplitude
        self.offset = offset
        self.timeshift = timeshift

    def value_at(self, ts_ns: int) -> float:
        t = (ts_ns - self.timeshift) / 1e9
        ph = (t * self.frequency) % 1.0
        if self.waveform == "sine":
            v = math.sin(2 * math.pi * ph)
        elif self.waveform == "square":
            v = 1.0 if ph < 0.5 else -1.0
        elif self.waveform == "saw":
            v = 1.0 - 2.0 * ph
        else:  # triangle
            v = 4 * ph - 1 if ph < 0.5 else 3 - 4 * ph
        return self.offset + self.amplitude * v


class TriggerControlSource(InterpolationControlSource):
    def __init__(self, tolerance_ns: int = 0):
        super().__init__(mode="none")
        self.tolerance = tolerance_ns


@dataclass
class ControlBinding:
    element: object
    prop: str
    source: ControlSource
    # direct binding maps the raw value; proportional maps [0,1] to range
    mode: str = "direct"

    def sync(self, ts_ns: int) -> None:
        v = self.source.value_at(ts_ns)
        typ = self.element.PROPERTIES[self.prop][0]
        if typ is int:
            v = int(round(v))
        self.element.set_property(self.prop, v)


class Controller:
    """Applies bindings at tick boundaries (install via attach())."""

    def __init__(self):
        self.bindings: List[ControlBinding] = []

    def bind(self, element, prop: str, source: ControlSource,
             mode: str = "direct") -> ControlBinding:
        b = ControlBinding(element, prop, source, mode)
        self.bindings.append(b)
        return b

    def sync_values(self, ts_ns: int) -> None:
        for b in self.bindings:
            b.sync(ts_ns)
