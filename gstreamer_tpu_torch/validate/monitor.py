"""Validation monitors and scenarios.

TPU-native re-design of gst-validate (reference:
subprojects/gst-devtools/validate/ — monitor objects wrapping pipeline/
elements/pads checking protocol invariants, gst-validate-pad-monitor.c;
declarative scenarios gst-validate-scenario.h:97).

A PipelineMonitor subscribes to the tracer hooks and checks:
* timestamps are monotonically non-decreasing per element
* durations are sane (positive when present)
* every linked pad has fixed caps after negotiation
* buffers only flow while PLAYING; EOS is posted exactly once
A Scenario is a list of (tick, action) pairs executed against a running
pipeline (seek / stop, mirroring the seek/pause/set-state actions of the
reference scenario format).

A copy of the JAX package's ``validate/monitor.py`` over the port's
``core/tracer.py`` hooks.  Every check reads host values (timestamps,
durations and batch sizes are Python integers, caps and events host
objects), so monitoring reads nothing back from the device; the
appsrc-push action hands its data (numpy arrays or tensors) to the appsrc
as it is, and the pipeline stages it on its device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.tracer import Tracer, hooks


def _array(x):
    """A pushed plane as the appsrc takes it: a tensor as it is (on its
    device), anything else as a numpy array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class Violation:
    kind: str
    element: str
    detail: str

    def __repr__(self):
        return f"<{self.kind} on {self.element}: {self.detail}>"


class PadMonitor:
    """Per-pad protocol monitor (gst-validate-pad-monitor.c): installs an
    event probe on a SINK pad and checks the event protocol —
    STREAM_START before CAPS before SEGMENT before data, fixed caps in
    CAPS events, sane SEGMENT/GAP payloads, EOS at most once."""

    ORDER = {"stream-start": 0, "caps": 1, "segment": 2}

    def __init__(self, pad, violations: List[Violation]):
        self.pad = pad
        self.violations = violations
        self._seen: List[str] = []
        self._eos = 0
        pad.event_probes.append(self._probe)

    def _v(self, kind, detail):
        self.violations.append(Violation(
            kind, f"{self.pad.element.name}.{self.pad.name}", detail))

    def _probe(self, pad, ev):
        from ..core.events import EventType

        t = ev.type
        if t in self.ORDER:
            for prev in self._seen:
                if prev in self.ORDER and self.ORDER[prev] > self.ORDER[t]:
                    self._v("event-order",
                            f"{t} after {prev}")
            self._seen.append(t)
        if t == EventType.CAPS:
            caps = ev.data.get("caps")
            if caps is None or not caps.is_fixed():
                self._v("caps-event-not-fixed", str(caps))
        if t == EventType.SEGMENT:
            seg = ev.data.get("segment")
            if seg is not None and getattr(seg, "rate", 1.0) == 0:
                self._v("segment-zero-rate", "")
        if t == EventType.GAP:
            if ev.data.get("duration", 0) < 0:
                self._v("gap-negative-duration",
                        str(ev.data.get("duration")))
        if t == EventType.EOS:
            self._eos += 1
            if self._eos > 1:
                self._v("eos-twice", "")
        return ev

    def check_buffer_allowed(self):
        """Data may only flow after STREAM_START+CAPS+SEGMENT
        (gst-validate-pad-monitor buffer-before-segment checks)."""
        missing = [t for t in ("stream-start", "caps", "segment")
                   if t not in self._seen]
        if missing:
            self._v("buffer-before-events", ",".join(missing))


class PipelineMonitor(Tracer):
    name = "validate"

    VALID_FLOW = {"ok", "eos", "flushing", "not-linked", "not-negotiated",
                  "error"}

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.violations: List[Violation] = []
        self._last_pts: Dict[str, int] = {}
        self._eos_count = 0
        self.pad_monitors: Dict[Any, PadMonitor] = {}
        for e in pipeline.iterate_elements():
            for p in e.pads:
                if p.direction == "sink" and p.peer is not None:
                    self.pad_monitors[p] = PadMonitor(p, self.violations)
        hooks.install(self)
        pipeline.bus.add_watch(self._on_message)

    # -- hooks ------------------------------------------------------------
    def subscribe(self):
        return {
            "pipeline-negotiated": self._on_negotiated,
            "buffer-post": self._on_buffer,
            "buffer-pre": self._on_buffer_pre,
            "flow-return": self._on_flow,
        }

    def _on_buffer_pre(self, element, buf):
        # data reaching a sink pad before its sticky protocol events
        for p in element.sink_pads():
            pm = self.pad_monitors.get(p)
            if pm is not None:
                pm.check_buffer_allowed()

    def _on_flow(self, element, ret):
        if ret not in self.VALID_FLOW:
            self.violations.append(Violation(
                "invalid-flow-return", element.name, repr(ret)))

    def _on_negotiated(self, pipeline):
        if pipeline is not self.pipeline:
            return
        # (re)negotiation replays the sticky set — reset per-pad event
        # order tracking (the reference re-arms monitors on caps changes)
        for pm in self.pad_monitors.values():
            pm._seen.clear()
        for e in pipeline.iterate_elements():
            for p in e.pads:
                if p.peer is not None and (p.caps is None
                                           or not p.caps.is_fixed()):
                    self.violations.append(Violation(
                        "caps-not-fixed", e.name, f"pad {p.name}"))

    def _on_buffer(self, element, buf):
        pts = buf.pts
        if pts is not None:
            last = self._last_pts.get(element.name)
            if last is not None and pts < last:
                self.violations.append(Violation(
                    "timestamp-regression", element.name,
                    f"{pts} < {last}"))
            self._last_pts[element.name] = pts
        if buf.duration is not None and buf.duration < 0:
            self.violations.append(Violation(
                "negative-duration", element.name, str(buf.duration)))
        if buf.batch <= 0:
            self.violations.append(Violation(
                "empty-batch", element.name, str(buf.batch)))

    def _on_message(self, msg):
        if msg.type == "eos":
            self._eos_count += 1
            if self._eos_count > 1:
                self.violations.append(Violation(
                    "multiple-eos", msg.src or "?", ""))
        elif msg.type == "error":
            self.violations.append(Violation(
                "error-message", msg.src or "?", str(msg.data)))

    # -- reporting --------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        return {"violations": [repr(v) for v in self.violations]}

    def reset_timestamps(self):
        """Call after a flushing seek (timestamps legitimately jump)."""
        self._last_pts.clear()

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclass
class Scenario:
    """Declarative action list (gst-validate-scenario equivalent):
    actions = [(tick_index, fn(pipeline)), ...] — e.g.
    Scenario([(5, lambda p: p.seek(0))]).run(pipeline)"""

    actions: List[Tuple[int, Callable]] = field(default_factory=list)
    max_ticks: Optional[int] = None

    @staticmethod
    def seek(to_ns: int, stop_ns=None, rate: float = 1.0,
             flush: bool = True):
        """gst-validate seek action (start/stop/rate/flags)."""
        return lambda p: p.seek(to_ns, stop=stop_ns, rate=rate,
                                flush=flush)

    @staticmethod
    def stop():
        def _stop(p):
            p.set_state("null")
            return "stop"
        return _stop

    @staticmethod
    def set_property(element_name: str, prop: str, value):
        """gst-validate set-property action."""
        def _set(p):
            e = p.get_by_name(element_name)
            if e is None:
                raise ValueError(f"no element {element_name!r}")
            e.set_property(prop, value)
        return _set

    @staticmethod
    def eos_injection():
        """gst-validate eos action: end every source's stream."""
        def _eos(p):
            from ..core.element import SourceElement
            for e in p.iterate_elements():
                if isinstance(e, SourceElement):
                    if hasattr(e, "end_of_stream"):
                        e.end_of_stream()
                    elif "num-buffers" in e.props:
                        e.props["num-buffers"] = 0
        return _eos

    @staticmethod
    def set_state(state: str):
        """gst-validate set-state action."""
        def _set(p):
            from ..core.pipeline import State
            p.set_state(getattr(State, state.upper(), state))
        return _set

    @staticmethod
    def wait(ticks: int = 1):
        """gst-validate wait action: let `ticks` iterations pass
        without intervening (timing-based waits collapse to tick
        counts in the batch model)."""
        def _wait(p):
            return None
        _wait.__name__ = f"wait_{ticks}"
        return _wait

    @staticmethod
    def pause(ticks: int = 1):
        """gst-validate pause action: hold the pipeline for `ticks`
        loop iterations (then the play action — or the hold expiring —
        resumes it)."""
        def _pause(p):
            return ("pause", ticks)
        return _pause

    @staticmethod
    def play():
        """gst-validate play action: resume from pause immediately."""
        def _play(p):
            return "play"
        return _play

    @staticmethod
    def flush():
        """gst-validate flush action: flushing seek to the current
        position (FLUSH_START/STOP + state reset)."""
        def _flush(p):
            p.seek(getattr(p, "_position_ns", 0), flush=True)
            return "flushed"
        return _flush

    @staticmethod
    def switch_pad(selector_name: str, pad_name: str):
        """gst-validate switch-pad action: flip an input-selector's
        active-pad property."""
        def _switch(p):
            e = p.get_by_name(selector_name)
            if e is None:
                raise ValueError(f"no element {selector_name!r}")
            e.set_property("active-pad", pad_name)
        return _switch

    @staticmethod
    def set_caps(source_name: str, caps: str):
        """Mid-stream caps switch on an appsrc (renegotiation action)."""
        def _set(p):
            p.get_by_name(source_name).set_caps(caps)
        return _set

    @staticmethod
    def select_streams(element_name: str, streams):
        """gst-validate switch-track / select-streams action
        (gst-validate-scenario.c execute_switch_track): restrict a
        multi-stream element (decodebin3/uridecodebin/demuxer) to the
        named streams; pass None to reselect all."""
        def _sel(p):
            e = p.get_by_name(element_name)
            if e is None or not hasattr(e, "select_streams"):
                raise ValueError(
                    f"no stream-selectable element {element_name!r}")
            e.select_streams(streams)
        return _sel

    @staticmethod
    def appsrc_push(source_name: str, data, pts=None):
        """gst-validate appsrc-push action: feed one buffer into a
        named appsrc (gst-validate-scenario.c _execute_appsrc_push)."""
        def _push(p):
            from ..core.buffer import Buffer
            e = p.get_by_name(source_name)
            if e is None or not hasattr(e, "push_buffer"):
                raise ValueError(f"no appsrc {source_name!r}")
            if isinstance(data, Buffer):
                buf = data
            elif isinstance(data, (tuple, list)):
                buf = Buffer(data=type(data)(_array(x) for x in data),
                             batch=1, pts=pts)
            else:
                buf = Buffer(data=_array(data), batch=1, pts=pts)
            e.push_buffer(buf)
        return _push

    @staticmethod
    def appsrc_eos(source_name: str):
        """gst-validate appsrc-eos action."""
        def _eos(p):
            e = p.get_by_name(source_name)
            if e is None or not hasattr(e, "end_of_stream"):
                raise ValueError(f"no appsrc {source_name!r}")
            e.end_of_stream()
        return _eos

    @staticmethod
    def check_position(expected_ns: int, tolerance_ns: int = 0):
        """gst-validate check-position action: assert the pipeline's
        position query (gst-validate-scenario.c
        _execute_check_position)."""
        def _chk(p):
            pos = p.query_position()
            if pos is None or abs(pos - expected_ns) > tolerance_ns:
                raise AssertionError(
                    f"position {pos} != {expected_ns} "
                    f"(±{tolerance_ns})")
        return _chk

    def run(self, pipeline, monitor=None) -> None:
        pending = sorted(self.actions, key=lambda a: a[0])
        n = 0
        hold = 0
        while self.max_ticks is None or n < self.max_ticks:
            resumed = False
            while pending and pending[0][0] <= n:
                _, fn = pending.pop(0)
                r = fn(pipeline)
                if r == "stop":
                    return
                if isinstance(r, tuple) and r[0] == "pause":
                    hold = max(hold, r[1])
                elif r == "play":
                    hold = 0
                    resumed = True
                elif r == "flushed" and monitor is not None:
                    monitor.reset_timestamps()
            if hold > 0 and not resumed:
                # paused: no data flows this iteration, but scenario
                # time still advances so play actions can fire
                hold -= 1
                n += 1
                continue
            if not pipeline.tick():
                break
            n += 1
        pipeline.set_state("null")
