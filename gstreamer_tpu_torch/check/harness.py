"""Harness — single-element test rig.

TPU-native re-design of GstHarness (reference:
subprojects/gstreamer/libs/gst/check/gstharness.c — floating src/sink pads
around one element, auto caps/segment, :50 docs; launch-line support
gst_harness_new_parse).

    h = Harness("videoconvert")
    h.set_caps("video/x-raw,format=I420,width=8,height=8",
               "video/x-raw,format=RGB,width=8,height=8")
    out = h.push(planes)        # returns the transformed data

A port of the JAX package's ``check/harness.py``: the harness's pipeline,
its appsrc, appsink and capsfilter and its src and sink sub-harnesses run on
the harness's device, CUDA unless ``device`` names another (no fallback to
the CPU); ``push`` returns what the sink received, on that device.
"""

from __future__ import annotations

from typing import Any, Optional

from ..core.buffer import Buffer, Sample
from ..core.caps import Caps
from ..core.element import element_factory_make
from ..core.parse import parse_launch
from ..core.pipeline import Pipeline, link


class Harness:
    def __init__(self, element_or_launch: str, device=None, **props):
        self.pipeline = Pipeline(device=device)
        self.device = self.pipeline.device
        if ("!" in element_or_launch or " " in element_or_launch.strip()):
            inner = parse_launch(element_or_launch, device=self.device)
            elems = inner.iterate_elements()
            for e in elems:
                e.parent = None
            self.pipeline.add(*elems)
            self.element = elems[0]
            self._last = elems[-1]
        else:
            self.element = element_factory_make(element_or_launch, **props)
            self.pipeline.add(self.element)
            self._last = self.element
        self.src = element_factory_make("appsrc", name="hsrc")
        self.sink = element_factory_make("appsink", name="hsink")
        # only wire the floating pads that the element actually has
        # (a source-only launch gets no appsrc, sink-only no appsink)
        if self.element.sink_pads() \
                and not any(p.peer for p in self.element.sink_pads()):
            self.pipeline.add(self.src)
            link(self.src, self.element)
        if self._last.src_pads() \
                and not any(p.peer for p in self._last.src_pads()):
            self.pipeline.add(self.sink)
            link(self._last, self.sink)
        self._compiled = False

    def set_caps(self, src_caps: str, sink_caps: Optional[str] = None):
        self.src.set_property("caps", Caps.from_string(src_caps))
        if sink_caps:
            cf = element_factory_make("capsfilter",
                                      caps=Caps.from_string(sink_caps))
            # splice capsfilter between element and sink
            last_src = self._last.src_pads()[0]
            peer = last_src.peer
            last_src.peer = None
            peer.peer = None
            self.pipeline.add(cf)
            link(self._last, cf)
            link(cf, self.sink)
        return self

    def push(self, data: Any, pts: Optional[int] = None,
             duration: Optional[int] = None, batch: int = 1) -> Optional[Any]:
        """Push one buffer through; returns the output data (or None).
        With a sink sub-harness attached, output stays queued for
        push_to_sink (gst_harness_push does not pull)."""
        b = self.push_buffer(Buffer(data=data, pts=pts,
                                    duration=duration, batch=batch))
        return b.data if b is not None else None

    def push_buffer(self, buf: Buffer) -> Optional[Buffer]:
        self.src.push_buffer(buf)
        if not self._compiled:
            self.pipeline.compile()
            self.pipeline.set_state("playing")
            self._compiled = True
        self.pipeline.tick()
        if getattr(self, "sink_harness", None) is not None:
            return None                      # keep queued for push_to_sink
        s = self.sink.pull_sample()
        return s.buffer if s is not None else None

    def pull(self) -> Optional[Sample]:
        return self.sink.pull_sample()

    def try_pull(self) -> Optional[Sample]:
        """gst_harness_try_pull: non-blocking (the batch model never
        blocks, so this is pull without the implied expectation)."""
        return self.sink.pull_sample()

    @property
    def buffers_received(self) -> int:
        """gst_harness_buffers_received (queued + already pulled)."""
        return getattr(self.sink, "_received",
                       len(self.sink._queue)) or len(self.sink._queue)

    # -- events (gst_harness_push_event / _pull_event) ---------------------
    def push_event(self, event) -> bool:
        pads = self.element.sink_pads()
        if not pads:
            return False
        return self.element.sink_event(pads[0], event)

    @property
    def events(self) -> list:
        """Events observed at the harness sink."""
        return list(getattr(self.sink, "events", ()))

    # -- test clock (gst_harness_use_testclock / crank) --------------------
    def use_testclock(self):
        """Install a TestClock as the pipeline clock; clock-aware
        elements (clocksync) then gate buffers on it."""
        from .testclock import TestClock
        clock = TestClock()
        self.pipeline.use_clock(clock)
        return clock

    def crank_single_clock_wait(self) -> bool:
        """gst_harness_crank_single_clock_wait: advance the test clock
        to the earliest pending wait and release it.  In the batched
        model the released buffer flows on the next push/tick."""
        clock = self.pipeline.get_clock()
        if clock is None:
            return False
        return clock.process_next_clock_id() is not None

    # -- sub-harnesses (gst_harness_add_src / add_sink) --------------------
    def add_src(self, launch: str) -> "Harness":
        """Attach a source sub-harness whose output feeds this harness
        (gst_harness_add_src_parse).  Use push_from_src() to move one
        buffer across."""
        self.src_harness = Harness(launch, device=self.device)
        return self.src_harness

    def push_from_src(self) -> Optional[Any]:
        """gst_harness_push_from_src: pull one buffer from the src
        sub-harness and push it here."""
        sh = getattr(self, "src_harness", None)
        if sh is None:
            raise RuntimeError("no src harness (call add_src first)")
        if not sh._compiled:
            sh.pipeline.compile()
            sh.pipeline.set_state("playing")
            sh._compiled = True
        sh.pipeline.tick()
        s = sh.sink.pull_sample()
        if s is None:
            return None
        return self.push_buffer(s.buffer)

    def add_sink(self, launch: str) -> "Harness":
        """Attach a sink sub-harness consuming this harness's output
        (gst_harness_add_sink_parse).  Use push_to_sink()."""
        self.sink_harness = Harness(launch, device=self.device)
        return self.sink_harness

    def push_to_sink(self) -> Optional[Any]:
        """gst_harness_push_to_sink: move one pulled output into the
        sink sub-harness."""
        sh = getattr(self, "sink_harness", None)
        if sh is None:
            raise RuntimeError("no sink harness (call add_sink first)")
        s = self.sink.pull_sample()
        if s is None:
            return None
        # forward the sticky caps into the sub-harness (the reference
        # forwards the caps event automatically)
        if sh.src.props.get("caps") is None and s.caps is not None:
            sh.src.set_property("caps", s.caps)
        return sh.push_buffer(s.buffer)

    @property
    def sinkpad_caps(self) -> Optional[Caps]:
        pads = self.element.sink_pads()
        return pads[0].caps if pads else None

    @property
    def srcpad_caps(self) -> Optional[Caps]:
        pads = self._last.src_pads()
        return pads[0].caps if pads else None
