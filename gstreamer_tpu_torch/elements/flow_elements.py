"""Flow-control elements: concat, funnel, input-selector, output-selector,
streamiddemux, clocksync, multiqueue, downloadbuffer (structural).

References: subprojects/gstreamer/plugins/elements/ — gstconcat.c
(sequential N:1), gstfunnel.c (N:1 forward whatever arrives),
gstinputselector.c / gstoutputselector.c, gststreamiddemux.c,
gstclocksync.c.  In the batched runtime several of these reduce to
metadata-plane routing decisions.

Copies of the JAX package's ``elements/flow_elements.py`` classes.  The
N-to-1 elements run on the pipeline's aggregator path, taking
``{sink pad: value}`` and forwarding one value (a tuple of planes, or one
audio tensor: input-selector tests its choice against None, since a
tensor has no truth value).  output-selector fans out to every branch, as
in the reference (its ``active-pad`` is not read).  clocksync with a
``check.TestClock`` on the pipeline is a host element that holds host
``Buffer``s until the clock reaches their timestamps; without one it is
structural.
"""

from __future__ import annotations

from typing import Dict

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, TransformElement, register_element)


def _root(elem):
    """The outermost bin holding `elem` (the pipeline, which owns the
    clock)."""
    root = elem
    while getattr(root, "parent", None) is not None:
        root = root.parent
    return root


@register_element
class Concat(AggregatorElement):
    """concat: outputs streams one after the other.  In the batched model
    each tick takes the first still-active input in pad order."""
    FACTORY = "concat"
    DESCRIPTION = "Concatenate multiple streams"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, Caps.any()),
        PadTemplate("sink_%u", PadDirection.SINK, Caps.any(),
                    PadPresence.REQUEST),
    ]

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed: Caps) -> Caps:
        first = next(iter(sorted(in_caps.items())))[1]
        return first

    def aggregate_fn(self):
        def fn(inputs):
            for name in sorted(inputs):
                return inputs[name]
        return fn


@register_element
class Funnel(AggregatorElement):
    """funnel: N:1, forwards input as it arrives (here: pad order)."""
    FACTORY = "funnel"
    DESCRIPTION = "Funnel pipe fitting"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, Caps.any()),
        PadTemplate("sink_%u", PadDirection.SINK, Caps.any(),
                    PadPresence.REQUEST),
    ]

    def negotiate_output(self, in_caps, allowed):
        return next(iter(sorted(in_caps.items())))[1]

    def aggregate_fn(self):
        def fn(inputs):
            return inputs[sorted(inputs)[0]]
        return fn


@register_element
class InputSelector(AggregatorElement):
    """input-selector: forwards exactly one of N inputs."""
    FACTORY = "input-selector"
    DESCRIPTION = "N-to-1 input stream selector"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, Caps.any()),
        PadTemplate("sink_%u", PadDirection.SINK, Caps.any(),
                    PadPresence.REQUEST),
    ]
    PROPERTIES = {"active-pad": (str, "sink_0", "name of the active pad")}

    def negotiate_output(self, in_caps, allowed):
        active = self.props["active-pad"]
        return in_caps.get(active) or next(iter(sorted(in_caps.items())))[1]

    def aggregate_fn(self):
        active = self.props["active-pad"]

        def fn(inputs):
            v = inputs.get(active)
            return v if v is not None else inputs[sorted(inputs)[0]]
        return fn


@register_element
class OutputSelector(TransformElement):
    """output-selector: 1:N, meant to route to the active src pad only.
    Like the reference's, this one sends the data down every linked
    branch: `active-pad` is declared and not read (ROADMAP.md section
    3)."""
    FACTORY = "output-selector"
    DESCRIPTION = "1-to-N output stream selector"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.REQUEST),
    ]
    PROPERTIES = {"active-pad": (str, "src_0", "")}


@register_element
class StreamIdDemux(TransformElement):
    """streamiddemux: demux by stream-id; single-stream passthrough in
    the batched model (multi-stream routing in a later round)."""
    FACTORY = "streamiddemux"
    DESCRIPTION = "Demultiplex by stream id"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.REQUEST),
    ]


@register_element
class ClockSync(TransformElement):
    """clocksync: waits for buffer running time on the clock.  The
    batched offline runtime has no realtime clock; with sync=false (the
    useful offline setting) this is passthrough, and timestamps are
    already carried on the metadata plane."""
    FACTORY = "clocksync"
    DESCRIPTION = "Synchronize buffers to the clock"
    HOST_ELEMENT = False
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {"sync": (bool, True, ""),
                  "ts-offset": (int, 0, "ns offset added to timestamps")}

    def _test_clock(self):
        root = _root(self)
        clock = getattr(root, "clock", None)
        return clock if (clock is not None
                         and hasattr(clock, "process_next_clock_id")) \
            else None

    def set_info(self, incaps, outcaps):
        # with a TestClock installed on the pipeline, clocksync becomes
        # a host-side gate that holds buffers until the clock is
        # cranked past their timestamps (gst_test_clock semantics in
        # the batched model); without one it stays a fused passthrough
        self.HOST_ELEMENT = (self.props["sync"]
                             and self._test_clock() is not None)

    def start(self):
        self._held = []

    def host_process(self, buf):
        clock = self._test_clock()
        if buf is not None:
            off = self.props["ts-offset"]
            if off and buf.pts is not None:
                buf = buf.with_(pts=buf.pts + off)
            if clock is not None and buf.pts is not None \
                    and buf.pts > clock.get_time():
                clock.new_single_shot_id(buf.pts)
                self._held.append(buf)
                buf = None
        # release any held buffers the clock has reached
        if clock is not None and self._held:
            ready = [b for b in self._held
                     if b.pts <= clock.get_time()]
            if ready:
                self._held = [b for b in self._held
                              if b.pts > clock.get_time()]
                # merge the released buffer in front (one per tick)
                out = ready[0]
                self._held = ready[1:] + self._held
                if buf is not None:
                    self._held.append(buf)
                return out
        return buf

    @property
    def _pending_buf(self):
        return True if getattr(self, "_held", None) else None

    _decouple = True

    def process_meta(self, buf: Buffer) -> Buffer:
        off = self.props["ts-offset"]
        if off and buf.pts is not None and not self.HOST_ELEMENT:
            return buf.with_(pts=buf.pts + off)
        return buf


@register_element
class MultiQueue(TransformElement):
    """multiqueue: structural in the batched runtime (like queue)."""
    FACTORY = "multiqueue"
    DESCRIPTION = "Multiple data queue (structural)"
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK, Caps.any(),
                    PadPresence.REQUEST),
        PadTemplate("src_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.REQUEST),
    ]
    PROPERTIES = {
        "max-size-buffers": (int, 5, ""),
        "max-size-bytes": (int, 10485760, ""),
        "max-size-time": (int, 0, ""),
    }
