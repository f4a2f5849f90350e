"""Core utility elements (reference: subprojects/gstreamer/plugins/elements/
— capsfilter, identity, fakesink, queue, appsrc/appsink from
gst-libs/gst/app).

Copies of the JAX package's ``elements/util_elements.py`` classes of the
same names.  `capsfilter` and `identity` are structural; `queue` is
structural in a fully composed graph and a one-tick double buffer in a
graph split by host elements.  `appsrc` takes numpy arrays or tensors
(the pipeline moves them to its device), and `appsink` hands out the
tensors as they arrive, on the pipeline's device.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional

from ..core.buffer import Buffer, FlowReturn, Sample
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, TransformElement,
                            register_element)


@register_element
class CapsFilter(TransformElement):
    """capsfilter (gstcapsfilter.c): constrains negotiation, passthrough."""
    FACTORY = "capsfilter"
    KLASS = "Generic"
    DESCRIPTION = "Pass data without modification, limiting formats"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {"caps": (object, None, "restricting caps")}

    def __init__(self, name=None, **props):
        if "caps" in props and isinstance(props["caps"], str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)

    def transform_caps(self, direction, caps, filter=None):
        res = caps
        if self.props["caps"] is not None:
            res = res.intersect(self.props["caps"])
        if filter is not None:
            res = res.intersect(filter)
        return res


@register_element
class Identity(TransformElement):
    """identity (gstidentity.c): passthrough, optional callbacks."""
    FACTORY = "identity"
    DESCRIPTION = "Pass data without modification"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "silent": (bool, True, "suppress notifications"),
        "dump": (bool, False, "dump buffer contents"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.handoffs: List[Callable[[Buffer], None]] = []

    def process_meta(self, buf: Buffer) -> Buffer:
        for cb in self.handoffs:
            cb(buf)
        return buf


@register_element
class Queue(TransformElement):
    """queue (gstqueue.c:211-216): in the reference this decouples
    streaming threads.  Inside a fully composed graph it is structural;
    in a graph already split by host elements the pipeline promotes it
    to a ONE-TICK DOUBLE BUFFER — downstream consumes tick N-1's
    (device-resident) data while tick N's kernels are queued on the
    stream.  Pending data flushes at EOS (Pipeline._propagate drain)."""
    FACTORY = "queue"
    DESCRIPTION = "Simple data queue (decouples host-split pipelines)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "max-size-buffers": (int, 200, "max buffers"),
        "max-size-bytes": (int, 10485760, "max bytes"),
        "max-size-time": (int, 1000000000, "max time (ns)"),
        "leaky": (str, "no", "leak mode (leaky queues stay structural)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._decouple = False
        self._pending_buf = None

    def start(self):
        self._pending_buf = None

    def host_process(self, buf):
        if not self._decouple:
            return buf
        out, self._pending_buf = self._pending_buf, buf
        return out


@register_element
class FakeSink(SinkElement):
    """fakesink (gstfakesink.c): swallow buffers, count them."""
    FACTORY = "fakesink"
    DESCRIPTION = "Black hole for data"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "silent": (bool, True, ""),
        "sync": (bool, False, "sync on clock (no real-time clock here)"),
        "num-buffers": (int, -1, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.n_rendered = 0
        self.last_buffer: Optional[Buffer] = None

    def render(self, buf: Buffer) -> str:
        self.n_rendered += buf.batch
        self.last_buffer = buf
        return FlowReturn.OK


@register_element
class AppSink(SinkElement):
    """appsink (gst-libs/gst/app/gstappsink.c): the app boundary —
    buffers land in a host-side queue; `pull_sample()` returns them as
    Samples whose data are tensors on the pipeline's device."""
    FACTORY = "appsink"
    DESCRIPTION = "Allow the application to get access to raw buffer"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "max-buffers": (int, 0, "max queued samples (0 = unlimited)"),
        "drop": (bool, False, "drop old buffers when full"),
        "emit-signals": (bool, False, ""),
        "sync": (bool, False, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._queue: deque = deque()
        self._received = 0         # lifetime count (harness statistics)
        self.new_sample_cb: Optional[Callable[["AppSink"], None]] = None
        self.events: list = []     # observed stream events (EOS/GAP/...)

    def render(self, buf: Buffer) -> str:
        maxb = self.props["max-buffers"]
        if maxb and len(self._queue) >= maxb:
            if self.props["drop"]:
                self._queue.popleft()
            # without drop the reference would block; batched model just grows
        # per-buffer caps (parsers attach refined caps in meta) win
        # over the negotiated pad caps — samples carry their own caps
        # (gstappsink.c: gst_sample_new with the buffer's caps)
        caps = (buf.meta or {}).get("caps") or self.sink_pads()[0].caps
        self._queue.append(Sample(buf, caps))
        self._received += 1
        if self.new_sample_cb:
            self.new_sample_cb(self)
        return FlowReturn.OK

    def pull_sample(self) -> Optional[Sample]:
        return self._queue.popleft() if self._queue else None

    def try_pull_sample(self, timeout=None) -> Optional[Sample]:
        return self.pull_sample()

    def __len__(self):
        return len(self._queue)

    def sink_event(self, pad, event) -> bool:
        """Record stream events (EOS/GAP/CAPS/TAG...) so the app can
        observe them, like gst_app_sink's eos signal / event access."""
        self.events.append(event)
        return super().sink_event(pad, event)

    @property
    def is_eos(self) -> bool:
        from ..core.events import EventType
        return any(e.type == EventType.EOS for e in self.events)


@register_element
class AppSrc(SourceElement):
    """appsrc (gstappsrc.c:2800 push_buffer): the app feeds arrays in."""
    FACTORY = "appsrc"
    DESCRIPTION = "Allow the application to feed buffers"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "caps": (object, None, "caps of the pushed data"),
        "format": (str, "time", ""),
        "is-live": (bool, False, ""),
    }

    def __init__(self, name=None, **props):
        if "caps" in props and isinstance(props["caps"], str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)
        self._queue: deque = deque()
        self._eos = False

    def push_buffer(self, buf: Buffer) -> str:
        if self._eos:
            return FlowReturn.EOS
        self._queue.append(buf)
        return FlowReturn.OK

    def end_of_stream(self) -> None:
        self._eos = True

    def set_caps(self, caps) -> None:
        """Mid-stream caps switch (gst_app_src_set_caps): buffers pushed
        before this call drain under the old caps; the next batch after
        the marker renegotiates the pipeline (CAPS event semantics,
        gstevent.c:905)."""
        if isinstance(caps, str):
            caps = Caps.from_string(caps)
        self._queue.append(("__caps__", caps))

    def push_gap(self, pts: int, duration: int) -> None:
        """Send a GAP event downstream (gst_event_new_gap semantics:
        'no data for this interval'); delivered via the pad event flow."""
        from ..core.events import gap_event
        for sp in self.src_pads():
            sp.push_event(gap_event(pts, duration))

    def check_reconfigure(self) -> bool:
        if self._queue and isinstance(self._queue[0], tuple) \
                and self._queue[0][0] == "__caps__":
            _, caps = self._queue.popleft()
            self.props["caps"] = caps
            return True
        return super().check_reconfigure()

    def get_caps(self, filter=None):
        caps = self.props["caps"] or Caps.any()
        if filter is not None:
            caps = caps.intersect(filter) if not caps.is_any else filter
        return caps

    def create(self, n_frames: int) -> Optional[Buffer]:
        # stop at a caps marker: those buffers belong to the next config
        if self._queue and not (isinstance(self._queue[0], tuple)
                                and self._queue[0][0] == "__caps__"):
            return self._queue.popleft()
        return None  # EOS when drained (or renegotiation pending)

