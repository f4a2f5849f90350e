"""Core utility elements (reference: subprojects/gstreamer/plugins/elements/
— capsfilter, identity, fakesrc/fakesink, queue, queue2, tee, valve,
downloadbuffer, appsrc/appsink from gst-libs/gst/app; watchdog from
gst-plugins-bad debugutils).

Copies of the JAX package's ``elements/util_elements.py`` classes of the
same names.  `capsfilter`, `identity` and `tee` are structural (tee's
fan-out is value reuse in the pipeline's step); `queue` and `queue2` are
structural in a fully composed graph and a one-tick double buffer in a
graph split by host elements.  `appsrc` takes numpy arrays or tensors
(the pipeline moves them to its device), and `appsink` hands out the
tensors as they arrive, on the pipeline's device.  `downloadbuffer` spools
the bytes of every buffer, taken to the host.  `valve drop=true` is a host
gate that lets nothing through; the reference declares the property and
never reads it (ROADMAP.md section 3).  `autovideosink` and
`autoaudiosink` resolve to fakevideosink and fakeaudiosink.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional

import numpy as np

from ..core.buffer import Buffer, FlowReturn, Sample, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadPresence, PadTemplate,
                            SinkElement, SourceElement, TransformElement,
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

    def flush(self):
        self._pending_buf = None

    def host_process(self, buf):
        if not self._decouple:
            return buf
        out, self._pending_buf = self._pending_buf, buf
        return out


@register_element
class Queue2(Queue):
    FACTORY = "queue2"
    DESCRIPTION = "Data queue with optional file buffering (structural)"


@register_element
class DownloadBuffer(TransformElement):
    """downloadbuffer (gstdownloadbuffer.c): spools the upstream byte
    stream to a temp file for seekable re-reads.  Host element: buffers
    pass through unchanged while their bytes (taken to the host) append to
    the spool; the element exposes the spool path and byte-range reads."""
    FACTORY = "downloadbuffer"
    DESCRIPTION = "Download buffer (spools to a temp file)"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "temp-template": (str, "/tmp/gtpu-download-XXXXXX", ""),
        "max-size-bytes": (int, 0, "0 = unlimited"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._file = None
        self.temp_location = None
        self.downloaded_bytes = 0

    def start(self):
        import os
        import tempfile

        tmpl = self.props["temp-template"]
        prefix = tmpl.split("XXXXXX")[0]
        fd, self.temp_location = tempfile.mkstemp(
            prefix=prefix.rsplit("/", 1)[-1] or "gtpu-download-")
        self._file = os.fdopen(fd, "wb")
        self.downloaded_bytes = 0

    def stop(self):
        if self._file:
            self._file.close()
            self._file = None

    def host_process(self, buf: Buffer):
        data = buf.data
        leaves = (data if isinstance(data, (tuple, list)) else (data,))
        for leaf in leaves:
            raw = host_array(leaf).tobytes()
            cap = self.props["max-size-bytes"]
            if cap and self.downloaded_bytes + len(raw) > cap:
                raw = raw[:max(0, cap - self.downloaded_bytes)]
            self._file.write(raw)
            self.downloaded_bytes += len(raw)
        self._file.flush()
        return buf

    def read_range(self, offset: int, size: int) -> bytes:
        """Seekable read from the spool (the element's purpose)."""
        with open(self.temp_location, "rb") as f:
            f.seek(offset)
            return f.read(size)


@register_element
class Tee(TransformElement):
    """tee (gsttee.c): 1:N fan-out -- value reuse in the pipeline's step."""
    FACTORY = "tee"
    DESCRIPTION = "1-to-N pipe fitting"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.REQUEST),
    ]
    PROPERTIES = {"allow-not-linked": (bool, False, "")}


@register_element
class Valve(TransformElement):
    """valve (gstvalve.c): with drop=true no buffer passes -- a host gate
    (set at negotiation) whose ``host_process`` swallows every buffer, so
    the elements after it see none; with drop=false it is structural.  The
    reference declares `drop` and defines no function, so its drop=true
    passes everything (ROADMAP.md section 3)."""
    FACTORY = "valve"
    DESCRIPTION = "Drops buffers when drop=true"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {"drop": (bool, False, "drop buffers")}

    def set_info(self, incaps, outcaps):
        self.HOST_ELEMENT = bool(self.props["drop"])

    def host_process(self, buf):
        return None if self.props["drop"] else buf


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



@register_element
class FakeSrc(SourceElement):
    """fakesrc (gstfakesrc.c): produce empty buffers (zeros on the host,
    moved to the pipeline's device like any source's)."""
    FACTORY = "fakesrc"
    DESCRIPTION = "Push empty (random) buffers around"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "num-buffers": (int, -1, "number of buffers then EOS"),
        "sizemax": (int, 4096, "buffer size"),
        "silent": (bool, True, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._count = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        num = self.props["num-buffers"]
        if num >= 0 and self._count >= num:
            return None
        n = n_frames if num < 0 else min(n_frames, num - self._count)
        data = np.zeros((n, self.props["sizemax"]), np.uint8)
        buf = Buffer(data=data, pts=self._count, batch=n)
        self._count += n
        return buf


@register_element
class AutoVideoSink(FakeSink):
    """autovideosink: with no display server it resolves to the fake
    video renderer (the reference auto-plugs the highest-rank video sink;
    fakevideosink is the highest-rank one that exists here)."""
    FACTORY = "autovideosink"
    DESCRIPTION = "Auto-plugged video sink (offline: fakevideosink)"

    def __new__(cls, name=None, **props):
        from .debug_elements import FakeVideoSink
        return FakeVideoSink(name=name, **props)


@register_element
class AutoAudioSink(FakeSink):
    """autoaudiosink: resolves to the ring-buffer-backed fake audio
    sink, keeping real audio-sink timing semantics."""
    FACTORY = "autoaudiosink"
    DESCRIPTION = "Auto-plugged audio sink (offline: fakeaudiosink)"

    def __new__(cls, name=None, **props):
        from .audio_sinks import FakeAudioSink
        return FakeAudioSink(name=name, **props)


@register_element
class Watchdog(TransformElement):
    """watchdog (gst-plugins-bad gst/debugutils/gstwatchdog.c): posts an
    ERROR on the bus when no buffer passes for `timeout` ms -- stall
    detection for live pipelines.  Armed on the first buffer: the first
    tick may include building kernels, which is not a stall."""
    FACTORY = "watchdog"
    DESCRIPTION = "Watches the pipeline for data flow stalls"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "timeout": (int, 1000, "stall timeout (ms)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._last = None
        self._thread = None
        self._running = False
        self.triggered = False

    def _bus(self):
        p = self.parent
        while p is not None and not hasattr(p, "bus"):
            p = p.parent
        return getattr(p, "bus", None)

    def start(self):
        # armed on the FIRST buffer (the reference arms on PLAYING)
        self._running = False
        self.triggered = False

    def _arm(self):
        import threading
        import time

        self._last = time.monotonic()
        self._running = True
        bus = self._bus()

        def watch():
            while self._running:
                time.sleep(self.props["timeout"] / 4000.0)
                if not self._running:
                    return
                dt = time.monotonic() - self._last
                if dt * 1000.0 > self.props["timeout"]:
                    self.triggered = True
                    if bus is not None:
                        from ..core.pipeline import Message
                        bus.post(Message(
                            "error", self.name,
                            {"error": "Watchdog triggered", "domain":
                             "stream", "ms-since-last": int(dt * 1000)}))
                    return

        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(1.0)

    def process_meta(self, buf):
        import time
        self._last = time.monotonic()
        if not self._running and not self.triggered:
            self._arm()
        return buf
