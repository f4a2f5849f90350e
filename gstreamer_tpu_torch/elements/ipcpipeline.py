"""ipcpipeline — split one logical pipeline across two processes.

Clean-room reduction of gst-plugins-bad/sys/ipcpipeline/
(gstipcpipelinesink.c, gstipcpipelinesrc.c, gstipcslavepipeline.c):
the master's ipcpipelinesink serializes negotiated caps + buffers +
EOS over a file descriptor; the slave's ipcpipelinesrc replays them
as a live source.  The wire format is the GStreamer Data Protocol
framing already implemented for gdppay/gdpdepay (elements/gdp.py,
dp-private.h analog) — the reference uses its own protocol.h with
the same caps/buffer/event record classes.

Master process:  ... ! ipcpipelinesink fdout=W
Slave process:   ipcpipelinesrc fdin=R ! ...   (ipcslavepipeline is
the slave-side pipeline wrapper; here the source element itself
carries the slave semantics and the name is registered over it).

A port of the JAX package's ``elements/ipcpipeline.py`` on the port's
``elements/gdp.py``: the sink copies each tick's data to the host to
frame it; the source's host arrays are staged by its pipeline.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..core.buffer import Buffer, FlowReturn
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)
from ..utils.log import get_logger
from .gdp import (PAYLOAD_BUFFER, PAYLOAD_CAPS, _deserialize_payload,
                  _serialize_payload, dp_packet, dp_parse)

_log = get_logger("ipcpipeline")

# GDP event payload class (gst dp-private.h: events are 64 + type);
# only EOS crosses the boundary in this reduction
PAYLOAD_EVENT_EOS = 64


@register_element
class IpcPipelineSink(SinkElement):
    """ipcpipelinesink (gstipcpipelinesink.c): forwards caps, buffers
    and EOS to the slave process over `fdout`."""
    FACTORY = "ipcpipelinesink"
    DESCRIPTION = "Allows splitting and continuing a pipeline in "\
                  "another process"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "fdout": (int, -1, "write fd towards the slave"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._caps_sent = False
        self._caps = None

    def start(self):
        self._caps_sent = False
        if self.props["fdout"] < 0:
            raise RuntimeError("ipcpipelinesink: no fdout")

    def set_caps(self, caps) -> None:
        self._caps = caps

    def render(self, buf: Buffer) -> str:
        fd = self.props["fdout"]
        caps = self._caps
        if caps is None:
            pad = self.sink_pads()[0]
            caps = pad.caps
        if caps is None:
            # ANY-caps upstream: without a caps record the slave
            # cannot deserialize — fail the flow (the pipeline posts
            # the bus error) instead of raising from
            # _serialize_payload.
            _log.error("ipcpipelinesink %s: no caps negotiated on the "
                       "sink pad; cannot frame buffers", self.name)
            return FlowReturn.ERROR
        out = bytearray()
        if not self._caps_sent:
            out += dp_packet(PAYLOAD_CAPS,
                             str(caps).encode() + b"\0")
            self._caps_sent = True
        for k, p in enumerate(_serialize_payload(buf, caps)):
            out += dp_packet(PAYLOAD_BUFFER, p, pts=buf.pts,
                             duration=buf.duration)
        try:
            off = 0
            data = bytes(out)
            while off < len(data):
                off += os.write(fd, data[off:])
            return FlowReturn.OK
        except OSError:
            return FlowReturn.ERROR

    def stop(self):
        fd = self.props["fdout"]
        if fd >= 0:
            try:
                os.write(fd, dp_packet(PAYLOAD_EVENT_EOS, b""))
            except OSError:
                pass


@register_element
class IpcPipelineSrc(SourceElement):
    """ipcpipelinesrc (gstipcpipelinesrc.c): replays the master's
    caps/buffers from `fdin` until the EOS record."""
    FACTORY = "ipcpipelinesrc"
    DESCRIPTION = "Continues a split pipeline from another process"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "fdin": (int, -1, "read fd from the master"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._acc = bytearray()
        self._caps: Optional[Caps] = None
        self._queue: List = []
        self._eos = False

    def _pump(self) -> None:
        """Read fd until a full record parses (blocking read like the
        reference's socket wait)."""
        fd = self.props["fdin"]
        while not self._eos:
            pos = 0
            r = None
            try:
                r = dp_parse(bytes(self._acc), 0)
            except ValueError:
                self._eos = True
                return
            if r is not None:
                ptype, payload, pts, dur, nxt = r
                del self._acc[:nxt]
                if ptype == PAYLOAD_CAPS:
                    self._caps = Caps.from_string(
                        payload.rstrip(b"\0").decode())
                    continue
                if ptype == PAYLOAD_EVENT_EOS:
                    self._eos = True
                    return
                if ptype == PAYLOAD_BUFFER:
                    self._queue.append((payload, pts, dur))
                    return
                continue
            chunk = os.read(fd, 65536)
            if not chunk:
                self._eos = True
                return
            self._acc += chunk

    def get_caps(self, filter=None):
        if self._caps is None and self.props["fdin"] >= 0:
            self._pump()                         # caps precede data
            while self._caps is None and not self._eos:
                self._pump()
        caps = self._caps if self._caps is not None else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def create(self, n_frames: int) -> Optional[Buffer]:
        if not self._queue and not self._eos:
            self._pump()
        if not self._queue:
            return None
        payload, pts, dur = self._queue.pop(0)
        data, batch = _deserialize_payload([payload], self._caps)
        return Buffer(data=data, pts=pts, duration=dur, batch=batch)


@register_element
class IpcSlavePipeline(IpcPipelineSrc):
    """ipcslavepipeline (gstipcslavepipeline.c): the slave-process
    pipeline wrapper; in this collapsed model the source element
    itself carries the slave role, so the name registers over it."""
    FACTORY = "ipcslavepipeline"
    DESCRIPTION = "Contains the slave part of an inter-process "\
                  "pipeline"
