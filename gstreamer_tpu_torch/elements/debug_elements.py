"""Debug utility elements — gst-plugins-good/gst/debugutils +
gst-plugins-bad debugutils equivalents.

progressreport (progressreport.c: periodic "progress" element messages
with percent/current/total), taginject (gsttaginject.c: pushes a TAG
event once before the first buffer), capssetter (gstcapssetter.c:
merges caps fields in place), breakmydata (breakmydata.c: deterministic
probabilistic data corruption for robustness tests), cpureport
(cpureport.c: per-buffer process CPU-time messages), fakevideosink
(-bad debugutilsbad: a sink with video-sink caps and a last-sample).
The `watchdog` element lives in util_elements.

Copies of the JAX package's ``elements/debug_elements.py`` classes.  All
but capssetter and fakevideosink are host elements; breakmydata takes a
buffer's data to the host, corrupts its bytes there and returns them to
the data's device with the same dtype and shape.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.buffer import Buffer, FlowReturn, host_array, map_leaves
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            TransformElement, register_element)


def _post(elem, name: str, fields: dict) -> None:
    root = elem.parent
    while getattr(root, "parent", None) is not None:
        root = root.parent
    if root is not None and hasattr(root, "bus"):
        from ..core.pipeline import Message
        fields = dict(fields)
        fields["name"] = name
        root.bus.post(Message("element", elem.name, fields))


@register_element
class ProgressReport(TransformElement):
    """progressreport: posts 'progress' messages every update-freq
    seconds of stream time (progressreport.c:213 message fields)."""
    FACTORY = "progressreport"
    DESCRIPTION = "Periodically query and report on stream progress"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    HOST_ELEMENT = True
    PROPERTIES = {
        "update-freq": (int, 5, "seconds between reports"),
        "silent": (bool, False, "post only, don't print"),
        "format": (str, "auto", "reporting format (time only here)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._last_report = None
        self._total: Optional[int] = None

    def start(self):
        self._last_report = None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None or buf.pts is None:
            return buf
        pos_s = buf.pts // 1_000_000_000
        if self._last_report is not None and \
                pos_s - self._last_report < self.props["update-freq"]:
            return buf
        self._last_report = pos_s
        total = self._total
        percent = (min(100, buf.pts * 100 // total)
                   if total else 100)
        _post(self, "progress", {
            "percent": int(percent),
            "percent-double": float(percent),
            "current": int(pos_s),
            "total": int(total // 1_000_000_000) if total else -1})
        if not self.props["silent"]:
            from ..utils.log import get_logger
            get_logger("progressreport").info(
                "%s (%2d %%)", self.name, percent)
        return buf


@register_element
class TagInject(TransformElement):
    """taginject: send the configured tags as a TAG event before the
    first buffer (gsttaginject.c)."""
    FACTORY = "taginject"
    DESCRIPTION = "inject metadata tags"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    HOST_ELEMENT = True
    PROPERTIES = {"tags": (str, "", "taglist string, e.g. "
                                   "title=foo,artist=bar")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._sent = False

    def start(self):
        self._sent = False

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is not None and not self._sent and self.props["tags"]:
            self._sent = True
            from ..core.events import tag_event
            from ..core.tags import TagList
            tags = TagList()
            for kv in self.props["tags"].split(","):
                k, _, v = kv.partition("=")
                if k:
                    tags.add("append", k.strip(), v.strip().strip('"'))
            for sp in self.src_pads():
                sp.push_event(tag_event(tags))
        return buf


@register_element
class CapsSetter(TransformElement):
    """capssetter: merge (or replace) fields into outgoing caps
    (gstcapssetter.c)."""
    FACTORY = "capssetter"
    DESCRIPTION = "Set/merge caps fields"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "caps": (object, None, "fields to merge"),
        "replace": (bool, False, "drop original fields"),
    }

    def __init__(self, name=None, **props):
        if isinstance(props.get("caps"), str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)

    def transform_caps(self, direction, caps, filter=None):
        setter = self.props["caps"]
        if direction == PadDirection.SINK and setter is not None \
                and caps is not None and len(caps.structures):
            from ..core.structure import Structure
            out = []
            for s in caps.structures:
                fields = {} if self.props["replace"] else dict(s.fields)
                ns = setter.structures[0]
                fields.update(ns.fields)
                out.append(Structure(
                    ns.name if self.props["replace"] else s.name, fields))
            res = Caps(out)
        else:
            res = caps
        if filter is not None and res is not None:
            res = res.intersect(filter)
        return res


@register_element
class BreakMyData(TransformElement):
    """breakmydata: deterministic pseudo-random byte corruption
    (breakmydata.c: seed/set/skip/probability)."""
    FACTORY = "breakmydata"
    DESCRIPTION = "randomly change data in the stream"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    HOST_ELEMENT = True
    PROPERTIES = {
        "seed": (int, 0, "RNG seed"),
        "probability": (float, 0.0, "per-byte corruption probability"),
        "skip": (int, 0, "bytes to skip before corrupting"),
        "set": (int, -1, "value to set (-1 = random)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._rng = None
        self._pos = 0

    def start(self):
        self._rng = np.random.default_rng(self.props["seed"])
        self._pos = 0

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None or self.props["probability"] <= 0:
            return buf
        host = np.array(np.asarray(map_leaves(host_array, buf.data)),
                        copy=True)
        data = host.reshape(-1)
        view = data.view(np.uint8)
        mask = self._rng.random(view.size) < self.props["probability"]
        skip = max(0, self.props["skip"] - self._pos)
        mask[:min(skip, view.size)] = False
        self._pos += view.size
        if mask.any():
            if self.props["set"] >= 0:
                view[mask] = self.props["set"] & 0xFF
            else:
                view[mask] = self._rng.integers(
                    0, 256, int(mask.sum()), dtype=np.uint8)
        leaf = buf.data
        while isinstance(leaf, (tuple, list)):
            leaf = leaf[0]
        out = torch.from_numpy(data.reshape(host.shape))
        if isinstance(leaf, torch.Tensor):
            out = out.to(leaf.device)
        return buf.with_(data=out)


@register_element
class CpuReport(TransformElement):
    """cpureport: posts process CPU time per buffer (cpureport.c)."""
    FACTORY = "cpureport"
    DESCRIPTION = "Post cpu usage information every buffer"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    HOST_ELEMENT = True
    PROPERTIES = {}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._last = None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return buf
        now = time.process_time()
        wall = time.monotonic()
        if self._last is not None:
            dcpu = now - self._last[0]
            dwall = max(1e-9, wall - self._last[1])
            _post(self, "cpu-report", {
                "cpu-time": dcpu, "actual-time": dwall,
                "load": min(100, int(100 * dcpu / dwall))})
        self._last = (now, wall)
        return buf


@register_element
class FakeVideoSink(SinkElement):
    """fakevideosink (-bad): video-caps sink keeping a last-sample."""
    FACTORY = "fakevideosink"
    DESCRIPTION = "Fake video display that allows zero-copy"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "video/x-raw")]
    PROPERTIES = {"num-buffers": (int, -1, "")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.last_sample = None
        self.rendered = 0

    def render(self, buf: Buffer) -> str:
        self.last_sample = buf
        self.rendered += getattr(buf, "batch", 1)
        return FlowReturn.OK
