"""splitmuxsink / splitmuxsrc — fragmented recording and playback.

Port of gst-plugins-good/gst/multifile/gstsplitmuxsink.c /
gstsplitmuxsrc.c, built over this framework's container muxers:
* splitmuxsink drives a child muxer instance per fragment (the
  reference resets its muxer+filesink child per file), splitting when
  the fragment's running time reaches `max-size-time` or its payload
  bytes reach `max-size-bytes`; posts
  "splitmuxsink-fragment-opened"/"-closed" element messages with the
  location and running time (gstsplitmuxsink.c:1152-1180).
* splitmuxsrc globs the fragment files, demuxes each in turn and
  re-stamps pts so the parts play back as one continuous stream.

Raw video makes every frame a keyframe, so fragments split at frame
granularity (the reference's keyframe-boundary rule degenerates to
exactly this for raw streams).

A port of the JAX package's ``elements/splitmux.py``.  The child muxers and
demuxers take the element's device; a fragment's size counts the bytes of
each buffer wherever they lie.
"""

from __future__ import annotations

import glob as _glob
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, SourceElement,
                            element_factory_make, register_element)
from .isomp4 import _MUX_AUDIO_CAPS, _MUX_VIDEO_CAPS


def _nbytes(x) -> int:
    return x.nbytes if isinstance(x, torch.Tensor) else np.asarray(x).nbytes


@register_element
class SplitMuxSink(AggregatorElement):
    FACTORY = "splitmuxsink"
    DESCRIPTION = "Muxes and splits media into multiple files"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("video_%u", PadDirection.SINK, _MUX_VIDEO_CAPS,
                    presence=PadPresence.REQUEST),
        PadTemplate("audio_%u", PadDirection.SINK, _MUX_AUDIO_CAPS,
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, "video/quicktime"),
    ]
    PROPERTIES = {
        "location": (str, "out%05d.mov", "fragment path pattern"),
        "max-size-time": (int, 0, "max fragment duration ns (0: off)"),
        "max-size-bytes": (int, 0, "max fragment payload bytes (0: off)"),
        "muxer-factory": (str, "qtmux", "muxer element per fragment"),
        "start-index": (int, 0, "first fragment index"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._in_caps: Dict[str, Caps] = {}
        self._mux = None
        self._frag_idx = 0
        self._frag_time = 0
        self._frag_bytes = 0
        self._run_time = 0

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed):
        self._in_caps = {n: c.fixate() for n, c in in_caps.items()}
        # validate against the child muxer's contract
        probe = element_factory_make(self.props["muxer-factory"])
        probe.negotiate_output(self._in_caps, Caps.any())
        return Caps.from_string("video/quicktime")

    def start(self):
        self._mux = None
        self._frag_idx = self.props["start-index"]
        self._run_time = 0

    def _post(self, kind: str, location: str):
        root = self
        while getattr(root, "parent", None) is not None:
            root = root.parent
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            root.bus.post(Message("element", self.name, {
                "name": f"splitmuxsink-fragment-{kind}",
                "location": location,
                "fragment-id": self._frag_idx,
                "running-time": self._run_time,
            }))

    def _open_fragment(self):
        loc = self.props["location"]
        if "%" in loc:
            loc = loc % self._frag_idx
        self._mux = element_factory_make(
            self.props["muxer-factory"], location=loc)
        self._mux.device = self.device
        self._mux.negotiate_output(self._in_caps, Caps.any())
        self._mux.start()
        self._frag_time = 0
        self._frag_bytes = 0
        self._cur_loc = loc
        self._post("opened", loc)

    def _close_fragment(self):
        if self._mux is None:
            return
        self._mux.stop()
        self._post("closed", self._cur_loc)
        self._mux = None
        self._frag_idx += 1

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        # fragment accounting from the video (or first) stream
        lead = None
        for n, b in sorted(ins.items()):
            if n.startswith("video"):
                lead = b
                break
        if lead is None:
            lead = next(iter(ins.values()))
        dur = lead.duration or 0
        nbytes = 0
        for b in ins.values():
            d = b.data if isinstance(b.data, (list, tuple)) else [b.data]
            nbytes += sum(int(_nbytes(x)) for x in d)
        # split BEFORE the buffer that would overflow the fragment
        # (gst_splitmux_check_new_caps rule: fragments stay <= limit
        # unless a single GOP alone exceeds it)
        mt = self.props["max-size-time"]
        mb = self.props["max-size-bytes"]
        if self._mux is not None and self._frag_time > 0 and (
                (mt and self._frag_time + dur > mt)
                or (mb and self._frag_bytes + nbytes > mb)):
            self._close_fragment()
        if self._mux is None:
            self._open_fragment()
        self._mux.host_aggregate(ins)
        self._frag_time += dur
        self._run_time += dur
        self._frag_bytes += nbytes
        first = next(iter(ins.values()))
        return first.with_(data=np.zeros(1, np.uint8))

    def stop(self):
        self._close_fragment()


@register_element
class SplitMuxSrc(SourceElement):
    FACTORY = "splitmuxsrc"
    DESCRIPTION = "Source that reads a set of files created by splitmuxsink"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "glob pattern of fragment files"),
        "stream": (str, "video", "video | audio | stream index"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._parts: List = []
        self._cur = 0
        self._pts_base = 0

    def _demux_for(self, path: str):
        factory = ("avidemux" if path.lower().endswith(".avi")
                   else "matroskademux"
                   if path.lower().endswith((".mkv", ".webm"))
                   else "qtdemux")
        d = element_factory_make(
            factory, location=path, stream=self.props["stream"])
        d.device = self.device
        return d

    def _load(self):
        if self._parts:
            return
        files = sorted(_glob.glob(self.props["location"]))
        if not files:
            raise FileNotFoundError(
                f"splitmuxsrc: no files match "
                f"{self.props['location']!r}")
        self._parts = [self._demux_for(f) for f in files]

    def get_caps(self, filter=None):
        try:
            self._load()
        except (OSError, FileNotFoundError):
            return Caps.any()
        return self._parts[0].get_caps(filter)

    def start(self):
        self._load()
        for p in self._parts:
            p.device = self.device
            p.start()
        self._cur = 0
        self._pts_base = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        while self._cur < len(self._parts):
            buf = self._parts[self._cur].create(n_frames)
            if buf is not None:
                pts = (buf.pts or 0) + self._pts_base
                self._last_end = pts + (buf.duration or 0)
                return buf.with_(pts=pts)
            # fragment exhausted: continue the timeline in the next one
            self._pts_base = getattr(self, "_last_end", self._pts_base)
            self._cur += 1
        return None
