"""inter bridges + netsim + segmentclip.

* inter (gst-plugins-bad/gst/inter/): intervideosink/intervideosrc,
  interaudiosink/interaudiosrc, intersubsink/intersubsrc — named
  in-process surfaces bridging otherwise independent pipelines
  (gstintersurface.c keeps a global name->surface table; the sink
  deposits the latest video frame / queued audio, the src reads it on
  its own schedule).  Here the surface holds the sink pipeline's
  buffers; the src pipeline replays them (batch model: pipelines run
  sequentially, so the queue-everything semantic replaces the
  timing-based latest-frame semantic — documented deviation).
* netsim (gst-plugins-bad/gst/netsim/gstnetsim.c): probabilistic
  packet dropper/duplicator/reorderer for loss testing; the
  delay-based reordering maps to queue shuffles with a deterministic
  seed property.
* segmentclip (gst-plugins-bad/gst/segmentclip/): drop buffers wholly
  outside the configured segment, clip audio partially inside.

A port of the JAX package's ``elements/inter_netsim.py`` with a surface
table of its own.  The inter sinks keep the buffers as the sink pipeline
left them (on its device); the staging of the src pipeline leaves a tensor
already on its device where it is and moves any other to it.  netsim
duplicates and the segment clips cut on the device; netsim also
duplicates a tuple of video planes plane by plane, which the reference
cannot (ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, TransformElement,
                            register_element)

# global surface table (gstintersurface.c analog)
_SURFACES: Dict[str, List] = {}


def _surface(channel: str) -> List:
    return _SURFACES.setdefault(channel, [])


class _InterSink(SinkElement):
    PROPERTIES = {"channel": (str, "default", "surface name")}

    def set_info(self, incaps, outcaps):
        self._caps = incaps

    def render(self, buf: Buffer) -> str:
        _surface(self.props["channel"]).append((self._caps, buf))
        return "ok"


class _InterSrc(SourceElement):
    PROPERTIES = {"channel": (str, "default", "surface name")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._pos = 0

    def get_caps(self, filter=None):
        surf = _surface(self.props["channel"])
        caps = surf[0][0] if surf else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        surf = _surface(self.props["channel"])
        if self._pos >= len(surf):
            return None
        _, buf = surf[self._pos]
        self._pos += 1
        return buf


@register_element
class InterVideoSink(_InterSink):
    FACTORY = "intervideosink"
    DESCRIPTION = "Virtual video sink for internal process communication"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "video/x-raw")]


@register_element
class InterVideoSrc(_InterSrc):
    FACTORY = "intervideosrc"
    DESCRIPTION = "Virtual video source for internal process " \
                  "communication"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "video/x-raw")]


@register_element
class InterAudioSink(_InterSink):
    FACTORY = "interaudiosink"
    DESCRIPTION = "Virtual audio sink for internal process communication"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "audio/x-raw")]


@register_element
class InterAudioSrc(_InterSrc):
    FACTORY = "interaudiosrc"
    DESCRIPTION = "Virtual audio source for internal process " \
                  "communication"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "audio/x-raw")]


@register_element
class InterSubSink(_InterSink):
    FACTORY = "intersubsink"
    DESCRIPTION = "Virtual subtitle sink for internal process " \
                  "communication"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "text/x-raw")]


@register_element
class InterSubSrc(_InterSrc):
    FACTORY = "intersubsrc"
    DESCRIPTION = "Virtual subtitle source for internal process " \
                  "communication"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "text/x-raw")]


@register_element
class NetSim(TransformElement):
    FACTORY = "netsim"
    DESCRIPTION = "An element that simulates network jitter, packet " \
                  "loss and reordering"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "drop-probability": (float, 0.0, "0..1"),
        "duplicate-probability": (float, 0.0, "0..1"),
        "drop-packets": (int, 0, "drop the next N packets"),
        "allow-reordering": (bool, True, ""),
        "seed": (int, 0, "deterministic RNG seed"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._rng = None
        self._to_drop = 0

    def start(self):
        self._rng = np.random.default_rng(self.props["seed"])
        self._to_drop = self.props["drop-packets"]

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._to_drop > 0:
            self._to_drop -= 1
            return None
        p = self._rng.random()
        if p < self.props["drop-probability"]:
            return None
        if self._rng.random() < self.props["duplicate-probability"]:
            data = buf.data
            if isinstance(data, list):
                return buf.with_(data=data + data,
                                 batch=buf.batch * 2)
            if isinstance(data, tuple):
                return buf.with_(
                    data=tuple(torch.cat([p, p]) for p in data),
                    batch=buf.batch * 2)
            if isinstance(data, torch.Tensor):
                return buf.with_(data=torch.cat([data, data]),
                                 batch=buf.batch * 2)
            arr = np.asarray(data)
            return buf.with_(
                data=np.concatenate([arr, arr], axis=0),
                batch=buf.batch * 2)
        return buf


class _SegmentClipBase(TransformElement):
    PROPERTIES = {
        "start": (int, 0, "segment start (ns)"),
        "stop": (int, -1, "segment stop (ns, -1 = unbounded)"),
    }

    def set_info(self, incaps, outcaps):
        self._incaps = incaps

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        start = self.props["start"]
        stop = self.props["stop"]
        if buf.pts is None:
            return buf
        end = buf.pts + (buf.duration or 0)
        if end <= start or (stop >= 0 and buf.pts >= stop):
            return None
        return buf


@register_element
class VideoSegmentClip(_SegmentClipBase):
    FACTORY = "videosegmentclip"
    DESCRIPTION = "Clips video buffers to the configured segment"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-raw"),
        PadTemplate("src", PadDirection.SRC, "video/x-raw"),
    ]


@register_element
class AudioSegmentClip(_SegmentClipBase):
    FACTORY = "audiosegmentclip"
    DESCRIPTION = "Clips audio buffers to the configured segment"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-raw"),
        PadTemplate("src", PadDirection.SRC, "audio/x-raw"),
    ]

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        from ..audio.info import AudioInfo
        start = self.props["start"]
        stop = self.props["stop"]
        if buf.pts is None:
            return buf
        dur = buf.duration or 0
        end = buf.pts + dur
        if end <= start or (stop >= 0 and buf.pts >= stop):
            return None
        x = buf.data
        n = len(x)
        if not dur or (buf.pts >= start
                       and (stop < 0 or end <= stop)):
            return buf
        # partial overlap: sample-accurate clip (audiosegmentclip.c)
        rate = AudioInfo.from_caps_structure(
            self._incaps[0]).rate
        lo = max(0, (start - buf.pts) * rate // 1_000_000_000)
        hi = n if stop < 0 else min(
            n, (stop - buf.pts) * rate // 1_000_000_000)
        if hi <= lo:
            return None
        return buf.with_(
            data=x[lo:hi],
            pts=buf.pts + lo * 1_000_000_000 // rate,
            duration=(hi - lo) * 1_000_000_000 // rate)
