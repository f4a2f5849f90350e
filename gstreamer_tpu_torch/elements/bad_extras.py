"""Assorted gst-plugins-bad elements: subtitle encoders, audio/video
debug utilities, raw-parse aliases, auto filters.

References (gst-plugins-bad/gst/...):
* subenc/gstsrtenc.c — SRT blocks "n\\nHH:MM:SS,mmm --> ...\\ntext\\n\\n"
  with timestamp/duration shift properties; gstwebvttenc.c — the
  WEBVTT header and dot-separated milliseconds.
* audiofxbad/gstaudiochannelmix.c — stereo 2x2 gain matrix
  (left-to-left/left-to-right/right-to-left/right-to-right).
* debugutils/ — gstchecksumsink.c (per-buffer hash printout; stored
  here), gstchopmydata.c (random re-chunking), gsterrorignore.c
  (swallow flow errors), gstdebugspy.c (checksum probe passthrough),
  fpsdisplaysink.c (frame statistics sink), gstclockselect.c (clock
  choice; batched graph keeps one clock), gstroundrobin.c (1:N
  packet distribution), gsttestsrcbin.c (audio+video test source
  bin), gstvideocodectestsink.c (raw video checksum sink).
* rawparse/gstvideoparse.c + gstaudioparse.c — legacy property
  aliases over rawvideoparse/rawaudioparse.
* autoconvert/gstautovideoflip.c, gstautodeinterlace.c — caps/
  orientation-driven dispatchers over videoflip/deinterlace.
* videofilters/gstvideoframe-audiolevel.c — synchronized per-frame
  audio RMS messages.
* timecode/gsttimecodestamper.c — attach SMPTE timecode metas
  counting frames from the configured start.

A port of the JAX package's ``elements/bad_extras.py``.  audiochannelmix
runs on the pipeline's device in float32, with the fused multiply-add
that XLA gives ``ll*left + rl*right`` on the CPU (``_mix``); the sinks,
debug elements and chopmydata read a host copy of the tick's data
(chopmydata's chunks go back to its device); videoparse, audioparse and
autovideoflip wrap the port's rawvideoparse, rawaudioparse and videoflip.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .._xp import fma32
from ..core.buffer import Buffer, FlowReturn, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            TransformElement, register_element)
from .rawparse import RawAudioParse, RawVideoParse


def _ts_srt(ns: int) -> str:
    h, rem = divmod(ns, 3600 * 1_000_000_000)
    m, rem = divmod(rem, 60 * 1_000_000_000)
    s, rem = divmod(rem, 1_000_000_000)
    return f"{h:02d}:{m:02d}:{s:02d},{rem // 1_000_000:03d}"


def _ts_vtt(ns: int) -> str:
    return _ts_srt(ns).replace(",", ".")


class _SubEncBase(SinkElement):
    HOST_ELEMENT = True
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "text/x-raw; application/x-subtitle")]
    PROPERTIES = {
        "location": (str, "out.srt", "output path"),
        "timestamp": (int, 0, "ns added to timestamps"),
        "duration": (int, 0, "ns added to durations"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._file = None
        self._count = 0

    def start(self):
        self._file = open(self.props["location"], "w",
                          encoding="utf-8")
        self._count = 0
        self._write_header()

    def _write_header(self):
        pass

    def stop(self):
        if self._file:
            self._file.close()
            self._file = None

    def _texts(self, buf: Buffer) -> List[str]:
        d = buf.data
        items = d if isinstance(d, (list, tuple)) else [d]
        out = []
        for t in items:
            if isinstance(t, str):
                out.append(t)
            elif isinstance(t, (bytes, bytearray)):
                out.append(t.decode("utf-8", "replace"))
            else:
                out.append(host_array(t).tobytes()
                           .decode("utf-8", "replace"))
        return out

    def render(self, buf: Buffer) -> str:
        ts = (buf.pts or 0) + self.props["timestamp"]
        dur = (buf.duration or 1_000_000_000) + self.props["duration"]
        for text in self._texts(buf):
            self._count += 1
            self._write_cue(self._count, ts, ts + dur, text)
        return FlowReturn.OK

    def _write_cue(self, n, start, end, text):
        raise NotImplementedError


@register_element
class SrtEnc(_SubEncBase):
    FACTORY = "srtenc"
    DESCRIPTION = "Srt subtitle encoder"

    def _write_cue(self, n, start, end, text):
        self._file.write(f"{n}\n{_ts_srt(start)} --> {_ts_srt(end)}\n"
                         f"{text}\n\n")


@register_element
class WebVttEnc(_SubEncBase):
    FACTORY = "webvttenc"
    DESCRIPTION = "WebVTT subtitle encoder"

    def _write_header(self):
        self._file.write("WEBVTT\n\n")

    def _write_cue(self, n, start, end, text):
        self._file.write(f"{_ts_vtt(start)} --> {_ts_vtt(end)}\n"
                         f"{text}\n\n")


def _mix(a: float, x: torch.Tensor, b: float, y: torch.Tensor):
    """``a*x + b*y`` in float32 as XLA computes it on the CPU: one product
    fused into the add (one rounding), the other rounded first.  XLA fuses
    the left product, or the right one where only the left coefficient
    is negative (it rewrites the sum as ``b*y - |a|*x``); found by
    counting differing bits against the jitted expression over seeded
    samples and every sign pair."""
    a, b = float(np.float32(a)), float(np.float32(b))
    if a < 0 <= b:
        return fma32(y, b, a * x)
    return fma32(x, a, b * y)


@register_element
class AudioChannelMix(TransformElement):
    """2x2 stereo gain matrix (gstaudiochannelmix.c)."""
    FACTORY = "audiochannelmix"
    DESCRIPTION = "Mixes left/right channels of stereo audio"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=F32LE, channels=2, "
                    "layout=interleaved"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=F32LE, channels=2, "
                    "layout=interleaved"),
    ]
    PROPERTIES = {
        "left-to-left": (float, 1.0, ""),
        "left-to-right": (float, 0.0, ""),
        "right-to-left": (float, 0.0, ""),
        "right-to-right": (float, 1.0, ""),
    }

    def make_fn(self):
        ll = self.props["left-to-left"]
        lr = self.props["left-to-right"]
        rl = self.props["right-to-left"]
        rr = self.props["right-to-right"]

        def fn(samples):
            left = samples[..., 0]
            right = samples[..., 1]
            return torch.stack([_mix(ll, left, rl, right),
                                _mix(lr, left, rr, right)], dim=-1)

        return fn


@register_element
class ChecksumSink(SinkElement):
    """checksumsink (gstchecksumsink.c): hash per buffer; the
    reference g_prints, we keep `checksums` for inspection."""
    FACTORY = "checksumsink"
    DESCRIPTION = "Calculates a checksum for buffers"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {"hash": (str, "sha1", "md5|sha1|sha256")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.checksums: List[str] = []

    def start(self):
        self.checksums = []

    def render(self, buf: Buffer) -> str:
        d = buf.data
        for b in (d if isinstance(d, (list, tuple)) else [d]):
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            h = hashlib.new(self.props["hash"])
            h.update(raw)
            self.checksums.append(h.hexdigest())
        return FlowReturn.OK


@register_element
class VideoCodecTestSink(ChecksumSink):
    """videocodectestsink: checksums decoded video for codec
    conformance runs (gstvideocodectestsink.c)."""
    FACTORY = "videocodectestsink"
    DESCRIPTION = "Sink to test video codec conformance"
    PROPERTIES = dict(ChecksumSink.PROPERTIES,
                      location=(str, "", "optional raw dump path"))

    def start(self):
        super().start()
        self._dump = (open(self.props["location"], "wb")
                      if self.props["location"] else None)

    def stop(self):
        if getattr(self, "_dump", None):
            self._dump.close()
            self._dump = None

    def render(self, buf: Buffer) -> str:
        d = buf.data
        planes = d if isinstance(d, (list, tuple)) else [d]
        raw = b"".join(host_array(p).tobytes() for p in planes)
        h = hashlib.new(self.props["hash"])
        h.update(raw)
        self.checksums.append(h.hexdigest())
        if self._dump:
            self._dump.write(raw)
        return FlowReturn.OK


@register_element
class ChopMyData(TransformElement):
    """chopmydata: random re-chunking (gstchopmydata.c) — the -bad
    twin of rndbuffersize."""
    FACTORY = "chopmydata"
    DESCRIPTION = "FIXME"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "max-size": (int, 4096, ""),
        "min-size": (int, 1, ""),
        "step-size": (int, 1, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._rest = b""
        self._rng = np.random.default_rng(0)

    def start(self):
        self._rest = b""
        self._rng = np.random.default_rng(0)

    _decouple = True
    _like = None              # the data whose device the chunks go to

    @property
    def _pending_buf(self):
        return True if self._rest else None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            if not self._rest:
                return None
            out, self._rest = self._rest, b""
            return Buffer(data=device_array(np.frombuffer(out, np.uint8),
                                            self._like), batch=1)
        d = buf.data
        self._like = d
        blobs = d if isinstance(d, (list, tuple)) else [d]
        raw = self._rest + b"".join(
            bytes(b) if isinstance(b, (bytes, bytearray))
            else host_array(b).tobytes() for b in blobs)
        lo = self.props["min-size"]
        hi = max(lo, self.props["max-size"])
        step = max(1, self.props["step-size"])
        out = []
        pos = 0
        while len(raw) - pos >= hi:
            n = int(self._rng.integers(lo // step,
                                       hi // step + 1)) * step or step
            out.append(device_array(np.frombuffer(raw[pos:pos + n],
                                                  np.uint8), d))
            pos += n
        self._rest = raw[pos:]
        if not out:
            return None
        return buf.with_(data=out if len(out) > 1 else out[0],
                         batch=len(out))


@register_element
class ErrorIgnore(TransformElement):
    """errorignore: converts downstream flow errors into OK
    (gsterrorignore.c); the batched graph surfaces errors as
    exceptions, so this passthrough guards host hooks."""
    FACTORY = "errorignore"
    DESCRIPTION = "Pass through all packets but ignore some GstFlow" \
                  "Return types"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "ignore-error": (bool, True, ""),
        "ignore-notlinked": (bool, False, ""),
        "ignore-notnegotiated": (bool, True, ""),
    }


@register_element
class DebugSpy(TransformElement):
    """debugspy: passthrough posting a checksum message per buffer
    (gstdebugspy.c)."""
    FACTORY = "debugspy"
    DESCRIPTION = "DebugSpy provides information on buffers with " \
                  "bus messages"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {"silent": (bool, False, ""),
                  "checksum-type": (str, "sha1", "")}

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None or self.props["silent"]:
            return buf
        d = buf.data
        raw = b"".join(
            bytes(b) if isinstance(b, (bytes, bytearray))
            else host_array(b).tobytes()
            for b in (d if isinstance(d, (list, tuple)) else [d]))
        h = hashlib.new(self.props["checksum-type"])
        h.update(raw)
        from .misc_elements import _root
        root = _root(self)
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            root.bus.post(Message("element", self.name, {
                "name": "GstDebugSpy", "checksum": h.hexdigest(),
                "timestamp": buf.pts}))
        return buf


@register_element
class FpsDisplaySink(SinkElement):
    """fpsdisplaysink: collects frames-rendered statistics
    (fpsdisplaysink.c; no window in the offline runtime — stats via
    properties/messages)."""
    FACTORY = "fpsdisplaysink"
    DESCRIPTION = "Video sink with frames-per-second statistics"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "text-overlay": (bool, True, "unused offline"),
        "fps-update-interval": (int, 500, "ms"),
        "signal-fps-measurements": (bool, False, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.frames_rendered = 0
        self.frames_dropped = 0
        self.last_pts = None

    def start(self):
        self.frames_rendered = 0
        self.frames_dropped = 0

    def render(self, buf: Buffer) -> str:
        self.frames_rendered += buf.batch or 1
        self.last_pts = buf.pts
        return FlowReturn.OK


@register_element
class ClockSelect(TransformElement):
    """clockselect: pipeline clock choice (gstclockselect.c); the
    batched graph has one logical clock, recorded for inspection."""
    FACTORY = "clockselect"
    DESCRIPTION = "Pipeline clock selector"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {"clock-id": (str, "default", "default|monotonic|"
                                               "realtime|ptp"),
                  "ptp-domain": (int, 0, "")}


@register_element
class RoundRobin(TransformElement):
    """roundrobin: distribute buffers across src pads in turn
    (gstroundrobin.c)."""
    FACTORY = "roundrobin"
    DESCRIPTION = "A round robin dispatcher element"
    HOST_ELEMENT = True
    from ..core.element import PadPresence
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.REQUEST),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._next = 0

    def start(self):
        self._next = 0

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        return buf

    def route_outputs(self, buf: Buffer) -> Dict[str, Buffer]:
        pads = self.src_pads()
        if not pads:
            return {}
        pad = pads[self._next % len(pads)]
        self._next += 1
        return {pad.name: buf}


@register_element
class VideoParseLegacy(RawVideoParse):
    """videoparse (gstvideoparse.c): legacy property spelling over
    rawvideoparse."""
    FACTORY = "videoparse"
    DESCRIPTION = "Converts stream into video frames (deprecated: " \
                  "use rawvideoparse instead)"


@register_element
class AudioParseLegacy(RawAudioParse):
    FACTORY = "audioparse"
    DESCRIPTION = "Converts stream into audio frames (deprecated: " \
                  "use rawaudioparse instead)"


@register_element
class AutoVideoFlip(TransformElement):
    """autovideoflip: applies videoflip according to the image-
    orientation tag (gstautovideoflip.c); collapsed to a videoflip
    proxy driven by the `video-direction`/tag events."""
    FACTORY = "autovideoflip"
    DESCRIPTION = "Flips video based on its orientation tag"

    def _vf_templates():
        from .videofilter import VideoFlip
        return list(VideoFlip.PAD_TEMPLATES)

    PAD_TEMPLATES = _vf_templates()
    del _vf_templates

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._method = "none"
        self._inner = None

    def sink_event(self, pad, event) -> bool:
        if getattr(event, "type", None) == "tag":
            tl = event.data.get("tags")
            v = tl.get("image-orientation") if tl is not None else None
            if v:
                self._method = {
                    "rotate-0": "none", "rotate-90": "clockwise",
                    "rotate-180": "rotate-180",
                    "rotate-270": "counterclockwise",
                    "flip-rotate-0": "horizontal-flip",
                    "flip-rotate-180": "vertical-flip",
                }.get(str(v), "none")
        return super().sink_event(pad, event)

    def transform_caps(self, direction, caps, filter=None):
        from ..core.element import element_factory_make
        if self._inner is None:
            self._inner = element_factory_make(
                "videoflip", method=self._method)
        return self._inner.transform_caps(direction, caps, filter)

    def set_info(self, incaps, outcaps):
        if self._inner is not None:
            self._inner.device = self.device
            self._inner.set_info(incaps, outcaps)

    def make_fn(self):
        if self._inner is not None:
            return self._inner.make_fn()
        return super().make_fn()


@register_element
class VideoFrameAudioLevel(TransformElement):
    """videoframe-audiolevel: per-buffer RMS messages on the audio
    path (gstvideoframe-audiolevel.c computes RMS per video frame
    span; the batched tick IS the frame span)."""
    FACTORY = "videoframe-audiolevel"
    DESCRIPTION = "Synchronized audio/video RMS Level messenger " \
                  "for audio/raw"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format={ F32LE, S16LE }"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format={ F32LE, S16LE }"),
    ]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        x = host_array(buf.data).astype(np.float64)
        if x.dtype.kind == "i" or x.max(initial=0) > 2:
            x = x / 32768.0
        rms = np.sqrt((x ** 2).mean(axis=0)) if x.size else [0.0]
        from .misc_elements import _root
        root = _root(self)
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            root.bus.post(Message("element", self.name, {
                "name": "videoframe-audiolevel",
                "timestamp": buf.pts,
                "rms": [float(r) for r in np.atleast_1d(rms)]}))
        return buf
