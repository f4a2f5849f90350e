"""Small -good/-bad utility elements:

* autovideosrc/autoaudiosrc — auto-plugged capture sources
  (gst-plugins-good/sys/autodetect): offline there is no camera or
  microphone, so they resolve to the highest-rank test sources,
  mirroring how autovideosink/autoaudiosink resolve to the fake sinks.
* videoanalyse (gst-plugins-bad/gst/videosignal/gstvideoanalyse.c):
  per-frame luma mean/variance posted as "GstVideoAnalyse" element
  messages; the reduction runs on device, only the message is host.
* audiomixmatrix (gst-plugins-bad/gst/audiomixmatrix/): NxM channel
  matrix transform (rows=out, cols=in, coefficients in [-1,1]),
  modes manual | first-channels (truncated identity,
  gstaudiomixmatrix.c:824); one device matmul.
* audiobuffersplit (gst-plugins-bad/gst/audiobuffersplit/): re-chunk
  audio into exact `output-buffer-duration` pieces with sample
  accounting carried across input buffers.

A port of the JAX package's ``elements/misc_elements.py``.  audiomixmatrix
is a float64 product on the pipeline's device (``mix_matrix``);
audiobuffersplit re-chunks the samples where they are, on their device;
videoanalyse, videoframe_audiolevel and spanplc read a host copy of the
tick's samples or luma (spanplc's concealment goes back to the device).
spanplc negotiates in a launch string, where the JAX package's raises
NameError (``Caps`` is not imported there; ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection,
                            PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo


def _root(elem):
    root = elem
    while getattr(root, "parent", None) is not None:
        root = root.parent
    return root


@register_element
class AutoVideoSrc:
    """autovideosrc: resolves to videotestsrc (no capture devices in
    the offline runtime; the reference auto-plugs the highest-rank
    video source)."""
    FACTORY = "autovideosrc"
    DESCRIPTION = "Auto-plugged video source (offline: videotestsrc)"
    PAD_TEMPLATES = []
    PROPERTIES = {}

    def __new__(cls, name=None, **props):
        from .videotestsrc import VideoTestSrc
        return VideoTestSrc(name=name, **props)


@register_element
class AutoAudioSrc:
    """autoaudiosrc: resolves to audiotestsrc."""
    FACTORY = "autoaudiosrc"
    DESCRIPTION = "Auto-plugged audio source (offline: audiotestsrc)"
    PAD_TEMPLATES = []
    PROPERTIES = {}

    def __new__(cls, name=None, **props):
        from .audio_elements import AudioTestSrc
        return AudioTestSrc(name=name, **props)


@register_element
class VideoAnalyse(TransformElement):
    """videoanalyse (gstvideoanalyse.c): luma statistics messages.

    luma-average = mean(Y)/maxval, luma-variance = E[y^2]-E[y]^2 over
    the normalized luma (gstvideoanalyse.c analyse plane loop)."""
    FACTORY = "videoanalyse"
    DESCRIPTION = "Analyse video signal"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-raw"),
        PadTemplate("src", PadDirection.SRC, "video/x-raw"),
    ]
    PROPERTIES = {"message": (bool, True, "post statistics messages")}

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if not self.props["message"]:
            return buf
        data = buf.data if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        y = host_array(data[0]).astype(np.float64)
        maxval = float((1 << self._info.finfo.bits) - 1)
        yn = y / maxval
        axes = tuple(range(1, yn.ndim))
        avg = yn.mean(axis=axes)
        var = (yn ** 2).mean(axis=axes) - avg ** 2
        root = _root(self)
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            for k in range(len(avg)):
                pts = buf.pts
                if pts is not None and buf.duration and buf.batch:
                    pts = pts + k * buf.duration // buf.batch
                root.bus.post(Message("element", self.name, {
                    "name": "GstVideoAnalyse",
                    "timestamp": pts,
                    "luma-average": float(avg[k]),
                    "luma-variance": float(var[k]),
                }))
        return buf


_MIX_CAPS = ("audio/x-raw, format={ F32LE, F64LE, S16LE, S32LE }, "
             "rate=[1,2147483647], channels=[1,64], layout=interleaved")


def mix_matrix(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x @ m.T`` in float64: each output channel's products added in
    input-channel order, every product and sum rounded once, so the card
    and the CPU give the same bits.  XLA's CPU dot orders and fuses them by
    the shape; the float64 output's last bits differ from it (ROADMAP.md
    section 3), the integer and float32 outputs do not."""
    v = x[..., :1] * m[:, 0]
    for c in range(1, m.shape[1]):
        v = v + x[..., c:c + 1] * m[:, c]
    return v


@register_element
class AudioMixMatrix(TransformElement):
    FACTORY = "audiomixmatrix"
    DESCRIPTION = "Mixes a number of input channels into output channels"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _MIX_CAPS),
        PadTemplate("src", PadDirection.SRC, _MIX_CAPS),
    ]
    PROPERTIES = {
        "in-channels": (int, 0, "number of input channels"),
        "out-channels": (int, 0, "number of output channels"),
        "matrix": (object, None, "rows=out x cols=in coefficients"),
        "mode": (str, "manual", "manual | first-channels"),
    }

    def transform_caps(self, direction, caps, filter=None):
        from ..core.caps import Caps
        from ..core.value import IntRange
        out = []
        for s in caps:
            ns = s.copy()
            if self.props["mode"] == "first-channels":
                ns["channels"] = IntRange(1, 64)
            elif direction == PadDirection.SINK:
                if self.props["out-channels"]:
                    ns["channels"] = self.props["out-channels"]
            else:
                if self.props["in-channels"]:
                    ns["channels"] = self.props["in-channels"]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])
        self._out_ch = outcaps[0]["channels"]

    def make_fn(self):
        in_ch = self._info.channels
        out_ch = self._out_ch
        if self.props["mode"] == "first-channels":
            m = np.zeros((out_ch, in_ch))
            for i in range(min(in_ch, out_ch)):
                m[i, i] = 1.0               # truncated identity (:824)
        else:
            m = np.asarray(self.props["matrix"], np.float64)
            if m.shape != (out_ch, in_ch):
                raise ValueError(
                    f"audiomixmatrix: matrix shape {m.shape} != "
                    f"({out_ch}, {in_ch})")
        f = self._info.finfo
        lim = None if f.is_float else (-(1 << (f.width - 1)),
                                       (1 << (f.width - 1)) - 1)

        def fn(x):
            v = mix_matrix(x.to(torch.float64),
                           torch.as_tensor(m, device=x.device))
            if lim is not None:
                v = torch.clamp(torch.round(v), lim[0], lim[1])
            return v.to(x.dtype)

        return fn


@register_element
class AudioBufferSplit(TransformElement):
    """audiobuffersplit: exact-duration re-chunking with sample
    accounting (gstaudiobuffersplit.c; default 1/50 s chunks)."""
    FACTORY = "audiobuffersplit"
    DESCRIPTION = "Splits raw audio buffers into equal-sized chunks"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-raw"),
        PadTemplate("src", PadDirection.SRC, "audio/x-raw"),
    ]
    PROPERTIES = {
        "output-buffer-duration": (object, None,
                                   "chunk duration (Fraction, def 1/50)"),
        "strict-buffer-size": (bool, False,
                               "drop the final partial chunk"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._hist: Optional[torch.Tensor] = None
        self._out_count = 0

    def start(self):
        self._hist = None
        self._out_count = 0

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])
        dur = self.props["output-buffer-duration"]
        if dur is None:
            num, den = 1, 50
        elif isinstance(dur, str):
            num, den = (int(v) for v in dur.split("/"))
        else:
            num, den = dur.num, dur.denom
        # samples per output chunk; error accumulated in the remainder
        self._chunk = max(self._info.rate * num // den, 1)

    # the pipeline's EOS drain pass flushes decoupling host elements
    # via host_process(None) — reuse it for the final partial chunk
    _decouple = True

    @property
    def _pending_buf(self):
        if self._hist is not None and len(self._hist) \
                and not self.props["strict-buffer-size"]:
            return True
        return None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        rate = self._info.rate
        if buf is None:                      # EOS drain: emit the tail
            if self._pending_buf is None:
                return None
            out, self._hist = self._hist, None
            pts = self._out_count * 1_000_000_000 // rate
            self._out_count += len(out)
            return Buffer(data=out, pts=pts, batch=1,
                          duration=len(out) * 1_000_000_000 // rate)
        x = buf.data
        if self._hist is not None:
            x = torch.cat([self._hist, x], dim=0)
        n_chunks = len(x) // self._chunk
        take = n_chunks * self._chunk
        self._hist = x[take:]
        if n_chunks == 0:
            return None
        out = x[:take]
        pts = self._out_count * 1_000_000_000 // rate
        self._out_count += take
        return buf.with_(data=out, pts=pts,
                         duration=take * 1_000_000_000 // rate)


@register_element
class VideoFrameAudioLevel(AggregatorElement):
    """videoframe_audiolevel (gst-plugins-bad/gst/videoframe_audiolevel/
    gstvideoframe-audiolevel.c): passes video through while posting one
    RMS-per-channel message for the audio that accompanies each video
    frame."""
    FACTORY = "videoframe_audiolevel"
    DESCRIPTION = "Synchronized audio/video RMS messages"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("video", PadDirection.SINK, "video/x-raw"),
        PadTemplate("audio", PadDirection.SINK,
                    "audio/x-raw, format={ S16LE, F32LE }, "
                    "layout=interleaved"),
        PadTemplate("src", PadDirection.SRC, "video/x-raw"),
    ]

    def negotiate_output(self, in_caps, allowed):
        return in_caps.get("video")

    def host_aggregate(self, ins):
        import numpy as _np
        vbuf = ins.get("video")
        abuf = ins.get("audio")
        if abuf is not None:
            x = host_array(abuf.data)
            if x.ndim == 1:
                x = x[:, None]
            if x.dtype == _np.int16:
                x = x.astype(_np.float64) / 32768.0
            rms = _np.sqrt((x.astype(_np.float64) ** 2).mean(axis=0))
            root = self
            while getattr(root, "parent", None) is not None:
                root = root.parent
            bus = getattr(root, "bus", None)
            if bus is not None:
                from ..core.pipeline import Message
                bus.post(Message("element", self.name, {
                    "type": "videoframe-audiolevel",
                    "rms": [float(r) for r in rms],
                    "timestamp": vbuf.pts if vbuf is not None
                    else abuf.pts}))
        return vbuf if vbuf is not None else abuf


@register_element
class SpanPlc(TransformElement):
    """spanplc (gst-plugins-bad/ext/spandsp/gstspanplc.c reduced):
    packet loss concealment — GAP buffers (flagged or zero-length
    meta 'gap') are filled by pitch-repeating the last good audio,
    with a linear fade toward silence."""
    FACTORY = "spanplc"
    DESCRIPTION = "Packet loss concealment for audio"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=S16LE, layout=interleaved"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=S16LE, layout=interleaved"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._history = None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "audio/x-raw, format=S16LE, layout=interleaved")
        if caps is not None and not caps.is_any and len(caps):
            res = caps
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._history = None

    def host_process(self, buf):
        import numpy as _np
        if buf is None:
            return None
        is_gap = bool((buf.meta or {}).get("gap"))
        x = host_array(buf.data)
        if x.ndim == 1:
            x = x[:, None]
        if not is_gap and x.size and _np.any(x):
            self._history = x[-2048:].copy()
            return buf
        n = x.shape[0]
        if self._history is None or not len(self._history):
            return buf
        # repeat the history tail and fade to silence over the gap
        reps = -(-n // len(self._history))
        fill = _np.tile(self._history, (reps, 1))[:n].astype(
            _np.float64)
        fade = _np.linspace(1.0, 0.0, n)[:, None]
        out = _np.clip(_np.round(fill * fade), -32768,
                       32767).astype(_np.int16)
        return buf.with_(data=device_array(out, buf.data))
