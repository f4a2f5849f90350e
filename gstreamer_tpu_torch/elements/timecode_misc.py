"""timecodestamper, avwait, h264timestamper, combdetect, ivtc,
compare, audiolatency.

References (gst-plugins-bad/gst/...):
* timecode/gsttimecodestamper.c — attaches SMPTE timecode metas from
  an internal frame counter (source=internal), optional drop-frame
  counting and element messages.
* timecode/gstavwait.c — drops buffers until target-timecode /
  target-running-time, stops at end-running-time; `recording` acts
  as a master valve.  (Reduced: per-stream instance; the reference
  pairs audio+video pads — the batched graph runs one instance per
  branch with the same thresholds.)
* codectimestamper/gsth264timestamper.c — fills missing DTS from PTS
  order for streams without B-frame reordering (reduced: the full
  POC-based reorder needs decoded SPS state).
* ivtc/gstcombdetect.c — the exact comb metric: a pixel combs when
  it leaves [min(up,down)-5, max(up,down)+5]; run lengths accumulate
  left + down rows, >100 paints the 16/235 stripe pattern keyed by
  (i+j+z)&4 with the per-frame z counter (:40-110).
* ivtc/gstivtc.c — 2:3 pulldown removal; reduced to the same-parity
  field-match test over a 2-frame window (full 5-frame cadence
  search not ported; documented).
* compare/gstcompare.c — pairwise buffer comparison posting element
  messages (method mem/max/ssim -> here mse/max metrics).
* audiolatency/gstaudiolatency.c — measures spike round-trip
  latency; here the detector half: finds the first loud spike and
  posts its offset from the buffer start.

A port of the JAX package's ``elements/timecode_misc.py``.  timecodestamper,
avwait, the two timestampers and compare's output touch metas and
timestamps only: the buffer's tensors pass as they are.  combdetect and
ivtc read a host copy of the luma (combdetect's painted luma goes back to
the buffer's device, ivtc keeps the frames it passes on the device);
audiolatency finds its spike on the device and reads back one index.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection,
                            PadPresence, PadTemplate, TransformElement,
                            register_element)


def _root(elem):
    root = elem
    while getattr(root, "parent", None) is not None:
        root = root.parent
    return root


def _post(elem, name: str, fields: dict) -> None:
    root = _root(elem)
    if hasattr(root, "bus"):
        from ..core.pipeline import Message
        root.bus.post(Message("element", elem.name,
                              dict({"name": name}, **fields)))


def frames_to_timecode(n: int, fps_n: int, fps_d: int,
                       drop_frame: bool) -> tuple:
    """frame count -> (h, m, s, f); SMPTE 12M drop-frame skips frame
    numbers 0,1 each minute except every 10th (29.97/59.94)."""
    fps = (fps_n + fps_d - 1) // fps_d
    if drop_frame and fps_n % fps_d:
        drop = 2 if fps == 30 else 4
        fp10min = 10 * (fps * 60) - 9 * drop
        fpmin = fps * 60 - drop
        d = n // fp10min
        m10 = n % fp10min
        if m10 < fps * 60:
            mins = d * 10
            frame = m10
        else:
            mins = d * 10 + 1 + (m10 - fps * 60) // fpmin
            frame = drop + (m10 - fps * 60) % fpmin
        h = mins // 60
        m = mins % 60
        s = frame // fps
        f = frame % fps
        return h % 24, m, s, f
    total_s, f = divmod(n, fps)
    m, s = divmod(total_s // 60, 60)[1], total_s % 60
    h = total_s // 3600
    return h % 24, (total_s // 60) % 60, s, f


@register_element
class TimecodeStamper(TransformElement):
    FACTORY = "timecodestamper"
    DESCRIPTION = "Attach a timecode meta into each video frame"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, width=[1,32767], height=[1,32767]"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, width=[1,32767], height=[1,32767]"),
    ]
    PROPERTIES = {
        "source": (str, "internal", "internal only (reduced)"),
        "set": (str, "keep", "keep|always"),
        "drop-frame": (bool, False, ""),
        "post-messages": (bool, False, ""),
        "start-hour": (int, 0, "internal counter start hour"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frame = 0
        self._fps = (30, 1)

    def set_info(self, incaps, outcaps):
        fr = incaps[0].fields.get("framerate")
        if fr is not None and not isinstance(fr, tuple):
            self._fps = (fr.num, fr.denom)

    def start(self):
        self._frame = self.props["start-hour"] * 3600 \
            * ((self._fps[0] + self._fps[1] - 1) // self._fps[1])

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        n = buf.batch or 1
        tcs = []
        for k in range(n):
            tc = frames_to_timecode(self._frame + k, *self._fps,
                                    self.props["drop-frame"])
            tcs.append(tc)
            if self.props["post-messages"]:
                _post(self, "timecodestamper", {
                    "timecode": "%02d:%02d:%02d:%02d" % tc})
        self._frame += n
        return buf.with_(meta=dict(buf.meta or {}, timecode=tcs))


@register_element
class AvWait(TransformElement):
    FACTORY = "avwait"
    DESCRIPTION = "Drops all audio/video until a specific timecode " \
                  "or running time has been reached"
    HOST_ELEMENT = True
    _decouple = False
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "target-running-time": (int, 0, "ns; pass from here"),
        "end-running-time": (int, -1, "ns; drop after (-1 = never)"),
        "target-timecode-str": (str, "", "HH:MM:SS:FF "
                                         "(needs timecode metas)"),
        "recording": (bool, True, "master valve"),
        "mode": (str, "running-time",
                 "running-time|timecode|video-first (reduced)"),
    }

    def _tc_tuple(self):
        s = self.props["target-timecode-str"]
        if not s:
            return None
        parts = [int(x) for x in s.replace(";", ":").split(":")]
        return tuple(parts) if len(parts) == 4 else None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        if not self.props["recording"]:
            return None
        pts = buf.pts or 0
        end = self.props["end-running-time"]
        if end >= 0 and pts >= end:
            return None
        tct = self._tc_tuple()
        if self.props["mode"] == "timecode" and tct is not None:
            tcs = (buf.meta or {}).get("timecode")
            if not tcs:
                return None
            keep = [k for k, tc in enumerate(tcs) if tuple(tc) >= tct]
            if not keep:
                return None
            return buf
        if pts < self.props["target-running-time"]:
            dur = buf.duration or 0
            if pts + dur <= self.props["target-running-time"]:
                return None
        return buf


@register_element
class H264Timestamper(TransformElement):
    FACTORY = "h264timestamper"
    DESCRIPTION = "Timestamp correction element for H.264 streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-h264"),
        PadTemplate("src", PadDirection.SRC, "video/x-h264"),
    ]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        # streams without reordering: DTS = PTS (gsth264timestamper.c
        # fallback path when no pic reordering is signalled)
        if buf.dts is None and buf.pts is not None:
            buf = buf.with_(dts=buf.pts)
        return buf


@register_element
class CombDetect(TransformElement):
    """Exact gstcombdetect.c:40-110 transliteration (vectorized per
    row; the left-to-right run accumulation stays sequential in i via
    cumulative segments)."""
    FACTORY = "combdetect"
    DESCRIPTION = "Detect combing artifacts in video frames"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format={ I420, Y42B }"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ I420, Y42B }"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._z = 0

    def start(self):
        self._z = 0

    def _detect_frame(self, y: np.ndarray) -> np.ndarray:
        h, w = y.shape
        out = y.copy()
        self._z += 1
        z = self._z
        out[:2] = y[:2] // 2
        out[h - 2:] = y[h - 2:] // 2
        thisline = np.zeros(w, np.int64)
        score = 0
        yi = y.astype(np.int64)
        for j in range(2, h - 2):
            up, cur, dn = yi[j - 1], yi[j], yi[j + 1]
            comb = (cur < np.minimum(up, dn) - 5) \
                | (cur > np.maximum(up, dn) + 5)
            # sequential left accumulation (C: thisline[i] +=
            # thisline[i-1] before ++)
            tl = thisline
            new = np.zeros(w, np.int64)
            # exact loop (thisline carries across rows AND left
            # neighbors within the row; the C order is load-bearing)
            for i in range(w):
                if comb[i]:
                    v = tl[i] + (new[i - 1] if i > 0 else 0)
                    v += 1
                    if v > 1000:
                        v = 1000
                    new[i] = v
                else:
                    new[i] = 0
            thisline = new
            stripe = thisline > 100
            score += int(stripe.sum())
            row = out[j]
            vals = np.where(((np.arange(w) + j + z) & 4).astype(bool),
                            235, 16).astype(np.uint8)
            out[j] = np.where(stripe, vals, y[j])
        return out

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        planes = list(buf.data)
        y = np.array(host_array(planes[0]))
        if y.ndim == 3:
            for k in range(y.shape[0]):
                y[k] = self._detect_frame(y[k])
        else:
            y = self._detect_frame(y)
        planes[0] = device_array(y, buf.data)
        return buf.with_(data=tuple(planes))


@register_element
class Ivtc(TransformElement):
    """ivtc (reduced): drops a frame whenever its fields both match
    the previous frame's opposite fields (the 2:3 duplicate created
    by pulldown); the reference's 5-frame cadence search is not
    ported."""
    FACTORY = "ivtc"
    DESCRIPTION = "Inverse Telecine Filter"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._prev = None

    def start(self):
        self._prev = None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        planes = list(buf.data)
        y = host_array(planes[0])
        n = buf.batch or 1
        keep = []
        for k in range(n):
            frame = y[k] if y.ndim == 3 else y
            if self._prev is not None:
                diff = np.abs(frame.astype(np.int64)
                              - self._prev.astype(np.int64))
                if diff.mean() < 0.5:           # pulldown duplicate
                    self._prev = frame.copy()
                    continue
            self._prev = frame.copy()
            keep.append(k)
        if not keep:
            return None
        if y.ndim == 3:
            planes = [p[keep] for p in planes]
            return buf.with_(data=tuple(planes), batch=len(keep))
        return buf


@register_element
class Compare(AggregatorElement):
    FACTORY = "compare"
    DESCRIPTION = "Compares incoming buffers"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("check", PadDirection.SINK, Caps.any(),
                    PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "method": (str, "mem", "mem|max|mse"),
        "threshold": (float, 0.0, "pass threshold"),
        "meta": (bool, True, "unused (reduced)"),
    }

    def negotiate_output(self, in_caps, allowed):
        for pad_name, caps in in_caps.items():
            if pad_name == "sink":
                return caps.fixate()
        return next(iter(in_caps.values())).fixate()

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        main = ins.get("sink")
        check = None
        for pad_name, b in ins.items():
            if pad_name.startswith("check"):
                check = b
        if main is None:
            return None
        if check is not None:
            a = np.concatenate([host_array(x).ravel().astype(
                np.float64) for x in (main.data if isinstance(
                    main.data, (list, tuple)) else [main.data])])
            b = np.concatenate([host_array(x).ravel().astype(
                np.float64) for x in (check.data if isinstance(
                    check.data, (list, tuple)) else [check.data])])
            nmin = min(len(a), len(b))
            d = a[:nmin] - b[:nmin]
            method = self.props["method"]
            if method == "max":
                metric = float(np.abs(d).max(initial=0.0))
            elif method == "mse":
                metric = float((d ** 2).mean()) if nmin else 0.0
            else:                                # mem: equality ratio
                metric = float((d != 0).mean()) if nmin else 0.0
            _post(self, "delta", {
                "method": method, "delta": metric,
                "equal": metric <= self.props["threshold"]})
        return main

    def host_aggregate_drain(self):
        return None


@register_element
class AudioLatency(TransformElement):
    """audiolatency (reduced detector): finds the first |sample| >
    0.5 spike per buffer and posts its offset as the measured
    latency."""
    FACTORY = "audiolatency"
    DESCRIPTION = "Measures the audio latency between the source " \
                  "and the sink"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=F32LE"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=F32LE"),
    ]
    PROPERTIES = {"print-latency": (bool, False, "")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.last_latency_ns: Optional[int] = None

    def set_info(self, incaps, outcaps):
        self._rate = incaps[0].fields.get("rate", 48000)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        x = buf.data
        mono = x.abs().amax(dim=-1) if x.ndim == 2 else x.abs()
        # the first loud sample, found where the samples are: one flag and
        # one index come back
        hit = (mono > 0.5).to(torch.uint8)
        first = hit.argmax() if hit.numel() else None
        found, first = (torch.stack([hit[first].long(), first]).tolist()
                        if first is not None else (0, 0))
        if found:
            off_ns = first * 1_000_000_000 // self._rate
            self.last_latency_ns = (buf.pts or 0) + off_ns
            _post(self, "latency", {
                "last-latency": self.last_latency_ns})
        return buf


@register_element
class H265Timestamper(TransformElement):
    """h265timestamper (gst-plugins-bad codectimestamper): same DTS
    reconstruction reduction as h264timestamper for HEVC streams."""
    FACTORY = "h265timestamper"
    DESCRIPTION = "Timestamp correction element for H.265 streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-h265"),
        PadTemplate("src", PadDirection.SRC, "video/x-h265"),
    ]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        if buf.dts is None and buf.pts is not None:
            buf = buf.with_(dts=buf.pts)
        return buf
