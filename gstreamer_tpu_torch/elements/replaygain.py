"""ReplayGain elements: rganalysis / rgvolume / rglimiter, in torch.

A port of the JAX package's ``elements/replaygain.py`` (references:
gst-plugins-good gst/replaygain/):

* rganalysis (gstrganalysis.c) — a host passthrough over the copied
  ``audio/rganalysis.py``: posts and pushes the track (and, when album
  processing completes, album) gain and peak tags at EOS;
* rgvolume (gstrgvolume.c) — the tag-driven gain, limited so that the peak
  stays under `headroom` dB (gst_rg_volume_determine_gain :640-688), a
  float32 product on the tensor's device;
* rglimiter (gstrglimiter.c:168-196) — the tanh soft limiter above
  ±0.5 (-6 dB).  The expression is taken in float64 and rounded once to
  float32, so the card and the CPU give the same bytes; XLA's own float32
  tanh is within 2 ULP of it (ROADMAP.md section 3).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..audio.info import AudioInfo
from ..audio.rganalysis import RG_REFERENCE_LEVEL, RgAnalysisCtx
from ..core.buffer import Buffer, host_array
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

_ANALYSIS_CAPS = ("audio/x-raw, format={ F32LE, S16LE }, "
                  "rate={ 48000, 44100, 32000, 24000, 22050, 16000, "
                  "12000, 11025, 8000 }, channels=[1,2], "
                  "layout=interleaved")
_FLOAT_CAPS = ("audio/x-raw, format=F32LE, rate=[1,2147483647], "
               "channels=[1,64], layout=interleaved")


@register_element
class RgAnalysis(TransformElement):
    FACTORY = "rganalysis"
    DESCRIPTION = "Perform the ReplayGain analysis"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _ANALYSIS_CAPS),
        PadTemplate("src", PadDirection.SRC, _ANALYSIS_CAPS),
    ]
    PROPERTIES = {
        "num-tracks": (int, 0, "album mode: tracks remaining"),
        "forced": (bool, True, "analyze even if tags are present"),
        "reference-level": (float, RG_REFERENCE_LEVEL, "dB"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._ctx = RgAnalysisCtx()
        self._tracks_left = self.props["num-tracks"]

    def start(self):
        self._ctx = RgAnalysisCtx()
        self._tracks_left = self.props["num-tracks"]

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])
        self._ctx.set_sample_rate(self._info.rate)

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._ctx.sample_rate == 0:      # start() may follow set_info
            self._ctx.set_sample_rate(self._info.rate)
        x = host_array(buf.data)
        if x.dtype == np.int16:
            # int16 path scales by 1/32768 for peak, raw for analysis
            # (rg_analysis_analyze_stereo_int16 :602)
            xs = x.astype(np.float64) / 32768.0
        else:
            xs = x.astype(np.float64)
        self._ctx.analyze(xs)
        return buf

    def _post_tags(self, tags):
        root = self
        while getattr(root, "parent", None) is not None:
            root = root.parent
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            root.bus.post(Message("tag", self.name, tags))
        from ..core.events import tag_event
        for sp in self.src_pads():
            ev = tag_event(tags)
            if sp.peer is not None:
                sp.push_event(ev)
            else:
                sp.sticky[ev.type] = ev

    def sink_event(self, pad, event) -> bool:
        from ..core.events import EventType

        if event.type == EventType.EOS:
            res = self._ctx.track_result()
            if res is not None:
                gain, peak = res
                tags = {
                    "replaygain-track-gain": gain,
                    "replaygain-track-peak": peak,
                    "replaygain-reference-level":
                        self.props["reference-level"],
                }
                if self._tracks_left > 0:
                    self._tracks_left -= 1
                    if self._tracks_left == 0:
                        ares = self._ctx.album_result()
                        if ares is not None:
                            tags["replaygain-album-gain"] = ares[0]
                            tags["replaygain-album-peak"] = ares[1]
                self._post_tags(tags)
        return super().sink_event(pad, event)


@register_element
class RgVolume(TransformElement):
    FACTORY = "rgvolume"
    DESCRIPTION = "Apply ReplayGain volume adjustment"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _FLOAT_CAPS),
        PadTemplate("src", PadDirection.SRC, _FLOAT_CAPS),
    ]
    PROPERTIES = {
        "album-mode": (bool, True, "prefer album gain"),
        "headroom": (float, 0.0, "extra headroom (dB)"),
        "pre-amp": (float, 0.0, "extra gain (dB)"),
        "fallback-gain": (float, 0.0, "gain when no tags (dB)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._tags = {}
        self.target_gain = 0.0
        self.result_gain = 0.0

    def sink_event(self, pad, event) -> bool:
        from ..core.events import EventType

        if event.type == EventType.TAG:
            tags = event.data.get("tags") or {}
            self._tags.update({k: v for k, v in tags.items()
                               if k.startswith("replaygain-")})
        return super().sink_event(pad, event)

    def _determine_gain(self):
        """gst_rg_volume_determine_gain (gstrgvolume.c:640)."""
        t = self._tags
        has_tg = "replaygain-track-gain" in t
        has_ag = "replaygain-album-gain" in t
        album_mode = self.props["album-mode"]
        if not has_tg and not has_ag:
            gain, peak = self.props["fallback-gain"], 1.0
        elif (album_mode and has_ag) or (not album_mode and not has_tg):
            gain = t["replaygain-album-gain"]
            peak = t.get("replaygain-album-peak", 1.0)
        else:
            gain = t["replaygain-track-gain"]
            peak = t.get("replaygain-track-peak", 1.0)
        gain += self.props["pre-amp"]
        self.target_gain = self.result_gain = gain
        if peak > 0 and 20.0 * math.log10(peak) + gain \
                > self.props["headroom"]:
            self.result_gain = (20.0 * math.log10(1.0 / peak)
                                + self.props["headroom"])

    def set_info(self, incaps, outcaps):
        pass

    def make_fn(self):
        self._determine_gain()
        vol = 10.0 ** (self.result_gain / 20.0)
        if vol == 1.0:
            return None

        def fn(x):
            return (x * vol).to(x.dtype)

        return fn


@register_element
class RgLimiter(TransformElement):
    """rglimiter (gstrglimiter.c): tanh soft-clip above -6 dB."""
    FACTORY = "rglimiter"
    DESCRIPTION = "Apply signal compression to raw audio data"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _FLOAT_CAPS),
        PadTemplate("src", PadDirection.SRC, _FLOAT_CAPS),
    ]
    PROPERTIES = {"enabled": (bool, True, "")}

    def set_info(self, incaps, outcaps):
        pass

    def make_fn(self):
        if not self.props["enabled"]:
            return None
        thres = compl_ = 0.5

        def fn(x):
            xf = x.to(torch.float32)
            xd = xf.to(torch.float64)
            hi = torch.tanh((xd - thres) / compl_) * compl_ + thres
            lo = torch.tanh((xd + thres) / compl_) * compl_ - thres
            lim = torch.where(xd > thres, hi, lo).to(torch.float32)
            return torch.where((xf > thres) | (xf < -thres), lim,
                               xf).to(x.dtype)

        return fn
