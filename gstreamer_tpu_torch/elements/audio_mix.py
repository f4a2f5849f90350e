"""audiomixer / adder / audiointerleave / audiorate, in torch.

A port of the JAX package's ``elements/audio_mix.py`` (reference:
gst-plugins-base/gst/audiomixer/gstaudiomixer.c — sample-accurate N:1 sum
on GstAudioAggregator, saturating per format; gst/adder/gstadder.c — the
legacy sum; gst/audiorate/gstaudiorate.c — gap fill and drop for perfect
timestamps).  Buffers are (frames, channels) tensors on the pipeline's
device; the sums are plain torch there.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..audio.info import AudioInfo
from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, TransformElement, register_element)
from .audio_elements import AUDIO_CAPS


class _AudioSumBase(AggregatorElement):
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, AUDIO_CAPS),
        PadTemplate("sink_%u", PadDirection.SINK, AUDIO_CAPS,
                    PadPresence.REQUEST),
    ]

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed: Caps) -> Caps:
        first = next(iter(in_caps.values()))
        out = first
        if not allowed.is_any:
            inter = Caps([first[0]]).intersect(allowed)
            out = inter if not inter.is_empty else allowed
        out = out.fixate()
        self._info = AudioInfo.from_caps_structure(out[0])
        return out

    def aggregate_fn(self):
        f = self._info.finfo

        def fn(inputs):
            vals = list(inputs.values())
            # match lengths (sample-accurate mixing trims to shortest)
            n = min(v.shape[-2] for v in vals)
            vals = [v[..., :n, :] for v in vals]
            if f.is_float:
                # float64 sum in pad order, one rounding to the format
                acc = sum(v.to(torch.float64) for v in vals)
                return acc.to(vals[0].dtype)
            acc = sum(v.to(torch.int64) for v in vals)
            lim = 1 << (f.width - 1)
            return torch.clamp(acc, -lim, lim - 1).to(vals[0].dtype)

        return fn


@register_element
class AudioMixer(_AudioSumBase):
    FACTORY = "audiomixer"
    DESCRIPTION = "Mixes multiple audio streams (sample accurate)"


@register_element
class Adder(_AudioSumBase):
    FACTORY = "adder"
    DESCRIPTION = "Add N audio channel buffers (legacy)"


@register_element
class AudioInterleave(AggregatorElement):
    """audiointerleave: N mono streams -> one N-channel stream, channel k
    from the k-th pad name in sorted order."""
    FACTORY = "audiointerleave"
    DESCRIPTION = "Folds many mono channels into one interleaved stream"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, AUDIO_CAPS),
        PadTemplate("sink_%u", PadDirection.SINK, AUDIO_CAPS,
                    PadPresence.REQUEST),
    ]

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed: Caps) -> Caps:
        first = next(iter(in_caps.values()))[0].copy()
        first["channels"] = len(in_caps)
        out = Caps([first])
        if not allowed.is_any:
            inter = out.intersect(allowed)
            if not inter.is_empty:
                out = inter
        out = out.fixate()
        self._info = AudioInfo.from_caps_structure(out[0])
        self._order = sorted(in_caps)
        return out

    def aggregate_fn(self):
        order = self._order

        def fn(inputs):
            vals = [inputs[k] for k in order]
            n = min(v.shape[-2] for v in vals)
            return torch.cat([v[..., :n, :] for v in vals], dim=-1)

        return fn


@register_element
class AudioRate(TransformElement):
    """audiorate: produce a perfect stream by filling gaps with silence
    and dropping overlapping samples (gstaudiorate.c).  The decision is
    made on the host from the timestamps; the samples stay tensors where
    they are."""
    FACTORY = "audiorate"
    DESCRIPTION = "Drops/duplicates/fills audio to make a perfect stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, AUDIO_CAPS),
        PadTemplate("src", PadDirection.SRC, AUDIO_CAPS),
    ]
    PROPERTIES = {
        "silent": (bool, True, ""),
        "tolerance": (int, 40000000, "ns"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.in_samples = 0
        self.out_samples = 0
        self.add_samples = 0
        self.drop_samples = 0
        self._next_offset = None

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def start(self):
        self._next_offset = None
        self.in_samples = self.out_samples = 0
        self.add_samples = self.drop_samples = 0

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        rate = self._info.rate
        x = buf.data
        n = x.shape[0]
        self.in_samples += n
        offset = ((buf.pts or 0) * rate + 500_000_000) // 1_000_000_000
        if self._next_offset is None:
            self._next_offset = offset
        gap = offset - self._next_offset
        tol_samples = self.props["tolerance"] * rate // 1_000_000_000
        if abs(gap) <= tol_samples:
            gap = 0
        if gap > 0:       # fill silence
            sil = torch.zeros((gap,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            x = torch.cat([sil, x], dim=0)
            self.add_samples += gap
        elif gap < 0:     # overlap: drop leading samples
            drop = min(-gap, n)
            x = x[drop:]
            self.drop_samples += drop
            if x.shape[0] == 0:
                return None
        pts = self._next_offset * 1_000_000_000 // rate
        self._next_offset += x.shape[0]
        self.out_samples += x.shape[0]
        return buf.with_(data=x, pts=pts,
                         duration=x.shape[0] * 1_000_000_000 // rate)
