"""Audio elements: audiotestsrc, audioconvert, audioresample, volume.

Copies of the JAX package's ``elements/audio_elements.py`` classes of the
same names (references: gst-plugins-base gst/audiotestsrc/gstaudiotestsrc.c,
gst/audioconvert/gstaudioconvert.c over audio-converter.c, gst/audioresample/
gstaudioresample.c, gst/volume/gstvolume.c) with their device functions on
torch:

* ``audiotestsrc`` makes its samples on the host with numpy, as the
  reference does; the pipeline moves each buffer to its device.
* ``audioconvert``: unpack -> S32->F64 (int->float) -> mix -> F64->S32
  (float->int) -> quantize -> pack, on the tensor's device.  With noise
  shaping it is a host element (the quantizer's recurrence runs on the host).
* ``audioresample`` is a host element for its state (history, phase,
  timestamps); the history stays on the pipeline's device and the FIR runs
  there (``audio/resampler.py``).
* ``volume``: the static gain, float or Q27 integer, or a controlled gain
  (``make_dyn_fn``: the tick's float32 value from a control source bound
  to ``volume``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..audio import channel_mixer as chmix
from ..audio import format as afmt
from ..audio.info import AudioInfo
from ..audio.quantize import DITHER_NONE, Quantizer
from ..audio.resampler import AudioResampler
from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SourceElement,
                            TransformElement, register_element)
from ..core.value import IntRange, ValueList, fixate_nearest_int
from ..core.value import intersect as _intersect

AUDIO_FORMATS = ("S8 U8 S16LE S16BE U16LE S24_32LE S24LE S32LE F32LE F64LE"
                 ).split()
AUDIO_CAPS = ("audio/x-raw, format={ " + ", ".join(AUDIO_FORMATS) + " }, "
              "rate=[1,2147483647], channels=[1,64], layout=interleaved")

WAVES = ["sine", "square", "saw", "triangle", "silence", "white-noise",
         "pink-noise", "sine-table", "ticks", "gaussian-noise", "red-noise",
         "blue-noise", "violet-noise"]


@register_element
class AudioTestSrc(SourceElement):
    FACTORY = "audiotestsrc"
    KLASS = "Source/Audio"
    DESCRIPTION = "Creates audio test signals"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, AUDIO_CAPS)]
    PROPERTIES = {
        "wave": (str, "sine", "waveform"),
        "freq": (float, 440.0, "frequency (Hz)"),
        "volume": (float, 0.8, "amplitude 0..1"),
        "num-buffers": (int, -1, ""),
        "samplesperbuffer": (int, 1024, "samples per buffer"),
        "is-live": (bool, False, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._info: Optional[AudioInfo] = None
        self._acc = 0.0
        self._nbuf = 0
        self._sample_pos = 0
        self._rng = np.random.default_rng(0)

    def fixate(self, caps: Caps) -> Caps:
        caps = caps.truncate()
        s = caps[0].copy()
        if "rate" in s:
            s["rate"] = fixate_nearest_int(s["rate"], 44100)
        if "channels" in s:
            s["channels"] = fixate_nearest_int(s["channels"], 1)
        if "format" in s and isinstance(s["format"], ValueList):
            vals = list(s["format"])
            s["format"] = "S16LE" if "S16LE" in vals else vals[0]
        return Caps([s]).fixate()

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(outcaps[0])

    def start(self):
        self._acc = 0.0
        self._nbuf = 0
        self._sample_pos = 0

    def do_seek(self, segment) -> bool:
        if self._info is None:
            return False
        rate = self._info.rate
        self._sample_pos = segment.start * rate // 1_000_000_000
        step = 2 * math.pi * self.props["freq"] / rate
        self._acc = float((self._sample_pos * step) % (2 * math.pi))
        return True

    def create(self, n_frames: int) -> Optional[Buffer]:
        num = self.props["num-buffers"]
        if num >= 0 and self._nbuf >= num:
            return None
        info = self._info
        n = self.props["samplesperbuffer"] * max(1, n_frames)
        rate = info.rate
        wave = self.props["wave"]
        vol = self.props["volume"]
        freq = self.props["freq"]
        step = 2 * math.pi * freq / rate

        i = np.arange(1, n + 1, dtype=np.float64)
        acc = self._acc + i * step
        # the reference wraps by subtracting 2*pi as it accumulates; the
        # closed form below matches to float64 rounding
        acc_w = np.mod(acc, 2 * math.pi)
        if wave == "sine":
            samples = np.sin(acc_w) * vol
        elif wave == "square":
            samples = np.where(acc_w < math.pi, vol, -vol)
        elif wave == "saw":
            # ramp from +amp at 0 to -amp at 2pi (gstaudiotestsrc DEFINE_SAW)
            samples = np.where(acc_w < math.pi, vol * acc_w / math.pi,
                               vol * (acc_w - 2 * math.pi) / math.pi)
        elif wave == "triangle":
            samples = vol * (2 / math.pi) * np.where(
                acc_w < math.pi / 2, acc_w,
                np.where(acc_w < 1.5 * math.pi, math.pi - acc_w,
                         acc_w - 2 * math.pi))
        elif wave == "silence":
            samples = np.zeros(n)
        elif wave in ("white-noise",):
            samples = (self._rng.random(n) * 2 - 1) * vol
        elif wave == "gaussian-noise":
            samples = self._rng.normal(0, 0.5, n) * vol
        elif wave in ("red-noise", "pink-noise", "blue-noise", "violet-noise"):
            white = (self._rng.random(n) * 2 - 1) * vol
            if wave == "red-noise":
                samples = np.cumsum(white) * 0.05
                samples = np.clip(samples, -vol, vol)
            elif wave == "blue-noise" or wave == "violet-noise":
                samples = np.diff(white, prepend=0.0)
                samples = np.clip(samples, -vol, vol)
            else:  # pink: simple -3dB/oct via a one-pole filter bank (host)
                b = [0.99886, 0.99332, 0.96900]
                samples = np.empty(n)
                s0 = s1 = s2 = 0.0
                for k in range(n):
                    w = white[k]
                    s0 = b[0] * s0 + w * 0.0555179
                    s1 = b[1] * s1 + w * 0.0750759
                    s2 = b[2] * s2 + w * 0.1538520
                    samples[k] = (s0 + s1 + s2 + w * 0.1848) * 1.2
                samples = np.clip(samples, -vol, vol)
        elif wave == "ticks":
            period = rate  # 1 tick/s
            pos = (self._sample_pos + np.arange(n)) % period
            samples = np.where(pos < rate // 100, np.sin(acc_w) * vol, 0.0)
        else:
            samples = np.sin(acc_w) * vol
        self._acc = float(np.mod(self._acc + n * step, 2 * math.pi))

        samples = np.repeat(samples[:, None], info.channels, axis=1)
        f = info.finfo
        dt = np.dtype(str(afmt.native_dtype(f)).removeprefix("torch."))
        if f.is_float:
            data = samples.astype(dt)
        else:
            scale = float((1 << (f.width - 1)) - 1) if f.width <= 16 else 2147483647.0
            data = (samples * scale).astype(np.float64)
            data = data.astype(dt) if f.is_signed else (
                data.astype(np.int64) + (1 << (f.width - 1))).astype(dt)

        pts = self._sample_pos * 1_000_000_000 // rate
        dur = n * 1_000_000_000 // rate
        self._sample_pos += n
        self._nbuf += 1
        return Buffer(data=data, pts=pts, duration=dur, batch=1)


@register_element
class AudioConvert(TransformElement):
    FACTORY = "audioconvert"
    DESCRIPTION = "Convert audio to different formats"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, AUDIO_CAPS),
        PadTemplate("src", PadDirection.SRC, AUDIO_CAPS),
    ]
    PROPERTIES = {
        "dithering": (str, "tpdf", "dither method for depth reduction"),
        "noise-shaping": (str, "none", ""),
        "mix-matrix": (object, None, "custom mix matrix (rows=out)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._fn = None

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            ns = s.copy()
            ns["format"] = Caps.from_string(AUDIO_CAPS)[0]["format"]
            ns["channels"] = IntRange(1, 64)
            ns.fields.pop("channel-mask", None)
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction, caps, othercaps):
        s_in = caps[0]
        out = othercaps.truncate()[0].copy()
        for key in ("format", "channels", "rate"):
            if key in s_in and key in out.fields:
                r = _intersect(out[key], s_in[key])
                if r is not None:
                    out[key] = r
        if "channels" in out.fields:
            tgt = s_in.get("channels", 2)
            out["channels"] = fixate_nearest_int(out["channels"], tgt)
        return Caps([out]).fixate()

    def set_info(self, incaps, outcaps):
        iinfo = AudioInfo.from_caps_structure(incaps[0])
        oinfo = AudioInfo.from_caps_structure(outcaps[0])
        self._passthrough = incaps == outcaps
        if self._passthrough:
            self._fn = None
            return
        inf, onf = iinfo.finfo, oinfo.finfo
        mix_m = None
        if iinfo.channels != oinfo.channels or self.props["mix-matrix"] is not None:
            if self.props["mix-matrix"] is not None:
                mix_m = np.asarray(self.props["mix-matrix"], np.float32).T
            else:
                mix_m = chmix.build_matrix(iinfo.positions, oinfo.positions)
        dither = self.props["dithering"]
        quant: Optional[Quantizer] = None
        # chain_quantize gating (audio-converter.c:966-1014)
        if onf.is_integer and onf.depth < 32:
            if onf.depth > 20 or (inf.is_integer and onf.depth >= inf.depth):
                dither = DITHER_NONE
            quant = Quantizer(dither, 32 - onf.depth, oinfo.channels,
                              ns=self.props["noise-shaping"])
        self._quant = quant
        int_domain = inf.is_integer and onf.is_integer
        mix_int = chmix.matrix_int(mix_m) if mix_m is not None else None

        def fn(x):
            v = afmt.unpack(inf, x)
            if inf.is_integer and not onf.is_integer:
                v = afmt.s32_to_double(v)
            if mix_m is not None:
                if int_domain:
                    v = chmix.mix_int(v, mix_int)
                else:
                    v = chmix.mix_float(v, mix_m)
            if not inf.is_integer and onf.is_integer:
                v = afmt.double_to_s32(v)
            if quant is not None and quant.shift:
                # each call draws the next dither values (host PRNG); dither
                # none needs only the bias constant
                v = quant.apply(v)
            return afmt.pack(onf, v)

        self._fn = fn
        # noise shaping is a sequential error recurrence -> host element
        # (the quantizer runs the exact numpy recurrence per buffer)
        self.HOST_ELEMENT = (quant is not None
                             and self.props["noise-shaping"] != "none")

    def make_fn(self):
        if getattr(self, "HOST_ELEMENT", False):
            return None
        return self._fn

    def host_process(self, buf):
        if self._fn is None:
            return buf
        return buf.with_(data=self._fn(buf.data))


@register_element
class AudioResample(TransformElement):
    """audioresample: stateful (history, phase, timestamps), so a host
    element; its history stays on the pipeline's device and the FIR runs
    there."""
    FACTORY = "audioresample"
    DESCRIPTION = "Resamples audio"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, AUDIO_CAPS),
        PadTemplate("src", PadDirection.SRC, AUDIO_CAPS),
    ]
    PROPERTIES = {
        "quality": (int, 4, "0..10"),
        "resample-method": (str, "kaiser", ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._res: Optional[AudioResampler] = None
        self._hist: Optional[torch.Tensor] = None
        self._phase = 0
        self._base_out_pts = None
        self._next_in_pts = None
        self._out_count = 0

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            ns = s.copy()
            ns["rate"] = IntRange(1, 2147483647)
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction, caps, othercaps):
        s_in = caps[0]
        out = othercaps.truncate()[0].copy()
        if "rate" in out.fields and "rate" in s_in:
            out["rate"] = fixate_nearest_int(out["rate"], s_in["rate"])
        return Caps([out]).fixate()

    def set_info(self, incaps, outcaps):
        self._iinfo = AudioInfo.from_caps_structure(incaps[0])
        self._oinfo = AudioInfo.from_caps_structure(outcaps[0])
        self._passthrough = self._iinfo.rate == self._oinfo.rate
        if self._passthrough:
            self._res = None
            return
        self._res = AudioResampler(
            self.props["resample-method"], self._iinfo.rate, self._oinfo.rate,
            quality=self.props["quality"], device=self.device)
        f = self._iinfo.finfo
        self._dtype = ("s16" if f.is_integer and f.width <= 16 else
                       "s32" if f.is_integer else
                       "f32" if f.width == 32 else "f64")
        self._hist = None

    def start(self):
        self._hist = None
        self._phase = 0
        self._base_out_pts = None
        self._next_in_pts = None
        self._out_count = 0

    # input-timestamp drift beyond this resyncs the output timeline
    # (gstaudioresample.c drift tracking around :1146)
    DRIFT_TOLERANCE_NS = 40_000_000

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._passthrough:
            return buf
        in_rate = self._iinfo.rate
        out_rate = self._oinfo.rate
        hist_len = 0 if self._hist is None else len(self._hist)
        x = torch.as_tensor(buf.data)

        # -- timestamp drift tracking --------------------------------------
        if buf.pts is not None:
            expected = self._next_in_pts
            if (expected is None
                    or abs(buf.pts - expected) > self.DRIFT_TOLERANCE_NS):
                # discont: re-anchor the output timeline at this input,
                # accounting for queued history samples
                self._base_out_pts = (buf.pts
                                      - hist_len * 1_000_000_000 // in_rate)
                self._out_count = 0
            self._next_in_pts = (buf.pts
                                 + x.shape[0] * 1_000_000_000 // in_rate)

        if self._hist is not None:
            x = torch.cat([self._hist, x], dim=0)
        res = self._res
        up, down = res.out_red, res.in_red
        ph0 = self._phase
        # fixed output count per chunk length (worst-case start phase); the
        # remainder stays in history and is emitted next chunk —
        # sample-exact continuity
        n_out = ((len(x) - res.n_taps) * up - (up - 1)) // down + 1 \
            if len(x) >= res.n_taps else 0
        if n_out <= 0:
            self._hist = x
            return None
        out = res.resample_fn_phased(self._dtype, len(x), n_out)(x, ph0)
        total = ph0 + n_out * down
        consumed = total // up
        self._phase = total % up
        self._hist = x[consumed:].clone()

        pts = None
        if self._base_out_pts is not None:
            pts = (self._base_out_pts
                   + self._out_count * 1_000_000_000 // out_rate)
        self._out_count += n_out
        return buf.with_(data=out, pts=pts,
                         duration=n_out * 1_000_000_000 // out_rate)


@register_element
class Volume(TransformElement):
    """volume (gstvolume.c): gain + mute."""
    FACTORY = "volume"
    DESCRIPTION = "Set volume on audio streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, AUDIO_CAPS),
        PadTemplate("src", PadDirection.SRC, AUDIO_CAPS),
    ]
    PROPERTIES = {
        "volume": (float, 1.0, "gain factor"),
        "mute": (bool, False, ""),
    }
    DYNAMIC_PROPS = ("volume",)

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def make_dyn_fn(self):
        """Keyframed gain: `volume` arrives each tick as float32 (the
        control-binding path), no rebuild on value changes.  The float
        path multiplies by the float32 gain; the integer path takes its
        Q27 factor from the float32 product vol * 2**27 (``make_fn``
        takes it from the float64 one)."""
        f = self._info.finfo
        mute = self.props["mute"]

        def fn(x, dyn):
            vol = np.float32(0.0) if mute else np.float32(dyn["volume"])
            if f.is_float:
                return (x * float(vol)).to(x.dtype)
            q = int(vol * np.float32(1 << 27))
            v = (x.to(torch.int64) * q) >> 27
            lim = 1 << (f.width - 1)
            return torch.clamp(v, -lim, lim - 1).to(x.dtype)

        return fn

    def make_fn(self):
        vol = 0.0 if self.props["mute"] else self.props["volume"]
        if vol == 1.0:
            return None
        f = self._info.finfo

        def fn(x):
            if f.is_float:
                return (x * vol).to(x.dtype)
            # integer path: Q27 multiply like the reference ORC loops
            q = int(vol * (1 << 27))
            v = (x.to(torch.int64) * q) >> 27
            lim = 1 << (f.width - 1)
            return torch.clamp(v, -lim, lim - 1).to(x.dtype)

        return fn
