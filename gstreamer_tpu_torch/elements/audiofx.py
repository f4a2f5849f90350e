"""The audio effects family and the analysis elements, in torch.

A port of the JAX package's ``elements/audiofx.py`` (references:
gst-plugins-good gst/audiofx/, gst/spectrum/, gst/level/, gst/equalizer/,
gst/stereo/):

* device functions on the tensor's device: audioamplify, audioinvert,
  audiokaraoke, audiodynamic, audiopanorama;
* host elements, copied: audioecho, spectrum, level, equalizer-3bands,
  equalizer-10bands, equalizer-nbands, audiowsinclimit, audiowsincband,
  audiofirfilter, audioiirfilter, audiocheblimit, audiochebband, stereo.
  Each takes its buffer to the host (numpy, scipy's ``lfilter`` for the
  recursions) and returns the result on the device the buffer came from;
  spectrum and level pass the buffer through and post the reference's bus
  messages.

Where the JAX package's arithmetic differs from a plain torch spelling, the
port follows what XLA computes on the CPU:

* a float -> integer cast saturates in XLA and wraps in torch: every such
  cast clamps to the target's range first (``_saturate``; audioamplify's
  ``clipping-method=none`` relies on it);
* audiokaraoke's ``l - r * level`` in float64 is contracted into a fused
  multiply-add by XLA: ``_fma`` computes it with one rounding;
* audiopanorama's ``R + L * pan`` in float32 likewise: the port computes it
  in float64 and rounds once to float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..audio.fft import FFT
from ..audio.info import AudioInfo
from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from .audio_elements import AUDIO_CAPS

FLOAT_CAPS = ("audio/x-raw, format={ F32LE, F64LE }, rate=[1,2147483647], "
              "channels=[1,64], layout=interleaved")


def _saturate(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float -> `dtype` as XLA converts: truncation toward zero, saturating
    at the integer type's range (torch's own cast wraps)."""
    if dtype.is_floating_point:
        return v.to(dtype)
    info = torch.iinfo(dtype)
    return torch.clamp(v, info.min, info.max).to(dtype)


def _split(x: torch.Tensor):
    """Veltkamp's split of float64 values into 26- and 27-bit halves."""
    c = x * 134217729.0
    hi = c - (c - x)
    return hi, x - hi


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float64 with one rounding, as XLA's contraction of the
    expression into a fused multiply-add gives it: Dekker's exact product
    and Knuth's exact sum, then one rounding of their parts."""
    bt = torch.full_like(a, b)
    p = a * bt
    ah, al = _split(a)
    bh, bl = _split(bt)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + err)


class _AudioFxBase(TransformElement):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, AUDIO_CAPS),
        PadTemplate("src", PadDirection.SRC, AUDIO_CAPS),
    ]

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def _limits(self):
        f = self._info.finfo
        if f.is_float:
            return None
        lim = 1 << (f.width - 1)
        return (-lim, lim - 1)


@register_element
class AudioAmplify(_AudioFxBase):
    FACTORY = "audioamplify"
    DESCRIPTION = "Amplifies audio with selectable clipping"
    PROPERTIES = {
        "amplification": (float, 1.0, "gain factor"),
        "clipping-method": (str, "clip",
                            "clip|wrap-negative|wrap-positive|none"),
    }

    def make_fn(self):
        amp = self.props["amplification"]
        if amp == 1.0:
            return None
        method = self.props["clipping-method"]
        lim = self._limits()

        def fn(x):
            if lim is None:
                v = x * amp
                if method == "clip":
                    v = torch.clamp(v, -1.0, 1.0)
                return v.to(x.dtype)
            v = x.to(torch.float64) * amp
            if method == "clip":
                v = torch.clamp(v, lim[0], lim[1])
            elif method.startswith("wrap"):
                rng = lim[1] - lim[0] + 1
                v = torch.remainder(v - lim[0], rng) + lim[0]
            return _saturate(v, x.dtype)

        return fn


@register_element
class AudioInvert(_AudioFxBase):
    FACTORY = "audioinvert"
    DESCRIPTION = "Swaps upper and lower half of audio samples"
    PROPERTIES = {"degree": (float, 0.0, "0..1")}

    def make_fn(self):
        d = self.props["degree"]
        if d == 0.0:
            return None
        factor = 1.0 - 2.0 * d
        lim = self._limits()

        def fn(x):
            v = x.to(torch.float64) * factor
            if lim is not None:
                v = torch.clamp(v, lim[0], lim[1])
            return _saturate(v, x.dtype)

        return fn


@register_element
class AudioKaraoke(_AudioFxBase):
    """audiokaraoke: out_l = l - r * level, out_r = r - l * level, each a
    fused multiply-add as XLA computes it (``_fma``).  ``mono-level`` is
    declared and never read, as in the reference."""
    FACTORY = "audiokaraoke"
    DESCRIPTION = "Removes the center channel (voice)"
    PROPERTIES = {
        "level": (float, 1.0, "cancellation level"),
        "mono-level": (float, 1.0, ""),
    }

    def make_fn(self):
        level = self.props["level"]
        lim = self._limits()

        def fn(x):
            if x.shape[-1] < 2:
                return x
            v = x.to(torch.float64)
            l, r = v[..., 0], v[..., 1]
            out_l = _fma(-r, level, l)
            out_r = _fma(-l, level, r)
            if lim is not None:
                out_l = torch.clamp(out_l, lim[0], lim[1])
                out_r = torch.clamp(out_r, lim[0], lim[1])
            rest = [v[..., i] for i in range(2, x.shape[-1])]
            return _saturate(torch.stack([out_l, out_r] + rest, dim=-1),
                             x.dtype)

        return fn


@register_element
class AudioEcho(_AudioFxBase):
    """audioecho: out = in + intensity * in[t - delay] with feedback (host
    element: the delay line is carried across buffers)."""
    FACTORY = "audioecho"
    DESCRIPTION = "Adds an echo to audio"
    HOST_ELEMENT = True
    PROPERTIES = {
        "delay": (int, 1, "delay in ns"),
        "intensity": (float, 0.0, "echo intensity 0..1"),
        "feedback": (float, 0.0, "feedback 0..1"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._hist: Optional[np.ndarray] = None

    def start(self):
        self._hist = None

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        info = self._info
        delay_samps = self.props["delay"] * info.rate // 1_000_000_000
        inten = self.props["intensity"]
        fb = self.props["feedback"]
        if delay_samps <= 0 or inten == 0.0:
            return buf
        xs = host_array(buf.data)
        x = xs.astype(np.float64)
        n = x.shape[0]
        if self._hist is None:
            self._hist = np.zeros((delay_samps,) + x.shape[1:], np.float64)
        # sequential feedback per delay block (vectorised inside a block)
        hist = self._hist
        out = np.empty_like(x)
        pos = 0
        while pos < n:
            m = min(delay_samps, n - pos)
            out[pos:pos + m] = x[pos:pos + m] + inten * hist[:m]
            hist = np.concatenate([hist[m:],
                                   x[pos:pos + m] + fb * hist[:m]], axis=0)
            pos += m
        self._hist = hist
        lim = self._limits()
        if lim is not None:
            out = np.clip(out, lim[0], lim[1])
        return buf.with_(data=device_array(out.astype(xs.dtype), buf.data))


@register_element
class AudioDynamic(_AudioFxBase):
    """audiodynamic: hard-knee compressor / expander.  ``characteristics``
    is declared and never read (soft-knee runs the hard-knee formula), as
    in the reference."""
    FACTORY = "audiodynamic"
    DESCRIPTION = "Compressor/expander"
    PROPERTIES = {
        "mode": (str, "compressor", "compressor|expander"),
        "characteristics": (str, "hard-knee", "hard-knee|soft-knee"),
        "threshold": (float, 0.0, "0..1"),
        "ratio": (float, 1.0, ""),
    }

    def make_fn(self):
        thr = self.props["threshold"]
        ratio = self.props["ratio"]
        mode = self.props["mode"]
        if ratio == 1.0:
            return None
        f = self._info.finfo
        lim = self._limits()
        scale = 1.0 if f.is_float else (lim[1] + 1)

        def fn(x):
            v = x.to(torch.float64) / scale
            a = torch.abs(v)
            if mode == "compressor":
                mag = torch.where(a > thr, thr + (a - thr) * ratio, a)
            else:
                mag = torch.where(a < thr, a * ratio, a)
            # sign(v) * mag, with XLA's sign of -0.0
            out = torch.copysign(mag, v) * scale
            if lim is not None:
                out = torch.clamp(out, lim[0], lim[1])
            return _saturate(out, x.dtype)

        return fn


@register_element
class Spectrum(_AudioFxBase):
    """spectrum: passthrough + per-interval magnitude/phase messages.

    gstspectrum.c: nfft = 2*bands-2, Hamming window, non-overlapping FFT
    blocks in a sample ring, magnitude per band 10*log10((re^2+im^2)/nfft^2)
    clamped at `threshold` and averaged over the interval's FFTs (run_fft
    :713, block loop :862); the interval's frame count carries the ns
    rounding error forward (accumulated_error :905).  Host numpy."""
    FACTORY = "spectrum"
    DESCRIPTION = "Run an FFT on the audio signal, output spectrum data"
    HOST_ELEMENT = True
    PROPERTIES = {
        "bands": (int, 128, "number of frequency bands"),
        "interval": (int, 100_000_000, "message interval in ns"),
        "threshold": (int, -60, "dB threshold; lower values clamped"),
        "post-messages": (bool, True, ""),
        "message-magnitude": (bool, True, ""),
        "message-phase": (bool, False, ""),
        "multi-channel": (bool, False, "analyze channels separately"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.last_magnitudes = None
        self.last_phases = None
        self._reset_done = False

    def _reset(self):
        bands = self.props["bands"]
        nch = self._nch()
        self._nfft = 2 * bands - 2
        self._ring = np.zeros((nch, self._nfft), np.float32)
        self._input_pos = 0
        self._num_frames = 0
        self._num_fft = 0
        self._mag = np.zeros((nch, bands), np.float32)
        self._phase = np.zeros((nch, bands), np.float32)
        rate = self._info.rate
        interval = self.props["interval"]
        self._fpi = max(1, interval * rate // 1_000_000_000)
        self._frames_todo = self._fpi
        self._err_per_interval = (interval * rate) % 1_000_000_000
        self._acc_err = 0
        self._message_ts = 0
        self._fft = FFT(self._nfft)
        self._reset_done = True

    def _nch(self):
        return self._info.channels if self.props["multi-channel"] else 1

    def start(self):
        self._reset_done = False

    def flush(self):
        self._reset_done = False

    def _post(self, duration):
        root = self.parent
        while getattr(root, "parent", None) is not None:
            root = root.parent
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            fields = {"name": "spectrum",
                      "endtime": self._message_ts + duration,
                      "timestamp": self._message_ts,
                      "stream-time": self._message_ts,
                      "running-time": self._message_ts,
                      "duration": duration}
            if self.props["message-magnitude"]:
                m = self.last_magnitudes
                fields["magnitude"] = (m[0].tolist()
                                       if not self.props["multi-channel"]
                                       else [c.tolist() for c in m])
            if self.props["message-phase"]:
                p = self.last_phases
                fields["phase"] = (p[0].tolist()
                                   if not self.props["multi-channel"]
                                   else [c.tolist() for c in p])
            root.bus.post(Message("element", self.name, fields))

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        if not self._reset_done:
            self._reset()
        x = host_array(buf.data).astype(np.float32)
        if x.ndim == 1:
            x = x[:, None]
        f = self._info.finfo
        if not f.is_float:
            x = x / np.float32((1 << (f.width - 1)) - 1)
        if not self.props["multi-channel"]:
            x = (x.sum(axis=1) / self._info.channels)[:, None]
        bands = self.props["bands"]
        nfft = self._nfft
        threshold = self.props["threshold"]
        pos = 0
        size = x.shape[0]
        while size > 0:
            fft_todo = nfft - (self._num_frames % nfft)
            msg_todo = self._frames_todo - self._num_frames
            block = min(msg_todo, size, fft_todo)
            idx = (self._input_pos + np.arange(block)) % nfft
            self._ring[:, idx] = x[pos:pos + block].T
            pos += block
            size -= block
            self._input_pos = (self._input_pos + block) % nfft
            self._num_frames += block
            full = self._num_frames == self._frames_todo
            if (self._num_frames % nfft == 0) or (full and not self._num_fft):
                order = (self._input_pos + np.arange(nfft)) % nfft
                data = self._ring[:, order].astype(np.float32)
                spec = self._fft.fft(np, data, win="hamming")
                if self.props["message-magnitude"]:
                    val = (spec.real ** 2 + spec.imag ** 2) / (nfft * nfft)
                    db = 10.0 * np.log10(np.maximum(val, 1e-38))
                    self._mag += np.maximum(db, threshold)[:, :bands]
                if self.props["message-phase"]:
                    self._phase += np.arctan2(spec.imag,
                                              spec.real)[:, :bands]
                self._num_fft += 1
            if full:
                self._frames_todo = self._fpi
                if self._acc_err >= 1_000_000_000:
                    self._acc_err -= 1_000_000_000
                    self._frames_todo += 1
                self._acc_err += self._err_per_interval
                self.last_magnitudes = self._mag / max(1, self._num_fft)
                self.last_phases = self._phase / max(1, self._num_fft)
                if self.props["post-messages"] and self.parent is not None:
                    self._post(self.props["interval"])
                self._message_ts += self.props["interval"]
                self._mag[:] = 0
                self._phase[:] = 0
                self._num_frames = 0
                self._num_fft = 0
        return buf


@register_element
class Level(_AudioFxBase):
    """level: RMS/peak/decaying-peak messages per interval.

    gstlevel.c: normalised cumulative/peak squares per channel
    (DEFINE_INT_LEVEL_CALCULATOR :342), decay peak with TTL + dB/sec
    falloff (transform_ip :614-672), message values
    RMSdB = 20*log10(sqrt(CS/frames)+eps), peak/decay in power dB
    (post_message :700-720).  Host numpy."""
    FACTORY = "level"
    DESCRIPTION = "RMS/Peak/Decaying Peak Level messager for audio/raw"
    HOST_ELEMENT = True
    PROPERTIES = {
        "post-messages": (bool, True, ""),
        "interval": (int, 100_000_000, "message interval in ns"),
        "peak-ttl": (int, 300_000_000, "decay peak time-to-live in ns"),
        "peak-falloff": (float, 10.0, "decay rate after TTL in dB/sec"),
    }
    EPSILON = 1e-35

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.last_rms = None
        self.last_peak = None
        self.last_decay = None
        self._state = None

    def start(self):
        self._state = None

    def flush(self):
        self._state = None

    def _post(self, duration):
        root = self.parent
        while getattr(root, "parent", None) is not None:
            root = root.parent
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            root.bus.post(Message(
                "element", self.name,
                {"name": "level",
                 "timestamp": self._msg_ts, "duration": duration,
                 "rms": list(self.last_rms), "peak": list(self.last_peak),
                 "decay": list(self.last_decay)}))

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        ch = self._info.channels
        rate = self._info.rate
        if self._state is None:
            self._state = {
                "CS": np.zeros(ch), "peak": np.zeros(ch),
                "last_peak": np.zeros(ch), "decay_peak": np.zeros(ch),
                "decay_base": np.zeros(ch),
                "decay_age": np.zeros(ch, np.int64),
                "num_frames": 0, "msg_ts": buf.pts or 0,
            }
        st = self._state
        x = host_array(buf.data).astype(np.float64)
        if x.ndim == 1:
            x = x[:, None]
        f = self._info.finfo
        if not f.is_float:
            x = x / float(1 << (f.width - 1))
        interval_frames = max(
            1, self.props["interval"] * rate // 1_000_000_000)
        num_frames = x.shape[0]
        pos = 0
        while num_frames > 0:
            block = min(interval_frames - st["num_frames"], num_frames)
            seg = x[pos:pos + block]
            sq = seg * seg
            st["CS"] += sq.sum(axis=0)
            st["peak"] = sq.max(axis=0) if block else st["peak"]
            # age advances by the REMAINING frame count, as the C does
            # (gstlevel.c:621 uses num_frames, not block_size)
            st["decay_age"] += num_frames * 1_000_000_000 // rate
            st["last_peak"] = np.maximum(st["last_peak"], st["peak"])
            falloff_t = st["decay_age"] - self.props["peak-ttl"]
            fall = falloff_t > 0
            if fall.any():
                length = falloff_t / 1e9
                factor = 10.0 ** (self.props["peak-falloff"]
                                  * length / -20.0)
                st["decay_peak"] = np.where(
                    fall, st["decay_base"] * factor, st["decay_peak"])
            newpeak = st["peak"] >= st["decay_peak"]
            st["decay_peak"] = np.where(newpeak, st["peak"],
                                        st["decay_peak"])
            st["decay_base"] = np.where(newpeak, st["peak"],
                                        st["decay_base"])
            st["decay_age"] = np.where(newpeak, 0, st["decay_age"])
            pos += block
            st["num_frames"] += block
            num_frames -= block
            if st["num_frames"] >= interval_frames:
                frames = st["num_frames"]
                dur = frames * 1_000_000_000 // rate
                rms = np.sqrt(st["CS"] / frames)
                self.last_rms = 20 * np.log10(rms + self.EPSILON)
                self.last_peak = 10 * np.log10(st["last_peak"]
                                               + self.EPSILON)
                st["decay_peak"] = np.maximum(st["decay_peak"],
                                              st["last_peak"])
                self.last_decay = 10 * np.log10(st["decay_peak"]
                                                + self.EPSILON)
                self._msg_ts = st["msg_ts"]
                if self.props["post-messages"] and self.parent is not None:
                    self._post(dur)
                st["msg_ts"] += dur
                st["CS"][:] = 0
                st["last_peak"][:] = 0
                st["num_frames"] = 0
        return buf


class _EqualizerBase(_AudioFxBase):
    """Shared equalizer machinery (gstiirequalizer.c — cascaded biquads,
    S16 processed as float per CREATE_OPTIMIZED_FUNCTIONS_INT gint16 ->
    gfloat :819).  Host element."""
    HOST_ELEMENT = True
    N_BANDS = 3

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._eq = None

    def set_info(self, incaps, outcaps):
        super().set_info(incaps, outcaps)
        from ..audio.equalizer import IirEqualizer
        info = self._info
        self._eq = IirEqualizer(self._n_bands(), info.rate, info.channels)
        self._apply_gains()
        self._eq.setup()

    def _n_bands(self):
        return self.N_BANDS

    def _apply_gains(self):
        for i in range(self._n_bands()):
            key = f"band{i}"
            if key in self.props:
                self._eq.bands[i].gain = float(self.props[key])

    def start(self):
        if self._eq is not None:
            self._eq.reset()

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._eq is None or all(b.gain == 0.0 for b in self._eq.bands):
            return buf    # set_passthrough(:585): all gains 0 -> identity
        x = host_array(buf.data)
        lim = self._limits()
        y = self._eq.process(x.astype(np.float64))
        if lim is None:
            out = y.astype(x.dtype)
        else:
            # the reference's int path computes in float and casts back
            # (one_step gint16/gfloat) with CLAMP
            out = np.clip(y, lim[0], lim[1]).astype(x.dtype)
        return buf.with_(data=device_array(out, buf.data))


@register_element
class Equalizer3Bands(_EqualizerBase):
    FACTORY = "equalizer-3bands"
    DESCRIPTION = "3-band IIR equalizer (110 Hz / 1.1 kHz / 11 kHz)"
    N_BANDS = 3
    PROPERTIES = {
        "band0": (float, 0.0, "gain dB, 110 Hz band"),
        "band1": (float, 0.0, "gain dB, 1.1 kHz band"),
        "band2": (float, 0.0, "gain dB, 11 kHz band"),
    }


@register_element
class Equalizer10Bands(_EqualizerBase):
    FACTORY = "equalizer-10bands"
    DESCRIPTION = "10-band IIR equalizer"
    N_BANDS = 10
    PROPERTIES = {f"band{i}": (float, 0.0, f"gain dB, band {i}")
                  for i in range(10)}


@register_element
class EqualizerNBands(_EqualizerBase):
    FACTORY = "equalizer-nbands"
    DESCRIPTION = "N-band IIR equalizer"
    PROPERTIES = {"num-bands": (int, 10, "number of bands (1-64)")}

    def _n_bands(self):
        return int(self.props["num-bands"])

    def set_band_gain(self, idx: int, gain_db: float):
        """child-proxy equivalent: set band gain programmatically."""
        self._eq.set_gain(idx, gain_db)


@register_element
class AudioPanorama(TransformElement):
    """audiopanorama: mono/stereo -> stereo panning.

    audiopanorama.c and audiopanoramaorc.orc: psychoacoustic mode
    crossfeeds the attenuated channel into the other (ch2_psy_right
    :64/:108: L'=L*(1-pan), R'=R+L*pan; mirrored for pan<0); simple mode
    only attenuates (ch2_sim_* :235); mono spreads L=x*(1-r), R=x*r with
    r=(pan+1)/2 (:33).  Every product and sum is taken in float64 and
    rounded once to float32, as XLA's fused multiply-add rounds it."""
    FACTORY = "audiopanorama"
    DESCRIPTION = "Positions audio streams in the stereo panorama"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format={ S16LE, F32LE }, "
                    "rate=[1,2147483647], channels=[1,2], "
                    "layout=interleaved"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format={ S16LE, F32LE }, "
                    "rate=[1,2147483647], channels=2, "
                    "layout=interleaved"),
    ]
    PROPERTIES = {
        "panorama": (float, 0.0, "position [-1..1]"),
        "method": (str, "psychoacoustic", "psychoacoustic|simple"),
    }

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            ns = s.copy()
            if direction == PadDirection.SINK:
                ns["channels"] = 2
            else:
                from ..core.value import IntRange
                ns["channels"] = IntRange(1, 2)
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def make_fn(self):
        pan = np.float32(self.props["panorama"])
        psy = self.props["method"] == "psychoacoustic"
        mono = self._info.channels == 1
        is_int = self._info.finfo.is_integer
        # the float32 factors of the reference's expressions
        one_minus = float(np.float32(1.0 - pan))
        one_plus = float(np.float32(1.0 + pan))
        r = np.float32((pan + 1.0) / 2.0)
        spread = (float(np.float32(1.0) - r), float(r))

        def fn(x):
            v = x.to(torch.float32).to(torch.float64)
            if mono:
                s = v[..., 0]
                if psy:
                    left, right = s * spread[0], s * spread[1]
                elif pan == 0.0:
                    left = right = s
                elif pan > 0.0:
                    left, right = s * one_minus, s
                else:
                    left, right = s, s * one_plus
            else:
                L, R = v[..., 0], v[..., 1]
                if pan == 0.0:
                    left, right = L, R
                elif psy and pan > 0.0:
                    left = L * one_minus
                    right = R + L * float(pan)
                elif psy:
                    left = L + R * float(-pan)
                    right = R * one_plus
                elif pan > 0.0:
                    left, right = L * one_minus, R
                else:
                    left, right = L, R * one_plus
            out = torch.stack([left, right], dim=-1).to(torch.float32)
            if is_int:
                out = torch.clamp(torch.round(out), -32768, 32767
                                  ).to(torch.int16)
            return out

        return fn


def _wsinc_window(kernel: np.ndarray, window: str) -> np.ndarray:
    """The five FIR windows (audiowsinclimit.c:273-291)."""
    ln = len(kernel)
    i = np.arange(ln, dtype=np.float64)
    if window == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * i / (ln - 1))
    elif window == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * i / (ln - 1))
             + 0.08 * np.cos(4 * np.pi * i / (ln - 1)))
    elif window == "gaussian":
        w = np.exp(-0.5 * (3.0 / ln * (2 * i - (ln - 1))) ** 2)
    elif window == "cosine":
        w = np.cos(np.pi * i / (ln - 1) - np.pi / 2)
    elif window == "hann":
        w = 0.5 * (1 - np.cos(2 * np.pi * i / (ln - 1)))
    else:
        raise ValueError(f"unknown window {window!r}")
    return kernel * w


def _sinc_kernel(cutoff: float, rate: int, ln: int,
                 window: str) -> np.ndarray:
    """Windowed-sinc lowpass, DC-normalised (audiowsinclimit.c:262-298)."""
    w = 2 * np.pi * (cutoff / rate)
    i = np.arange(ln, dtype=np.float64)
    mid = (ln - 1) / 2.0
    with np.errstate(invalid="ignore", divide="ignore"):
        k = np.where(i == mid, w, np.sin(w * (i - mid)) / (i - mid))
    k = _wsinc_window(k, window)
    return k / k.sum()


def _spectral_invert(k: np.ndarray) -> np.ndarray:
    ln = len(k)
    k = -k
    if ln % 2 == 1:
        k[(ln - 1) // 2] += 1.0
    else:
        k[ln // 2 - 1] += 0.5
        k[ln // 2] += 0.5
    return k


class _FirBase(_AudioFxBase):
    """gstaudiofxbasefirfilter equivalent: streaming FIR with carried
    history (host element, scipy's ``lfilter``)."""
    HOST_ELEMENT = True

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._zi = None

    def start(self):
        self._zi = None

    def _kernel(self) -> np.ndarray:
        raise NotImplementedError

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        from scipy.signal import lfilter

        k = self._kernel()
        x = host_array(buf.data)
        xf = x.astype(np.float64)
        if self._zi is None:
            self._zi = np.zeros((len(k) - 1, xf.shape[-1]))
        y, self._zi = lfilter(k, [1.0], xf, axis=0, zi=self._zi)
        lim = self._limits()
        if lim is None:
            out = y.astype(x.dtype)
        else:
            out = np.clip(y, lim[0], lim[1]).astype(x.dtype)
        return buf.with_(data=device_array(out, buf.data))


@register_element
class AudioWSincLimit(_FirBase):
    """audiowsinclimit: windowed-sinc low/high-pass
    (audiowsinclimit.c build_kernel :223)."""
    FACTORY = "audiowsinclimit"
    DESCRIPTION = "Low/high-pass windowed-sinc filter"
    PROPERTIES = {
        "cutoff": (float, 0.0, "cutoff Hz"),
        "length": (int, 101, "kernel length"),
        "mode": (str, "low-pass", "low-pass|high-pass"),
        "window": (str, "hamming", "hamming|blackman|gaussian|cosine|hann"),
    }

    def _kernel(self):
        rate = self._info.rate
        cutoff = min(max(float(self.props["cutoff"]), 0.0), rate / 2)
        k = _sinc_kernel(cutoff, rate, int(self.props["length"]),
                         self.props["window"])
        if self.props["mode"] == "high-pass":
            k = _spectral_invert(k)
        return k


@register_element
class AudioWSincBand(_FirBase):
    """audiowsincband: windowed-sinc band-pass/reject
    (audiowsincband.c build_kernel :250)."""
    FACTORY = "audiowsincband"
    DESCRIPTION = "Band-pass/reject windowed-sinc filter"
    PROPERTIES = {
        "lower-frequency": (float, 0.0, "lower edge Hz"),
        "upper-frequency": (float, 0.0, "upper edge Hz"),
        "length": (int, 101, "kernel length"),
        "mode": (str, "band-pass", "band-pass|band-reject"),
        "window": (str, "hamming", ""),
    }

    def _kernel(self):
        rate = self._info.rate
        lo = min(max(float(self.props["lower-frequency"]), 0.0), rate / 2)
        hi = min(max(float(self.props["upper-frequency"]), 0.0), rate / 2)
        if lo > hi:
            lo, hi = hi, lo
        ln = int(self.props["length"])
        win = self.props["window"]
        k_lp = _sinc_kernel(lo, rate, ln, win)
        k_hp = _spectral_invert(_sinc_kernel(hi, rate, ln, win))
        k = k_lp + k_hp            # band reject
        if self.props["mode"] == "band-pass":
            k = -k
            k[ln // 2] += 1        # (:372 — uses len/2, not (len-1)/2)
        return k


@register_element
class AudioFirFilter(_FirBase):
    """audiofirfilter: user-supplied FIR kernel (gstaudiofirfilter.c)."""
    FACTORY = "audiofirfilter"
    DESCRIPTION = "Generic FIR filter with custom kernel"
    PROPERTIES = {"kernel": (object, None, "float taps")}

    def _kernel(self):
        k = self.props["kernel"]
        if k is None:
            return np.array([1.0])
        return np.asarray(k, np.float64)


@register_element
class AudioIirFilter(_AudioFxBase):
    """audioiirfilter: user-supplied IIR coefficients.

    gst naming (audioiirfilter.c:109-120, audiofxbaseiirfilter.c:301-317):
    `b` is the NUMERATOR (feed-forward), `a` the DENOMINATOR (feed-back):
    y[n] = (sum b[j] x[n-j] - sum a[j>=1] y[n-j]) / a[0].  Host element."""
    FACTORY = "audioiirfilter"
    DESCRIPTION = "Generic IIR filter with custom coefficients"
    HOST_ELEMENT = True
    PROPERTIES = {
        "a": (object, None, "denominator (feed-back) coefficients"),
        "b": (object, None, "numerator (feed-forward) coefficients"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._zi = None

    def start(self):
        self._zi = None

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        from scipy.signal import lfilter

        ff = self.props["b"]
        fb = self.props["a"]
        if ff is None:
            return buf
        ff = np.asarray(ff, np.float64)
        fb = (np.asarray(fb, np.float64) if fb is not None
              else np.array([1.0]))
        x = host_array(buf.data)
        xf = x.astype(np.float64)
        n = max(len(ff), len(fb))
        if self._zi is None:
            self._zi = np.zeros((n - 1, xf.shape[-1]))
        y, self._zi = lfilter(ff, fb, xf, axis=0, zi=self._zi)
        lim = self._limits()
        out = (y.astype(x.dtype) if lim is None
               else np.clip(y, lim[0], lim[1]).astype(x.dtype))
        return buf.with_(data=device_array(out, buf.data))


class _ChebBase(_AudioFxBase):
    """Shared IIR streaming core for the Chebyshev elements
    (audiofxbaseiirfilter.c process: y[n] = sum b x - sum a[j>=1] y).
    Host element."""
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, FLOAT_CAPS),
        PadTemplate("src", PadDirection.SRC, FLOAT_CAPS),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._zi = None

    def start(self):
        self._zi = None

    def _coefficients(self, rate):
        raise NotImplementedError

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        from scipy.signal import lfilter

        a, b = self._coefficients(self._info.rate)
        x = host_array(buf.data)
        xf = x.astype(np.float64)
        n = max(len(a), len(b))
        if n == 1:
            return buf.with_(data=device_array(
                (xf * b[0] / a[0]).astype(x.dtype), buf.data))
        if self._zi is None or self._zi.shape != (n - 1, xf.shape[-1]):
            self._zi = np.zeros((n - 1, xf.shape[-1]))
        y, self._zi = lfilter(b, a, xf, axis=0, zi=self._zi)
        return buf.with_(data=device_array(y.astype(x.dtype), buf.data))


@register_element
class AudioChebLimit(_ChebBase):
    """audiocheblimit (audiocheblimit.c): Chebyshev low/high-pass."""
    FACTORY = "audiocheblimit"
    DESCRIPTION = "Chebyshev low pass and high pass filter"
    PROPERTIES = {
        "mode": (str, "low-pass", "low-pass|high-pass"),
        "type": (int, 1, "1|2 (Chebyshev type)"),
        "cutoff": (float, 0.0, "cutoff frequency (Hz)"),
        "ripple": (float, 0.25, "passband ripple / stopband atten (dB)"),
        "poles": (int, 4, "number of poles (even, 2-32)"),
    }

    def _coefficients(self, rate):
        from ..audio.chebyshev import cheb_limit_coefficients
        poles = max(2, min(32, self.props["poles"])) & ~1
        return cheb_limit_coefficients(
            self.props["mode"], self.props["type"], poles,
            self.props["cutoff"], self.props["ripple"], rate)


@register_element
class AudioChebBand(_ChebBase):
    """audiochebband (audiochebband.c): Chebyshev band pass/reject."""
    FACTORY = "audiochebband"
    DESCRIPTION = "Chebyshev band pass and band reject filter"
    PROPERTIES = {
        "mode": (str, "band-pass", "band-pass|band-reject"),
        "type": (int, 1, "1|2 (Chebyshev type)"),
        "lower-frequency": (float, 0.0, "band start (Hz)"),
        "upper-frequency": (float, 0.0, "band stop (Hz)"),
        "ripple": (float, 0.25, "passband ripple / stopband atten (dB)"),
        "poles": (int, 4, "number of poles (multiple of 4, 4-32)"),
    }

    def _coefficients(self, rate):
        from ..audio.chebyshev import cheb_band_coefficients
        poles = max(4, min(32, self.props["poles"])) & ~3
        return cheb_band_coefficients(
            self.props["mode"], self.props["type"], poles,
            self.props["lower-frequency"], self.props["upper-frequency"],
            self.props["ripple"], rate)


@register_element
class Stereo(_AudioFxBase):
    """stereo (gststereo.c): widen/narrow the stereo image.

    The reference's half-buffer quirk included: the C loop runs
    `for (i = 0; i < samples / 2; i += 2)` over the flat s16 sample array
    (gststereo.c:140), so only the FIRST HALF of each buffer's frames are
    processed; the rest pass through untouched.  avg uses C truncating
    integer division; the final double->int16 store truncates toward zero.
    Host element: numpy rounds each operation as the C code does."""
    FACTORY = "stereo"
    DESCRIPTION = "Muck with the stereo signal to enhance its stereo-ness"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=S16LE, rate=[1,2147483647], "
                    "channels=2, layout=interleaved"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=S16LE, rate=[1,2147483647], "
                    "channels=2, layout=interleaved"),
    ]
    PROPERTIES = {
        "active": (bool, True, "process or passthrough"),
        "stereo": (float, 0.1, "stereo separation factor 0..1"),
    }

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if not self.props["active"]:
            return buf
        mul = self.props["stereo"]
        x = host_array(buf.data)
        n = x.shape[-2]
        # flat-index limit samples/2 with i += 2 => ceil(n/2) frames
        half = (n + 1) // 2
        l = x[..., :half, 0].astype(np.int64)
        r = x[..., :half, 1].astype(np.int64)
        s = l + r
        avg = (np.sign(s) * (np.abs(s) // 2)).astype(np.float64)
        lo = avg + (l - avg) * mul
        ro = avg + (r - avg) * mul
        out = x.copy()
        out[..., :half, 0] = \
            np.trunc(np.clip(lo, -32768, 32767)).astype(x.dtype)
        out[..., :half, 1] = \
            np.trunc(np.clip(ro, -32768, 32767)).astype(x.dtype)
        return buf.with_(data=device_array(out, buf.data))
