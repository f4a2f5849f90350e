"""Audio visualizer elements — wavescope / spectrascope / spacescope /
synaescope on a GstAudioVisualizer-equivalent base.

Reference:
- base class: subprojects/gst-plugins-base/gst-libs/gst/pbutils/
  gstaudiovisualizer.c (render loop :1096-1240; the ten shader
  functions :169-460: SHADE = per-byte saturating subtract of the
  shade-amount, the move variants shift by rows or by ONE BYTE for the
  vert in/out pair, reproduced bit-for-bit including the last-row/column
  carry-over of the previous temp frame)
- scopes: subprojects/gst-plugins-bad/gst/audiovisualizers/
  gstwavescope.c (render_dots :243, render_lines :268, color variants
  with the persistent 3-band filter :296-310), gstspectrascope.c
  (bars :172-238, req_spf = 2*width :129-144), gstspacescope.c (XY
  Lissajous styles :214-420), gstsynaescope.c (stereo-phase stars
  :209-315, PEAKIFY color table :106-127), drawing primitives
  gstdrawhelpers.h (draw_dot/draw_dot_c/draw_dot_aa/draw_line_aa).

TPU-native design: these are host feedback elements (like the rippletv
family) — per-frame scanline rasterization with persistent frame state;
the surrounding convert/scale chain stays fused on device.  The frame
is a flat uint32 xRGB word array with one row + one word of slack so the
reference's draw_dot_aa (x+1, y+1) overshoot lands in slack instead of
out of bounds (the C relies on buffer padding for the same writes).

A port of the JAX package's ``elements/visualizers.py``.  The scopes read a
host copy of each tick's samples and rasterise on the host as the
reference does; a tick's frames are drawn into host planes at the
negotiated size and moved to the samples' device in one copy.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.value import Fraction, fixate_nearest_fraction, fixate_nearest_int
from ..audio.fft import FFT, WINDOW_HAMMING

SHADERS = ("none", "fade", "fade-and-move-up", "fade-and-move-down",
           "fade-and-move-left", "fade-and-move-right",
           "fade-and-move-horiz-out", "fade-and-move-horiz-in",
           "fade-and-move-vert-out", "fade-and-move-vert-in")


# ---------------------------------------------------------------------------
# drawing primitives (gstdrawhelpers.h) on a flat uint32 canvas
# ---------------------------------------------------------------------------

def draw_dot(vdata: np.ndarray, x, y, stride: int, color: int) -> None:
    """draw_dot: plain store (vectorized; constant color makes duplicate
    hits order-independent)."""
    vdata[np.asarray(y) * stride + np.asarray(x)] = color


def draw_dot_c(vdata: np.ndarray, x, y, stride: int, color: int) -> None:
    """draw_dot_c: |= color."""
    np.bitwise_or.at(vdata, np.asarray(y) * stride + np.asarray(x),
                     np.uint32(color))


def draw_dot_aa(vdata: np.ndarray, x: int, y: int, stride: int, color: int,
                f: float) -> None:
    """draw_dot_aa: per-channel old + c*f, truncated, clamped at 255."""
    off = y * stride + x
    oc = int(vdata[off])
    c3 = min(int((oc & 0xFF) + (color & 0xFF) * f), 255)
    c2 = min(int(((oc >> 8) & 0xFF) + ((color >> 8) & 0xFF) * f), 255)
    c1 = min(int(((oc >> 16) & 0xFF) + ((color >> 16) & 0xFF) * f), 255)
    vdata[off] = (c1 << 16) | (c2 << 8) | c3


def draw_line_aa(vdata: np.ndarray, x1: int, x2: int, y1: int, y2: int,
                 stride: int, color: int) -> None:
    """draw_line_aa: DDA with 4-tap coverage (gstdrawhelpers.h:60)."""
    dx, dy = x2 - x1, y2 - y1
    j = max(abs(dx), abs(dy))
    for i in range(j):
        f = i / j
        rx = x1 + dx * f
        ry = y1 + dy * f
        xi, yi = int(rx), int(ry)
        fx, fy = rx - xi, ry - yi
        draw_dot_aa(vdata, xi, yi, stride, color, ((1 - fx) + (1 - fy)) / 2)
        draw_dot_aa(vdata, xi + 1, yi, stride, color, (fx + (1 - fy)) / 2)
        draw_dot_aa(vdata, xi, yi + 1, stride, color, ((1 - fx) + fy) / 2)
        draw_dot_aa(vdata, xi + 1, yi + 1, stride, color, (fx + fy) / 2)


def add_pixel(vdata: np.ndarray, off: int, color: int) -> None:
    """spectrascope/synaescope add_pixel: per-byte saturating add."""
    oc = int(vdata[off])
    b = min((oc & 0xFF) + (color & 0xFF), 255)
    g = min(((oc >> 8) & 0xFF) + ((color >> 8) & 0xFF), 255)
    r = min(((oc >> 16) & 0xFF) + ((color >> 16) & 0xFF), 255)
    a = min(((oc >> 24) & 0xFF) + ((color >> 24) & 0xFF), 255)
    vdata[off] = (a << 24) | (r << 16) | (g << 8) | b


# ---------------------------------------------------------------------------
# shaders (gstaudiovisualizer.c:169-460), byte-exact on a (h, w*4) view.
# SHADE subtracts (b, g, r) from bytes 0/1/2 of each pixel, zeroes byte 3.
# ---------------------------------------------------------------------------

def _shade_bytes(src: np.ndarray, amount: int) -> np.ndarray:
    """src: (..., n*4) uint8 pixel bytes -> shaded copy."""
    r = (amount >> 16) & 0xFF
    g = (amount >> 8) & 0xFF
    b = amount & 0xFF
    out = np.empty_like(src)
    out[..., 0::4] = np.where(src[..., 0::4] > b, src[..., 0::4] - b, 0)
    out[..., 1::4] = np.where(src[..., 1::4] > g, src[..., 1::4] - g, 0)
    out[..., 2::4] = np.where(src[..., 2::4] > r, src[..., 2::4] - r, 0)
    out[..., 3::4] = 0
    return out


def _shade_shifted(src_bytes: np.ndarray, amount: int, byte_shift: int,
                   n_pix: int) -> np.ndarray:
    """SHADE reading source at a BYTE offset (the vert in/out shaders use
    guint8* + 1 — one byte, not one pixel; reproduced as-is)."""
    flat = src_bytes.reshape(-1)
    view = flat[byte_shift:byte_shift + n_pix * 4]
    return _shade_bytes(view, amount)


def apply_shader(kind: str, frame: np.ndarray, temp: np.ndarray,
                 amount: int) -> None:
    """frame: current output (h, w*4) uint8; writes the next temp frame
    into `temp` IN PLACE (unwritten regions keep their old bytes, as the
    C leaves them)."""
    h, wb = frame.shape
    w = wb // 4
    if kind == "fade":
        temp[:] = _shade_bytes(frame, amount)
    elif kind == "fade-and-move-up":
        temp[0:h - 1] = _shade_bytes(frame[1:h], amount)
    elif kind == "fade-and-move-down":
        temp[1:h] = _shade_bytes(frame[0:h - 1], amount)
    elif kind == "fade-and-move-left":
        # d[i] = shade(s[i+1]), one PIXEL left (s += 4 bytes)
        temp[:, :4 * (w - 1)] = _shade_bytes(frame[:, 4:4 * w], amount)
    elif kind == "fade-and-move-right":
        temp[:, 4:4 * w] = _shade_bytes(frame[:, :4 * (w - 1)], amount)
    elif kind == "fade-and-move-horiz-out":
        # upper half up one row; lower half re-shaded in place
        # (gstaudiovisualizer.c:316 — the lower loop's pointers coincide)
        temp[0:h // 2] = _shade_bytes(frame[1:h // 2 + 1], amount)
        temp[h // 2:h // 2 * 2] = _shade_bytes(frame[h // 2:h // 2 * 2],
                                               amount)
    elif kind == "fade-and-move-horiz-in":
        # upper half down one row, lower half up one row (the C's last
        # lower-half read past the frame is clamped to the last row)
        temp[1:h // 2 + 1] = _shade_bytes(frame[0:h // 2], amount)
        lo = np.minimum(np.arange(h // 2, h) + 1, h - 1)
        temp[h // 2:h] = _shade_bytes(frame[lo], amount)
    elif kind == "fade-and-move-vert-out":
        # left half left by ONE BYTE, right half right by one byte
        # (gstaudiovisualizer.c:404 s1 = s + 1 on guint8*)
        half = w // 2
        for j in range(h):
            temp[j, :4 * half] = _shade_shifted(frame[j], amount, 1, half)
            n = (w - 1) - half
            if n > 0:
                shifted = _shade_bytes(
                    frame[j, 4 * half:4 * half + n * 4], amount)
                temp[j, 4 * half + 1:4 * half + 1 + n * 4] = shifted
    elif kind == "fade-and-move-vert-in":
        half = w // 2
        for j in range(h):
            # left half to the right by one byte, right half to the left
            shifted = _shade_bytes(frame[j, 0:half * 4], amount)
            temp[j, 1:1 + half * 4] = shifted
            n = (w - 1) - half
            if n > 0:
                temp[j, 4 * half:4 * half + n * 4] = _shade_shifted(
                    frame[j], amount, 4 * half + 1, n)
    else:                              # none
        temp[:] = 0


# ---------------------------------------------------------------------------
# base element
# ---------------------------------------------------------------------------

SINK_CAPS = ("audio/x-raw, format=S16LE, layout=interleaved, "
             "rate=[1,2147483647], channels=[1,256]")
SRC_CAPS = ("video/x-raw, format=BGRx, width=[1,32767], "
            "height=[1,32767], framerate=[0/1,2147483647/1]")


class AudioVisualizerElement(TransformElement):
    """GstAudioVisualizer equivalent: S16 interleaved audio in, BGRx
    frames out at the negotiated framerate, with shader feedback."""

    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, SINK_CAPS),
        PadTemplate("src", PadDirection.SRC, SRC_CAPS),
    ]
    PROPERTIES = {
        "shader": (str, "fade", "background shader"),
        "shade-amount": (int, 0x000A0A0A, "shade color subtract amount"),
    }
    # multiple of channels needed per frame; subclasses may pin req_spf
    REQUIRES_STEREO = False

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._pending: List[np.ndarray] = []
        self._avail = 0
        self._frame32: Optional[np.ndarray] = None   # flat canvas + slack
        self._temp: Optional[np.ndarray] = None      # (h, w*4) bytes
        self._w = self._h = 0
        self._rate = 0
        self._channels = 0
        self._fps = Fraction(25, 1)
        self._spf = 0
        self._req_spf = 0
        self._consumed = 0

    # -- negotiation -------------------------------------------------------
    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            SRC_CAPS if direction == PadDirection.SINK else
            (SINK_CAPS if not self.REQUIRES_STEREO
             else SINK_CAPS.replace("channels=[1,256]", "channels=2")))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction, caps, othercaps):
        if direction == PadDirection.SINK:        # fixing our src side
            out = []
            for s in othercaps.structures:
                s = s.copy() if hasattr(s, "copy") else s
                f = dict(s.fields)
                f["width"] = fixate_nearest_int(f.get("width", 320), 320)
                f["height"] = fixate_nearest_int(f.get("height", 200), 200)
                f["framerate"] = fixate_nearest_fraction(
                    f.get("framerate", Fraction(25, 1)), Fraction(25, 1))
                from ..core.structure import Structure
                out.append(Structure(s.name, f))
                break
            return Caps(out).fixate()
        return othercaps.fixate()

    def set_info(self, incaps, outcaps):
        si = incaps.structures[0]
        so = outcaps.structures[0]
        self._rate = si.fields.get("rate", 44100)
        self._channels = si.fields.get("channels", 2)
        self._w = so.fields.get("width", 320)
        self._h = so.fields.get("height", 200)
        fps = so.fields.get("framerate", Fraction(25, 1))
        if isinstance(fps, tuple):
            fps = Fraction(*fps)
        self._fps = fps if fps.num else Fraction(25, 1)
        # spf = samples per frame from the framerate
        # (gstaudiovisualizer.c:753)
        self._spf = self._rate * self._fps.denom // self._fps.num
        self._req_spf = self._spf
        # slack row + 1 word for the aa-overshoot writes
        self._frame32 = np.zeros(self._h * self._w + self._w + 2, np.uint32)
        self._temp = np.zeros((self._h, self._w * 4), np.uint8)
        self._pending.clear()
        self._avail = 0
        self._consumed = 0
        self.setup()

    def setup(self):
        """Subclass hook: adjust self._req_spf, allocate per-size state."""

    # -- render loop (gstaudiovisualizer.c:1096) ----------------------------
    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:                 # EOS drain: remainder is dropped
            return None
        samples = host_array(buf.data)
        if samples.ndim == 1:
            samples = samples[:, None]
        self._pending.append(samples.astype(np.int16))
        self._avail += samples.shape[0]
        frames = []
        pts0 = None
        while self._avail >= self._req_spf and self._req_spf > 0:
            data = self._take_window(self._req_spf)
            if pts0 is None:
                pts0 = self._consumed * 1_000_000_000 // self._rate
            canvas = self._frame32
            view = canvas[:self._h * self._w].reshape(self._h, self._w)
            shader = self.props["shader"]
            if shader != "none":
                # start from the shaded previous frame
                view.view(np.uint8).reshape(self._h, -1)[:] = self._temp
            else:
                canvas[:] = 0
            self.render(canvas, data)
            frames.append(view.copy())
            if shader != "none":
                apply_shader(shader,
                             view.view(np.uint8).reshape(self._h, -1),
                             self._temp, self.props["shade-amount"])
            # flush policy: consume spf (gstaudiovisualizer.c:1224)
            if self._avail - self._req_spf >= self._req_spf:
                self._flush(self._req_spf)
            else:
                self._flush(self._avail - self._req_spf)
                break
        if not frames:
            return None
        words = np.stack(frames)        # (n, h, w) uint32 xRGB
        r = ((words >> 16) & 0xFF).astype(np.uint8)
        g = ((words >> 8) & 0xFF).astype(np.uint8)
        b = (words & 0xFF).astype(np.uint8)
        dur = 1_000_000_000 * self._fps.denom // self._fps.num
        return Buffer(data=device_planes((r, g, b), buf.data), pts=pts0,
                      duration=dur, batch=words.shape[0])

    def _take_window(self, n: int) -> np.ndarray:
        """Peek n interleaved sample frames (without consuming)."""
        out = []
        need = n
        for chunk in self._pending:
            take = min(need, chunk.shape[0])
            out.append(chunk[:take])
            need -= take
            if need == 0:
                break
        return np.concatenate(out, axis=0)

    def _flush(self, n: int) -> None:
        self._consumed += n
        self._avail -= n
        while n > 0 and self._pending:
            c = self._pending[0]
            if c.shape[0] <= n:
                n -= c.shape[0]
                self._pending.pop(0)
            else:
                self._pending[0] = c[n:]
                n = 0

    def render(self, vdata: np.ndarray, samples: np.ndarray) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# wavescope
# ---------------------------------------------------------------------------

CUTOFF_1 = 0.15
CUTOFF_2 = 0.45
RESONANCE = 1.0 / 0.5


def _three_band_filter(flt: np.ndarray, value: float) -> None:
    """gstwavescope.c filter(): two chained 2-pole filters; flt holds
    [f1_l, f1_m, f1_h, f2_l, f2_m, f2_h]."""
    flt[2] = value - (flt[1] * RESONANCE) - flt[0]
    flt[1] += flt[2] * CUTOFF_1
    flt[0] += flt[1] * CUTOFF_1
    flt[5] = (flt[1] + flt[2]) - (flt[4] * RESONANCE) - flt[3]
    flt[4] += flt[5] * CUTOFF_2
    flt[3] += flt[4] * CUTOFF_2


@register_element
class WaveScope(AudioVisualizerElement):
    FACTORY = "wavescope"
    DESCRIPTION = "Waveform oscilloscope"
    PROPERTIES = dict(AudioVisualizerElement.PROPERTIES)
    PROPERTIES["style"] = (str, "dots",
                           "dots | lines | color-dots | color-lines")

    def setup(self):
        self._flt = np.zeros(6 * self._channels, np.float64)

    def render(self, vdata, samples):
        style = self.props["style"]
        w, h = self._w, self._h
        n = samples.shape[0]
        adata = samples
        if style == "dots":
            dx = np.float32(w) / np.float32(n)
            dy = np.float32(h / 65536.0)
            oy = h // 2
            for c in range(self._channels):
                i = np.arange(n)
                x = (i.astype(np.float32) * dx).astype(np.uint32)
                y = (oy + adata[:, c].astype(np.float32) * dy).astype(
                    np.int64).astype(np.uint32)
                draw_dot(vdata, x, y, w, 0x00FFFFFF)
        elif style == "lines":
            dx = (w - 1) / np.float32(n)
            dy = np.float32((h - 1) / 65536.0)
            oy = (h - 1) // 2
            for c in range(self._channels):
                x2 = 0
                y2 = int(oy + np.float32(adata[0, c]) * dy)
                for i in range(1, n):
                    x = int(np.float32(i) * dx)
                    y = int(oy + np.float32(adata[i, c]) * dy)
                    draw_line_aa(vdata, x2, x, y2, y, w, 0x00FFFFFF)
                    x2, y2 = x, y
        elif style == "color-dots":
            dx = np.float32(w) / np.float32(n)
            dy = np.float32(h / 65536.0)
            oy = h // 2
            h1 = h - 2
            for c in range(self._channels):
                flt = self._flt[6 * c:6 * c + 6]
                for i in range(n):
                    x = int(np.float32(i) * dx)
                    _three_band_filter(flt, float(adata[i, c]))
                    y = min(int(oy + flt[0] * dy), h1)
                    draw_dot_c(vdata, x, y, w, 0x00FF0000)
                    y = min(int(oy + flt[3] * dy), h1)
                    draw_dot_c(vdata, x, y, w, 0x0000FF00)
                    y = min(int(oy + (flt[4] + flt[5]) * dy), h1)
                    draw_dot_c(vdata, x, y, w, 0x000000FF)
        elif style == "color-lines":
            dx = (w - 1) / np.float32(n)
            dy = np.float32((h - 1) / 65536.0)
            oy = (h - 1) // 2
            h1 = h - 2
            for c in range(self._channels):
                flt = self._flt[6 * c:6 * c + 6]
                x2 = 0
                _three_band_filter(flt, float(adata[0, c]))
                y2 = min(int(oy + flt[0] * dy), h1)
                y3 = min(int(oy + flt[3] * dy), h1)
                y4 = min(int(oy + (flt[4] + flt[5]) * dy), h1)
                for i in range(1, n):
                    x = int(np.float32(i) * dx)
                    _three_band_filter(flt, float(adata[i, c]))
                    y = min(int(oy + flt[0] * dy), h1)
                    draw_line_aa(vdata, x2, x, y2, y, w, 0x00FF0000)
                    y2 = y
                    y = min(int(oy + flt[3] * dy), h1)
                    draw_line_aa(vdata, x2, x, y3, y, w, 0x0000FF00)
                    y3 = y
                    y = min(int(oy + (flt[4] + flt[5]) * dy), h1)
                    draw_line_aa(vdata, x2, x, y4, y, w, 0x000000FF)
                    y4 = y
                    x2 = x
        else:
            raise ValueError(f"wavescope: unknown style {style!r}")


# ---------------------------------------------------------------------------
# spectrascope
# ---------------------------------------------------------------------------

@register_element
class SpectraScope(AudioVisualizerElement):
    FACTORY = "spectrascope"
    DESCRIPTION = "Simple frequency spectrum scope"

    def setup(self):
        # req_spf = num_freq * 2 - 2 with num_freq = width + 1
        self._req_spf = (self._w + 1) * 2 - 2
        self._fft = FFT(self._req_spf)

    def render(self, vdata, samples):
        w, h = self._w, self._h - 1
        mono = samples.astype(np.int32)
        if self._channels > 1:
            # integer mixdown v / ch (gstspectrascope.c:196)
            mono = mono.sum(axis=1) // self._channels
        else:
            mono = mono[:, 0]
        nfft = self._req_spf
        # gst_fft_s16: fixed-point kissfft scales by 1/nfft overall
        spec = self._fft.fft(np, mono.astype(np.float64),
                             win=WINDOW_HAMMING) / nfft
        fr = spec.real / 512.0
        fi = spec.imag / 512.0
        mag = np.sqrt(fr * fr + fi * fi)
        for x in range(w):
            y = int(h * mag[1 + x])
            y = min(y, h)
            y = h - y
            off = y * w + x
            vdata[off] = 0x00FFFFFF
            for l in range(y, h):
                off += w
                add_pixel(vdata, off, 0x007F7F7F)
            add_pixel(vdata, off, 0x007F7F7F)


# ---------------------------------------------------------------------------
# spacescope
# ---------------------------------------------------------------------------

@register_element
class SpaceScope(AudioVisualizerElement):
    FACTORY = "spacescope"
    DESCRIPTION = "Simple stereo visualizer (XY scope)"
    REQUIRES_STEREO = True
    PROPERTIES = dict(AudioVisualizerElement.PROPERTIES)
    PROPERTIES["style"] = (str, "dots",
                           "dots | lines | color-dots | color-lines")

    def setup(self):
        self._sflt = np.zeros(12, np.float64)   # two stereo filter banks

    def render(self, vdata, samples):
        style = self.props["style"]
        w, h = self._w, self._h
        n = samples.shape[0]
        l = samples[:, 0].astype(np.float64)
        r = samples[:, 1].astype(np.float64)
        if style == "dots":
            dx = np.float32(w / 65536.0)
            dy = np.float32(h / 65536.0)
            x = (w // 2 + l.astype(np.float32) * dx).astype(np.uint32)
            y = (h // 2 + r.astype(np.float32) * dy).astype(np.uint32)
            draw_dot(vdata, x, y, w, 0x00FFFFFF)
        elif style == "lines":
            dx = np.float32((w - 1) / 65536.0)
            dy = np.float32((h - 1) / 65536.0)
            ox, oy = (w - 1) // 2, (h - 1) // 2
            x2 = int(ox + np.float32(l[0]) * dx)
            y2 = int(oy + np.float32(r[0]) * dy)
            for i in range(1, n):
                x = int(ox + np.float32(l[i]) * dx)
                y = int(oy + np.float32(r[i]) * dy)
                draw_line_aa(vdata, x2, x, y2, y, w, 0x00FFFFFF)
                x2, y2 = x, y
        else:
            # color styles: chained band filters on both channels
            # (gstspacescope.c:262-283); the three bands land on
            # red/green/blue dots or line chains
            fl = self._sflt[:6]
            fr = self._sflt[6:]
            dx = np.float32(w / 65536.0)
            dy = np.float32(h / 65536.0)
            ox, oy = w // 2, h // 2
            w1, h1 = w - 2, h - 2
            lines = style == "color-lines"
            prev = None
            for i in range(n):
                _three_band_filter(fl, l[i])
                _three_band_filter(fr, r[i])
                pts = []
                for (vx, vy) in ((fl[0], fr[0]), (fl[3], fr[3]),
                                 (fl[4] + fl[5], fr[4] + fr[5])):
                    x = max(0, min(int(ox + vx * dx), w1))
                    y = max(0, min(int(oy + vy * dy), h1))
                    pts.append((x, y))
                if lines:
                    if prev is not None:
                        for k, col in enumerate(
                                (0x00FF0000, 0x0000FF00, 0x000000FF)):
                            draw_line_aa(vdata, prev[k][0], pts[k][0],
                                         prev[k][1], pts[k][1], w, col)
                    prev = pts
                else:
                    for k, col in enumerate(
                            (0x00FF0000, 0x0000FF00, 0x000000FF)):
                        draw_dot_c(vdata, pts[k][0], pts[k][1], w, col)


# ---------------------------------------------------------------------------
# synaescope
# ---------------------------------------------------------------------------

def _synae_colors() -> np.ndarray:
    """PEAKIFY color table (gstsynaescope.c:106-127)."""
    colors = np.zeros(256, np.uint32)
    for i in range(256):
        def peakify(x):
            return min(x - x * (255 - x) // 255 // 2, 255)
        r = peakify(i & (15 * 16))
        g = peakify((i & 15) * 16 + (i & (15 * 16)) // 4)
        b = peakify((i & 15) * 16)
        colors[i] = (r << 16) | (g << 8) | b
    return colors


_SYNAE_COLORS = _synae_colors()
_SYNAE_SHADE = np.array([i * 200 >> 8 for i in range(256)], np.int64)


@register_element
class SynaeScope(AudioVisualizerElement):
    FACTORY = "synaescope"
    DESCRIPTION = "Creates video visualizations of audio input, like "\
        "the old Synaesthesia stand-alone program"
    REQUIRES_STEREO = True

    def setup(self):
        self._req_spf = (self._h + 1) * 2 - 2
        self._fft = FFT(self._req_spf)

    def render(self, vdata, samples):
        w, h = self._w, self._h
        nfft = self._req_spf
        fl = self._fft.fft(np, samples[:, 0].astype(np.float64)) / nfft
        fr = self._fft.fft(np, samples[:, 1].astype(np.float64)) / nfft
        sl = 30
        for y in range(h):
            b = h - y
            frl, fil = fl[b].real, fl[b].imag
            frr, fir = fr[b].real, fr[b].imag
            ll = (frl + fil) ** 2 + (frr - fir) ** 2
            lv = math.sqrt(ll)
            rr = (frl - fil) ** 2 + (frr + fir) ** 2
            rv = math.sqrt(rr)
            denom = ll + rr
            if denom == 0.0:
                continue
            clarity = int(((frl + fil) * (frl - fil)
                           + (frr + fir) * (frr - fir)) / denom * 256)
            fc = rv + lv
            if fc == 0.0:
                continue
            x = int(rv * w / fc)
            br = int(b * fc * 0.01)
            br1 = max(0, min(br * (clarity + 128) >> 8, 255))
            br2 = max(0, min(br * (128 - clarity) >> 8, 255))
            off = y * w + x
            add_pixel(vdata, off, int(_SYNAE_COLORS[(br1 >> 4)
                                                    | (br2 & 0xF0)]))
            inside = (sl - 1) < x < (w - sl) and (sl - 1) < y < (h - sl)
            i = 1
            while br1 or br2:
                if inside:
                    c = int(_SYNAE_COLORS[(br1 >> 4) + (br2 & 0xF0)])
                    add_pixel(vdata, off - i, c)
                    add_pixel(vdata, off + i, c)
                    add_pixel(vdata, off - i * w, c)
                    add_pixel(vdata, off + i * w, c)
                else:
                    c = int(_SYNAE_COLORS[(br1 >> 4) | (br2 & 0xF0)])
                    if x - i > 0:
                        add_pixel(vdata, off - i, c)
                    if x + i < w - 1:
                        add_pixel(vdata, off + i, c)
                    if y - i > 0:
                        add_pixel(vdata, off - i * w, c)
                    if y + i < h - 1:
                        add_pixel(vdata, off + i * w, c)
                br1 = int(_SYNAE_SHADE[br1])
                br2 = int(_SYNAE_SHADE[br2])
                i += 1
