"""videotestsrc — test-pattern video source.

Port of the JAX package's ``elements/videotestsrc.py`` (reference element:
subprojects/gst-plugins-base/gst/videotestsrc/ — patterns enum
gstvideotestsrc.h:86-105, color tables videotestsrc.c:61-154, CCIR
RGB<->YUV macros :160-204, SMPTE geometry gst_video_test_src_smpte :380,
LCG noise random_char :38 with state*1103515245+12345).

Design: patterns are drawn once at negotiation time in the canonical
4:4:4 space (AYUV for YUV outputs, ARGB for RGB outputs — matching
paint_tmpline_AYUV/ARGB), packed to the negotiated format, and kept as
tensors on the pipeline's device; animated regions (snow) are generated on
the device each tick with the closed form of the reference's LCG (the state
after k steps is an affine function of the start state), so the noise is
bit-identical to the sequential C loop while staying a handful of
vectorised torch ops.  The host drawing code is a copy of the JAX
package's (numpy); packing, noise and ``create`` are torch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SourceElement,
                            register_element)
from ..core.value import Fraction, fixate_nearest_fraction, fixate_nearest_int
from ..device import resolve
from ..video.format import FORMATS, pack
from ..video.info import VideoInfo

# color tables (videotestsrc.c:61-154): (Y, U, V, A, R, G, B)
BT709_100 = [
    (235, 128, 128, 255, 255, 255, 255), (219, 16, 138, 255, 255, 255, 0),
    (188, 154, 16, 255, 0, 255, 255), (173, 42, 26, 255, 0, 255, 0),
    (78, 214, 230, 255, 255, 0, 255), (63, 102, 240, 255, 255, 0, 0),
    (32, 240, 118, 255, 0, 0, 255), (16, 128, 128, 255, 0, 0, 0),
    (16, 198, 21, 255, 0, 0, 128), (16, 235, 198, 255, 0, 128, 255),
    (0, 128, 128, 255, 0, 0, 0), (32, 128, 128, 255, 19, 19, 19),
]
BT709_75 = [
    (180, 128, 128, 255, 191, 191, 191), (168, 44, 136, 255, 191, 191, 0),
    (145, 147, 44, 255, 0, 191, 191), (133, 63, 52, 255, 0, 191, 0),
    (63, 193, 204, 255, 191, 0, 191), (51, 109, 212, 255, 191, 0, 0),
    (28, 212, 120, 255, 0, 0, 191), (16, 128, 128, 255, 0, 0, 0),
    (16, 198, 21, 255, 0, 0, 128), (16, 235, 198, 255, 0, 128, 255),
    (0, 128, 128, 255, 0, 0, 0), (32, 128, 128, 255, 19, 19, 19),
]
BT601_100 = [
    (235, 128, 128, 255, 255, 255, 255), (210, 16, 146, 255, 255, 255, 0),
    (170, 166, 16, 255, 0, 255, 255), (145, 54, 34, 255, 0, 255, 0),
    (106, 202, 222, 255, 255, 0, 255), (81, 90, 240, 255, 255, 0, 0),
    (41, 240, 110, 255, 0, 0, 255), (16, 128, 128, 255, 0, 0, 0),
    (16, 198, 21, 255, 0, 0, 128), (16, 235, 198, 255, 0, 128, 255),
    (0, 128, 128, 255, 0, 0, 0), (32, 128, 128, 255, 19, 19, 19),
]
BT601_75 = [
    (180, 128, 128, 255, 191, 191, 191), (162, 44, 142, 255, 191, 191, 0),
    (131, 156, 44, 255, 0, 191, 191), (112, 72, 58, 255, 0, 191, 0),
    (84, 184, 198, 255, 191, 0, 191), (65, 100, 212, 255, 191, 0, 0),
    (35, 212, 114, 255, 0, 0, 191), (16, 128, 128, 255, 0, 0, 0),
    (16, 198, 21, 255, 0, 0, 128), (16, 235, 198, 255, 0, 128, 255),
    (0, 128, 128, 255, 0, 0, 0), (32, 128, 128, 255, 19, 19, 19),
]

(C_WHITE, C_YELLOW, C_CYAN, C_GREEN, C_MAGENTA, C_RED, C_BLUE, C_BLACK,
 C_NEG_I, C_POS_Q, C_SUPER_BLACK, C_DARK_GREY) = range(12)

# videotestsrc.c:1125 sine_table[256] == int(128 + 127.999*sin(2*pi*i/256))
# (verified identical against the reference table)
SINE_TABLE = (128 + 127.999 * np.sin(
    2 * np.pi * np.arange(256) / 256)).astype(np.int64)

# CCIR fixed-point RGB->YUV (videotestsrc.c:160-204)
SCALEBITS = 10
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x):
    return int(x * (1 << SCALEBITS) + 0.5)


def rgb_to_yuv_ccir(r, g, b, bt709: bool):
    if bt709:
        cy = (0.2126, 0.7152, 0.0722)
        cu = (0.114572, 0.385427)
        cv = (0.454153, 0.045847)
    else:
        cy = (0.299, 0.587, 0.114)
        cu = (0.16874, 0.33126)
        cv = (0.41869, 0.08131)
    y = (_fix(cy[0] * 219 / 255) * r + _fix(cy[1] * 219 / 255) * g +
         _fix(cy[2] * 219 / 255) * b + (ONE_HALF + (16 << SCALEBITS))) >> SCALEBITS
    u = ((-_fix(cu[0] * 224 / 255) * r - _fix(cu[1] * 224 / 255) * g +
          _fix(0.5 * 224 / 255) * b + ONE_HALF - 1) >> SCALEBITS) + 128
    v = ((_fix(0.5 * 224 / 255) * r - _fix(cv[0] * 224 / 255) * g -
          _fix(cv[1] * 224 / 255) * b + ONE_HALF - 1) >> SCALEBITS) + 128
    return y, u, v


def _blend(a, b, x):
    """BLEND macro (videotestsrc.c:337-339): exact div255."""
    t = a * x + b * (255 - x)
    return (t + ((t + 128) >> 8) + 128) >> 8


LCG_A = 1103515245
LCG_C = 12345
M32 = (1 << 32) - 1


def lcg_affine(k: int):
    """(mul, add) such that state_after_k = mul*state + add (mod 2^32)."""
    mul, add = 1, 0
    a, c = LCG_A, LCG_C
    while k:
        if k & 1:
            mul = (mul * a) & M32
            add = (add * a + c) & M32
        c = (c * a + c) & M32
        a = (a * a) & M32
        k >>= 1
    return mul, add


def lcg_tables(m: int):
    """Per-step (mul, add) tables for steps 1..m (uint32 numpy)."""
    muls = np.empty(m, np.uint32)
    adds = np.empty(m, np.uint32)
    mul, add = 1, 0
    for j in range(m):
        mul = (mul * LCG_A) & M32
        add = (add * LCG_A + LCG_C) & M32
        muls[j] = mul
        adds[j] = add
    return muls, adds


FORMAT_LIST = "{ " + ", ".join(sorted(FORMATS)) + " }"

PATTERNS = [
    "smpte", "snow", "black", "white", "red", "green", "blue",
    "checkers-1", "checkers-2", "checkers-4", "checkers-8", "circular",
    "blink", "smpte75", "zone-plate", "gamut", "chroma-zone-plate",
    "solid-color", "ball", "smpte100", "bar", "pinwheel", "spokes",
    "gradient", "colors",
]


@register_element
class VideoTestSrc(SourceElement):
    FACTORY = "videotestsrc"
    KLASS = "Source/Video"
    DESCRIPTION = "Creates a test video stream"
    PAD_TEMPLATES = [PadTemplate(
        "src", PadDirection.SRC,
        f"video/x-raw, format={FORMAT_LIST}, width=[1,32767], "
        f"height=[1,32767], framerate=[0/1,2147483647/1]")]
    PROPERTIES = {
        "pattern": (str, "smpte", "test pattern"),
        "num-buffers": (int, -1, "frames to emit, then EOS"),
        "foreground-color": (int, 0xFFFFFFFF, "ARGB foreground"),
        "background-color": (int, 0xFF000000, "ARGB background"),
        "is-live": (bool, False, ""),
        "animation-mode": (str, "frames", "frames|wall-time|running-time"),
        "motion": (str, "wavy", "ball motion: wavy|sweep|hsweep"),
        "flip": (bool, False, "invert ball colors every 0.5 revolutions"),
        "horizontal-speed": (int, 0, "scroll pixels per frame"),
        "k0": (int, 0, "zoneplate zero-order phase"),
        "kx": (int, 0, "zoneplate x phase"), "ky": (int, 0, ""),
        "kt": (int, 0, ""), "kxt": (int, 0, ""), "kyt": (int, 0, ""),
        "kxy": (int, 0, ""), "kx2": (int, 20, ""), "ky2": (int, 20, ""),
        "kt2": (int, 0, ""), "xoffset": (int, 0, ""), "yoffset": (int, 0, ""),
    }

    def __init__(self, name=None, **props):
        if "pattern" in props and isinstance(props["pattern"], str) \
                and props["pattern"].isdigit():
            props["pattern"] = PATTERNS[int(props["pattern"])]
        super().__init__(name=name, **props)
        self._frame = 0
        self._info: Optional[VideoInfo] = None
        self._static_planes = None
        self._noise_fn = None
        self._noise_count = 0
        self._lcg_state = 0          # gstvideotestsrc.c:422 random_state=0

    # -- negotiation -------------------------------------------------------
    def fixate(self, caps: Caps) -> Caps:
        # reference fixates to 320x240@30 (gst_video_test_src_fixate)
        caps = caps.truncate()
        s = caps[0].copy()
        s["width"] = fixate_nearest_int(s.get("width", 320), 320)
        s["height"] = fixate_nearest_int(s.get("height", 240), 240)
        s["framerate"] = fixate_nearest_fraction(
            s.get("framerate", Fraction(30)), Fraction(30))
        return Caps([s]).fixate()

    def set_info(self, incaps, outcaps) -> None:
        self._info = VideoInfo.from_caps_structure(outcaps[0])
        self._build_pattern()

    # -- pattern drawing ---------------------------------------------------
    def _colors(self, table=100):
        bt709 = self._info.colorimetry.matrix == "bt709"
        if table == 75:
            return BT709_75 if bt709 else BT601_75
        return BT709_100 if bt709 else BT601_100

    def _canon_color(self, idx_or_tuple, colors=None):
        """Color as canonical 4-vector (A, c0, c1, c2)."""
        colors = colors or self._colors()
        c = colors[idx_or_tuple] if isinstance(idx_or_tuple, int) else idx_or_tuple
        y, u, v, a, r, g, b = c
        if self._info.finfo.is_rgb:
            return np.array([a, r, g, b], np.int32)
        return np.array([a, y, u, v], np.int32)

    def _prop_color(self, prop):
        argb = self.props[prop] & 0xFFFFFFFF
        a = (argb >> 24) & 0xFF
        r = (argb >> 16) & 0xFF
        g = (argb >> 8) & 0xFF
        b = argb & 0xFF
        bt709 = self._info.colorimetry.matrix == "bt709"
        y, u, v = rgb_to_yuv_ccir(r, g, b, bt709)
        return (y, u, v, a, r, g, b)

    def _build_pattern(self):
        info = self._info
        w, h = info.width, info.height
        pat = self.props["pattern"]
        canon = np.zeros((h, w, 4), np.int32)
        noise_mask = np.zeros((h, w), bool)
        fg = self._canon_color(self._prop_color("foreground-color"))
        bg = self._canon_color(self._prop_color("background-color"))

        def fill(region, color):
            canon[region] = self._canon_color(color)

        colors = self._colors()
        if pat in ("smpte",):
            y1, y2 = 2 * h // 3, 3 * h // 4
            for i in range(7):
                canon[:y1, i * w // 7:(i + 1) * w // 7] = self._canon_color(i)
            for i in range(7):
                k = 7 if (i & 1) else 6 - i
                canon[y1:y2, i * w // 7:(i + 1) * w // 7] = self._canon_color(k)
            for i, k in enumerate((C_NEG_I, C_WHITE, C_POS_Q)):
                canon[y2:, i * w // 6:(i + 1) * w // 6] = self._canon_color(k)
            for i, k in enumerate((C_SUPER_BLACK, C_BLACK, C_DARK_GREY)):
                canon[y2:, w // 2 + i * w // 12:w // 2 + (i + 1) * w // 12] = \
                    self._canon_color(k)
            canon[y2:, w * 3 // 4:] = self._canon_color(C_BLACK)
            noise_mask[y2:, w * 3 // 4:] = True
        elif pat in ("smpte75", "smpte100"):
            colors = self._colors(75 if pat == "smpte75" else 100)
            for i in range(7):
                canon[:, i * w // 7:(i + 1) * w // 7] = \
                    self._canon_color(i, colors)
        elif pat == "snow":
            canon[:] = bg
            noise_mask[:] = True
        elif pat in ("black", "white", "red", "green", "blue"):
            idx = {"black": C_BLACK, "white": C_WHITE, "red": C_RED,
                   "green": C_GREEN, "blue": C_BLUE}[pat]
            canon[:] = self._canon_color(idx)
        elif pat == "solid-color":
            canon[:] = fg
        elif pat.startswith("checkers-"):
            n = int(pat.split("-")[1])
            yy, xx = np.mgrid[0:h, 0:w]
            m = ((xx // n) ^ (yy // n)) & 1
            canon[m == 0] = self._canon_color(C_RED)
            canon[m == 1] = self._canon_color(C_GREEN)
        elif pat == "gradient":
            # vertical luma ramp blended fg->bg (videotestsrc.c gradient)
            yv = (np.arange(h) * 255.0 / h).astype(np.int64)
            line = np.stack([_blend(fg[c], bg[c], yv) for c in range(4)], -1)
            canon[:] = line[:, None, :]
        elif pat == "colors":
            # exact port of gst_video_test_src_colors (videotestsrc.c):
            # A=255, Y=(i*4096/w)%256, U=((j*16/h)<<4)|(i*16/w),
            # V=(j*4096/h)%256
            jj, ii = np.mgrid[0:h, 0:w].astype(np.int64)
            canon[..., 0] = 255
            canon[..., 1] = (ii * 4096 // w) % 256
            canon[..., 2] = ((jj * 16 // h) << 4) | (ii * 16 // w)
            canon[..., 3] = (jj * 4096 // h) % 256
        elif pat == "bar":
            canon[:] = bg
            canon[:, : w // 7] = fg
        elif pat == "blink":
            canon[:] = bg   # per-frame flip handled in create()
        elif pat in ("circular", "zone-plate", "chroma-zone-plate",
                     "pinwheel", "spokes", "gamut", "ball"):
            canon[:] = self._draw_geometric(pat, w, h, fg, bg)
        else:
            canon[:] = self._canon_color(C_BLACK)

        self._canon_static = canon.astype(np.uint8)
        self._noise_mask = noise_mask
        self._noise_count = int(noise_mask.sum())
        # time-dependent patterns regenerate per frame on the host
        # (ball/blink always; zoneplate/pinwheel families when their
        # t-coefficients are set; any pattern under horizontal-speed)
        pp = self.props
        self._animated = (
            pat in ("ball", "blink")
            or (pat in ("zone-plate", "chroma-zone-plate")
                and (pp["kt"] or pp["kt2"] or pp["kxt"] or pp["kyt"]))
            or (pat in ("pinwheel", "spokes") and pp["kt"])
            or pp["horizontal-speed"] != 0)
        self._pack_static()
        if self._noise_count:
            self._setup_noise()

    def _draw_ball(self, w, h, fg, bg, n):
        """Exact port of gst_video_test_src_ball (videotestsrc.c): the
        animation phase comes from the frame counter / running time /
        wall clock, position from the wavy or (h)sweep motion, coverage
        from the per-pixel distance ramp."""
        pp = self.props
        mode = pp["animation-mode"]
        fps = self._info.fps
        if mode == "running-time" and fps.num:
            t_s = n * fps.denom / fps.num
            rad = t_s
            flipit = int(t_s) % 2
        elif mode == "wall-time":
            import time as _time
            wall = _time.time()
            rad = wall
            flipit = int(wall) % 2
        else:                       # frames
            rad = n / 200.0
            flipit = (n // 50) % 2
        motion = pp["motion"]
        if motion == "hsweep":
            rad /= 2
            rad -= math.floor(2 * rad) / 2
        rad = 2 * math.pi * rad
        radius = 20
        if motion == "wavy":
            x = radius + (0.5 + 0.5 * math.sin(rad)) * (w - 2 * radius)
            y = radius + (0.5 + 0.5 * math.sin(rad * math.sqrt(2))) \
                * (h - 2 * radius)
        else:
            radius = min(h, w) // 4
            x = w / 2 + math.sin(rad) * radius
            y = h / 2 - math.cos(rad) * radius
        if pp["flip"] and flipit:
            fg, bg = bg, fg
        ii = np.arange(h, dtype=np.float64)[:, None]
        jj = np.arange(w, dtype=np.float64)[None, :]
        rowok = ~((ii < y - radius) | (ii > y + radius))
        o = np.maximum(0.0, radius * radius - (ii - y) ** 2)
        r = np.rint(np.sqrt(o))
        x1 = np.trunc(np.maximum(0.0, x - r))
        x2 = np.trunc(np.minimum(float(w), x + r + 1))
        colok = (jj >= x1) & (jj < x2)
        rr = (radius - np.sqrt((jj - x) ** 2 + (ii - y) ** 2)) * 0.5
        t = np.clip(np.floor(256 * rr), 0, 255).astype(np.int64)
        t = np.where(rowok & colok, t, 0)
        if motion in ("sweep", "hsweep"):
            t[:, w // 2] = 255
            t[:, int(x)] = 255
        out = np.zeros((h, w, 4), np.int32)
        for c in range(4):
            out[..., c] = _blend(fg[c], bg[c], t)
        if motion in ("sweep", "hsweep"):
            line = np.stack([np.full((w,), _blend(fg[c], bg[c], 255),
                             np.int32) for c in range(4)], axis=-1)
            out[h // 2] = line
            yi = int(y)
            if 0 <= yi < h:
                out[yi] = line
        return out

    def _draw_frame_canon(self, n: int) -> np.ndarray:
        """Canonical (h, w, 4) image of frame n for animated patterns."""
        info = self._info
        w, h = info.width, info.height
        pat = self.props["pattern"]
        fg = self._canon_color(self._prop_color("foreground-color"))
        bg = self._canon_color(self._prop_color("background-color"))
        if pat == "ball":
            canon = self._draw_ball(w, h, fg, bg, n)
        elif pat == "blink":
            # gst_video_test_src_blink: fg on odd frames, bg on even
            color = fg if (n & 1) else bg
            canon = np.broadcast_to(
                np.asarray(color, np.int32), (h, w, 4)).copy()
        elif pat in ("zone-plate", "chroma-zone-plate", "pinwheel",
                     "spokes"):
            canon = self._draw_geometric(pat, w, h, fg, bg, t=n)
        else:
            canon = self._canon_static.astype(np.int32)
        speed = self.props["horizontal-speed"]
        if speed:
            x_off = (speed * n) % w
            if x_off < 0:
                x_off += w
            canon = np.roll(canon, -x_off, axis=1)
        return canon.astype(np.uint8)

    def _draw_geometric(self, pat, w, h, fg, bg, t=0):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        out = np.zeros((h, w, 4), np.int32)
        if pat == "ball":
            return self._draw_ball(w, h, fg, bg, t)
        elif pat in ("zone-plate", "chroma-zone-plate"):
            s = SINE_TABLE[self._zoneplate_phase(w, h, t) & 0xFF]
            if pat == "zone-plate":
                out[..., 0] = 255
                out[..., 1] = s
                out[..., 2] = 128
                out[..., 3] = 128
            else:
                # gst_video_test_src_chromazoneplate: Y=128, U=V=sine
                # (videotestsrc.c:1356-1358)
                out[..., 0] = 255
                out[..., 1] = 128
                out[..., 2] = s
                out[..., 3] = s
        elif pat in ("pinwheel", "spokes"):
            # exact port of gst_video_test_src_pinwheel/spokes: 19 ray
            # projections summed, then blended fg/bg
            theta = np.pi / 19 * np.arange(19) + 0.001 * self.props["kt"] * t
            cth, sth = np.cos(theta), np.sin(theta)
            xi = (xx - 0.5 * w)
            yj = (yy - 0.5 * h)
            proj = (cth[:, None, None] * xi[None] + sth[:, None, None] * yj[None])
            if pat == "pinwheel":
                y19 = np.clip(proj, -1, 1)
                y19[1::2] *= -1
                vsum = y19.sum(axis=0)
                tline = np.clip(np.rint(vsum * 128 + 128), 0, 255).astype(np.int64)
            else:
                x19 = 2.0 * 0.5 - np.abs(proj)
                y19 = np.clip(x19 + 0.5, 0.0, 1.0)
                vsum = y19.sum(axis=0)
                tline = np.clip(np.rint(vsum * 255), 0, 255).astype(np.int64)
            for c in range(4):
                out[..., c] = _blend(fg[c], bg[c], tline)
        elif pat == "circular":
            # exact port of gst_video_test_src_circular: ring segments
            # with octave-spaced frequencies through sine_table
            freq = np.zeros(8)
            for i in range(1, 8):
                freq[i] = 200 * (2.0 ** (-(i - 1) / 4.0))
            dist = np.sqrt((2 * xx - w) ** 2 + (2 * yy - h) ** 2) / (2 * w)
            seg = np.floor(dist * 16).astype(np.int64)
            d16 = np.floor(256 * dist * freq[np.clip(seg, 0, 7)] + 0.5
                           ).astype(np.int64)
            tline = np.where((seg == 0) | (seg >= 8), 0,
                             SINE_TABLE[d16 & 0xFF]).astype(np.int64)
            for c in range(4):
                out[..., c] = _blend(fg[c], bg[c], tline)
        elif pat == "gamut":
            # exact port of gst_video_test_src_gamut: 4 bands with a
            # 16-px checker alternating in-gamut and out-of-gamut colors
            prim = np.zeros((4, 4), np.int64)
            sec = np.zeros((4, 4), np.int64)
            for r, base in enumerate((C_BLACK, C_WHITE, C_RED, C_BLUE)):
                col = self._canon_color(base)
                prim[r] = col
                s2 = col.copy()
                if r == 0:
                    s2[1] = 0      # superblack Y=0
                elif r == 1:
                    s2[1] = 255    # superwhite Y=255
                elif r == 2:
                    s2[3] = 255    # V=255 (out of gamut red)
                else:
                    s2[2] = 255    # U=255 (out of gamut blue)
                sec[r] = s2
            yyi, xxi = np.mgrid[0:h, 0:w]
            region = (yyi * 4) // h
            checker = ((xxi ^ yyi) & 16) != 0
            for c in range(4):
                out[..., c] = np.where(checker, prim[region][..., c],
                                       sec[region][..., c])
        return out

    def _zoneplate_phase(self, w, h, t):
        """Exact port of the optimized zoneplate loop
        (videotestsrc.c gst_video_test_src_zoneplate):
        phase = k0 + kx(i+1) + ky(j+1) + kt*t + kxt*t(i+1) + kyt*t(j+1)
              + (kxy*y*scale_kxy*(xreset+i+1)) >> 16
              + (kx2*x^2*scale_kx2) >> 16 + (ky2*y^2)/h + (kt2*t^2) >> 1
        in wrapping 32-bit integer arithmetic."""
        pp = self.props
        i32 = np.int32
        xoff, yoff = pp["xoffset"], pp["yoffset"]
        xreset = -(w // 2) - xoff
        yreset = -(h // 2) - yoff
        ii = np.arange(w, dtype=np.int64)
        jj = np.arange(h, dtype=np.int64)
        x = (xreset + ii)
        y = (yreset + jj)
        scale_kxy = 0xFFFF // (w // 2) if w >= 2 else 0
        scale_kx2 = 0xFFFF // w

        def w32(a):
            return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)
                    - (1 << 31)).astype(np.int64)

        phase = np.zeros((h, w), np.int64)
        phase += pp["k0"] + pp["kt"] * t + ((pp["kt2"] * t * t) >> 1)
        phase += (pp["kx"] + pp["kxt"] * t) * (ii + 1)[None, :]
        phase += (pp["ky"] + pp["kyt"] * t) * (jj + 1)[None, :].T
        delta_kxy = w32(pp["kxy"] * y * scale_kxy)
        accum_kxy = w32(delta_kxy[:, None] * (xreset + ii + 1)[None, :])
        phase += accum_kxy >> 16
        phase += w32(pp["kx2"] * x * x * scale_kx2)[None, :] >> 16
        ky2row = np.trunc((pp["ky2"] * y * y) / h).astype(np.int64)
        phase += ky2row[:, None]
        return phase.astype(np.int64)

    def _pack_static(self):
        info = self._info
        canon = self._canon_static
        if info.finfo.bits == 16:
            # reference paints 8-bit then widens with TO_16(x) = x<<8|x
            # (videotestsrc.c:35)
            canon = canon.astype(np.int32) * 257
        planes = pack(np, info.finfo, canon, info.width, info.height)
        dev = resolve(self.device)
        self._static_planes = tuple(
            torch.from_numpy(np.ascontiguousarray(p)).to(dev) for p in planes)

    def _setup_noise(self):
        dev = resolve(self.device)
        muls, adds = lcg_tables(self._noise_count)
        info = self._info
        w, h = info.width, info.height
        finfo = info.finfo

        def on_dev(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=dev)

        # The LCG is uint32 arithmetic; here it runs in int64 with the
        # multiplier split into 16-bit halves, so no product passes 2^48
        # and the low 32 bits are those of the wrapping C multiply.
        mul_lo = on_dev(muls & 0xFFFF, np.int64)
        mul_hi = on_dev(muls >> 16, np.int64)
        adds_t = on_dev(adds, np.int64)
        # static linear indices of the noise pixels (row-major order — the
        # reference fills noise left-to-right, top-to-bottom)
        lin_idx = on_dev(np.flatnonzero(self._noise_mask.reshape(-1)),
                         np.int64)
        static_t = on_dev(self._canon_static.reshape(h * w, 4), np.int32)
        fg_t = on_dev(self._canon_color(
            self._prop_color("foreground-color")), np.int32)
        bg_t = on_dev(self._canon_color(
            self._prop_color("background-color")), np.int32)

        def noise_frames(starts):
            # starts: (B,) uint32 values in int64 — the LCG state at the
            # start of each frame's noise region.  noise byte =
            # (state>>16)&0xff after each step.
            s = starts[:, None]
            st = (s * mul_lo[None, :]
                  + (((s * mul_hi[None, :]) & 0xFFFF) << 16)
                  + adds_t[None, :]) & M32
            nz = ((st >> 16) & 0xFF).to(torch.int32)       # (B, m)
            t = fg_t[None, None, :] * nz[..., None] + \
                bg_t[None, None, :] * (255 - nz)[..., None]
            blended = (t + ((t + 128) >> 8) + 128) >> 8    # (B, m, 4)
            # a dense copy per batch: an index assignment cannot write
            # through a broadcast view
            canon = static_t.expand(starts.shape[0], h * w, 4).clone()
            canon[:, lin_idx, :] = blended
            canon = canon.reshape(-1, h, w, 4)
            if finfo.bits == 16:
                canon = canon * 257
            return pack(torch, finfo, canon, w, h)

        self._noise_fn = noise_frames

    # -- dataflow ----------------------------------------------------------
    def start(self):
        self._frame = 0
        self._lcg_state = 0

    def do_seek(self, segment) -> bool:
        fps = self._info.fps if self._info else None
        if not fps or not fps.num:
            return False
        self._frame = segment.start * fps.num // (1_000_000_000 * fps.denom)
        return True

    def create(self, n_frames: int) -> Optional[Buffer]:
        num = self.props["num-buffers"]
        if num >= 0 and self._frame >= num:
            return None
        n = n_frames if num < 0 else min(n_frames, num - self._frame)
        info = self._info
        fps = info.fps
        if getattr(self, "_animated", False):
            # time-dependent patterns draw per frame on the host (exact
            # double-precision reference math), then pack; the pipeline
            # moves the planes to its device
            canon = np.stack([self._draw_frame_canon(self._frame + k)
                              for k in range(n)]).astype(np.int32)
            if info.finfo.bits == 16:
                canon = canon * 257
            data = pack(np, info.finfo, canon, info.width, info.height)
        elif self._noise_count:
            starts = np.empty(n, np.int64)
            s = self._lcg_state
            mul_f, add_f = lcg_affine(self._noise_count)
            for i in range(n):
                starts[i] = s
                s = (s * mul_f + add_f) & M32
            self._lcg_state = s
            with torch.no_grad():
                data = self._noise_fn(torch.as_tensor(
                    starts, device=self._static_planes[0].device))
        else:
            data = tuple(p.expand((n,) + tuple(p.shape))
                         for p in self._static_planes)
        if fps.num:
            pts = self._frame * 1_000_000_000 * fps.denom // fps.num
            dur = 1_000_000_000 * fps.denom // fps.num
        else:
            pts, dur = 0, None
        buf = Buffer(data=data, pts=pts, duration=dur, offset=self._frame,
                     batch=n)
        self._frame += n
        return buf
