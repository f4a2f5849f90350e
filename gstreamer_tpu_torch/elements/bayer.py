"""bayer2rgb / rgb2bayer — Bayer mosaic (de)mosaicing.

Reference: gst-plugins-bad/gst/bayer/:
* gstbayer2rgb.c — bilinear demosaic via horizontal split+upsample of
  each source line into the two color phases (the DEST0/DEST1 tables at
  gstbayer2rgb.c:407-466) followed by a 3-line merge
  (bayer_orc_merge_bg_* / _gr_*, gstbayerorc.orc:43-91: R/B from the
  rounded average of the previous+next lines, G from
  avg(avg(prev,next),cur) on the non-green sample and the line's own G
  on the green sample).  Format symmetry handling as in
  gst_bayer2rgb_process (gstbayer2rgb.c:585-597): RGGB/GBRG swap the
  R/B outputs, GRBG/GBRG swap the row roles.
* gstrgb2bayer.c — mosaic extraction: pos=(row&1)<<1|(col&1), B where
  pos==fmt, R where pos==fmt^3, else G (gstrgb2bayer.c:317-343);
  deep output scales v<<(bpp-8)|v>>(16-bpp) (bayer_scale_and_swap
  gstrgb2bayer.c:271).
* depth adaptation: 16->16 out = min(65535, v*65535>>bpp)
  (bayer16to16_orc_reorder gstbayerorc.orc:494), 16->8 out =
  sat8(v>>(bpp-8)) (bayer16to8 :511), 8->16 out = v<<8|v (bayer8to16
  :526).

The JAX package's ``elements/bayer.py`` on torch: instead of the
reference's per-line ring buffer + ORC row kernels, the whole batch is
demosaiced as shifted slices and selects in int32 on the planes' device;
a 16-bit output is cast to ``torch.uint16`` only at the end (torch has few
uint16 operations).  ``parse_bayer_format`` is a host copy.

Edge semantics match the reference exactly, including the quirky bottom
row: the reference's 8-line ring means output row h-1 reads the
pre-processed pair of source row h-4 as its "next" line
(LINE() macro, gstbayer2rgb.c:549 with j*2+2 wrapped mod 8).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

_PATTERNS = ["bggr", "gbrg", "grbg", "rggb"]   # gstrgb2bayer.h:39 order
_DEPTHS = [8, 10, 12, 14, 16]

BAYER_FORMATS = []
for _p in _PATTERNS:
    BAYER_FORMATS.append(_p)
    for _d in (10, 12, 14, 16):
        BAYER_FORMATS.extend([f"{_p}{_d}le", f"{_p}{_d}be"])

BAYER_CAPS = ("video/x-bayer, format={ " + ", ".join(BAYER_FORMATS)
              + " }, width=[2,32767], height=[2,32767], "
              "framerate=[0/1,2147483647/1]")
RGB_OUT_CAPS = ("video/x-raw, format={ RGBA, BGRA, ARGB, ABGR, RGBx, "
                "BGRx, xRGB, xBGR, RGBA64_LE }, width=[2,32767], "
                "height=[2,32767], framerate=[0/1,2147483647/1]")


def parse_bayer_format(fmt: str):
    """-> (pattern, bpp, bigendian)."""
    pat = fmt[:4]
    if pat not in _PATTERNS:
        raise ValueError(f"unknown bayer format {fmt!r}")
    if len(fmt) == 4:
        return pat, 8, False
    bpp = int(fmt[4:-2])
    if bpp not in _DEPTHS:
        raise ValueError(f"unsupported bayer depth in {fmt!r}")
    return pat, bpp, fmt.endswith("be")


def _avg(a, b):
    """avgub/avguw: (a + b + 1) >> 1 (rounded)."""
    return (a + b + 1) >> 1


def demosaic_fn(pattern: str, bpp: int, out16: bool, height: int,
                width: int, device=None):
    """Device fn: (B,H,W) mosaic plane -> (R,G,B,A) planes.

    Bilinear demosaic per gstbayer2rgb.c; math in int32, output
    uint8/uint16.  The row and column tables go to `device` once."""
    if width % 2 or height % 2:
        raise ValueError("bayer demosaic requires even dimensions")
    rows_gr_first = pattern in ("grbg", "gbrg")   # swap merge order
    swap_rb = pattern in ("rggb", "gbrg")         # swap r/b offsets

    h, w = height, width
    # row ring semantics: prev(0)=1, next(h-1)=h-4 (h>=4), else clamp
    pidx = np.arange(h) - 1
    pidx[0] = 1
    nidx = np.arange(h) + 1
    nidx[h - 1] = h - 4 if h >= 4 else h - 2
    ce = (np.arange(w) % 2 == 0)                  # even column
    re = (np.arange(h) % 2 == 0)                  # even row
    if rows_gr_first:
        re = ~re
    pidx, nidx, cej, rej = (torch.as_tensor(a, device=device)
                            for a in (pidx, nidx, ce, re[:, None]))
    odtype = torch.uint16 if out16 else torch.uint8
    alpha_v = 65535 if out16 else 255

    if bpp == 8:
        if out16:                       # bayer8to16: splat v<<8|v
            conv = lambda v: ((v << 8) | v).to(odtype)
        else:
            conv = lambda v: v.to(odtype)
    elif out16:                         # bayer16to16_orc_reorder
        conv = lambda v: torch.clamp((v * 65535) >> bpp, max=65535) \
            .to(odtype)
    else:                               # bayer16to8_orc_reorder
        conv = lambda v: torch.clamp(v >> (bpp - 8), max=255).to(odtype)

    def fn(x):
        if isinstance(x, (tuple, list)):
            x = x[0]
        x = x.to(torch.int32)
        # horizontal split+upsample (DEST0/DEST1 tables,
        # gstbayer2rgb.c:407-466); edges overridden after the bulk
        xl = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        xr = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
        nbr = _avg(xl, xr)
        e0 = torch.where(cej, x, nbr)
        e1 = torch.where(cej, nbr, x)
        # col 0: dest1 = src[1]; col w-2: dest1 = src[w-3];
        # col w-1: dest0 = src[w-2]
        e1[..., 0] = x[..., 1]
        e1[..., w - 2] = x[..., w - 3]
        e0[..., w - 1] = x[..., w - 2]
        # vertical merge: v0/v1 = rounded avg of prev/next line phases
        p0, p1 = e0[:, pidx], e1[:, pidx]
        n0, n1 = e0[:, nidx], e1[:, nidx]
        v0, v1 = _avg(p0, n0), _avg(p1, n1)
        # "BG" rows (B on even cols): B=e0, R=v1,
        #   G = even col: avg(v0, e1) (3-line avg), odd col: e1
        # "GR" rows (G on even cols): B=v0, R=e1,
        #   G = even col: e0, odd col: avg(v1, e0)
        b = torch.where(rej, e0, v0)
        r = torch.where(rej, v1, e1)
        g = torch.where(rej,
                        torch.where(cej, _avg(v0, e1), e1),
                        torch.where(cej, e0, _avg(v1, e0)))
        if swap_rb:
            r, b = b, r
        a = torch.full(r.shape, alpha_v, dtype=torch.int32,
                       device=r.device).to(odtype)
        return (conv(r), conv(g), conv(b), a)

    return fn


@register_element
class Bayer2RGB(TransformElement):
    """bayer2rgb (gstbayer2rgb.c): video/x-bayer -> RGB(A)."""
    FACTORY = "bayer2rgb"
    DESCRIPTION = "Converts Bayer-mosaic video to RGB"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, BAYER_CAPS),
        PadTemplate("src", PadDirection.SRC, RGB_OUT_CAPS),
    ]

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            tmpl = (RGB_OUT_CAPS if direction == PadDirection.SINK
                    else BAYER_CAPS)
            ns = Caps.from_string(tmpl)[0].copy()
            for key in ("width", "height", "framerate"):
                if key in s.fields:
                    ns[key] = s[key]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction, caps, othercaps):
        out = othercaps.truncate()[0].copy()
        if direction == PadDirection.SINK:
            # default dest depth follows the source depth
            # (gstbayer2rgb.c:568-580: >8bpp emits RGBA64)
            _, bpp, _ = parse_bayer_format(caps[0]["format"])
            fmt = out.get("format")
            if fmt is not None and not isinstance(fmt, str):
                out["format"] = "RGBA64_LE" if bpp > 8 else "RGBA"
        else:
            fmt = out.get("format")
            if fmt is not None and not isinstance(fmt, str):
                out["format"] = "bggr"
        return Caps([out]).fixate()

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        self._pattern, self._bpp, self._be = \
            parse_bayer_format(s["format"])
        self._w, self._h = s["width"], s["height"]
        self._out16 = "64" in outcaps[0]["format"]

    def make_fn(self):
        return demosaic_fn(self._pattern, self._bpp, self._out16,
                           self._h, self._w, self.device)


@register_element
class RGB2Bayer(TransformElement):
    """rgb2bayer (gstrgb2bayer.c): ARGB -> video/x-bayer."""
    FACTORY = "rgb2bayer"
    DESCRIPTION = "Converts RGB video to a Bayer mosaic"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format=ARGB, width=[2,32767], "
                    "height=[2,32767], framerate=[0/1,2147483647/1]"),
        PadTemplate("src", PadDirection.SRC, BAYER_CAPS),
    ]

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            tmpl = (BAYER_CAPS if direction == PadDirection.SINK
                    else self.PAD_TEMPLATES[0].caps)
            base = tmpl if isinstance(tmpl, Caps) else Caps.from_string(tmpl)
            ns = base[0].copy()
            for key in ("width", "height", "framerate"):
                if key in s.fields:
                    ns[key] = s[key]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction, caps, othercaps):
        out = othercaps.truncate()[0].copy()
        fmt = out.get("format")
        if fmt is not None and not isinstance(fmt, str):
            out["format"] = "bggr" if direction == PadDirection.SINK \
                else "ARGB"
        return Caps([out]).fixate()

    def set_info(self, incaps, outcaps):
        self._pattern, self._bpp, self._be = \
            parse_bayer_format(outcaps[0]["format"])
        s = incaps[0]
        self._w, self._h = s["width"], s["height"]

    def make_fn(self):
        fmt_idx = _PATTERNS.index(self._pattern)
        bpp = self._bpp
        h, w = self._h, self._w
        # pos = (row&1)<<1 | (col&1); channel: B at pos==fmt,
        # R at pos==fmt^3, else G (gstrgb2bayer.c:317)
        pos = ((np.arange(h)[:, None] & 1) << 1) | (np.arange(w) & 1)
        sel = torch.as_tensor(np.where(pos == fmt_idx, 2,
                                       np.where(pos == (fmt_idx ^ 3), 0, 1)),
                              device=self.device)

        def fn(planes):
            r, g, b = (p.to(torch.int32) for p in planes[:3])
            v = torch.where(sel == 2, b, torch.where(sel == 0, r, g))
            if bpp == 8:
                return v.to(torch.uint8)
            # bayer_scale_and_swap (gstrgb2bayer.c:273)
            return ((v << (bpp - 8)) | (v >> (16 - bpp))).to(torch.uint16)

        return fn
