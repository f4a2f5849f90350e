"""Video filter family: videobalance, gamma, videoflip, videocrop,
videobox, videomedian, alpha.

Copies of the JAX package's ``elements/videofilter.py`` classes of the same
names, with their device functions on torch (references
gst-plugins-good/gst/videofilter/ and friends):

* videobalance -- gstvideobalance.c:114-144: Y LUT
  y' = clamp(rint(16 + (y-16)*contrast + brightness*255)); U/V via hue
  rotation u' = 128 + ((u-128)cos(pi*hue) + (v-128)sin(pi*hue))*saturation;
  256x256 LUTs.  The same float64 tables are built on the host; where
  float32 arithmetic reproduces every table entry, the device evaluates the
  affine maps per pixel in float32, else it looks the tables up.  A
  controlled (keyframed) balance builds the same tables on the device every
  tick in float32 from the tick's values (``make_dyn_fn``).
* gamma -- gstgamma.c: the 256-entry float64 LUT of the reference, built on
  the host and put on the pipeline's device once, when the function is made.
* videoflip -- gstvideoflip.c, 8 methods: torch has no negative strides,
  so a reversal is ``torch.flip`` (a copy, taken before the transpose so it
  reads and writes in rows) and a 90-degree turn or diagonal a
  ``transpose`` view.  A plane that leaves the element as a view stays one;
  the converter and the kernels' callers make their planes dense where a
  kernel needs it.
* videocrop / videobox -- views of the planes (the crop of a subsampled
  plane shifted with Python's ``>>``, a floor, as the reference), videobox's
  borders a constant ``torch.nn.functional.pad`` on uint8.
* videomedian -- gstvideomedian.c's 5-point cross median.  The reference
  stacks four int32 rolls with the plane and takes ``jnp.median``; of five
  values that is the third smallest, which seven compare-exchanges of uint8
  views give exactly (``_median5``), without the int32 stack.  The borders
  keep their input values, as in the reference.  ``filtersize=9`` raises:
  the reference reads the property and runs the 5-point median all the same
  (ROADMAP.md section 3).
* alpha -- the set / green / blue modes; a format change goes through this
  package's VideoConverter on the pipeline's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo
from .videotestsrc import FORMAT_LIST

_ROADMAP = "not ported to gstreamer_tpu_torch (see ROADMAP.md)"

YUV_CAPS = ("video/x-raw, format={ AYUV, I420, YV12, Y444, Y42B, Y41B, "
            "NV12, NV21, YUY2, UYVY, VUYA }, width=[1,32767], "
            "height=[1,32767], framerate=[0/1,2147483647/1]")
ANY_VIDEO = (f"video/x-raw, format={FORMAT_LIST}, width=[1,32767], "
             f"height=[1,32767], framerate=[0/1,2147483647/1]")


class _VideoFilterBase(TransformElement):
    """GstVideoFilter equivalent: same caps in/out, per-frame function."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, YUV_CAPS),
        PadTemplate("src", PadDirection.SRC, YUV_CAPS),
    ]

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])


@register_element
class VideoBalance(_VideoFilterBase):
    FACTORY = "videobalance"
    DESCRIPTION = "Adjusts brightness, contrast, hue, saturation"
    PROPERTIES = {
        "contrast": (float, 1.0, "[0,2]"),
        "brightness": (float, 0.0, "[-1,1]"),
        "hue": (float, 0.0, "[-1,1]"),
        "saturation": (float, 1.0, "[0,2]"),
    }
    DYNAMIC_PROPS = ("contrast", "brightness", "hue", "saturation")

    def make_dyn_fn(self):
        """Keyframed balance: the four values arrive each tick as float32
        (``Pipeline.tick``) and the LUTs are built on the planes' device
        with the rint/clip math of the static tables, in float32, one
        rounding per operation (no fused multiply-add), then looked up.
        The scalar products and the hue's cos / sin are taken on the host
        in float32 (cos / sin correctly rounded from float64), so every
        device builds the same tables."""

        def fn(planes, dyn):
            f32 = np.float32
            c, b, hue, sat = (f32(dyn.get(k, self.props[k])) for k in
                              ("contrast", "brightness", "hue",
                               "saturation"))
            arg = f32(np.pi) * hue
            hc = float(f32(math.cos(float(arg))))
            hs = float(f32(math.sin(float(arg))))
            b255 = float(b * f32(255))
            dev = planes[0].device
            i = torch.arange(256, dtype=torch.float32, device=dev)
            ty = torch.clamp(torch.round(16.0 + (i - 16.0) * float(c)
                                         + b255), 0, 255).to(torch.int32)
            ii = (i - 128.0)[:, None]
            jj = (i - 128.0)[None, :]
            tu = torch.clamp(torch.round(128.0 + (ii * hc + jj * hs)
                                         * float(sat)), 0, 255)
            tv = torch.clamp(torch.round(128.0 + (-ii * hs + jj * hc)
                                         * float(sat)), 0, 255)
            y = planes[0].to(torch.int64)
            idx = planes[1].to(torch.int64) * 256 + planes[2].to(torch.int64)
            out = [ty[y].to(torch.uint8),
                   tu.reshape(-1).to(torch.uint8)[idx],
                   tv.reshape(-1).to(torch.uint8)[idx]]
            return tuple(out) + tuple(planes[3:])

        return fn

    def _tables(self):
        c, b = self.props["contrast"], self.props["brightness"]
        hue, sat = self.props["hue"], self.props["saturation"]
        i = np.arange(256, dtype=np.float64)
        tabley = np.clip(np.rint(16 + (i - 16) * c + b * 255), 0, 255)
        hc, hs = math.cos(math.pi * hue), math.sin(math.pi * hue)
        ii, jj = np.mgrid[-128:128, -128:128].astype(np.float64)
        tableu = np.clip(np.rint(128 + (ii * hc + jj * hs) * sat), 0, 255)
        tablev = np.clip(np.rint(128 + (-ii * hs + jj * hc) * sat), 0, 255)
        return (tabley.astype(np.int32), tableu.astype(np.int32),
                tablev.astype(np.int32))

    def _f32_direct_ok(self, ty, tu, tv):
        """The LUTs are pure affine maps of the pixel value, so direct
        per-pixel float32 evaluation can replace the lookups.  Verify on
        the host that float32 arithmetic reproduces every entry of the
        float64-built tables (rint ties can differ in principle); fall
        back to the lookup path if any differs."""
        c = np.float32(self.props["contrast"])
        b255 = np.float32(self.props["brightness"] * 255.0)
        hue, sat = self.props["hue"], self.props["saturation"]
        hcs = np.float32(math.cos(math.pi * hue) * sat)
        hss = np.float32(math.sin(math.pi * hue) * sat)
        i = np.arange(256, dtype=np.float32)
        ty2 = np.clip(np.rint(np.float32(16) + (i - np.float32(16))
                              * c + b255), 0, 255).astype(np.int32)
        ii, jj = np.mgrid[-128:128, -128:128].astype(np.float32)
        tu2 = np.clip(np.rint(np.float32(128) + ii * hcs + jj * hss),
                      0, 255).astype(np.int32)
        tv2 = np.clip(np.rint(np.float32(128) - ii * hss + jj * hcs),
                      0, 255).astype(np.int32)
        ok = (np.array_equal(ty2, ty) and np.array_equal(tu2, tu)
              and np.array_equal(tv2, tv))
        return ok, (c, b255, hcs, hss)

    def make_fn(self):
        if (self.props["contrast"] == 1.0 and self.props["brightness"] == 0.0
                and self.props["hue"] == 0.0 and self.props["saturation"] == 1.0):
            return None
        ty, tu, tv = self._tables()
        direct_ok, consts = self._f32_direct_ok(ty, tu, tv)

        if direct_ok:
            c, b255, hcs, hss = (float(v) for v in consts)

            def fn(planes):
                # one eager torch op per step: each product and sum rounds
                # to float32 as the host check above does (no fused
                # multiply-add); torch.round is round-half-to-even, as rint
                yf = planes[0].to(torch.float32)
                uf = planes[1].to(torch.float32) - 128.0
                vf = planes[2].to(torch.float32) - 128.0
                y2 = torch.clamp(torch.round(16.0 + (yf - 16.0) * c + b255),
                                 0, 255)
                u2 = torch.clamp(torch.round(128.0 + uf * hcs + vf * hss),
                                 0, 255)
                v2 = torch.clamp(torch.round(128.0 - uf * hss + vf * hcs),
                                 0, 255)
                out = [y2.to(torch.uint8), u2.to(torch.uint8),
                       v2.to(torch.uint8)]
                return tuple(out) + tuple(planes[3:])

            return fn

        tables = {}
        tuv = np.stack([tu, tv]).reshape(2, -1)

        def fn(planes):
            dev = planes[0].device
            if dev not in tables:
                tables[dev] = (torch.as_tensor(ty, device=dev),
                               torch.as_tensor(tuv, device=dev))
            ty_t, tuv_t = tables[dev]
            y = planes[0].to(torch.int64)
            idx = planes[1].to(torch.int64) * 256 + planes[2].to(torch.int64)
            out = [ty_t[y].to(torch.uint8), tuv_t[0][idx].to(torch.uint8),
                   tuv_t[1][idx].to(torch.uint8)]
            return tuple(out) + tuple(planes[3:])

        return fn


@register_element
class Gamma(_VideoFilterBase):
    FACTORY = "gamma"
    DESCRIPTION = "Adjusts gamma on video luma"
    PROPERTIES = {"gamma": (float, 1.0, "gamma value")}

    def make_fn(self):
        g = self.props["gamma"]
        if g == 1.0:
            return None
        i = np.arange(256, dtype=np.float64)
        lut = np.clip(np.rint(np.power(i / 255.0, 1.0 / g) * 255.0),
                      0, 255).astype(np.uint8)
        lut_t = torch.as_tensor(lut, device=self.device)

        def fn(planes):
            y = planes[0]
            out = torch.index_select(lut_t, 0, y.reshape(-1).to(torch.int32))
            return (out.reshape(y.shape),) + tuple(planes[1:])

        return fn


def _resize_caps(caps, dw: int, dh: int, direction, filter=None):
    """videocrop / videobox transform_caps: width and height shrink by the
    crop going downstream (grow going upstream)."""
    out = []
    for s in caps:
        ns = s.copy()
        for key, delta in (("width", dw), ("height", dh)):
            v = ns.get(key)
            if isinstance(v, int):
                ns[key] = v - delta if direction == PadDirection.SINK \
                    else v + delta
        out.append(ns)
    res = Caps(out)
    if filter is not None:
        res = res.intersect(filter)
    return res


def _subsampling(fmt, c: int):
    """(vertical, horizontal) subsampling shift of component plane c."""
    hs = fmt.h_sub[c] if c < len(fmt.h_sub) else 0
    ws = fmt.w_sub[c] if c < len(fmt.w_sub) else 0
    return hs, ws


@register_element
class VideoFlip(TransformElement):
    FACTORY = "videoflip"
    DESCRIPTION = "Flips and rotates video"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, ANY_VIDEO),
        PadTemplate("src", PadDirection.SRC, ANY_VIDEO),
    ]
    PROPERTIES = {"method": (str, "none",
                             "none|clockwise|rotate-180|counterclockwise|"
                             "horizontal-flip|vertical-flip|"
                             "upper-left-diagonal|upper-right-diagonal")}

    # method: (axes reversed on the input plane, then transposed?)
    _OPS = {
        "vertical-flip": ((-2,), False),
        "horizontal-flip": ((-1,), False),
        "rotate-180": ((-2, -1), False),
        "clockwise": ((-2,), True),
        "counterclockwise": ((-1,), True),
        "upper-left-diagonal": ((), True),
        "upper-right-diagonal": ((-2, -1), True),
    }
    SWAPS = tuple(m for m, (_, turn) in _OPS.items() if turn)

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            ns = s.copy()
            if self.props["method"] in self.SWAPS:
                w, h = ns.get("width"), ns.get("height")
                if w is not None and h is not None:
                    ns["width"], ns["height"] = h, w
            out.append(ns)
        res = Caps(out)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._in = VideoInfo.from_caps_structure(incaps[0])

    def make_fn(self):
        method = self.props["method"]
        if method not in self._OPS:
            return None
        flip_axes, turn = self._OPS[method]

        def op(p):
            if flip_axes:
                p = torch.flip(p, flip_axes)
            return p.transpose(-1, -2) if turn else p

        return lambda planes: tuple(op(p) for p in planes)


@register_element
class VideoCrop(TransformElement):
    FACTORY = "videocrop"
    DESCRIPTION = "Crops video"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, ANY_VIDEO),
        PadTemplate("src", PadDirection.SRC, ANY_VIDEO),
    ]
    PROPERTIES = {
        "top": (int, 0, ""), "bottom": (int, 0, ""),
        "left": (int, 0, ""), "right": (int, 0, ""),
    }

    def transform_caps(self, direction, caps, filter=None):
        return _resize_caps(caps, self.props["left"] + self.props["right"],
                            self.props["top"] + self.props["bottom"],
                            direction, filter)

    def set_info(self, incaps, outcaps):
        self._in = VideoInfo.from_caps_structure(incaps[0])

    def make_fn(self):
        t, b = self.props["top"], self.props["bottom"]
        l, r = self.props["left"], self.props["right"]
        if not any((t, b, l, r)):
            return None
        fmt = self._in.finfo

        def fn(planes):
            out = []
            for c, p in enumerate(planes):
                hs, ws = _subsampling(fmt, c)
                tt, bb = t >> hs, b >> hs
                ll, rr = l >> ws, r >> ws
                sl_h = slice(tt, p.shape[-2] - bb if bb else None)
                sl_w = slice(ll, p.shape[-1] - rr if rr else None)
                out.append(p[..., sl_h, sl_w])
            return tuple(out)

        return fn


@register_element
class VideoBox(TransformElement):
    """videobox: negative values add borders, positive crop."""
    FACTORY = "videobox"
    DESCRIPTION = "Resizes video by adding borders or cropping"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, YUV_CAPS),
        PadTemplate("src", PadDirection.SRC, YUV_CAPS),
    ]
    PROPERTIES = {
        "top": (int, 0, ""), "bottom": (int, 0, ""),
        "left": (int, 0, ""), "right": (int, 0, ""),
        "fill": (str, "black", "black|green|blue"),
    }

    def transform_caps(self, direction, caps, filter=None):
        return _resize_caps(caps, self.props["left"] + self.props["right"],
                            self.props["top"] + self.props["bottom"],
                            direction, filter)

    def set_info(self, incaps, outcaps):
        self._in = VideoInfo.from_caps_structure(incaps[0])

    def make_fn(self):
        t, b = self.props["top"], self.props["bottom"]
        l, r = self.props["left"], self.props["right"]
        if not any((t, b, l, r)):
            return None
        fmt = self._in.finfo
        fill = {"black": (16, 128, 128), "green": (145, 54, 34),
                "blue": (41, 240, 110)}[self.props["fill"]]

        def fn(planes):
            out = []
            for c, p in enumerate(planes[:3]):
                hs, ws = _subsampling(fmt, c)
                tt, bb = t >> hs, b >> hs
                ll, rr = l >> ws, r >> ws
                # crop positive
                sl_h = slice(max(tt, 0), p.shape[-2] - max(bb, 0) or None)
                sl_w = slice(max(ll, 0), p.shape[-1] - max(rr, 0) or None)
                q = p[..., sl_h, sl_w]
                # pad negative (last axis first, as F.pad counts them)
                pads = (max(-ll, 0), max(-rr, 0), max(-tt, 0), max(-bb, 0))
                if any(pads):
                    q = torch.nn.functional.pad(q, pads, value=fill[c])
                out.append(q)
            return tuple(out) + tuple(planes[3:])

        return fn


def _median5(c, n, s, w, e):
    """The third smallest of five same-shape uint8 tensors: N. Devillard's
    opt_med5 network of seven compare-exchanges, with only the min or max
    each later step reads."""
    lo, hi = torch.minimum(c, n), torch.maximum(c, n)
    w_lo, e_hi = torch.minimum(w, e), torch.maximum(w, e)
    w = torch.maximum(lo, w_lo)
    n = torch.minimum(hi, e_hi)
    n, s = torch.minimum(n, s), torch.maximum(n, s)
    return torch.maximum(n, torch.minimum(s, w))


@register_element
class VideoMedian(_VideoFilterBase):
    FACTORY = "videomedian"
    DESCRIPTION = "Apply a median filter to video"
    PROPERTIES = {"filtersize": (int, 5, "5 or 9"),
                  "lum-only": (bool, True, "")}

    def make_fn(self):
        if self.props["filtersize"] != 5:
            raise NotImplementedError(
                f"videomedian filtersize={self.props['filtersize']}: only "
                f"the 5-point median is {_ROADMAP[4:]}; the reference runs "
                f"it for every filtersize")
        lum_only = self.props["lum-only"]

        def median5(p):
            # 5-point cross median over the interior; the border rows and
            # columns keep their values (the reference restores them)
            out = p.clone()
            if p.shape[-2] >= 3 and p.shape[-1] >= 3:
                out[..., 1:-1, 1:-1] = _median5(
                    p[..., 1:-1, 1:-1], p[..., :-2, 1:-1], p[..., 2:, 1:-1],
                    p[..., 1:-1, :-2], p[..., 1:-1, 2:])
            return out

        def fn(planes):
            out = [median5(planes[0])]
            for p in planes[1:]:
                out.append(p if lum_only else median5(p))
            return tuple(out)

        return fn


@register_element
class Alpha(TransformElement):
    """alpha element: add/set alpha channel (chroma keying basic)."""
    FACTORY = "alpha"
    DESCRIPTION = "Adds an alpha channel to video"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, YUV_CAPS),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ AYUV, ARGB, BGRA, RGBA }, "
                    "width=[1,32767], height=[1,32767], "
                    "framerate=[0/1,2147483647/1]"),
    ]
    PROPERTIES = {
        "alpha": (float, 1.0, "alpha value"),
        "method": (str, "set", "set|green|blue|custom"),
        "angle": (float, 20.0, "chroma-key tolerance (degrees)"),
    }

    def transform_caps(self, direction, caps, filter=None):
        tmpl = (self.src_pads()[0].template_caps
                if direction == PadDirection.SINK
                else self.sink_pads()[0].template_caps)
        out = []
        for s in caps:
            for ts in tmpl:
                ns = ts.copy()
                for k in ("width", "height", "framerate"):
                    if k in s.fields:
                        ns[k] = s[k]
                out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._in = VideoInfo.from_caps_structure(incaps[0])
        self._out = VideoInfo.from_caps_structure(outcaps[0])

    def make_fn(self):
        from ..video.converter import VideoConverter
        a_val = int(self.props["alpha"] * 255)
        iinfo, oinfo = self._in, self._out
        # key colors in YUV (green/blue screen, bt601 values)
        key = {"green": (145, 54, 34),
               "blue": (41, 240, 110)}.get(self.props["method"])
        tol = (self.props["angle"] * 3) ** 2
        conv = None
        if iinfo.finfo.name != oinfo.finfo.name:
            conv = VideoConverter(
                VideoInfo(format=iinfo.format, width=iinfo.width,
                          height=iinfo.height, colorimetry=iinfo.colorimetry),
                VideoInfo(format=oinfo.format, width=oinfo.width,
                          height=oinfo.height), device=self.device)

        def fn(planes):
            y = planes[0]
            if key is not None:
                # distance to the key chroma at chroma resolution
                du = planes[1].to(torch.int32) - key[1]
                dv = planes[2].to(torch.int32) - key[2]
                dist2 = du * du + dv * dv
                a_chroma = torch.where(dist2 < tol, 0, a_val).to(torch.uint8)
                # upsample alpha (nearest) to full res
                rep_h = y.shape[-2] // a_chroma.shape[-2]
                rep_w = y.shape[-1] // a_chroma.shape[-1]
                a_plane = (a_chroma.repeat_interleave(rep_h, dim=-2)
                           .repeat_interleave(rep_w, dim=-1)
                           [..., :y.shape[-2], :y.shape[-1]])
            else:
                a_plane = torch.full(y.shape, a_val, dtype=torch.uint8,
                                     device=y.device)
            outp = conv.convert(planes) if conv is not None else planes
            return tuple(outp[:3]) + (a_plane,)

        return fn
