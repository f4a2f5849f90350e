"""Video filter family: videobalance.

A copy of the JAX package's ``elements/videofilter.py`` VideoBalance
(reference gst-plugins-good/gst/videofilter/gstvideobalance.c:114-144:
Y LUT y' = clamp(rint(16 + (y-16)*contrast + brightness*255)); U/V via hue
rotation u' = 128 + ((u-128)cos(pi*hue) + (v-128)sin(pi*hue))*saturation;
256x256 LUTs).  The same float64 tables are built on the host; where
float32 arithmetic reproduces every table entry, the device evaluates the
affine maps per pixel in float32, else it looks the tables up.  A
controlled (keyframed) balance builds the same tables on the device every
tick in float32 from the tick's values (``make_dyn_fn``).  The family's
other filters (gamma, videoflip, videocrop, videobox, videomedian, alpha)
are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

YUV_CAPS = ("video/x-raw, format={ AYUV, I420, YV12, Y444, Y42B, Y41B, "
            "NV12, NV21, YUY2, UYVY, VUYA }, width=[1,32767], "
            "height=[1,32767], framerate=[0/1,2147483647/1]")


class _VideoFilterBase(TransformElement):
    """GstVideoFilter equivalent: same caps in/out, per-frame function."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, YUV_CAPS),
        PadTemplate("src", PadDirection.SRC, YUV_CAPS),
    ]


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
