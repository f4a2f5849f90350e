"""gaudieffects — burn / chromium / dilate / dodge / exclusion /
solarize / gaussianblur.

The JAX package's ``elements/gaudieffects.py`` on torch: exact ports of
gst-plugins-bad/gst/gaudieffects/ as int64 passes over (R,G,B,A) planes
on the planes' device (the reference works on BGRx/RGBx words; component
roles map 1:1):
* burn (gstgaudieffectsorc.orc gaudi_orc_burn): 16-bit lane math
  out = 255 - (((255-v)<<7) / ((v+adj)>>1)), divide-by-zero -> 0xFFFF
  (ORC divluw), final convwb truncation; applied to all four bytes in
  the reference — here to R,G,B (the x byte is undefined padding).
* chromium (gstchromium.c:114): v' = |cosTable[(v+edge_a+(v*edge_b)/2)
  & 1023]| with the 1024-entry *512 integer cosine table.
* dilate (gstdilate.c): neighborhood max/min by luminance
  90R+115G+51B, candidate order down,right,up,left — note the
  reference's `up` guard (`if (up < src) up = src`) is always true,
  so the up neighbor never contributes; ported faithfully.
* dodge (gstdodge.c): v' = 256v/(256-v) clamped.
* exclusion (gstexclusion.c:114): factor-((factor-v)^2/factor +
  (green*v)/factor) — including the reference's use of GREEN in the
  red/green cross terms.
* solarize (gstsolarize.c:114): triangle remap over
  [start, threshold, end] with C modulo semantics.
* gaussianblur (gstgaussblur.c): separable float32 gaussian over AYUV
  with edge-renormalized kernel sums and +0.5 truncation.  The kernel and
  the edge sums are made on the host in float32, as the reference makes
  them, and go to the device once.  XLA on the CPU contracts the JAX
  package's ``acc + x * k`` into a fused multiply-add (one rounding), and
  the port does the same on every device: the product of two float32
  values is exact in float64, and so is its sum with the float32 ``acc``
  (their exponents lie within 53 bits of each other for 8-bit samples and
  this kernel), so ``float32(acc + float64(x) * k)`` rounds once, like the
  fused operation, whether or not a compiler fuses the float64 ones
  (tests/test_torch_videofx.py holds it to the JAX package at tolerance
  0, and to a separate-rounding sum that differs).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo

_RGBX_CAPS = ("video/x-raw, format={ BGRx, RGBx, RGBA, BGRA }, "
              "width=[1,32767], height=[1,32767], "
              "framerate=[0/1,2147483647/1]")
_AYUV_CAPS = ("video/x-raw, format=AYUV, width=[1,32767], "
              "height=[1,32767], framerate=[0/1,2147483647/1]")

# gstchromium.c:102-110 setup_cos_table: float32 radians with the
# reference's (typo'd) pi constant 3.141582f, cos() in double, *512
# truncated toward zero
_REF_PI = np.float32(3.141582)
COS_TABLE = np.array(
    [int(math.cos(float((np.float32(a) / np.float32(512))
                        * _REF_PI)) * 512)
     for a in range(1024)], np.int64)


class _GaudiBase(TransformElement):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _RGBX_CAPS),
        PadTemplate("src", PadDirection.SRC, _RGBX_CAPS),
    ]

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    @staticmethod
    def _rgb_map(fn1):
        """A plane fn applying fn1 to each of the (R, G, B) int64 planes."""
        def fn(planes):
            dt = planes[0].dtype
            return [fn1(p.to(torch.int64)).to(dt)
                    for p in planes[:3]] + list(planes[3:])
        return fn


@register_element
class Burn(_GaudiBase):
    FACTORY = "burn"
    DESCRIPTION = "Burn adjusts the colors in the video signal"
    PROPERTIES = {"adjustment": (int, 175, "adjustment 0-256")}

    def make_fn(self):
        adj = self.props["adjustment"]

        def burn1(v):
            a = ((v + adj) & 0xFFFF) >> 1
            t = (255 - v) << 7
            q = torch.where(a == 0, 0xFFFF, t // torch.clamp(a, min=1))
            return (255 - q) & 0xFF

        return self._rgb_map(burn1)


@register_element
class Chromium(_GaudiBase):
    FACTORY = "chromium"
    DESCRIPTION = "Chromium breaks the colors of the video signal"
    PROPERTIES = {"edge-a": (int, 200, "first edge parameter 0-256"),
                  "edge-b": (int, 1, "second edge parameter 0-256")}

    def make_fn(self):
        ea, eb = self.props["edge-a"], self.props["edge-b"]
        tab = torch.as_tensor(np.clip(np.abs(COS_TABLE), 0, 255),
                              device=self.device)

        def chrom1(v):
            return tab[(v + ea + (v * eb) // 2) & 1023]

        return self._rgb_map(chrom1)


@register_element
class Dodge(_GaudiBase):
    FACTORY = "dodge"
    DESCRIPTION = "Dodge saturates the colors in the video signal"
    PROPERTIES = {}

    def make_fn(self):
        return self._rgb_map(
            lambda v: torch.clamp((256 * v) // (256 - v), 0, 255))


@register_element
class Exclusion(_GaudiBase):
    FACTORY = "exclusion"
    DESCRIPTION = "Exclusion exclodes the colors in the video signal"
    PROPERTIES = {"factor": (int, 175, "exclusion factor 1-175")}

    def make_fn(self):
        f = self.props["factor"]

        def fn(planes):
            r, g, b = (p.to(torch.int64) for p in planes[:3])
            # the reference's cross terms use GREEN for red and green
            ro = f - (((f - r) * (f - r)) // f + (g * r) // f)
            go = f - (((f - g) * (f - g)) // f + (g * g) // f)
            bo = f - (((f - b) * (f - b)) // f + (b * b) // f)
            dt = planes[0].dtype
            return [torch.clamp(c, 0, 255).to(dt)
                    for c in (ro, go, bo)] + list(planes[3:])

        return fn


@register_element
class Solarize(_GaudiBase):
    FACTORY = "solarize"
    DESCRIPTION = "Solarize tunable inverse in the video signal"
    PROPERTIES = {"threshold": (int, 127, "0-256"),
                  "start": (int, 50, "0-256"),
                  "end": (int, 185, "0-256")}

    def make_fn(self):
        thr, start, end = (self.props["threshold"],
                           self.props["start"], self.props["end"])
        period = (end - start) if end != start else 1
        up_len = (thr - start) if thr != start else 1
        down_len = (end - thr) if thr != end else 1

        def sol1(v):
            # floor modulo and floor division, as the JAX package's
            param = (v + 256 - start) % period if period > 0 else \
                -((-(v + 256 - start)) % -period)
            up = (param * 255) // up_len
            down = ((down_len - (param - up_len)) * 255) // down_len
            out = torch.where(param < up_len, up, down)
            # C: guint color; only the >255 side is clamped
            return torch.clamp(out & 0xFFFFFFFF, max=255)

        return self._rgb_map(sol1)


@register_element
class Dilate(_GaudiBase):
    FACTORY = "dilate"
    DESCRIPTION = "Dilate copies the brightest pixel around"
    PROPERTIES = {"erode": (bool, False, "take the darkest instead")}

    def make_fn(self):
        erode = self.props["erode"]

        def shift(x, axis):
            """The neighbour below (axis -2) or to the right (-1), or to
            the left (+1), the pixel itself at the frame's edge."""
            if axis == -2:
                return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
            if axis == -1:
                return torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
            return torch.cat([x[..., :1], x[..., :-1]], dim=-1)

        def fn(planes):
            r, g, b = (p.to(torch.int64) for p in planes[:3])
            lum = 90 * r + 115 * g + 51 * b
            cur = [r, g, b, lum]
            # candidate order: down, right, (up: the reference's guard
            # makes it the pixel itself, a no-op), left; the shifts read
            # the input, not the running maximum
            for axis in (-2, -1, 1):
                nb = [shift(x, axis) for x in (r, g, b, lum)]
                take = (nb[3] < cur[3]) if erode else (nb[3] > cur[3])
                cur = [torch.where(take, n, c) for n, c in zip(nb, cur)]
            dt = planes[0].dtype
            return [c.to(dt) for c in cur[:3]] + list(planes[3:])

        return fn


def gaussian_kernel(sigma: float):
    """make_gaussian_kernel (gstgaussblur.c) in float32: (center, the
    kernel's taps, their running sums)."""
    fs = np.float32(sigma)
    center = int(math.ceil(2.5 * abs(float(fs))))
    win = 1 + 2 * center
    if win == 1:
        kernel = np.ones(1, np.float32)
    else:
        fe = np.float32(-0.5) / (fs * fs)
        dx = np.float32(1.0) / (fs * np.float32(math.sqrt(2 * math.pi)))
        kernel = np.empty(win, np.float32)
        kernel[center] = dx
        for i in range(1, center + 1):
            fx = dx * np.float32(math.e) ** (fe * i * i)
            kernel[center + i] = kernel[center - i] = fx
    return center, kernel, np.cumsum(kernel, dtype=np.float32)


def edge_sums(n: int, center: int, ksum: np.ndarray) -> np.ndarray:
    """(n,) float32: the sum of the taps that fall inside a line of n
    samples, at each position (the edge renormalisation's divisor)."""
    idx = np.arange(n)
    kmin = np.maximum(0, center - idx)
    kmax = np.minimum(len(ksum), n - (idx - center))
    return ksum[kmax - 1] - np.where(kmin > 0, ksum[np.maximum(kmin - 1, 0)],
                                     np.float32(0))


@register_element
class GaussianBlur(TransformElement):
    FACTORY = "gaussianblur"
    DESCRIPTION = "Perform Gaussian blur/sharpen on a video"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _AYUV_CAPS),
        PadTemplate("src", PadDirection.SRC, _AYUV_CAPS),
    ]
    PROPERTIES = {"sigma": (float, 1.2, "blur (>0) / sharpen (<0)")}

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def make_fn(self):
        sigma = self.props["sigma"]
        if sigma == 0.0:
            return None
        center, kernel, ksum = gaussian_kernel(sigma)
        taps = [float(k) for k in kernel]
        info = self._info
        sums = {ax: torch.as_tensor(edge_sums(n, center, ksum),
                                    device=self.device)
                for ax, n in ((-1, info.width), (-2, info.height))}

        def blur_axis(x, axis):
            n = x.shape[axis]
            pad = (center, center) if axis == -1 else (0, 0, center, center)
            xp = torch.nn.functional.pad(x, pad).to(torch.float64)
            # the first tap's product rounded to float32, then each
            # acc + x * k with a single rounding to float32 (see above)
            acc = (xp.narrow(axis, 0, n) * taps[0]).to(torch.float32)
            for k in range(1, len(taps)):
                acc = torch.add(acc, xp.narrow(axis, k, n),
                                alpha=taps[k]).to(torch.float32)
            s = sums[axis]
            return acc / (s if axis == -1 else s[:, None])

        def fn(planes):
            outs = []
            for p in planes:
                x = p.to(torch.float32)
                x = blur_axis(x, -1)      # rows
                x = blur_axis(x, -2)      # columns
                outs.append(torch.clamp(x + 0.5, 0, 255).to(torch.uint8)
                            .to(p.dtype))
            return outs

        return fn
