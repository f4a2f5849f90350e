"""geometrictransform -- coordinate-remap video effects.

The JAX package's ``elements/geometrictransform.py`` (reference:
gst-plugins-bad/gst/geometrictransform/): each element defines an inverse
map (output pixel -> input coordinate, in float64 like the reference's
gdouble map_func); the base samples with C-truncation nearest lookup and
the ignore/clamp/wrap off-edge modes (gst_geometric_transform_do_map
:179-218; ignore paints AYUV black 0xFF,0x10,0x80,0x80 / zeros for RGB,
:255-263).

The maps and their helpers (``map_xy`` of each element,
``_precalc_circle``, ``gm_mod_float``, the seeded noise tables of marble
and diffuse) are host numpy, copied unchanged, so the maps are identical.
``make_fn`` runs them once per caps and property set and puts the index
planes ``ix``, ``iy`` and the ``valid`` mask on the device then; each tick
is one gather per plane and a ``torch.where``.

Elements: bulge, circle, diffuse, fisheye, kaleidoscope, marble, mirror,
perspective, pinch, rotate, sphere, square, stretch, tunnel, twirl,
waterripple -- the complete family (marble/diffuse use a seeded RNG where
the reference draws from GLib's globally-seeded one).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo

_CAPS = ("video/x-raw, format={ AYUV, ARGB, BGRA, ABGR, RGBA }, "
         "width=[1,32767], height=[1,32767], "
         "framerate=[0/1,2147483647/1]")

MAX_SHRINK_AMOUNT = 3.0            # gststretch.c:75


def gm_mod_float(a, b):
    """geometricmath.c:172 — trunc-based modulo."""
    n = np.trunc(a / b)
    a = a - n * b
    return np.where(a < 0, a + b, a)


def gm_triangle(x):
    r = gm_mod_float(x, 1.0)
    return 2.0 * np.where(r < 0.5, r, 1 - r)


def gm_smoothstep(edge0, edge1, x):
    t = np.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


class GeometricTransform(TransformElement):
    """Base: subclasses implement map_xy(xx, yy, w, h) -> (in_x, in_y)
    float64 arrays."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CAPS),
        PadTemplate("src", PadDirection.SRC, _CAPS),
    ]
    BASE_PROPERTIES = {
        "off-edge-pixels": (str, "ignore", "ignore|clamp|wrap"),
    }

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        merged = dict(GeometricTransform.BASE_PROPERTIES)
        merged.update(getattr(cls, "PROPERTIES", {}))
        cls.PROPERTIES = merged

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def map_xy(self, xx, yy, w, h):
        raise NotImplementedError

    def _precalc_circle(self, w, h):
        """gstcirclegeometrictransform.c:145-155 helper for
        circle-derived subclasses."""
        xc = self.props.get("x-center", 0.5)
        yc = self.props.get("y-center", 0.5)
        radius = self.props.get("radius", 0.35)
        pcx = xc * w
        pcy = yc * h
        pr = radius * 0.5 * math.sqrt(w * w + h * h)
        return xc, yc, radius, pcx, pcy, pr, pr * pr

    def make_fn(self):
        info = self._info
        w, h = info.width, info.height
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        in_x, in_y = self.map_xy(xx, yy, float(w), float(h))
        mode = self.props["off-edge-pixels"]
        if mode == "clamp":
            in_x = np.clip(in_x, 0, w - 1)
            in_y = np.clip(in_y, 0, h - 1)
        elif mode == "wrap":
            in_x = gm_mod_float(in_x, float(w))
            in_y = gm_mod_float(in_y, float(h))
        tx = np.trunc(in_x)
        ty = np.trunc(in_y)
        valid = ((tx >= 0) & (tx < w) & (ty >= 0) & (ty < h))
        ix = np.clip(tx, 0, w - 1).astype(np.int32)
        iy = np.clip(ty, 0, h - 1).astype(np.int32)
        is_rgb = self._info.finfo.is_rgb
        # ignore-mode background: AYUV black / RGB zeros (:255-263), in
        # the canonical plane order (c0, c1, c2, A); AYUV's is (Y, U, V, A)
        black = [0, 0, 0, 0] if is_rgb else [16, 128, 128, 255]
        flat = torch.as_tensor((iy.astype(np.int64) * w + ix).reshape(-1),
                               device=self.device)
        jval = torch.as_tensor(valid, device=self.device)

        def fn(planes):
            outs = []
            for c, p in enumerate(planes):
                sampled = torch.index_select(p.flatten(-2), -1, flat) \
                    .view(p.shape)
                outs.append(torch.where(jval, sampled, black[min(c, 3)])
                            .to(p.dtype))
            return outs

        return fn


@register_element
class Bulge(GeometricTransform):
    FACTORY = "bulge"
    DESCRIPTION = "Adds a protuberance in the center of the image"
    PROPERTIES = {"zoom": (float, 3.0, "zoom at the center"),
                  "x-center": (float, 0.5, ""),
                  "y-center": (float, 0.5, ""),
                  "radius": (float, 0.35, "")}

    def map_xy(self, xx, yy, w, h):
        xc, yc, radius, *_ = self._precalc_circle(w, h)
        zoom = self.props["zoom"]
        nx = 2.0 * (xx / w - xc)
        ny = 2.0 * (yy / h - yc)
        r = np.sqrt(0.5 * (nx * nx + ny * ny))
        scale = 1.0 / (zoom + (1.0 - zoom)
                       * gm_smoothstep(0, radius, r))
        nx *= scale
        ny *= scale
        return (0.5 * nx + xc) * w, (0.5 * ny + yc) * h


@register_element
class CircleGT(GeometricTransform):
    FACTORY = "circle"
    DESCRIPTION = "Warps the picture into an arc shaped form"
    PROPERTIES = {"angle": (float, 0.0, ""),
                  "height": (int, 20, ""),
                  "spread-angle": (float, math.pi, ""),
                  "x-center": (float, 0.5, ""),
                  "y-center": (float, 0.5, ""),
                  "radius": (float, 0.35, "")}

    def map_xy(self, xx, yy, w, h):
        _, _, _, pcx, pcy, pr, _ = self._precalc_circle(w, h)
        dx = xx - pcx
        dy = yy - pcy
        distance = np.sqrt(dx * dx + dy * dy)
        theta = np.arctan2(-dy, -dx) + self.props["angle"]
        theta = gm_mod_float(theta, 2 * math.pi)
        in_x = w * theta / (self.props["spread-angle"] + 0.0001)
        in_y = h * (1 - (distance - pr)
                    / (self.props["height"] + 0.0001))
        return in_x, in_y


@register_element
class Fisheye(GeometricTransform):
    FACTORY = "fisheye"
    DESCRIPTION = "Simulate a fisheye lens by zooming on the center " \
                  "of the image and compressing the edges"
    PROPERTIES = {}

    def map_xy(self, xx, yy, w, h):
        nx = 2.0 * xx / w - 1.0
        ny = 2.0 * yy / h - 1.0
        r = np.sqrt((nx * nx + ny * ny) / 2.0)
        f = 0.33 + 0.1 * r * r + 0.57 * r ** 6.0
        nx *= f
        ny *= f
        return 0.5 * (nx + 1.0) * w, 0.5 * (ny + 1.0) * h


@register_element
class Kaleidoscope(GeometricTransform):
    FACTORY = "kaleidoscope"
    DESCRIPTION = "Applies 'kaleidoscope' geometric transform to the " \
                  "image"
    PROPERTIES = {"angle": (float, 0.0, ""),
                  "angle2": (float, 0.0, ""),
                  "sides": (int, 3, ""),
                  "x-center": (float, 0.5, ""),
                  "y-center": (float, 0.5, ""),
                  "radius": (float, 0.35, "")}

    def map_xy(self, xx, yy, w, h):
        _, _, _, pcx, pcy, pr, _ = self._precalc_circle(w, h)
        angle = self.props["angle"]
        dx = xx - pcx
        dy = yy - pcy
        distance = np.sqrt(dx * dx + dy * dy)
        theta = np.arctan2(dy, dx) - angle - self.props["angle2"]
        theta = gm_triangle(theta / math.pi
                            * self.props["sides"] * 0.5)
        if pr != 0:
            cos_t = np.cos(theta)
            safe = np.abs(cos_t) > 1e-10
            radiusc = pr / np.where(safe, cos_t, 1.0)
            distance = np.where(
                safe, radiusc * gm_triangle(distance / radiusc),
                distance)
        theta = theta + angle
        return (pcx + distance * np.cos(theta),
                pcy + distance * np.sin(theta))


@register_element
class Mirror(GeometricTransform):
    FACTORY = "mirror"
    DESCRIPTION = "Split the image into two halves and reflect one " \
                  "over each other"
    PROPERTIES = {"mode": (str, "left", "left|right|top|bottom")}

    def map_xy(self, xx, yy, w, h):
        mode = self.props["mode"]
        hw = w / 2.0 - 1.0
        hh = h / 2.0 - 1.0
        if mode == "left":
            in_x = np.where(xx > hw, w - 1.0 - xx, xx)
            in_y = yy
        elif mode == "right":
            in_x = np.where(xx > hw, xx, w - 1.0 - xx)
            in_y = yy
        elif mode == "top":
            in_y = np.where(yy > hh, h - 1.0 - yy, yy)
            in_x = xx
        else:
            in_y = np.where(yy > hh, yy, h - 1.0 - yy)
            in_x = xx
        return in_x, in_y


@register_element
class Perspective(GeometricTransform):
    FACTORY = "perspective"
    DESCRIPTION = "Apply a 2D perspective transform"
    PROPERTIES = {"matrix": (object, None, "9-element 3x3 matrix")}

    def map_xy(self, xx, yy, w, h):
        m = self.props["matrix"]
        m = ([1, 0, 0, 0, 1, 0, 0, 0, 1] if m is None
             else [float(v) for v in m])
        xp = m[0] * xx + m[1] * yy + m[2]
        yp = m[3] * xx + m[4] * yy + m[5]
        wp = m[6] * xx + m[7] * yy + m[8]
        return xp / wp, yp / wp


@register_element
class Pinch(GeometricTransform):
    FACTORY = "pinch"
    DESCRIPTION = "Applies 'pinch' geometric transform to the image"
    PROPERTIES = {"intensity": (float, 0.5, ""),
                  "x-center": (float, 0.5, ""),
                  "y-center": (float, 0.5, ""),
                  "radius": (float, 0.35, "")}

    def map_xy(self, xx, yy, w, h):
        _, _, _, pcx, pcy, _, pr2 = self._precalc_circle(w, h)
        dx = xx - pcx
        dy = yy - pcy
        distance = dx * dx + dy * dy
        inside = (distance <= pr2) & (distance != 0)
        d = np.sqrt(np.where(distance > 0, distance, 1.0) / pr2)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.sin(math.pi * 0.5 * d) ** -self.props["intensity"]
        t = np.nan_to_num(t, posinf=0.0)    # masked by `inside` anyway
        in_x = np.where(inside, pcx + dx * t, xx)
        in_y = np.where(inside, pcy + dy * t, yy)
        return in_x, in_y


@register_element
class Rotate(GeometricTransform):
    FACTORY = "rotate"
    DESCRIPTION = "Rotates the picture by an arbitrary angle"
    PROPERTIES = {"angle": (float, 0.0, "radians")}

    def map_xy(self, xx, yy, w, h):
        ar = self.props["angle"]
        cox, coy = 0.5 * int(w), 0.5 * int(h)
        xo = xx - cox
        yo = yy - coy
        ao = np.arctan2(yo, xo) + ar
        r = np.sqrt(xo * xo + yo * yo)
        return r * np.cos(ao) + cox, r * np.sin(ao) + coy


@register_element
class Sphere(GeometricTransform):
    FACTORY = "sphere"
    DESCRIPTION = "Applies 'sphere' geometric transform to the image"
    PROPERTIES = {"refraction": (float, 1.5, ""),
                  "x-center": (float, 0.5, ""),
                  "y-center": (float, 0.5, ""),
                  "radius": (float, 0.35, "")}

    def map_xy(self, xx, yy, w, h):
        _, _, _, pcx, pcy, _, pr2 = self._precalc_circle(w, h)
        dx = xx - pcx
        dy = yy - pcy
        dx2 = dx * dx
        dy2 = dy * dy
        outside = dy2 >= (pr2 - (pr2 * dx2) / pr2)
        rr = 1.0 / self.props["refraction"]
        inside_term = np.where(outside, 0.25,
                               1.0 - dx2 / pr2 - dy2 / pr2)
        z = np.sqrt(np.maximum(inside_term, 0.0) * pr2)
        z2 = z * z

        def refract(d, d2):
            angle = np.arccos(np.clip(
                d / np.sqrt(np.maximum(d2 + z2, 1e-30)), -1, 1))
            a1 = math.pi / 2 - angle
            a2 = np.arcsin(np.clip(np.sin(a1) * rr, -1, 1))
            a2 = math.pi / 2 - angle - a2
            return np.tan(a2) * z

        in_x = np.where(outside, xx, xx - refract(dx, dx2))
        in_y = np.where(outside, yy, yy - refract(dy, dy2))
        return in_x, in_y


@register_element
class Square(GeometricTransform):
    FACTORY = "square"
    DESCRIPTION = "Distort center part of the image into a square"
    PROPERTIES = {"width": (float, 0.5, ""),
                  "height": (float, 0.5, ""),
                  "zoom": (float, 2.0, "")}

    def map_xy(self, xx, yy, w, h):
        sw = self.props["width"]
        sh = self.props["height"]
        zoom = self.props["zoom"]
        nx = 2.0 * xx / w - 1.0
        ny = 2.0 * yy / h - 1.0
        nx = nx * (1.0 / zoom) * (1.0 + (zoom - 1.0) * gm_smoothstep(
            sw - 0.125, sw + 0.125, np.abs(nx)))
        ny = ny * (1.0 / zoom) * (1.0 + (zoom - 1.0) * gm_smoothstep(
            sh - 0.125, sh + 0.125, np.abs(ny)))
        return 0.5 * (nx + 1.0) * w, 0.5 * (ny + 1.0) * h


@register_element
class Stretch(GeometricTransform):
    FACTORY = "stretch"
    DESCRIPTION = "Stretch the image in a circle around the center " \
                  "point"
    PROPERTIES = {"intensity": (float, 0.5, ""),
                  "x-center": (float, 0.5, ""),
                  "y-center": (float, 0.5, ""),
                  "radius": (float, 0.35, "")}

    def map_xy(self, xx, yy, w, h):
        xc, yc, radius, *_ = self._precalc_circle(w, h)
        nx = 2.0 * (xx / w - xc)
        ny = 2.0 * (yy / h - yc)
        r = np.sqrt(0.5 * (nx * nx + ny * ny))
        a = 1.0 + (MAX_SHRINK_AMOUNT - 1.0) * self.props["intensity"]
        b = a - 1.0
        f = a - b * gm_smoothstep(0.0, radius, r)
        nx *= f
        ny *= f
        return (0.5 * nx + xc) * w, (0.5 * ny + yc) * h


@register_element
class Tunnel(GeometricTransform):
    FACTORY = "tunnel"
    DESCRIPTION = "Light tunnel effect"
    PROPERTIES = {"x-center": (float, 0.5, ""),
                  "y-center": (float, 0.5, ""),
                  "radius": (float, 0.35, "")}

    def map_xy(self, xx, yy, w, h):
        xc, yc, radius, *_ = self._precalc_circle(w, h)
        m = max(w, h)
        nx = 2.0 * (xx - xc * w) / m
        ny = 2.0 * (yy - yc * h) / m
        r = np.sqrt(0.5 * (nx * nx + ny * ny))
        f = np.clip(r, 0.0, radius) / np.where(r == 0, 1.0, r)
        nx *= f
        ny *= f
        return (0.5 * nx * m + xc * w, 0.5 * ny * m + yc * h)


@register_element
class Twirl(GeometricTransform):
    FACTORY = "twirl"
    DESCRIPTION = "Twists the image from the center out"
    PROPERTIES = {"angle": (float, math.pi, ""),
                  "x-center": (float, 0.5, ""),
                  "y-center": (float, 0.5, ""),
                  "radius": (float, 0.35, "")}

    def map_xy(self, xx, yy, w, h):
        _, _, _, pcx, pcy, pr, pr2 = self._precalc_circle(w, h)
        dx = xx - pcx
        dy = yy - pcy
        distance = dx * dx + dy * dy
        inside = distance <= pr2
        d = np.sqrt(distance)
        a = np.arctan2(dy, dx) + self.props["angle"] * (pr - d) / pr
        in_x = np.where(inside, pcx + d * np.cos(a), xx)
        in_y = np.where(inside, pcy + d * np.sin(a), yy)
        return in_x, in_y


@register_element
class WaterRipple(GeometricTransform):
    FACTORY = "waterripple"
    DESCRIPTION = "Creates a water ripple effect on the image"
    PROPERTIES = {"amplitude": (float, 10.0, ""),
                  "phase": (float, 0.0, ""),
                  "wavelength": (float, 16.0, ""),
                  "x-center": (float, 0.5, ""),
                  "y-center": (float, 0.5, ""),
                  "radius": (float, 0.35, "")}

    def map_xy(self, xx, yy, w, h):
        _, _, _, pcx, pcy, pr, pr2 = self._precalc_circle(w, h)
        amp = self.props["amplitude"]
        wl = self.props["wavelength"]
        phase = self.props["phase"]
        dx = xx - pcx
        dy = yy - pcy
        distance = dx * dx + dy * dy
        inside = distance <= pr2
        d = np.sqrt(distance)
        amount = amp * np.sin(d / wl * math.pi * 2 - phase)
        amount = amount * (pr - d) / pr
        amount = np.where(d != 0, amount * (wl / np.where(
            d == 0, 1.0, d)), amount)
        in_x = np.where(inside, xx + dx * amount, xx)
        in_y = np.where(inside, yy + dy * amount, yy)
        return in_x, in_y


# ---------------------------------------------------------------------------
# Noise-driven members (geometricmath.c Perlin noise).  The reference
# seeds its tables from GLib's global RNG (nondeterministic per run);
# here a `seed` property (default 0) makes runs reproducible.
# ---------------------------------------------------------------------------

class _GMNoise:
    """gst_gm_noise_new/gst_gm_noise_2 (geometricmath.c:1-166)."""

    B = 0x100
    N = 0x1000

    def __init__(self, rng: np.random.Generator):
        B = self.B
        self.p = np.zeros(2 * B + 2, np.int64)
        self.g2 = np.zeros((2 * B + 2, 2), np.float64)
        for i in range(B):
            self.p[i] = i
            v = (rng.integers(0, 2 ** 32, 2) % (2 * B) - B) / B
            n = math.sqrt(v[0] * v[0] + v[1] * v[1]) or 1.0
            self.g2[i] = v / n
        for i in range(B - 1, -1, -1):
            j = int(rng.integers(0, 2 ** 32) % B)
            self.p[i], self.p[j] = self.p[j], self.p[i]
        for i in range(B + 2):
            self.p[B + i] = self.p[i]
            self.g2[B + i] = self.g2[i]

    def noise_2(self, x, y):
        """Vectorized gst_gm_noise_2."""
        B, N = self.B, self.N
        BM = B - 1

        def split(t):
            t = t + N
            b0 = np.trunc(t).astype(np.int64) & BM
            r0 = t - np.trunc(t)
            return b0, (b0 + 1) & BM, r0, r0 - 1.0

        bx0, bx1, rx0, rx1 = split(np.asarray(x, np.float64))
        by0, by1, ry0, ry1 = split(np.asarray(y, np.float64))
        i = self.p[bx0]
        j = self.p[bx1]
        b00 = self.p[i + by0]
        b10 = self.p[j + by0]
        b01 = self.p[i + by1]
        b11 = self.p[j + by1]
        sx = rx0 * rx0 * (3.0 - 2.0 * rx0)
        sy = ry0 * ry0 * (3.0 - 2.0 * ry0)
        u = rx0 * self.g2[b00, 0] + ry0 * self.g2[b00, 1]
        v = rx1 * self.g2[b10, 0] + ry0 * self.g2[b10, 1]
        a = u + sx * (v - u)
        u = rx0 * self.g2[b01, 0] + ry1 * self.g2[b01, 1]
        v = rx1 * self.g2[b11, 0] + ry1 * self.g2[b11, 1]
        b = u + sx * (v - u)
        return 1.5 * (a + sy * (b - a))


@register_element
class Marble(GeometricTransform):
    FACTORY = "marble"
    DESCRIPTION = "Applies a marbling effect to the image"
    PROPERTIES = {"x-scale": (float, 4.0, "texture x scale"),
                  "y-scale": (float, 4.0, "displacement amount"),
                  "amount": (float, 1.0, ""),
                  "turbulence": (float, 1.0, ""),
                  "seed": (int, 0, "noise seed (reference: global RNG)")}

    def map_xy(self, xx, yy, w, h):
        noise = _GMNoise(np.random.default_rng(self.props["seed"]))
        i = np.arange(256)
        angle = (math.pi * 2 * i) / 256.0 * self.props["turbulence"]
        sin_t = -self.props["y-scale"] * np.sin(angle)
        cos_t = self.props["y-scale"] * np.cos(angle)
        xs = self.props["x-scale"]
        # the reference divides BOTH axes by x-scale (gstmarble.c:217)
        disp = 127 * (1 + noise.noise_2(xx / xs, yy / xs))
        disp = np.clip(np.trunc(disp), 0, 255).astype(np.int64)
        return xx + sin_t[disp], yy + cos_t[disp]


@register_element
class Diffuse(GeometricTransform):
    FACTORY = "diffuse"
    DESCRIPTION = "Diffuses the image by moving its pixels in random " \
                  "directions"
    PROPERTIES = {"scale": (float, 4.0, "displacement scale"),
                  "seed": (int, 0, "noise seed (reference: global RNG)")}

    def map_xy(self, xx, yy, w, h):
        rng = np.random.default_rng(self.props["seed"])
        i = np.arange(256)
        angle = (math.pi * 2 * i) / 256.0
        sin_t = self.props["scale"] * np.sin(angle)
        cos_t = self.props["scale"] * np.cos(angle)
        ang = rng.integers(0, 256, xx.shape)
        dist = rng.random(xx.shape)
        return xx + dist * sin_t[ang], yy + dist * cos_t[ang]
