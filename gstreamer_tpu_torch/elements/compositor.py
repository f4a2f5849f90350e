"""compositor / videomixer — N:1 video mixing, in torch.

A port of the JAX package's ``elements/compositor.py`` (reference:
subprojects/gst-plugins-base/gst/compositor/compositor.c — per-pad
xpos/ypos/width/height/alpha/zorder/operator :128-136, background
_draw_background :1619, aggregate_frames :1739; blend math blend.c:247
PLANAR_YUV_BLEND + compositororc.orc:20,295; base class
gstvideoaggregator.c — per-pad convert :436,479) on the GstAggregator
pattern (gstaggregator.c:1626 aggregate).

Negotiation and the per-pad plan are copies.  A pad whose format, size or
colorimetry differs from the output converts through its own
:class:`~gstreamer_tpu_torch.video.converter.VideoConverter`, built on the
pipeline's device (so a scaled 4:2:0 pad runs the yscale and chroma420
kernels).  The blends are plain torch on the device, as they are plain XLA
in the reference:

* an output without alpha is assembled plane by plane at each plane's own
  resolution: the geometry cuts the plane into bands and segments, each
  segment is the zorder fold of the pads that cover it (an opaque or
  ``source`` pad copies, a pad at alpha 0 is skipped, others blend with
  ``blend_u8``), and ``torch.cat`` joins them, so every output byte is
  written once;
* an output with alpha blends in canonical 4:4:4 int32 with the OVER, ADD
  or SOURCE operator, then packs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, register_element)
from ..core.value import Fraction, fixate_nearest_int
from ..core.value import intersect as _intersect
from ..ops import blend as blend_ops
from ..video.converter import VideoConverter
from ..video.format import pack, plane_shapes, unpack
from ..video.info import VideoInfo
from .videotestsrc import FORMAT_LIST

VIDEO_CAPS = (f"video/x-raw, format={FORMAT_LIST}, width=[1,32767], "
              f"height=[1,32767], framerate=[0/1,2147483647/1]")

PAD_PROP_DEFAULTS = {
    "xpos": 0, "ypos": 0, "width": 0, "height": 0,
    "alpha": 1.0, "zorder": 0, "operator": "over",
    "sizing-policy": "none",
}


def _alpha_u8(alpha: float) -> int:
    """The pad alpha as the reference maps it: int(alpha * 255) on the
    Python float, clamped to 0..255."""
    return max(0, min(255, int(alpha * 255)))


@register_element
class Compositor(AggregatorElement):
    FACTORY = "compositor"
    KLASS = "Filter/Editor/Video/Compositor"
    DESCRIPTION = "Composite multiple video streams"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, VIDEO_CAPS),
        PadTemplate("sink_%u", PadDirection.SINK, VIDEO_CAPS,
                    PadPresence.REQUEST),
    ]
    PROPERTIES = {
        "background": (str, "checker", "checker|black|white|transparent"),
        "zero-size-is-unscaled": (bool, True, ""),
    }

    def __init__(self, name=None, **props):
        pad_props = {}
        for k in list(props):
            if "::" in k:
                padname, prop = k.split("::", 1)
                pad_props.setdefault(padname, {})[prop] = props.pop(k)
        super().__init__(name=name, **props)
        self.pad_props: Dict[str, Dict] = {}
        for padname, d in pad_props.items():
            for prop, val in d.items():
                self.set_pad_property(padname, prop, val)

    def set_pad_property(self, padname: str, prop: str, value):
        d = self.pad_props.setdefault(padname, dict(PAD_PROP_DEFAULTS))
        if prop not in PAD_PROP_DEFAULTS:
            raise ValueError(f"compositor pad: no property {prop!r}")
        typ = type(PAD_PROP_DEFAULTS[prop])
        if isinstance(value, str) and typ is not str:
            value = typ(float(value)) if typ is not bool else value == "true"
        d[prop] = value

    def get_pad_props(self, padname: str) -> Dict:
        return self.pad_props.get(padname, dict(PAD_PROP_DEFAULTS))

    # -- negotiation -------------------------------------------------------
    def negotiate_output(self, in_caps: Dict[str, Caps], allowed: Caps) -> Caps:
        infos = {name: VideoInfo.from_caps_structure(c[0])
                 for name, c in in_caps.items()}
        # output geometry: bounding box of all pads (compositor
        # _fixate_caps: max(xpos + width), max(ypos + height))
        out_w = out_h = 0
        best_fps = None
        for name, info in infos.items():
            pp = self.get_pad_props(name)
            w = pp["width"] or info.width
            h = pp["height"] or info.height
            out_w = max(out_w, pp["xpos"] + w)
            out_h = max(out_h, pp["ypos"] + h)
            if best_fps is None:
                best_fps = info.fps
        first = next(iter(infos.values()))
        s = allowed.truncate()[0].copy() if not allowed.is_any else \
            Caps.from_string(VIDEO_CAPS)[0].copy()
        if "format" in s.fields:
            r = _intersect(s["format"], first.format)
            s["format"] = r if r is not None else s["format"]
        if "width" in s.fields:
            s["width"] = fixate_nearest_int(s["width"], out_w)
        if "height" in s.fields:
            s["height"] = fixate_nearest_int(s["height"], out_h)
        s["framerate"] = best_fps or Fraction(30)
        out = Caps([s]).fixate()

        self._out_info = VideoInfo.from_caps_structure(out[0])
        self._in_infos = infos
        self._build_plan()
        return out

    def _build_plan(self):
        """Each pad's clipped rectangle and, where its frames differ from
        the output's, a converter on the element's device."""
        oi = self._out_info
        self._converters = {}
        self._geometry = {}
        for name, info in self._in_infos.items():
            pp = self.get_pad_props(name)
            w = pp["width"] or info.width
            h = pp["height"] or info.height
            # clip to output frame
            x0, y0 = pp["xpos"], pp["ypos"]
            x1, y1 = min(x0 + w, oi.width), min(y0 + h, oi.height)
            if x0 >= x1 or y0 >= y1:
                self._geometry[name] = None
                continue
            pad_oi = VideoInfo(format=oi.format, width=w, height=h,
                               fps=info.fps, colorimetry=oi.colorimetry,
                               chroma_site=oi.chroma_site)
            conv = None
            if (info.format != oi.format or info.width != w
                    or info.height != h
                    or info.colorimetry != oi.colorimetry):
                conv = VideoConverter(info, pad_oi, device=self.device)
            self._converters[name] = conv
            self._geometry[name] = (x0, y0, x1, y1)

    # -- compute -----------------------------------------------------------
    def aggregate_fn(self):
        oi = self._out_info
        ofmt = oi.finfo
        order = sorted(self._in_infos,
                       key=lambda n: self.get_pad_props(n)["zorder"])
        conv_fns = {n: (c.convert if c is not None else None)
                    for n, c in self._converters.items()}
        if not ofmt.has_alpha:
            # per-plane path (the reference's actual structure: blend.c
            # blends each plane at its own resolution; the canonical 4:4:4
            # int32 staging below is needed only for per-pixel-alpha ops)
            return self._plane_fn(oi, ofmt, order, conv_fns)
        bg = torch.as_tensor(self._bg_canon(oi, ofmt), device=self.device)

        def fn(inputs):
            # inputs: dict padname -> planes of that pad's caps
            batch = tuple(next(iter(inputs.values()))[0].shape[:-2])
            out = bg.expand(batch + tuple(bg.shape)).clone()
            for name in order:
                if self._geometry.get(name) is None or name not in inputs:
                    continue
                planes = inputs[name]
                if conv_fns[name] is not None:
                    planes = conv_fns[name](planes)
                pp = self.get_pad_props(name)
                x0, y0, x1, y1 = self._geometry[name]
                w, h = x1 - x0, y1 - y0
                # the source frame in canonical 4:4:4; the final pack
                # re-subsamples chroma like the reference's per-plane
                # blends at plane resolution
                src = unpack(torch, ofmt, planes,
                             pp["width"] or self._in_infos[name].width,
                             pp["height"] or self._in_infos[name].height)
                src = src[..., :h, :w, :].to(torch.int32)
                op = pp["operator"]
                if op == "source":
                    blended = src
                else:
                    blend = (blend_ops.overlay_argb_addition if op == "add"
                             else blend_ops.overlay_argb)
                    blended = blend(out[..., y0:y1, x0:x1, :], src,
                                    _alpha_u8(pp["alpha"]))
                out[..., y0:y1, x0:x1, :] = blended
            return pack(torch, ofmt, out, oi.width, oi.height)

        return fn

    def _bg_canon(self, oi, ofmt) -> np.ndarray:
        """The background in canonical (H, W, 4) int32 (A, c0, c1, c2), as
        the reference draws it for the alpha path."""
        background = self.props["background"]
        h, w = oi.height, oi.width
        if background == "checker":
            yy, xx = np.mgrid[0:h, 0:w]
            val = np.array([80, 160, 80, 160])[((yy & 8) >> 3)
                                               + ((xx & 8) >> 3)]
            if ofmt.is_rgb:
                canon = np.stack([np.full_like(val, 255), val, val, val], -1)
            else:
                canon = np.stack([np.full_like(val, 255), val,
                                  np.full_like(val, 128),
                                  np.full_like(val, 128)], -1)
        else:
            if background == "white":
                c0 = (255, 255, 255, 255) if ofmt.is_rgb else (255, 255, 128,
                                                               128)
            elif background == "transparent":
                c0 = (0, 0, 0, 0) if ofmt.is_rgb else (0, 16, 128, 128)
            else:  # black
                c0 = (255, 0, 0, 0) if ofmt.is_rgb else (255, 16, 128, 128)
            canon = np.broadcast_to(np.array(c0), (h, w, 4))
        return np.ascontiguousarray(canon, dtype=np.int32)

    def _bg_plane(self, ofmt, ci: int, shape) -> np.ndarray:
        """Component plane `ci` of the background, uint8, as the reference
        draws it for the per-plane path."""
        background = self.props["background"]
        ph, pw = shape
        first = ofmt.is_rgb or ci == 0
        if background == "checker":
            if not first:
                return np.full((ph, pw), 128, np.uint8)
            yy, xx = np.mgrid[0:ph, 0:pw]
            tab = np.array([80, 160, 80, 160], np.uint8)
            return np.ascontiguousarray(
                tab[((yy & 8) >> 3) + ((xx & 8) >> 3)], dtype=np.uint8)
        if background == "white":
            v = 255 if first else 128
        else:                               # black, transparent
            v = 0 if ofmt.is_rgb else (16 if ci == 0 else 128)
        return np.full((ph, pw), v, np.uint8)

    def _plane_fn(self, oi, ofmt, order, conv_fns):
        """Non-alpha aggregate: blend each component plane at its own
        subsampled resolution (blend.c PLANAR_YUV_BLEND semantics;
        alpha==1.0 is the reference's memcpy fast case)."""
        shapes = plane_shapes(ofmt, oi.width, oi.height)
        subs = [(ofmt.w_sub[c], ofmt.h_sub[c]) for c in range(len(shapes))]
        bgs = [torch.as_tensor(self._bg_plane(ofmt, ci, shape),
                               device=self.device)
               for ci, shape in enumerate(shapes)]

        def fn(inputs):
            present = []
            converted = {}
            for name in order:
                if self._geometry.get(name) is None or name not in inputs:
                    continue
                if self.get_pad_props(name)["alpha"] == 0.0:
                    continue
                planes = inputs[name]
                if conv_fns[name] is not None:
                    planes = conv_fns[name](planes)
                converted[name] = planes
                present.append(name)
            batch = tuple(next(iter(inputs.values()))[0].shape[:-2])
            outs = []
            for ci, (ph_out, pw_out) in enumerate(shapes):
                ws, hs = subs[ci]
                rects = {}
                for name in present:
                    x0, y0, x1, y1 = self._geometry[name]
                    px0, py0 = x0 >> ws, y0 >> hs
                    pw, ph = (x1 - x0) >> ws, (y1 - y0) >> hs
                    if pw > 0 and ph > 0:
                        rects[name] = (px0, py0, px0 + pw, py0 + ph)

                def background(yb0, yb1, xb0, xb1):
                    return bgs[ci][yb0:yb1, xb0:xb1].expand(
                        batch + (yb1 - yb0, xb1 - xb0))

                ys = sorted({0, ph_out}
                            | {r[1] for r in rects.values()}
                            | {r[3] for r in rects.values()})
                ys = [y for y in ys if 0 <= y <= ph_out]
                bands = []
                for yb0, yb1 in zip(ys, ys[1:]):
                    if yb1 <= yb0:
                        continue
                    spans = [r for r in rects.values()
                             if r[1] <= yb0 and r[3] >= yb1]
                    xs = sorted({0, pw_out} | {r[0] for r in spans}
                                | {r[2] for r in spans})
                    xs = [x for x in xs if 0 <= x <= pw_out]
                    segs = []
                    for xb0, xb1 in zip(xs, xs[1:]):
                        if xb1 <= xb0:
                            continue
                        val = None          # background only when needed
                        for name in present:
                            r = rects.get(name)
                            if (r is None or r[0] > xb0 or r[2] < xb1
                                    or r[1] > yb0 or r[3] < yb1):
                                continue
                            src = converted[name][ci][
                                ..., yb0 - r[1]:yb1 - r[1],
                                xb0 - r[0]:xb1 - r[0]]
                            pp = self.get_pad_props(name)
                            if (pp["operator"] == "source"
                                    or pp["alpha"] == 1.0):
                                val = src.to(torch.uint8)
                            else:
                                if val is None:
                                    val = background(yb0, yb1, xb0, xb1)
                                val = blend_ops.blend_plane(
                                    val.to(torch.int32), src.to(torch.int32),
                                    _alpha_u8(pp["alpha"])).to(torch.uint8)
                        if val is None:
                            val = background(yb0, yb1, xb0, xb1)
                        segs.append(val)
                    bands.append(segs[0] if len(segs) == 1
                                 else torch.cat(segs, dim=-1))
                plane = (bands[0] if len(bands) == 1
                         else torch.cat(bands, dim=-2))
                outs.append(plane.contiguous())
            return tuple(outs)

        return fn


@register_element
class VideoMixer(Compositor):
    """videomixer (gst-plugins-good/gst/videomixer): the legacy N:1 mixer
    — same pad properties and blend math as compositor."""
    FACTORY = "videomixer"
    DESCRIPTION = "Mix multiple video streams (legacy alias of compositor)"
