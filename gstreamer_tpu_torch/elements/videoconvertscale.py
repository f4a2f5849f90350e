"""videoconvert / videoscale / videoconvertscale elements.

Copies of the JAX package's ``elements/videoconvertscale.py`` (reference:
subprojects/gst-plugins-base/gst/videoconvertscale/gstvideoconvertscale.c
— transform_caps removes format/size/colorimetry and rangifies :751,
fixate_caps preserves PAR and picks nearest size :1931, set_info builds a
GstVideoConverter :906, transform_frame :1981).

The element is a thin negotiation shell around this package's
:class:`~gstreamer_tpu_torch.video.converter.VideoConverter`, built on the
pipeline's device; its compute is the converter's ``convert``.  On a size
change the buffer's metas go through their registered "scale" transforms
(``core/meta.py``: a crop meta scales with the frame, a strided video meta
is dropped), as in the reference.
"""

from __future__ import annotations

from typing import Optional

from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.value import IntRange, fixate_nearest_int
from ..video import scaler as scaler_mod
from ..video.converter import VideoConverter
from ..video.format import FORMATS
from ..video.info import VideoInfo

# videotestsrc.py's FORMAT_LIST (the template format list of raw video)
FORMAT_LIST = "{ " + ", ".join(sorted(FORMATS)) + " }"

VIDEO_CAPS = (f"video/x-raw, format={FORMAT_LIST}, width=[1,32767], "
              f"height=[1,32767], framerate=[0/1,2147483647/1]")

# videoscale method property mapping (gstvideoconvertscale.c:995-1060)
SCALE_METHODS = {
    "nearest-neighbour": (scaler_mod.METHOD_NEAREST, 0),
    "bilinear": (scaler_mod.METHOD_LINEAR, 2),
    "4-tap": (scaler_mod.METHOD_SINC, 4),
    "lanczos": (scaler_mod.METHOD_LANCZOS, 0),
    "bilinear2": (scaler_mod.METHOD_LINEAR, 0),
    "sinc": (scaler_mod.METHOD_SINC, 0),
    "hermite": (scaler_mod.METHOD_CUBIC, 0),    # b=0,c=0
    "spline": (scaler_mod.METHOD_CUBIC, 0),     # b=1,c=0
    "catrom": (scaler_mod.METHOD_CUBIC, 0),     # b=0,c=1/2
    "mitchell": (scaler_mod.METHOD_CUBIC, 0),   # b=c=1/3
}
CUBIC_BC = {"hermite": (0.0, 0.0), "spline": (1.0, 0.0),
            "catrom": (0.0, 0.5), "mitchell": (1 / 3, 1 / 3)}


class _ConvertScaleBase(TransformElement):
    """Shared negotiation logic (GstVideoConvertScale base class)."""

    CONVERT_FORMAT = True      # element may change format/colorimetry
    CONVERT_SIZE = True        # element may change width/height/PAR

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, VIDEO_CAPS),
        PadTemplate("src", PadDirection.SRC, VIDEO_CAPS),
    ]
    PROPERTIES = {
        "method": (str, "bilinear", "scaling method"),
        "add-borders": (bool, True, "add black borders to keep DAR"),
        "dither": (str, "bayer", "dither method for 16->8"),
        "chroma-mode": (str, "full", ""),
        "matrix-mode": (str, "full", ""),
        "n-threads": (int, 0, "ignored (one CUDA stream)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._converter: Optional[VideoConverter] = None
        self._passthrough = False

    # transform_caps (gstvideoconvertscale.c:751): drop the convertible
    # fields and rangify sizes
    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            ns = s.copy()
            if self.CONVERT_FORMAT:
                ns.fields.pop("format", None)
                ns.fields.pop("colorimetry", None)
                ns.fields.pop("chroma-site", None)
                ns["format"] = Caps.from_string(VIDEO_CAPS)[0]["format"]
            if self.CONVERT_SIZE:
                ns["width"] = IntRange(1, 32767)
                ns["height"] = IntRange(1, 32767)
                ns.fields.pop("pixel-aspect-ratio", None)
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    # fixate_caps (gstvideoconvertscale.c:1931): keep input values where
    # the field is unconstrained downstream; nearest size otherwise
    def fixate_caps(self, direction, caps, othercaps):
        s_in = caps[0]
        out = othercaps.truncate()[0].copy()
        for key in ("format", "colorimetry", "chroma-site"):
            if key in s_in and key in out.fields:
                from ..core.value import intersect as _int
                r = _int(out[key], s_in[key])
                if r is not None:
                    out[key] = r
            elif key in s_in:
                out[key] = s_in[key]
        for key in ("width", "height"):
            target = s_in.get(key)
            if target is not None and key in out.fields:
                out[key] = fixate_nearest_int(out[key], target)
        if "framerate" in s_in:
            out["framerate"] = s_in["framerate"]
        return Caps([out]).fixate()

    def set_info(self, incaps, outcaps):
        in_info = VideoInfo.from_caps_structure(incaps[0])
        out_info = VideoInfo.from_caps_structure(outcaps[0])
        self._passthrough = (incaps == outcaps)
        if self._passthrough:
            self._converter = None
            return
        method_name = self.props["method"]
        method, taps = SCALE_METHODS.get(method_name,
                                         (scaler_mod.METHOD_LINEAR, 2))
        cfg = {
            "resampler-method": method,
            "resampler-taps": taps,
            "chroma-mode": self.props["chroma-mode"],
            "matrix-mode": self.props["matrix-mode"],
            "dither-method": self.props["dither"],
        }
        if method_name in CUBIC_BC:
            b, c = CUBIC_BC[method_name]
            cfg["cubic-b"], cfg["cubic-c"] = b, c
        # add-borders: keep display aspect ratio with symmetric borders
        # (gstvideoconvertscale.c:932-949 border calc, :1068 DEST_* opts)
        if self.props.get("add-borders", True):
            from_dar = (in_info.width * in_info.par.num,
                        in_info.height * in_info.par.denom)
            to_dar = (out_info.width * out_info.par.num,
                      out_info.height * out_info.par.denom)
            if from_dar[0] * to_dar[1] != to_dar[0] * from_dar[1]:
                n = from_dar[0] * out_info.par.denom
                d = from_dar[1] * out_info.par.num
                to_h = out_info.width * d // n
                if to_h <= out_info.height:
                    bw, bh = 0, out_info.height - to_h
                else:
                    to_w = out_info.height * n // d
                    bw, bh = out_info.width - to_w, 0
                if bw or bh:
                    cfg.update({
                        "dest-x": bw // 2, "dest-y": bh // 2,
                        "dest-width": out_info.width - bw,
                        "dest-height": out_info.height - bh,
                    })
        self._converter = VideoConverter(in_info, out_info, cfg,
                                         device=self.device)

    def make_fn(self):
        if self._passthrough or self._converter is None:
            return None
        return self._converter.convert

    def process_meta(self, buf):
        # geometry changed: run registered meta transforms (crop meta
        # scales with the frame, strided video meta drops --
        # gstvideometa.c transform functions)
        if self._converter is None:
            return buf
        from ..core.meta import transform_metas
        ii, oi = self._converter.in_info, self._converter.out_info
        if buf.meta and (ii.width, ii.height) != (oi.width, oi.height):
            return transform_metas(buf, "scale",
                                   in_size=(ii.width, ii.height),
                                   out_size=(oi.width, oi.height))
        return buf


@register_element
class VideoConvert(_ConvertScaleBase):
    FACTORY = "videoconvert"
    DESCRIPTION = "Colorspace converter"
    CONVERT_FORMAT = True
    CONVERT_SIZE = False


@register_element
class VideoScale(_ConvertScaleBase):
    FACTORY = "videoscale"
    DESCRIPTION = "Video scaler"
    CONVERT_FORMAT = False
    CONVERT_SIZE = True


@register_element
class VideoConvertScale(_ConvertScaleBase):
    FACTORY = "videoconvertscale"
    DESCRIPTION = "Colorspace converter and scaler"
    CONVERT_FORMAT = True
    CONVERT_SIZE = True
