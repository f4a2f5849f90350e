"""Image and vector overlay family: gdkpixbufdec, gdkpixbufoverlay,
cairooverlay, qroverlay, debugqroverlay, gdkpixbufsink, rsvgdec,
rsvgoverlay.

The JAX package's ``elements/pixbuf_overlay.py`` (references:
gst-plugins-good/ext/gdk_pixbuf/, ext/cairo/gstcairooverlay.c,
gst-plugins-bad/ext/qroverlay/, ext/rsvg/):

* ``decode_image``: PNG and JPEG through this package's codecs (the JPEG's
  4:2:0 planes to RGB with the float64 full-range matrix, on the host),
  other formats through Pillow, as the reference wraps gdk-pixbuf's loaders;
* the overlays build their VideoOverlayComposition on the host, per frame
  as the reference does (its positions, alpha, QR payloads and JSON), and
  blend it on the buffer's device with video-blend.c's integer math
  (``video/overlay.py``): the batch is unpacked once, each run of frames
  that carry the same composition is blended in one call, and the batch is
  packed.  The reference takes every frame to the host and blends it with
  numpy; the bytes are the same.  A composition that does not change is
  kept, so its rectangle is scaled and uploaded once;
* gdkpixbufsink posts a "pixbuf" element message per frame with the RGB(A)
  array on the host and keeps ``last_pixbuf``;
* rsvgdec / rsvgoverlay rasterise the reference's reduced SVG subset
  (rect, circle, ellipse, line, polygon, polyline, text with hex or named
  colours) with Pillow: the reference's reduction of librsvg, copied.
"""

from __future__ import annotations

import io
import json
import re
import xml.etree.ElementTree as ET
from typing import Callable, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            TransformElement, register_element)
from ..device import resolve
from ..ops.qrencode import qr_encode
from ..video.info import VideoInfo
from ..video.overlay import (VideoOverlayComposition, VideoOverlayRectangle,
                             blend_planes, runs)

VIDEO_CAPS = ("video/x-raw, format={ I420, Y444, RGB, RGBA, BGRx, "
              "RGBx, AYUV, NV12 }, width=[1,32767], height=[1,32767], "
              "framerate=[0/1,2147483647/1]")


def decode_image(data: bytes) -> np.ndarray:
    """Decode an encoded still image -> (H, W, 4) RGBA uint8 (host)."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        from ..codecs.png import png_decode

        fmt, arr = png_decode(data)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        if arr.shape[-1] == 3:
            arr = np.concatenate(
                [arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)],
                -1)
        return arr
    if data[:2] == b"\xff\xd8":
        from ..codecs.jpeg import jpeg_decode

        planes, w, h, _sub = jpeg_decode(data, device="cpu")
        planes = [p.numpy() for p in planes]

        # 4:2:0 -> RGB via the standard JPEG full-range matrix
        y = planes[0][:h, :w].astype(np.float64)

        def up(p):
            ry = max(round(planes[0].shape[0] / p.shape[0]), 1)
            rx = max(round(planes[0].shape[1] / p.shape[1]), 1)
            return np.repeat(np.repeat(p, ry, 0), rx, 1)[:h, :w] \
                .astype(np.float64) - 128

        u, v = up(planes[1]), up(planes[2])
        r = np.clip(np.round(y + 1.402 * v), 0, 255)
        g = np.clip(np.round(y - 0.344136 * u - 0.714136 * v), 0, 255)
        b = np.clip(np.round(y + 1.772 * u), 0, 255)
        a = np.full((h, w), 255.0)
        return np.stack([r, g, b, a], -1).astype(np.uint8)
    # everything else through PIL (the gdk-pixbuf loader analog)
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(img, np.uint8)


def _blobs(buf: Buffer):
    d = buf.data
    return [bytes(b) if isinstance(b, (bytes, bytearray))
            else host_array(b).ravel().astype(np.uint8).tobytes()
            for b in (d if isinstance(d, (list, tuple)) else [d])]


def _rgba_planes(frames, device) -> tuple:
    """(H, W, 4) host frames -> four (B, H, W) planes on `device`."""
    arr = np.moveaxis(np.stack(frames), -1, 0)
    return tuple(torch.from_numpy(np.ascontiguousarray(arr)).to(device))


class _ImageToRGBA(TransformElement):
    """Encoded buffers of host bytes -> RGBA frames on the device."""
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PROPERTIES = {}

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("video/x-raw, format=RGBA")
               if direction == PadDirection.SINK
               else self.sink_pads()[0].template_caps)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def _decode(self, raw: bytes) -> Optional[np.ndarray]:
        raise NotImplementedError

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        frames = [f for f in map(self._decode, _blobs(buf)) if f is not None]
        if not frames:
            return None
        return buf.with_(data=_rgba_planes(frames, resolve(self.device)),
                         batch=len(frames))


@register_element
class GdkPixbufDec(_ImageToRGBA):
    """gdkpixbufdec: encoded image buffers -> raw RGBA frames."""
    FACTORY = "gdkpixbufdec"
    DESCRIPTION = "Decodes images in a video stream using GdkPixbuf"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "image/png; image/jpeg; image/bmp; image/gif; "
                    "image/x-icon; image/tiff; image/webp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=RGBA"),
    ]

    def _decode(self, raw):
        return decode_image(raw) if raw else None


class _OverlayBase(TransformElement):
    """Shared canonical-blend scaffold for the overlay elements: a
    composition a frame from ``_composition`` (None: the frame passes),
    blended on the device."""
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, VIDEO_CAPS),
        PadTemplate("src", PadDirection.SRC, VIDEO_CAPS),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._info: Optional[VideoInfo] = None
        self._kept = (None, None, None)

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._info = VideoInfo.from_caps_structure(incaps[0])
            self._kept = (None, None, None)
            self._on_caps()

    def _on_caps(self):
        pass

    def _keep(self, pixels, place, make) -> VideoOverlayComposition:
        """The composition last made of the array `pixels` (the same
        object) at `place`, else make() kept in its stead: frames and
        buffers that need the same overlay share one composition, its
        scaled pixels and its device upload."""
        if self._kept[0] is not pixels or self._kept[1] != place:
            self._kept = (pixels, place, make())
        return self._kept[2]

    def _composition(self, buf: Buffer, k: int
                     ) -> Optional[VideoOverlayComposition]:
        raise NotImplementedError

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None or self._info is None:
            return buf
        info = self._info
        comps = []
        for k in range(buf.data[0].shape[0]):
            comp = self._composition(buf, k)
            comps.append(comp if comp is not None and comp.n_rectangles
                         else None)
        groups = runs(comps)
        if not groups:
            return buf
        # unpack then pack is the identity on the other frames for every
        # format of VIDEO_CAPS (8-bit, top-left chroma siting)
        out = blend_planes(info.finfo, buf.data, info.width, info.height,
                           groups)
        return buf.with_(data=out)


@register_element
class GdkPixbufOverlay(_OverlayBase):
    """gdkpixbufoverlay (gstgdkpixbufoverlay.c)."""
    FACTORY = "gdkpixbufoverlay"
    DESCRIPTION = "Overlay an image onto a video stream"
    PROPERTIES = {
        "location": (str, "", "image file to overlay"),
        "offset-x": (int, 0, "x offset (negative = from the right)"),
        "offset-y": (int, 0, "y offset (negative = from the bottom)"),
        "relative-x": (float, 0.0, "x offset as a fraction of width"),
        "relative-y": (float, 0.0, "y offset as a fraction of "
                                   "height"),
        "overlay-width": (int, 0, "scale overlay to width (0 = "
                                  "native)"),
        "overlay-height": (int, 0, "scale overlay to height"),
        "alpha": (float, 1.0, "global alpha"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._rgba = None

    def start(self):
        self._rgba = None
        loc = self.props["location"]
        if loc:
            with open(loc, "rb") as f:
                self._rgba = decode_image(f.read())

    def set_pixbuf(self, rgba: np.ndarray) -> None:
        """The `pixbuf` property analog: set the overlay directly."""
        self._rgba = np.asarray(rgba, np.uint8)

    def _composition(self, buf, k):
        if self._rgba is None:
            return None
        info = self._info
        ow = int(self.props["overlay-width"]) or self._rgba.shape[1]
        oh = int(self.props["overlay-height"]) or self._rgba.shape[0]
        x = int(self.props["offset-x"]) \
            + int(self.props["relative-x"] * info.width)
        y = int(self.props["offset-y"]) \
            + int(self.props["relative-y"] * info.height)
        if int(self.props["offset-x"]) < 0:
            x = info.width - ow + int(self.props["offset-x"]) \
                + int(self.props["relative-x"] * info.width)
        if int(self.props["offset-y"]) < 0:
            y = info.height - oh + int(self.props["offset-y"]) \
                + int(self.props["relative-y"] * info.height)
        alpha = float(self.props["alpha"])
        rgba = self._rgba

        def make():
            argb = np.concatenate([rgba[..., 3:4], rgba[..., :3]], -1)
            return VideoOverlayComposition([VideoOverlayRectangle(
                argb, render_x=x, render_y=y, render_width=ow,
                render_height=oh, global_alpha=alpha)])
        return self._keep(rgba, (x, y, ow, oh, alpha), make)


@register_element
class CairoOverlay(_OverlayBase):
    """cairooverlay (gstcairooverlay.c): per-frame app drawing.

    The reference emits "draw"(cairo context) and "caps-changed"
    signals; here `draw` is a callable attribute receiving
    (surface, pts_ns, duration_ns) where surface is a (H, W, 4)
    RGBA uint8 array to paint into (initially fully transparent),
    and `on_caps` receives the negotiated VideoInfo."""
    FACTORY = "cairooverlay"
    DESCRIPTION = "Render overlay on a video stream via a draw " \
                  "callback"
    PROPERTIES = {
        "draw-on-transparent-surface": (bool, True, "accepted for "
                                        "API parity (always draws on "
                                        "a transparent surface)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.draw: Optional[Callable] = None
        self.on_caps: Optional[Callable] = None

    def _on_caps(self):
        if self.on_caps is not None:
            self.on_caps(self._info)

    def _composition(self, buf, k):
        if self.draw is None:
            return None
        info = self._info
        surface = np.zeros((info.height, info.width, 4), np.uint8)
        dur = buf.duration or 0
        pts = (buf.pts or 0) + k * dur
        self.draw(surface, pts, dur)
        if not surface[..., 3].any():
            return None
        argb = np.concatenate([surface[..., 3:4], surface[..., :3]],
                              -1)
        return VideoOverlayComposition([VideoOverlayRectangle(argb)])


def _qr_argb(data: bytes, ec: str, pixel_size: int) -> np.ndarray:
    m = qr_encode(data, ec)
    big = np.kron(np.pad(m, 2), np.ones(
        (pixel_size, pixel_size), np.uint8))
    lum = np.where(big, 0, 255).astype(np.uint8)
    a = np.full_like(lum, 255)
    return np.stack([a, lum, lum, lum], -1)


@register_element
class QrOverlay(_OverlayBase):
    """qroverlay (gstqroverlay.c): static-data QR code overlay."""
    FACTORY = "qroverlay"
    DESCRIPTION = "Overlay Qrcodes over each buffer"
    PROPERTIES = {
        "data": (str, "", "data to write in the QR code"),
        "x": (float, 50.0, "x position in percent of the width"),
        "y": (float, 50.0, "y position in percent of the height"),
        "pixel-size": (int, 3, "size of a QR module in pixels"),
        "qrcode-error-correction": (str, "M", "L|M|Q|H"),
        "case-sensitive": (bool, True, "accepted for API parity"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._argb = None

    def _payload(self, buf, k) -> Optional[bytes]:
        d = self.props["data"]
        return d.encode() if d else None

    def _composition(self, buf, k):
        payload = self._payload(buf, k)
        if not payload:
            return None
        if self._argb is None or getattr(self, "_last_payload",
                                         None) != payload:
            self._argb = _qr_argb(
                payload, self.props["qrcode-error-correction"],
                max(int(self.props["pixel-size"]), 1))
            self._last_payload = payload
        info = self._info
        argb = self._argb
        h, w = argb.shape[:2]
        x = int((info.width - w) * float(self.props["x"]) / 100.0)
        y = int((info.height - h) * float(self.props["y"]) / 100.0)
        return self._keep(argb, (x, y), lambda: VideoOverlayComposition(
            [VideoOverlayRectangle(argb, render_x=max(x, 0),
                                   render_y=max(y, 0))]))


@register_element
class DebugQrOverlay(QrOverlay):
    """debugqroverlay (gstdebugqroverlay.c): encodes a JSON of
    timestamps / buffer counters, refreshed every span-buffer
    frames."""
    FACTORY = "debugqroverlay"
    DESCRIPTION = "Overlay debug information in a QR code"
    PROPERTIES = dict(QrOverlay.PROPERTIES)
    PROPERTIES.update({
        "span-buffer": (int, 1, "re-encode every N buffers"),
        "extra-data-name": (str, "", "name of an extra data field"),
        "extra-data-array": (str, "", "comma-separated extra values "
                                      "cycled per span"),
    })

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._counter = 0

    def start(self):
        self._counter = 0

    def _payload(self, buf, k):
        span = max(int(self.props["span-buffer"]), 1)
        idx = self._counter
        self._counter += 1
        if idx % span and self._argb is not None:
            return getattr(self, "_last_payload", None)
        dur = buf.duration or 0
        pts = (buf.pts or 0) + k * dur
        info = {"TIMESTAMP": pts, "BUFFERCOUNT": idx,
                "FRAMERATE": str(self._info.fps
                                 if self._info.fps else "0/1"),
                "NAME": self.name}
        extra_name = self.props["extra-data-name"]
        extra = self.props["extra-data-array"]
        if extra_name and extra:
            vals = extra.split(",")
            info[extra_name] = vals[(idx // span) % len(vals)]
        return json.dumps(info).encode()


@register_element
class GdkPixbufSink(SinkElement):
    """gdkpixbufsink (gstgdkpixbufsink.c): posts "pixbuf" messages."""
    FACTORY = "gdkpixbufsink"
    DESCRIPTION = "Output images as GdkPixbuf objects in bus messages"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format={ RGB, RGBA }")]
    PROPERTIES = {
        "post-messages": (bool, True, "post a pixbuf message per "
                                      "frame"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.last_pixbuf: Optional[np.ndarray] = None
        self.last_buffer: Optional[Buffer] = None

    def render(self, buf: Buffer):
        from ..core.buffer import FlowReturn

        frames = np.stack([host_array(p) for p in buf.data], -1)
        for rgb in frames:
            self.last_pixbuf = rgb
            if bool(self.props["post-messages"]):
                root = self
                while getattr(root, "parent", None) is not None:
                    root = root.parent
                if hasattr(root, "bus"):
                    from ..core.pipeline import Message
                    root.bus.post(Message("element", self.name, {
                        "name": "pixbuf", "pixbuf": rgb,
                        "pixel-aspect-ratio": "1/1"}))
        self.last_buffer = buf
        return FlowReturn.OK


# ---------------------------------------------------------------------------
# reduced SVG (host, Pillow; a copy of the reference's)
# ---------------------------------------------------------------------------

_HEX = re.compile(r"#([0-9a-fA-F]{6})")


def _svg_color(v: Optional[str], default=(0, 0, 0, 255)):
    if not v or v == "none":
        return None if v == "none" else default
    m = _HEX.match(v.strip())
    if m:
        n = int(m.group(1), 16)
        return ((n >> 16) & 255, (n >> 8) & 255, n & 255, 255)
    named = {"black": (0, 0, 0, 255), "white": (255, 255, 255, 255),
             "red": (255, 0, 0, 255), "green": (0, 128, 0, 255),
             "blue": (0, 0, 255, 255), "yellow": (255, 255, 0, 255)}
    return named.get(v.strip().lower(), default)


def render_svg(data: bytes, width: int = 0, height: int = 0
               ) -> np.ndarray:
    """Rasterize the supported SVG subset -> (H, W, 4) RGBA.

    Supported: svg width/height/viewBox, rect, circle, ellipse, line,
    polygon, polyline, text (PIL font).  The reference's documented
    reduction of librsvg."""
    from PIL import Image, ImageDraw

    root = ET.fromstring(data.decode("utf-8", errors="replace"))

    def f(v, d=0.0):
        try:
            return float(re.sub(r"[a-z%]+$", "", v.strip()))
        except (AttributeError, ValueError):
            return d

    w = int(f(root.get("width"), 0)) or width or 256
    h = int(f(root.get("height"), 0)) or height or 256
    img = Image.new("RGBA", (w, h), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)

    def walk(el):
        tag = el.tag.split("}")[-1]
        fill = _svg_color(el.get("fill"), (0, 0, 0, 255))
        stroke = _svg_color(el.get("stroke"), None) \
            if el.get("stroke") else None
        sw = int(f(el.get("stroke-width"), 1)) or 1
        if tag == "rect":
            x, y = f(el.get("x")), f(el.get("y"))
            rw, rh = f(el.get("width")), f(el.get("height"))
            draw.rectangle([x, y, x + rw, y + rh], fill=fill,
                           outline=stroke, width=sw)
        elif tag in ("circle", "ellipse"):
            cx, cy = f(el.get("cx")), f(el.get("cy"))
            rx = f(el.get("r")) or f(el.get("rx"))
            ry = f(el.get("r")) or f(el.get("ry"))
            draw.ellipse([cx - rx, cy - ry, cx + rx, cy + ry],
                         fill=fill, outline=stroke, width=sw)
        elif tag == "line":
            draw.line([f(el.get("x1")), f(el.get("y1")),
                       f(el.get("x2")), f(el.get("y2"))],
                      fill=stroke or fill, width=sw)
        elif tag in ("polygon", "polyline"):
            pts = [float(v) for v in
                   re.split(r"[,\s]+", (el.get("points") or "")
                            .strip()) if v]
            xy = list(zip(pts[::2], pts[1::2]))
            if tag == "polygon":
                draw.polygon(xy, fill=fill, outline=stroke)
            else:
                draw.line(xy, fill=stroke or fill, width=sw)
        elif tag == "text":
            draw.text((f(el.get("x")), f(el.get("y"))),
                      "".join(el.itertext()), fill=fill)
        for child in el:
            walk(child)

    walk(root)
    return np.asarray(img, np.uint8)


@register_element
class RsvgDec(_ImageToRGBA):
    """rsvgdec (gstrsvgdec.c, reduced SVG subset)."""
    FACTORY = "rsvgdec"
    DESCRIPTION = "Uses librsvg to decode SVG images (reduced native subset)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "image/svg+xml; "
                                               "image/svg"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=RGBA"),
    ]

    def _decode(self, raw):
        return render_svg(raw) if raw.strip() else None


@register_element
class RsvgOverlay(_OverlayBase):
    """rsvgoverlay (gstrsvgoverlay.c, reduced): SVG from `location` /
    `data` rendered over the frame; fit-to-frame scales to the video
    size."""
    FACTORY = "rsvgoverlay"
    DESCRIPTION = "Overlays SVG graphics over a video stream"
    PROPERTIES = {
        "location": (str, "", "SVG file"),
        "data": (str, "", "SVG document text"),
        "x": (int, 0, "x position"),
        "y": (int, 0, "y position"),
        "fit-to-frame": (bool, False, "scale the SVG to the frame"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._rgba = None
        self._doc = None

    def start(self):
        self._rgba = None
        doc = None
        if self.props["data"]:
            doc = self.props["data"].encode()
        elif self.props["location"]:
            with open(self.props["location"], "rb") as fobj:
                doc = fobj.read()
        self._doc = doc or None

    def _composition(self, buf, k):
        if self._doc is None:
            return None
        info = self._info
        fit = bool(self.props["fit-to-frame"])
        if self._rgba is None:
            self._rgba = (render_svg(self._doc, info.width, info.height)
                          if fit else render_svg(self._doc))
        rgba = self._rgba
        rw, rh = ((info.width, info.height) if fit
                  else (rgba.shape[1], rgba.shape[0]))
        x, y = int(self.props["x"]), int(self.props["y"])

        def make():
            argb = np.concatenate([rgba[..., 3:4], rgba[..., :3]], -1)
            return VideoOverlayComposition([VideoOverlayRectangle(
                argb, render_x=x, render_y=y, render_width=rw,
                render_height=rh)])
        return self._keep(rgba, (x, y, rw, rh), make)
