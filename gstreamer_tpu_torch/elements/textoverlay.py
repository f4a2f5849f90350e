"""textoverlay / timeoverlay / clockoverlay / textrender.

The JAX package's ``elements/textoverlay.py`` (reference:
gst-plugins-base/ext/pango/): text is rasterised on the host with Pillow's
built-in font (a lazy import, as in the reference; the pango/cairo
rasteriser's stand-in), placed as gstbasetextoverlay.c places it
(defaults text="", valignment=baseline, halignment=center, xpad=ypad=25,
xpos/ypos=0.5, gstbasetextoverlay.c:46-65) and blended with video-blend.c's
integer math on the buffer's device (``video/overlay.py``):

* textoverlay: one bitmap for the whole buffer;
* timeoverlay: "%u:%02u:%02u.%03u" of each frame's time, pts + k *
  duration // batch (gsttimeoverlay.c:142-154): a bitmap a frame, each
  blended into its frame of one unpacked copy of the batch;
* clockoverlay: strftime(time-format) of the wall clock (gstclockoverlay.c,
  default "%H:%M:%S"), once a buffer;
* textrender (gsttextrender.c): each text to an ARGB frame, the canvas made
  on the host and packed on the device.

A rendered text keeps its composition, and with it its device upload, in a
cache of up to 65 texts (cleared when it grows past 64, as the reference's
bitmap cache is, and at every caps change).
"""

from __future__ import annotations

import time as _time
from typing import Optional

import numpy as np
import torch

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve
from ..video.format import pack_planes
from ..video.info import VideoInfo
from ..video.overlay import (VideoOverlayComposition, VideoOverlayRectangle,
                             blend_planes, runs)
from .videotestsrc import FORMAT_LIST

VIDEO_CAPS = (f"video/x-raw, format={FORMAT_LIST}, width=[1,32767], "
              f"height=[1,32767], framerate=[0/1,2147483647/1]")


def render_text_argb(text: str, font_size: int = 18,
                     shaded: bool = False) -> np.ndarray:
    """Rasterize text to an (h, w, 4) ARGB uint8 bitmap (white glyphs
    on transparent, optional 50% black shading box)."""
    from PIL import Image, ImageDraw, ImageFont

    try:
        font = ImageFont.load_default(size=font_size)
    except TypeError:                      # older Pillow: fixed size
        font = ImageFont.load_default()
    probe = ImageDraw.Draw(Image.new("RGBA", (1, 1)))
    bbox = probe.multiline_textbbox((0, 0), text or " ", font=font)
    w = max(int(bbox[2] - bbox[0]) + 4, 1)
    h = max(int(bbox[3] - bbox[1]) + 4, 1)
    img = Image.new("RGBA", (w, h), (0, 0, 0, 128 if shaded else 0))
    draw = ImageDraw.Draw(img)
    draw.multiline_text((2 - bbox[0], 2 - bbox[1]), text or "",
                        fill=(255, 255, 255, 255), font=font,
                        align="center")
    rgba = np.asarray(img, np.uint8)
    # canonical (A, R, G, B) straight-alpha order for video_blend
    return np.concatenate([rgba[..., 3:4], rgba[..., :3]], axis=-1)


@register_element
class TextOverlay(TransformElement):
    FACTORY = "textoverlay"
    DESCRIPTION = "Adds text strings on top of a video buffer"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("video_sink", PadDirection.SINK, VIDEO_CAPS),
        PadTemplate("src", PadDirection.SRC, VIDEO_CAPS),
    ]
    PROPERTIES = {
        "text": (str, "", "text to render"),
        "valignment": (str, "baseline",
                       "baseline|bottom|top|position|center"),
        "halignment": (str, "center", "left|center|right|position"),
        "xpad": (int, 25, "horizontal padding"),
        "ypad": (int, 25, "vertical padding"),
        "xpos": (float, 0.5, "x position (position mode)"),
        "ypos": (float, 0.5, "y position (position mode)"),
        "shaded-background": (bool, False, "shaded background box"),
        "font-size": (int, 18, "bitmap font size (font-desc analog)"),
        "silent": (bool, False, "don't render"),
    }
    _PLACE = ("font-size", "shaded-background", "xpad", "ypad",
              "halignment", "valignment", "xpos", "ypos")

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._cache = {}

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])
        self._cache = {}

    def _composition(self, text: str) -> VideoOverlayComposition:
        """The text's bitmap at its place, one cached composition per text
        and placement."""
        key = (text,) + tuple(self.props[k] for k in self._PLACE)
        if key not in self._cache:
            if len(self._cache) > 64:
                self._cache.clear()
            bmp = render_text_argb(text, self.props["font-size"],
                                   self.props["shaded-background"])
            bh, bw = bmp.shape[:2]
            x, y = self._place(bw, bh)
            self._cache[key] = VideoOverlayComposition([VideoOverlayRectangle(
                pixels=bmp, render_x=x, render_y=y, render_width=bw,
                render_height=bh)])
        return self._cache[key]

    def _place(self, bw: int, bh: int):
        """gst_base_text_overlay_render_text positioning."""
        info = self._info
        xpad, ypad = self.props["xpad"], self.props["ypad"]
        ha, va = self.props["halignment"], self.props["valignment"]
        if ha == "left":
            x = xpad
        elif ha == "right":
            x = info.width - bw - xpad
        elif ha == "position":
            x = int(self.props["xpos"] * (info.width - bw))
        else:
            x = (info.width - bw) // 2
        if va == "top":
            y = ypad
        elif va == "center":
            y = (info.height - bh) // 2
        elif va == "position":
            y = int(self.props["ypos"] * (info.height - bh))
        else:                      # bottom / baseline
            y = info.height - bh - ypad
        return max(x, 0), max(y, 0)

    def _text_for_frame(self, buf: Buffer, k: int) -> str:
        return self.props["text"]

    def _per_frame(self) -> bool:
        return False

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self.props["silent"]:
            return buf
        info = self._info
        if not self._per_frame():
            text = self._text_for_frame(buf, 0)
            if not text:
                return buf
            groups = [(None, self._composition(text))]
        else:
            # one composition a frame; equal texts of consecutive frames
            # share a cached composition and blend in one call
            texts = [self._text_for_frame(buf, k)
                     for k in range(buf.data[0].shape[0])]
            groups = runs([self._composition(t) if t else None
                           for t in texts])
        out = blend_planes(info.finfo, buf.data, info.width, info.height,
                           groups)
        return buf.with_(data=out)


@register_element
class TimeOverlay(TextOverlay):
    """timeoverlay (gsttimeoverlay.c): stamps the buffer time."""
    FACTORY = "timeoverlay"
    DESCRIPTION = "Overlays buffer time stamps on a video stream"
    PROPERTIES = dict(TextOverlay.PROPERTIES, **{
        "time-mode": (str, "buffer-time", "buffer-time|stream-time|"
                      "running-time|elapsed-running-time"),
        "valignment": (str, "top", "default top (gsttimeoverlay.c)"),
    })

    def _per_frame(self) -> bool:
        return True

    @staticmethod
    def render_time(ns: Optional[int]) -> str:
        """gst_time_overlay_render_time (gsttimeoverlay.c:142)."""
        if ns is None:
            return " "
        secs_total, ns_rem = divmod(int(ns), 1_000_000_000)
        hours, rem = divmod(secs_total, 3600)
        mins, secs = divmod(rem, 60)
        msecs = ns_rem // 1_000_000
        return f"{hours}:{mins:02d}:{secs:02d}.{msecs:03d}"

    def _text_for_frame(self, buf: Buffer, k: int) -> str:
        pts = buf.pts
        if pts is None:
            return " "
        if buf.duration is not None and buf.batch:
            pts = pts + k * buf.duration // buf.batch
        return self.render_time(pts)


@register_element
class ClockOverlay(TextOverlay):
    """clockoverlay (gstclockoverlay.c): wall-clock stamp."""
    FACTORY = "clockoverlay"
    DESCRIPTION = "Overlays the current clock time on a video stream"
    PROPERTIES = dict(TextOverlay.PROPERTIES, **{
        "time-format": (str, "%H:%M:%S", "strftime format"),
        "valignment": (str, "bottom", "default bottom"),
        "halignment": (str, "left", "default left"),
    })

    def _text_for_frame(self, buf: Buffer, k: int) -> str:
        return _time.strftime(self.props["time-format"],
                              _time.localtime())


@register_element
class TextRender(TransformElement):
    """textrender (gsttextrender.c): text stream -> ARGB frames."""
    FACTORY = "textrender"
    DESCRIPTION = "Renders a text string to an image bitmap"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host text
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "text/x-raw"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=ARGB, width=[1,32767], "
                    "height=[1,32767], framerate=[0/1,2147483647/1]"),
    ]
    PROPERTIES = {
        "valignment": (str, "baseline", ""),
        "halignment": (str, "center", ""),
        "xpad": (int, 25, ""),
        "ypad": (int, 25, ""),
        "font-size": (int, 18, ""),
    }

    def transform_caps(self, direction, caps, filter=None):
        res = (self.src_pads()[0].template_caps
               if direction == PadDirection.SINK
               else Caps.from_string("text/x-raw"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction, caps, othercaps):
        out = othercaps.truncate()[0].copy()
        if direction == PadDirection.SINK:
            if not isinstance(out.get("width"), int):
                out["width"] = 320
            if not isinstance(out.get("height"), int):
                out["height"] = 240
        return Caps([out]).fixate()

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(outcaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        texts = buf.data if isinstance(buf.data, list) else [buf.data]
        info = self._info
        frames = []
        for t in texts:
            if isinstance(t, (bytes, bytearray)):
                t = t.decode("utf-8", "replace")
            elif not isinstance(t, str):
                t = host_array(t).tobytes().decode("utf-8", "replace")
            bmp = render_text_argb(t, self.props["font-size"])
            bh, bw = bmp.shape[:2]
            canvas = np.zeros((info.height, info.width, 4), np.uint8)
            x = max((info.width - bw) // 2, 0)
            y = max(info.height - bh - self.props["ypad"], 0)
            cw = min(bw, info.width - x)
            ch = min(bh, info.height - y)
            canvas[y:y + ch, x:x + cw] = bmp[:ch, :cw]
            frames.append(canvas)
        argb = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(np.stack(frames), -1, 0))).to(resolve(self.device))
        out = pack_planes(torch, info.finfo, list(argb), info.width,
                          info.height)
        return Buffer(data=out, pts=buf.pts, duration=buf.duration,
                      batch=len(frames))
