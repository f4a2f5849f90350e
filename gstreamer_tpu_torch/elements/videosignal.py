"""simplevideomark / simplevideomarkdetect — luma pattern watermark.

Port of gst-plugins-bad/gst/videosignal/ (completes the videosignal
plugin with videoanalyse in misc_elements.py):
* simplevideomark (gstsimplevideomark.c): draws `pattern-count`
  alternating black/white sync squares (even=0, odd=255) followed by
  `pattern-data-count` data squares (MSB first, 1=255) of
  pattern-width x pattern-height at (left-offset, bottom-offset) from
  the bottom-left, on the luma plane.
* simplevideomarkdetect (gstsimplevideomarkdetect.c): per-box
  brightness sum/(255*w*h); sync boxes must clear
  pattern-center +/- pattern-sensitivity, data bits compare against
  the center; posts "GstSimpleVideoMarkDetect" element messages with
  have-pattern and the decoded data word.

A port of the JAX package's ``elements/videosignal.py``: both elements
read a host copy of the tick's luma plane; simplevideomark's marked plane
goes back to the buffer's device, the chroma planes stay there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.buffer import Buffer, device_array, host_array
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo

_CAPS = ("video/x-raw, format={ I420, YV12, Y444, Y42B, NV12, GRAY8 }, "
         "width=[1,32767], height=[1,32767], "
         "framerate=[0/1,2147483647/1]")

_COMMON_PROPS = {
    "pattern-width": (int, 4, "width of each pattern box"),
    "pattern-height": (int, 16, "height of each pattern box"),
    "pattern-count": (int, 4, "number of sync boxes"),
    "pattern-data-count": (int, 5, "number of data boxes"),
    "left-offset": (int, 0, "x offset from the left"),
    "bottom-offset": (int, 0, "y offset from the bottom"),
}


@register_element
class SimpleVideoMark(TransformElement):
    FACTORY = "simplevideomark"
    DESCRIPTION = "Marks a video signal with a pattern"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CAPS),
        PadTemplate("src", PadDirection.SRC, _CAPS),
    ]
    PROPERTIES = dict(_COMMON_PROPS, **{
        "pattern-data": (int, 10, "data bits (MSB first)"),
        "enabled": (bool, True, ""),
    })

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if not self.props["enabled"]:
            return buf
        data = buf.data if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        y = host_array(data[0]).copy()
        h, w = y.shape[-2:]
        pw = self.props["pattern-width"]
        ph = self.props["pattern-height"]
        x0 = self.props["left-offset"]
        y0 = h - ph - self.props["bottom-offset"]
        count = self.props["pattern-count"]
        dcount = self.props["pattern-data-count"]
        word = self.props["pattern-data"]
        ys, ye = max(y0, 0), min(y0 + ph, h)
        if ye <= ys:
            return buf
        x = x0
        for i in range(count + dcount):
            if i < count:
                color = 255 if (i & 1) else 0
            else:
                bit = dcount - 1 - (i - count)
                color = 255 if (word >> bit) & 1 else 0
            xs, xe = max(x, 0), min(x + pw, w)
            if xe > xs:
                y[..., ys:ye, xs:xe] = color
            x += pw
            if x >= w:
                break
        out = [device_array(y, buf.data)] + list(data[1:])
        if not isinstance(buf.data, (list, tuple)):
            out = out[0]
        return buf.with_(data=out)


@register_element
class SimpleVideoMarkDetect(TransformElement):
    FACTORY = "simplevideomarkdetect"
    DESCRIPTION = "Detect patterns in a video signal"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CAPS),
        PadTemplate("src", PadDirection.SRC, _CAPS),
    ]
    PROPERTIES = dict(_COMMON_PROPS, **{
        "message": (bool, True, "post detection messages"),
        "pattern-center": (float, 0.5, ""),
        "pattern-sensitivity": (float, 0.3, ""),
    })

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def _detect_one(self, y: np.ndarray):
        h, w = y.shape
        pw = self.props["pattern-width"]
        ph = self.props["pattern-height"]
        x0 = self.props["left-offset"]
        y0 = h - ph - self.props["bottom-offset"]
        center = self.props["pattern-center"]
        sens = self.props["pattern-sensitivity"]
        count = self.props["pattern-count"]
        dcount = self.props["pattern-data-count"]
        ys, ye = max(y0, 0), min(y0 + ph, h)
        if ye <= ys:
            return False, 0
        x = x0

        def brightness(xs, xe):
            box = y[ys:ye, xs:xe].astype(np.float64)
            return box.sum() / (255.0 * box.size) if box.size else 0.0

        for i in range(count):
            xs, xe = max(x, 0), min(x + pw, w)
            b = brightness(xs, xe)
            if i & 1:
                if b < center + sens:
                    return False, 0
            else:
                if b > center - sens:
                    return False, 0
            x += pw
        word = 0
        for i in range(dcount):
            xs, xe = max(x, 0), min(x + pw, w)
            b = brightness(xs, xe)
            word = (word << 1) | (1 if b > center else 0)
            x += pw
        return True, word

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if not self.props["message"]:
            return buf
        data = buf.data if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        y = host_array(data[0])
        root = self
        while getattr(root, "parent", None) is not None:
            root = root.parent
        batch = y.shape[0] if y.ndim == 3 else 1
        for k in range(batch):
            frame = y[k] if y.ndim == 3 else y
            found, word = self._detect_one(frame)
            if hasattr(root, "bus"):
                from ..core.pipeline import Message
                pts = buf.pts
                if pts is not None and buf.duration and buf.batch:
                    pts = pts + k * buf.duration // buf.batch
                root.bus.post(Message("element", self.name, {
                    "name": "GstSimpleVideoMarkDetect",
                    "have-pattern": found,
                    "timestamp": pts,
                    "data": word,
                }))
        return buf
