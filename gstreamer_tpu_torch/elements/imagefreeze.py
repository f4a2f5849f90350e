"""imagefreeze — turn a still frame into a video stream.

Port of gst-plugins-good/gst/imagefreeze/gstimagefreeze.c: the FIRST
input frame is captured and re-emitted at the negotiated framerate
with pts n/fps and duration 1/fps; `num-buffers` bounds the total
output (gstimagefreeze.c:128).

Batch-model adaptation: the reference's src task loops forever pushing
duplicates; here each incoming tick of B frames yields B duplicates of
the frozen frame (the batch axis IS the time axis), so the element
stays a pure per-tick transform.  num-buffers=-1 (unlimited) therefore
produces exactly as many frames as the upstream source drives; set
num-buffers=N to truncate.

A port of the JAX package's ``elements/imagefreeze.py``: the frozen
frame and its repeats stay on the buffer's device.
"""

from __future__ import annotations

from typing import Optional

from ..core.buffer import Buffer
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

_CAPS = "video/x-raw"


@register_element
class ImageFreeze(TransformElement):
    FACTORY = "imagefreeze"
    DESCRIPTION = "Generates a still frame stream from an image"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CAPS),
        PadTemplate("src", PadDirection.SRC, _CAPS),
    ]
    PROPERTIES = {
        "num-buffers": (int, -1, "frames to output (-1: follow input)"),
        "is-live": (bool, False, "produce in live mode"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frozen = None
        self._emitted = 0

    def start(self):
        self._frozen = None
        self._emitted = 0

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        fr = s.get("framerate")
        self._fps = fr if fr and getattr(fr, "num", 0) else None

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        planes = list(buf.data) if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        batch = planes[0].shape[0]
        if self._frozen is None:
            self._frozen = [p[:1].clone() for p in planes]
        limit = self.props["num-buffers"]
        n = batch if limit < 0 else max(
            0, min(batch, limit - self._emitted))
        if n == 0:
            return None
        out = [f.repeat((n,) + (1,) * (f.ndim - 1)) for f in self._frozen]
        if len(out) == 1 and not isinstance(buf.data, (list, tuple)):
            out = out[0]
        pts = None
        dur = None
        if self._fps is not None:
            num, den = self._fps.num, self._fps.denom
            pts = self._emitted * 1_000_000_000 * den // num
            dur = n * 1_000_000_000 * den // num
        self._emitted += n
        return buf.with_(data=out, pts=pts, duration=dur)
