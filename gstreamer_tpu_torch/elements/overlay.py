"""overlaycomposition -- application-drawn overlays blended onto video.

The JAX package's ``elements/overlay.py`` (reference: subprojects/
gst-plugins-base/gst/overlaycomposition/gstoverlaycomposition.c): the
element takes a VideoOverlayComposition from the buffer's meta
(``overlay-composition``), else from the ``draw`` callable (buf ->
composition or None), else from the static ``composition`` attribute, in
that order, and blends it onto the frames with video-blend.c's integer math
(``video/overlay.py``) on the buffer's device: the batch is unpacked once,
blended in place and packed (``blend_planes``).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo
from ..video.overlay import VideoOverlayComposition, blend_planes
from .videotestsrc import FORMAT_LIST

VIDEO_CAPS = (f"video/x-raw, format={FORMAT_LIST}, width=[1,32767], "
              f"height=[1,32767], framerate=[0/1,2147483647/1]")


@register_element
class OverlayCompositionElement(TransformElement):
    FACTORY = "overlaycomposition"
    KLASS = "Filter/Editor/Video"
    DESCRIPTION = "Overlay an image onto a video stream"
    HOST_ELEMENT = True   # draw callback runs per buffer on the host
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, VIDEO_CAPS),
        PadTemplate("src", PadDirection.SRC, VIDEO_CAPS),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.draw: Optional[Callable[[Buffer],
                                     Optional[VideoOverlayComposition]]] = None
        self.composition: Optional[VideoOverlayComposition] = None
        self._info: Optional[VideoInfo] = None

    def set_info(self, incaps: Optional[Caps], outcaps: Optional[Caps]):
        if incaps is not None:
            self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        comp = buf.meta.get("overlay-composition")
        if comp is None and self.draw is not None:
            comp = self.draw(buf)
        if comp is None:
            comp = self.composition
        if comp is None or comp.n_rectangles == 0:
            return buf
        info = self._info
        out = blend_planes(info.finfo, buf.data, info.width, info.height,
                           [(None, comp)])
        return buf.with_(data=out)
