"""vp8enc/vp8dec/vp9enc/vp9dec — VP8/VP9 codecs over the system
libvpx, plus ivfmux/ivfparse file framing.

Reference: gst-plugins-good/ext/vpx/gstvp8enc.c:1 / gstvp8dec.c:1 /
gstvp9enc.c:1 / gstvp9dec.c:1 (libvpx wrappers — the codec is not
reimplemented there) and gst-plugins-bad/gst/ivfparse/gstivfparse.c:1.

Collapsed location-based style matching theoradec/theoraenc
(elements/xiph.py): decoders read an IVF file and stream raw I420;
encoders accumulate raw frames and write one IVF file at EOS.
Matroska/WebM V_VP8/V_VP9 tracks go through container_elements.py.

A port of the JAX package's ``elements/vpx_elements.py``: the decoders
give host arrays that the pipeline stages on its device; the encoders
copy each tick's planes to the host (``host_array``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, TransformElement,
                            register_element)


class _VpxDec(SourceElement):
    """Shared IVF-file decoder scaffold."""
    CODEC = ""
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "video/x-raw, format=I420")]
    PROPERTIES = {"location": (str, "", "ivf file path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frames = None
        self._pos = 0

    def _load(self):
        if self._frames is not None:
            return
        from ..codecs import vpx
        with open(self.props["location"], "rb") as f:
            data = f.read()
        codec, w, h, fps, packets = vpx.parse_ivf(data)
        if codec != self.CODEC:
            raise ValueError(
                f"{self.FACTORY}: IVF carries {codec}, not "
                f"{self.CODEC}")
        self._frames = vpx.decode_packets(codec, packets)
        self._dims = (w, h)
        self._fps = fps
        self._pos = 0

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError, RuntimeError):
                return Caps.any()
        if self._frames is None:
            return Caps.any()
        from ..core.structure import Structure
        from ..core.value import Fraction
        w, h = self._dims
        n, d = self._fps
        caps = Caps([Structure("video/x-raw", {
            "format": "I420", "width": w, "height": h,
            "framerate": Fraction(n, d)})])
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._frames):
            return None
        take = self._frames[self._pos:self._pos + max(1, n_frames)]
        data = tuple(np.stack([f[c] for f in take]) for c in range(3))
        n, d = self._fps
        pts = self._pos * 1_000_000_000 * d // n if n else None
        dur = 1_000_000_000 * d // n if n else None
        self._pos += len(take)
        return Buffer(data=data, batch=len(take), pts=pts,
                      duration=dur)


class _VpxEnc(TransformElement):
    """Encoder element: raw I420 -> VP8/VP9 packet stream (the
    reference's gstvpxenc.c shape).  `location` optionally dumps the
    packets as an IVF file at EOS for the earlier sink-style use."""
    CODEC = ""
    HOST_ELEMENT = True
    PROPERTIES = {
        "location": (str, "", "optional IVF dump path"),
        "target-bitrate": (int, 256000, "bitrate in bits/sec"),
        "deadline": (int, 1, "compatibility (unused)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._enc = None
        self._info = None
        self._pkts = []
        self._decouple = True
        self._pending_buf = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            f = {}
            if caps is not None and len(caps):
                for k in ("width", "height", "framerate"):
                    v = caps[0].get(k)
                    if v is not None:
                        f[k] = v
            from ..core.structure import Structure
            res = Caps([Structure(f"video/x-{self.CODEC}", f)])
        else:
            res = Caps.from_string("video/x-raw, format=I420")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        from ..video.info import VideoInfo
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def start(self):
        self._enc = None
        self._pkts = []
        self._pending_buf = True

    def _ensure_enc(self):
        if self._enc is None:
            from ..codecs import vpx
            fps = self._info.fps
            fps = ((fps.num, fps.denom) if fps and fps.num
                   else (30, 1))
            self._fps = fps
            self._enc = vpx.VpxEncoder(
                self.CODEC, self._info.width, self._info.height,
                fps, max(self.props["target-bitrate"] // 1000, 1))

    def _emit(self, pkts, buf):
        if self.props["location"]:
            self._pkts.extend(p for p, _ in pkts)
        if not pkts:
            return None
        data = [np.frombuffer(p, np.uint8) for p, _ in pkts]
        if buf is not None:
            return buf.with_(data=data)
        return Buffer(data=data, batch=len(data))

    def host_process(self, buf):
        if buf is None:
            self._pending_buf = None
            if self._enc is None:
                return None
            pkts = self._enc.flush()
            out = self._emit(pkts, None)
            if self.props["location"]:
                from ..codecs import vpx
                vpx.write_ivf(self.props["location"], self.CODEC,
                              self._info.width, self._info.height,
                              self._fps, self._pkts)
            self._enc = None
            return out
        self._ensure_enc()
        y, cb, cr = (host_array(p) for p in buf.data)
        if y.ndim == 2:
            y, cb, cr = y[None], cb[None], cr[None]
        pkts = []
        for k in range(y.shape[0]):
            pkts.extend(self._enc.encode((y[k], cb[k], cr[k])))
        return self._emit(pkts, buf)


@register_element
class Vp8Dec(_VpxDec):
    FACTORY = "vp8dec"
    DESCRIPTION = "Decode VP8 video streams"
    CODEC = "vp8"


@register_element
class Vp9Dec(_VpxDec):
    FACTORY = "vp9dec"
    DESCRIPTION = "Decode VP9 video streams"
    CODEC = "vp9"


@register_element
class Vp8Enc(_VpxEnc):
    FACTORY = "vp8enc"
    DESCRIPTION = "Encode VP8 video streams"
    CODEC = "vp8"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("src", PadDirection.SRC, "video/x-vp8"),
    ]


@register_element
class Vp9Enc(_VpxEnc):
    FACTORY = "vp9enc"
    DESCRIPTION = "Encode VP9 video streams"
    CODEC = "vp9"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("src", PadDirection.SRC, "video/x-vp9"),
    ]
