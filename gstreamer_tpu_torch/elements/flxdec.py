"""flxdec — FLIC (.fli/.flc) animation decoder element.

Pull-mode collapse of filesrc!flxdec (gstflxdec.c): decodes the whole
animation via codecs/flic.py and streams RGB frames at the header
speed.  The reference outputs xRGB/BGRx words from the palette; here
the palette map is applied per frame to canonical (R,G,B) planes.

A copy of the JAX package's ``elements/flxdec.py``: the frames are host
arrays that the pipeline stages on its device."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..codecs import flic
from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SourceElement,
                            register_element)
from ..core.value import Fraction


@register_element
class FlxDec(SourceElement):
    FACTORY = "flxdec"
    DESCRIPTION = "FLC/FLI/FLX video decoder"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "video/x-raw, format=RGB")]
    PROPERTIES = {"location": (str, "", ".fli/.flc file path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frames = None
        self._pos = 0

    def _load(self):
        if self._frames is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        frames, palettes, speed_ms, (w, h) = flic.decode(data)
        self._frames = frames
        self._palettes = palettes
        self._wh = (w, h)
        # speed in ms per frame -> framerate fraction
        self._speed_ms = max(speed_ms, 1)
        self._fps = Fraction(1000, self._speed_ms)

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        if self._frames is None:
            return Caps.any()
        w, h = self._wh
        caps = Caps.from_string(
            f"video/x-raw, format=RGB, width={w}, height={h}, "
            f"framerate={self._fps.num}/{self._fps.denom}")
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._frames):
            return None
        take = min(max(1, n_frames), len(self._frames) - self._pos)
        rs, gs, bs = [], [], []
        for k in range(self._pos, self._pos + take):
            idx = self._frames[k]
            pal = self._palettes[k]
            rgb = pal[idx]                     # (h, w, 3) gather
            rs.append(rgb[..., 0])
            gs.append(rgb[..., 1])
            bs.append(rgb[..., 2])
        pts = self._pos * self._speed_ms * 1_000_000
        self._pos += take
        return Buffer(
            data=(np.stack(rs), np.stack(gs), np.stack(bs)),
            batch=take, pts=pts,
            duration=take * self._speed_ms * 1_000_000)
