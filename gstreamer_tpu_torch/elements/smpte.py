"""smpte / smptealpha — SMPTE wipe transitions, in torch.

A port of the JAX package's ``elements/smpte.py`` (reference:
subprojects/gst-plugins-good/gst/smpte/gstsmpte.c — 2-input I420
transition: gst_smpte_blend_i420 :389, position/end_position :508-531,
pos = ((1<<depth)+border)*position/end_position; gstsmptealpha.c —
alpha-channel wipe: process_ayuv_ayuv :333, pos =
((1<<depth)+border)*position :494).

The wipe mask rasterizes once on the host (``video/smpte_mask.py``) and
goes to the element's device; the per-frame threshold and blend are plain
torch there, over the batch with a per-frame position vector:

    value = ((clamp(mask, pos-border, pos) - (pos-border)) << 8) // border
    out   = (in1 * value + in2 * (256 - value)) >> 8

``//`` is floor division of non-negative int32 values, the C division.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, TransformElement, register_element)
from ..video.info import VideoInfo
from ..video.smpte_mask import MASK_NAMES, MASK_TYPES, mask_factory_new

I420_CAPS = ("video/x-raw, format=I420, width=[1,32767], "
             "height=[1,32767], framerate=[0/1,2147483647/1]")
ALPHA_CAPS = ("video/x-raw, format={AYUV,ARGB,BGRA,RGBA}, width=[1,32767], "
              "height=[1,32767], framerate=[0/1,2147483647/1]")

_NAME_TO_TYPE = {v: k for k, v in MASK_NAMES.items()}


def _parse_type(value) -> int:
    if isinstance(value, str) and not value.lstrip("-").isdigit():
        if value not in _NAME_TO_TYPE:
            raise ValueError(f"unknown smpte transition {value!r}")
        return _NAME_TO_TYPE[value]
    t = int(value)
    if t not in MASK_TYPES:
        raise ValueError(f"unknown smpte transition type {t}")
    return t


def _mask(props, info: VideoInfo, device) -> torch.Tensor:
    """The element's wipe mask as an int32 tensor on `device`."""
    mask_np = mask_factory_new(props["type"], props["invert"], props["depth"],
                               info.width, info.height)
    return torch.as_tensor(np.minimum(mask_np, np.int64(2**31 - 1))
                           .astype(np.int32), device=device)


def _wipe_value(mask, mn, mx, border: int):
    """((clamp(mask, mn, mx) - mn) << 8) // border, in 0..256."""
    return ((torch.clamp(mask, mn, mx) - mn) << 8) // border


@register_element
class SMPTE(AggregatorElement):
    FACTORY = "smpte"
    KLASS = "Filter/Editor/Video/Transition"
    DESCRIPTION = "Apply the standard SMPTE transitions on video images"
    HOST_ELEMENT = True   # frame-position-dependent blend
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, I420_CAPS),
        PadTemplate("sink_%u", PadDirection.SINK, I420_CAPS,
                    PadPresence.REQUEST),
    ]
    PROPERTIES = {
        "type": (int, 1, "transition type (barboxwipes ids)"),
        "border": (int, 0, "border width of the transition"),
        "depth": (int, 16, "mask precision in bits"),
        "duration": (int, 1_000_000_000, "transition duration (ns)"),
        "invert": (bool, False, "invert the transition mask"),
    }

    def __init__(self, name=None, **props):
        if "type" in props:
            props["type"] = _parse_type(props["type"])
        super().__init__(name=name, **props)
        self._position = 0
        self._mask_t = None
        self._info: Optional[VideoInfo] = None

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed: Caps) -> Caps:
        first = next(iter(in_caps.values())).fixate()
        self._info = VideoInfo.from_caps_structure(first[0])
        return first

    def start(self):
        self._position = 0
        self._mask_t = None

    def flush(self):
        self._position = 0

    def _end_position(self) -> int:
        # gstsmpte.c:278 gst_util_uint64_scale(duration, fps_n, SEC*fps_d)
        fps = self._info.fps
        return int(self.props["duration"]) * fps.num // (
            1_000_000_000 * fps.denom)

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        names = sorted(ins)
        b1, b2 = ins[names[0]], ins[names[-1]]
        p1, p2 = b1.data, b2.data
        if self._mask_t is None:
            self._mask_t = _mask(self.props, self._info, p1[0].device)
        batch = p1[0].shape[0]
        end = max(self._end_position(), 1)
        top = (1 << self.props["depth"]) + (int(self.props["border"]) or 0)
        idx = np.arange(self._position, self._position + batch,
                        dtype=np.int64)
        idx = np.minimum(idx, end)   # past the end: pos -> full, output in2
        pos = torch.as_tensor((top * idx // end).astype(np.int32),
                              device=p1[0].device)
        self._position += batch
        border = int(self.props["border"]) or 1
        value = _wipe_value(self._mask_t[None], (pos - border)[:, None, None],
                            pos[:, None, None], border)
        vc = value[:, ::2, ::2]

        def blend(a, b, v):
            return ((a.to(torch.int32) * v + b.to(torch.int32) * (256 - v))
                    >> 8).to(torch.uint8)

        out = (blend(p1[0], p2[0], value), blend(p1[1], p2[1], vc),
               blend(p1[2], p2[2], vc))
        return b1.with_(data=out)


@register_element
class SMPTEAlpha(TransformElement):
    FACTORY = "smptealpha"
    KLASS = "Filter/Editor/Video"
    DESCRIPTION = "Apply SMPTE transitions by setting alpha"
    HOST_ELEMENT = True   # `position` is animated per buffer
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, ALPHA_CAPS),
        PadTemplate("src", PadDirection.SRC, ALPHA_CAPS),
    ]
    PROPERTIES = {
        "type": (int, 1, "transition type"),
        "border": (int, 0, "border width"),
        "depth": (int, 16, "mask bits"),
        "position": (float, 0.0, "transition position [0..1]"),
        "invert": (bool, False, "invert the mask"),
    }

    def __init__(self, name=None, **props):
        if "type" in props:
            props["type"] = _parse_type(props["type"])
        super().__init__(name=name, **props)
        self._info: Optional[VideoInfo] = None
        self._alpha_idx = 3
        self._mask_t = None

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._info = VideoInfo.from_caps_structure(incaps[0])
            self._mask_t = None

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        data = list(buf.data)
        a = data[self._alpha_idx]
        if self._mask_t is None:
            self._mask_t = _mask(self.props, self._info, a.device)
        border = int(self.props["border"]) or 1
        # gstsmptealpha.c:494 — double multiply, truncated to gint
        pos = int(((1 << self.props["depth"])
                   + (int(self.props["border"]) or 0))
                  * float(self.props["position"]))
        value = _wipe_value(self._mask_t, pos - border, pos, border)
        data[self._alpha_idx] = ((a.to(torch.int32) * value) >> 8).to(a.dtype)
        return buf.with_(data=tuple(data))
