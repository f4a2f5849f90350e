"""shapewipe — mask-driven alpha transition, in torch.

A port of the JAX package's ``elements/shapewipe.py`` (reference:
gst-plugins-good/gst/shapewipe/gstshapewipe.c): a grayscale mask on
`mask_sink` gates the alpha of the video on `video_sink`.  Exact kernel
(CREATE_ARGB_FUNCTIONS :764-831, identically used for AYUV):
  in = mask << 8 (GRAY8) or mask (GRAY16) into a 16-bit domain,
  low/high = position -/+ border/2 (float32, clamped as in :782-791),
  in <  low*65536  -> A = 0,
  in >= high*65536 -> A = input A,
  else A = ((((in-low_i)<<16)+round_i)//(high_i-low_i) * A + 32768)>>16.
Color components always pass through; only the A plane is rewritten.

The reference computes in uint32, where ``in - low_i`` wraps when
``in < low_i``; those pixels take A = 0 from the select whatever the
wrapped value.  Here the arithmetic is int64 (torch has no uint32
arithmetic) under the same select: on the pixels it selects nothing wraps
in uint32, so the values agree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadTemplate,
                            register_element)

_VIDEO_CAPS = ("video/x-raw, format={ AYUV, ARGB, BGRA, ABGR, RGBA }, "
               "width=[1,32767], height=[1,32767], "
               "framerate=[0/1,2147483647/1]")
_MASK_CAPS = ("video/x-raw, format={ GRAY8, GRAY16_LE }, "
              "width=[1,32767], height=[1,32767], "
              "framerate=[0/1,2147483647/1]")


@register_element
class ShapeWipe(AggregatorElement):
    FACTORY = "shapewipe"
    DESCRIPTION = "Adds a shape wipe transition to a video stream"
    PAD_TEMPLATES = [
        PadTemplate("video_sink", PadDirection.SINK, _VIDEO_CAPS),
        PadTemplate("mask_sink", PadDirection.SINK, _MASK_CAPS),
        PadTemplate("src", PadDirection.SRC, _VIDEO_CAPS),
    ]
    PROPERTIES = {
        "position": (float, 0.0, "mask position 0..1"),
        "border": (float, 0.0, "blended border width 0..1"),
    }

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed) -> Caps:
        video = in_caps["video_sink"][0].copy()
        mask = in_caps["mask_sink"][0]
        if (video["width"], video["height"]) != (mask["width"],
                                                 mask["height"]):
            from ..core.pipeline import NegotiationError
            raise NegotiationError(
                f"{self.name}: mask {mask['width']}x{mask['height']} != "
                f"video {video['width']}x{video['height']}")
        self._mask16 = mask["format"] == "GRAY16_LE"
        out = Caps([video])
        res = out.intersect(allowed)
        return res.fixate() if not res.is_empty else out

    def aggregate_fn(self):
        mask16 = self._mask16
        position = np.float32(self.props["position"])
        border = np.float32(self.props["border"])
        low = np.float32(position - border / np.float32(2.0))
        high = np.float32(position + border / np.float32(2.0))
        if low < 0.0:
            low = high = np.float32(0.0)
        if high > 1.0:
            low = high = np.float32(1.0)
        lo = int(np.uint32(np.float32(low) * 65536))
        hi = int(np.uint32(np.float32(high) * 65536))
        round_i = (hi - lo) >> 1
        div = max(hi - lo, 1)

        def fn(inputs):
            video = inputs["video_sink"]
            mask = inputs["mask_sink"]
            mask = mask[0] if isinstance(mask, (list, tuple)) else mask
            m = mask.to(torch.int64)
            if not mask16:
                m = m << 8
            a = video[3].to(torch.int64)
            val = (((m - lo) << 16) + round_i) // div
            val = (val * a + 32768) >> 16
            new_a = torch.where(m < lo, 0, torch.where(m >= hi, a, val))
            return tuple(video[:3]) + (new_a.to(video[3].dtype),)

        return fn
