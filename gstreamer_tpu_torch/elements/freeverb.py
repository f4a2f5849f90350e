"""freeverb — the classic public-domain Schroeder/Moorer reverb, in torch.

A port of the JAX package's ``elements/freeverb.py`` (reference:
gst-plugins-bad gst/freeverb/gstfreeverb.c, Jezar's Freeverb): 8 damped
combs in parallel and 4 allpasses in series a channel, the 44.1 kHz
tunings scaled by rate/44100 with float32 truncation, the DC_OFFSET
anti-denormal trick, the room-size/damping/width/level mapping and the
stereo crossmix; mono input feeds both sides ((2*in + DC)*gain), the
output is always stereo.

The per-sample recursion is ``ops/freeverb_kernel.py``: the CUDA kernel
on the card, its plain version on the CPU.  The state (rings, indices,
filterstores) lives on the pipeline's device, carried across buffers and
reset at ``start`` and ``set_info``.  Every float32 operation is rounded on
its own, as the scalar reference does; the JAX package's scan lets XLA
contract them into fused multiply-adds, so it is up to a few 1e-8 away
(ROADMAP.md section 3).  S16: cast to float32 with no scaling, then
clipped and truncated, as the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..audio.info import AudioInfo
from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..ops import freeverb_kernel as fk
from ..ops.freeverb_kernel import (ALLPASS_TUNINGS, COMB_TUNINGS,  # noqa: F401
                                   DC_OFFSET, FIXED_GAIN, OFFSET_ROOM,
                                   SCALE_ROOM, STEREO_SPREAD)

_SINK = ("audio/x-raw, format={ F32LE, S16LE }, rate=[1,2147483647], "
         "channels=[1,2], layout=interleaved")
_SRC = ("audio/x-raw, format={ F32LE, S16LE }, rate=[1,2147483647], "
        "channels=2, layout=interleaved")


@register_element
class Freeverb(TransformElement):
    FACTORY = "freeverb"
    DESCRIPTION = "Add reverberation to audio streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _SINK),
        PadTemplate("src", PadDirection.SRC, _SRC),
    ]
    PROPERTIES = {
        "room-size": (float, 0.5, "size of the simulated room"),
        "damping": (float, 0.2, "damping of high frequencies"),
        "width": (float, 1.0, "stereo panorama width"),
        "level": (float, 0.5, "dry/wet level"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._state = None

    def start(self):
        self._state = None

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            tmpl = _SRC if direction == PadDirection.SINK else _SINK
            ns = Caps.from_string(tmpl)[0].copy()
            for key in ("format", "rate"):
                if key in s.fields:
                    ns[key] = s[key]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])
        self._state = None

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        x = buf.data
        if x.dim() == 1:
            x = x[:, None]
        sizes = fk.ring_sizes(self._info.rate)
        if self._state is None:
            self._state = fk.fresh_state(1, sizes, x.device)
        prm = fk.params(self.props["room-size"], self.props["damping"],
                        self.props["width"], self.props["level"])
        out = fk.freeverb(x.to(torch.float32).contiguous()[None],
                          self._state, sizes, prm)[0]
        if x.dtype == torch.int16:
            out = torch.clamp(out, -32768, 32767).to(torch.int16)
        return buf.with_(data=out)
