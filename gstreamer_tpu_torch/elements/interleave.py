"""interleave / deinterleave — channel split and merge, in torch.

A port of the JAX package's ``elements/interleave.py`` (reference:
gst-plugins-good/gst/interleave/):

* deinterleave (deinterleave.c): one N-channel stream -> N mono streams on
  src_%u request pads (pad k carries channel k); `keep-positions` records
  the original channel position in the buffer meta.  A host element whose
  ``route_outputs`` slices the channel axis of the tensor where it lies.
* interleave (interleave.c): N mono sink_%u streams -> one N-channel
  stream, channel k from the k-th pad name in sorted (lexical) order, as
  the reference orders them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..audio.info import AudioInfo
from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, TransformElement,
                            register_element)
from ..core.value import IntRange

_ANY_AUDIO = ("audio/x-raw, rate=[1,2147483647], channels=[1,64], "
              "layout=interleaved")
_MONO = "audio/x-raw, rate=[1,2147483647], channels=1, layout=interleaved"


@register_element
class Deinterleave(TransformElement):
    FACTORY = "deinterleave"
    DESCRIPTION = "Splits one interleaved multichannel audio stream " \
                  "into many mono audio streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _ANY_AUDIO),
        PadTemplate("src_%u", PadDirection.SRC, _MONO,
                    PadPresence.REQUEST),
    ]
    PROPERTIES = {"keep-positions": (bool, False, "")}

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            ns = s.copy()
            if direction == PadDirection.SINK:
                ns["channels"] = 1
            else:
                ns["channels"] = IntRange(1, 64)
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        return buf                   # routing happens in route_outputs

    def route_outputs(self, buf: Buffer) -> Dict[str, Buffer]:
        x = buf.data
        out = {}
        for k, sp in enumerate(self.src_pads()):
            if k >= x.shape[-1]:
                break
            meta = dict(buf.meta or {})
            if self.props["keep-positions"]:
                meta["channel-position"] = k
            out[sp.name] = buf.with_(data=x[..., k:k + 1], meta=meta)
        return out


@register_element
class Interleave(AggregatorElement):
    FACTORY = "interleave"
    DESCRIPTION = "Folds many mono channels into one interleaved " \
                  "audio stream"
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK, _MONO,
                    PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, _ANY_AUDIO),
    ]
    PROPERTIES = {"channel-positions-from-input": (bool, True, "")}

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed):
        first = next(iter(in_caps.values())).fixate()[0]
        s = first.copy()
        s["channels"] = len(in_caps)
        self._order = sorted(in_caps)
        res = Caps([s]).intersect(allowed)
        return res.fixate() if not res.is_empty else Caps([s])

    def aggregate_fn(self):
        order = self._order

        def fn(inputs):
            chans = [inputs[n] for n in order if n in inputs]
            chans = [c[0] if isinstance(c, (list, tuple)) else c
                     for c in chans]
            return torch.cat([c.reshape(c.shape[0], -1)[..., :1]
                              if c.ndim > 1 else c[:, None]
                              for c in chans], dim=-1)

        return fn
