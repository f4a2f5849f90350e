"""mulawenc / mulawdec / alawenc / alawdec — the G.711 law codecs.

A port of the JAX package's ``elements/law_elements.py`` (references:
gst-plugins-good gst/law/mulaw-encode.c:41, mulaw-decode.c:57,
alaw-encode.c:309, alaw-decode.c:116): S16 interleaved 8-192 kHz, one or two
channels on the raw side; the coded side carries rate and channels only.
Pure transforms: the companding is one elementwise integer expression on the
tensor's device (``audio/law.py``).
"""

from __future__ import annotations

from ..audio import law
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

_RAW = ("audio/x-raw, format=S16LE, layout=interleaved, "
        "rate=[8000,192000], channels=[1,2]")
_MULAW = "audio/x-mulaw, rate=[8000,192000], channels=[1,2]"
_ALAW = "audio/x-alaw, rate=[8000,192000], channels=[1,2]"


class _LawBase(TransformElement):
    """Raw <-> coded caps, keeping rate and channels."""
    _SINK_CAPS = _RAW
    _SRC_CAPS = _RAW

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            tmpl = (self._SRC_CAPS if direction == PadDirection.SINK
                    else self._SINK_CAPS)
            ns = Caps.from_string(tmpl)[0].copy()
            for key in ("rate", "channels"):
                if key in s.fields:
                    ns[key] = s[key]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass


@register_element
class MuLawEnc(_LawBase):
    """mulawenc (mulaw-encode.c): S16 -> mu-law."""
    FACTORY = "mulawenc"
    DESCRIPTION = "Convert 16bit PCM to 8bit mu law"
    _SINK_CAPS, _SRC_CAPS = _RAW, _MULAW
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _RAW),
        PadTemplate("src", PadDirection.SRC, _MULAW),
    ]

    def make_fn(self):
        return law.mulaw_encode


@register_element
class MuLawDec(_LawBase):
    """mulawdec (mulaw-decode.c): mu-law -> S16."""
    FACTORY = "mulawdec"
    DESCRIPTION = "Convert 8bit mu law to 16bit PCM"
    _SINK_CAPS, _SRC_CAPS = _MULAW, _RAW
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _MULAW),
        PadTemplate("src", PadDirection.SRC, _RAW),
    ]

    def make_fn(self):
        return law.mulaw_decode


@register_element
class ALawEnc(_LawBase):
    """alawenc (alaw-encode.c): S16 -> A-law."""
    FACTORY = "alawenc"
    DESCRIPTION = "Convert 16bit PCM to 8bit A law"
    _SINK_CAPS, _SRC_CAPS = _RAW, _ALAW
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _RAW),
        PadTemplate("src", PadDirection.SRC, _ALAW),
    ]

    def make_fn(self):
        return law.alaw_encode


@register_element
class ALawDec(_LawBase):
    """alawdec (alaw-decode.c): A-law -> S16."""
    FACTORY = "alawdec"
    DESCRIPTION = "Convert 8bit A law to 16bit PCM"
    _SINK_CAPS, _SRC_CAPS = _ALAW, _RAW
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _ALAW),
        PadTemplate("src", PadDirection.SRC, _RAW),
    ]

    def make_fn(self):
        return law.alaw_decode
