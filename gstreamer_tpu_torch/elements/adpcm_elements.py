"""adpcmenc / adpcmdec — IMA(DVI)/Microsoft ADPCM elements.

Shells over audio/adpcm.py mirroring the reference caps contracts
(adpcmenc.c:37-68 dvi-only encoder, adpcmdec.c:44-59 microsoft+dvi
decoder): coded caps are audio/x-adpcm with layout and block_align.

A port of the JAX package's ``elements/adpcm_elements.py`` over the port's
copy of ``audio/adpcm.py``.  adpcmenc copies each tick's samples to the
host and gives host blocks; adpcmdec takes host blocks (unstaged when its
source gives them) and moves the decoded samples to the pipeline's
device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..audio import adpcm
from ..audio.info import AudioInfo
from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve

_RAW = ("audio/x-raw, format=S16LE, rate=[1,2147483647], "
        "channels=[1,2], layout=interleaved")
_ADPCM_DEC = ("audio/x-adpcm, layout={ microsoft, dvi }, "
              "rate=[1,2147483647], channels=[1,2]")
_ADPCM_ENC = ("audio/x-adpcm, layout=dvi, rate=[1,2147483647], "
              "channels=[1,2]")


@register_element
class AdpcmEnc(TransformElement):
    FACTORY = "adpcmenc"
    DESCRIPTION = "Encode ADPCM audio"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _RAW),
        PadTemplate("src", PadDirection.SRC, _ADPCM_ENC),
    ]
    PROPERTIES = {
        "blockalign": (int, 1024, "bytes per block"),
        "layout": (str, "dvi", "only dvi (like the reference)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._hist: Optional[np.ndarray] = None
        self._enc = None

    def start(self):
        self._hist = None
        self._enc = None

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            tmpl = (_ADPCM_ENC if direction == PadDirection.SINK
                    else _RAW)
            ns = Caps.from_string(tmpl)[0].copy()
            for key in ("rate", "channels"):
                if key in s.fields:
                    ns[key] = s[key]
            if direction == PadDirection.SINK:
                ns["block_align"] = self.props["blockalign"]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._enc is None:
            self._enc = adpcm.ImaEncoder(self._info.channels,
                                         self.props["blockalign"])
        x = host_array(buf.data)
        if x.ndim == 1:
            x = x[:, None]
        if self._hist is not None:
            x = np.concatenate([self._hist, x], axis=0)
        spb = self._enc.samples_per_block
        blocks: List[bytes] = []
        pos = 0
        while pos + spb <= len(x):
            blocks.append(self._enc.encode_block(x[pos:pos + spb]))
            pos += spb
        self._hist = x[pos:]
        if not blocks:
            return None
        return buf.with_(data=[np.frombuffer(b, np.uint8)
                               for b in blocks])


@register_element
class AdpcmDec(TransformElement):
    FACTORY = "adpcmdec"
    DESCRIPTION = "Decode MS and IMA ADPCM audio"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _ADPCM_DEC),
        PadTemplate("src", PadDirection.SRC, _RAW),
    ]

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            tmpl = (_RAW if direction == PadDirection.SINK
                    else _ADPCM_DEC)
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
        s = incaps[0]
        self._layout = s.get("layout") or "dvi"
        self._channels = s["channels"]
        self._rate = s["rate"]

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        blobs = buf.data if isinstance(buf.data, list) else [buf.data]
        outs = []
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            if self._layout == "microsoft":
                outs.append(adpcm.decode_ms_block(raw, self._channels))
            else:
                outs.append(adpcm.decode_ima_block(raw, self._channels))
        out = np.concatenate(outs, axis=0)
        return buf.with_(
            data=device_array(out, resolve(self.device)),
            duration=len(out) * 1_000_000_000 // self._rate)
