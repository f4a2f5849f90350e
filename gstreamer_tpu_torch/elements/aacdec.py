"""faad — AAC-LC audio decoder element.

Reference: gst-plugins-bad/ext/faad/gstfaad.c:1 (a faad2 wrapper; the
reference never implements AAC itself — gst-libav is the other route).
Here the decode is the clean-room spec implementation in
codecs/aac.py; the element consumes ADTS frames (from aacparse or a
demuxer) or raw access units with codec_data, and emits interleaved
F32 audio.

Chain: filesrc location=x.aac ! aacparse ! faad ! ...

A port of the JAX package's ``elements/aacdec.py``: the frames come to the
host (``host_array``), a tick's frames decode there, and the decoded
samples go to the element's device in one copy (``device_array``), as
``mpg123audiodec`` does.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve


def _frames_of(buf: Buffer) -> List[bytes]:
    if isinstance(buf.data, list):
        return [b if isinstance(b, (bytes, bytearray))
                else host_array(b).tobytes() for b in buf.data]
    arr = host_array(buf.data)
    if buf.batch > 1 and arr.ndim > 1:
        return [arr[k].tobytes() for k in range(buf.batch)]
    return [arr.tobytes()]


@register_element
class Faad(TransformElement):
    FACTORY = "faad"
    DESCRIPTION = "Free MPEG-2/4 AAC decoder"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/mpeg, mpegversion={ 2, 4 }"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=F32LE, rate=[7350,96000], "
                    "channels=[1,8], layout=interleaved"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._dec = None
        self._peeked = None
        self._nout = 0

    def start(self):
        self._dec = None
        self._nout = 0

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = None
            if self._peeked is None:
                from .image_codecs import _peek_upstream
                probe = self
                for _ in range(6):
                    blob = _peek_upstream(probe)
                    if blob is not None:
                        self._peeked = blob
                        break
                    pads = probe.sink_pads()
                    if not pads or pads[0].peer is None:
                        break
                    probe = pads[0].peer.element
            if self._peeked is not None:
                from ..codecs import aac as A
                blob = bytes(self._peeked)
                for pos in range(min(len(blob), 4096)):
                    hdr = A.parse_adts_header(blob, pos)
                    if hdr is not None:
                        fl, sfi, cc, _p, hl = hdr
                        ch = max(cc, 1)
                        rate = A.SAMPLE_RATES[sfi]
                        # decode the first frame to detect an SBR
                        # extension (HE-AAC doubles the output rate;
                        # gstfaad.c:1 learns this from faad's first
                        # frame the same way)
                        try:
                            probe_dec = A.AACDecoder(sfi, cc)
                            frame = probe_dec.decode_frame(
                                A.Bits(blob[pos + hl:pos + fl]))
                            if probe_dec.sbr_present:
                                rate *= 2
                            ch = max(frame.shape[1], ch)
                        except (A.EndOfData, ValueError,
                                IndexError):
                            pass
                        res = Caps.from_string(
                            "audio/x-raw, format=F32LE, "
                            f"rate={rate}, "
                            f"channels={ch}, layout=interleaved")
                        break
            if res is None:
                res = self.src_pads()[0].template_caps
        else:
            res = Caps.from_string("audio/mpeg, mpegversion=4")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        from ..codecs import aac as A
        codec_data = (buf.meta or {}).get("codec_data")
        chunks = []
        for frame in _frames_of(buf):
            if self._dec is None:
                hdr = A.parse_adts_header(frame)
                if hdr is not None:
                    _fl, sfi, cc, _p, _hl = hdr
                    self._dec = A.AACDecoder(sfi, cc)
                elif codec_data:
                    _aot, sfi, cc = A.parse_audio_specific_config(
                        bytes(codec_data))
                    self._dec = A.AACDecoder(sfi, cc)
                else:
                    continue
            hdr = A.parse_adts_header(frame)
            payload = frame[hdr[4]:hdr[0]] if hdr is not None else frame
            try:
                chunks.append(self._dec.decode_frame(A.Bits(payload)))
            except (A.EndOfData, ValueError):
                continue
        if not chunks:
            return None
        nch = max(f.shape[1] for f in chunks)
        chunks = [np.pad(f, ((0, 0), (0, nch - f.shape[1])))
                  if f.shape[1] < nch else f for f in chunks]
        out = np.concatenate(chunks, axis=0).astype(np.float32)
        rate = self._dec.output_rate
        pts = self._nout * 1_000_000_000 // rate
        self._nout += len(out)
        return Buffer(data=device_array(out, resolve(self.device)),
                      batch=1, pts=pts,
                      duration=len(out) * 1_000_000_000 // rate)
