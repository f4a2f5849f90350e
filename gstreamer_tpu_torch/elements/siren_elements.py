"""Siren7 (G.722.1 16 kHz) codec + RTP elements.

* sirendec / sirenenc — gst-plugins-bad/gst/siren/gstsirendec.c:1 /
  gstsirenenc.c:1: ``audio/x-siren, dct-length=320`` ↔ S16LE 16 kHz
  mono, 40-byte frames per 320 samples (20 ms, 16 kbit/s).
* rtpsirenpay / rtpsirendepay —
  gst-plugins-good/gst/rtp/gstrtpsirenpay.c:1 / gstrtpsirendepay.c:1:
  dynamic-PT audio payload, encoding-name SIREN, 16 kHz RTP clock,
  whole 40-byte frames packed back-to-back up to the MTU.

The codec itself is the clean-room implementation in
``codecs/siren.py`` (encoder verified bit-identical to the reference
library on tonal/speech-like signals, decoder ≤1 LSB).

A copy of the JAX package's ``elements/siren_elements.py``. Coded frames
and packets stay host bytes (``host_array``); the elements that take them
set ``HOST_INPUT``, and sirendec puts its PCM on the element's device in
one copy (``device_array``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve
from ..net.rtp import parse_rtp_header, rtp_header

_SIREN_CAPS = "audio/x-siren, dct-length=320"
_PCM_CAPS = ("audio/x-raw, format=S16LE, rate=16000, channels=1, "
             "layout=interleaved")
_FRAME_BYTES = 40
_FRAME_SAMPLES = 320


def _blobs(buf: Buffer) -> List[bytes]:
    d = buf.data
    if isinstance(d, (list, tuple)):
        return [bytes(x) if isinstance(x, (bytes, bytearray))
                else host_array(x).tobytes() for x in d]
    arr = host_array(d)
    if getattr(buf, "batch", 1) > 1 and arr.ndim > 1:
        return [arr[k].tobytes() for k in range(arr.shape[0])]
    return [arr.tobytes()]


@register_element
class SirenDec(TransformElement):
    FACTORY = "sirendec"
    DESCRIPTION = "Siren7 (G.722.1 at 16kHz) decoder"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host frames
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _SIREN_CAPS),
        PadTemplate("src", PadDirection.SRC, _PCM_CAPS),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._dec = None
        self._pending = b""
        self._nout = 0

    def start(self):
        from ..codecs.siren import SirenDecoder
        self._dec = SirenDecoder(16000)
        self._pending = b""
        self._nout = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            _PCM_CAPS if direction == PadDirection.SINK else _SIREN_CAPS)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        if self._dec is None:
            self.start()
        data = self._pending + b"".join(_blobs(buf))
        n = (len(data) // _FRAME_BYTES) * _FRAME_BYTES
        self._pending = data[n:]
        if n == 0:
            return None
        outs = [self._dec.decode_frame(data[i:i + _FRAME_BYTES])
                for i in range(0, n, _FRAME_BYTES)]
        pcm = np.concatenate(outs).reshape(-1, 1)
        pts = self._nout * 1_000_000_000 // 16000
        self._nout += pcm.shape[0]
        return buf.with_(data=device_array(pcm, resolve(self.device)),
                         batch=1, pts=pts,
                         duration=pcm.shape[0] * 1_000_000_000 // 16000)


@register_element
class SirenEnc(TransformElement):
    FACTORY = "sirenenc"
    DESCRIPTION = "Siren7 (G.722.1 at 16kHz) encoder"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _PCM_CAPS),
        PadTemplate("src", PadDirection.SRC, _SIREN_CAPS),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._enc = None
        self._pending = np.zeros(0, np.int16)
        self._nin = 0

    def start(self):
        from ..codecs.siren import SirenEncoder
        self._enc = SirenEncoder(16000)
        self._pending = np.zeros(0, np.int16)
        self._nin = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            _SIREN_CAPS if direction == PadDirection.SINK else _PCM_CAPS)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        if self._enc is None:
            self.start()
        raw = b"".join(_blobs(buf))
        samples = np.concatenate(
            [self._pending, np.frombuffer(raw, "<i2")])
        n = (len(samples) // _FRAME_SAMPLES) * _FRAME_SAMPLES
        self._pending = samples[n:]
        if n == 0:
            return None
        frames = [self._enc.encode_frame(samples[i:i + _FRAME_SAMPLES])
                  for i in range(0, n, _FRAME_SAMPLES)]
        pts = self._nin * 1_000_000_000 // 16000
        self._nin += n
        return buf.with_(data=b"".join(frames), batch=1, pts=pts,
                         duration=n * 1_000_000_000 // 16000)


@register_element
class RtpSirenPay(TransformElement):
    FACTORY = "rtpsirenpay"
    DESCRIPTION = "RTP Siren payloader (encoding-name SIREN)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host frames
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _SIREN_CAPS),
        PadTemplate("src", PadDirection.SRC,
                    "application/x-rtp, media=audio, clock-rate=16000, "
                    "encoding-name=SIREN"),
    ]
    PROPERTIES = {
        "mtu": (int, 1400, "max packet size"),
        "pt": (int, 96, "payload type"),
        "ssrc": (int, 0x51524E, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0

    def start(self):
        self._seq = 0

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-rtp, media=audio, "
                                "clock-rate=16000, encoding-name=SIREN")
               if direction == PadDirection.SINK
               else Caps.from_string(_SIREN_CAPS))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        raw = b"".join(_blobs(buf))
        nframes_room = max(1, (self.props["mtu"] - 12) // _FRAME_BYTES)
        room = nframes_room * _FRAME_BYTES
        ts = ((buf.pts or 0) * 16000) // 1_000_000_000
        pkts = []
        for off in range(0, len(raw) // _FRAME_BYTES * _FRAME_BYTES, room):
            chunk = raw[off:off + room]
            pkts.append(rtp_header(self.props["pt"], self._seq,
                                   (ts + (off // _FRAME_BYTES)
                                    * _FRAME_SAMPLES) & 0xFFFFFFFF,
                                   self.props["ssrc"]) + chunk)
            self._seq = (self._seq + 1) & 0xFFFF
        if not pkts:
            return None
        return buf.with_(data=pkts)


@register_element
class RtpSirenDepay(TransformElement):
    FACTORY = "rtpsirendepay"
    DESCRIPTION = "RTP Siren depayloader"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/x-rtp, media=audio, clock-rate=16000, "
                    "encoding-name=SIREN"),
        PadTemplate("src", PadDirection.SRC, _SIREN_CAPS),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string(_SIREN_CAPS)
               if direction == PadDirection.SINK
               else Caps.from_string(
                   "application/x-rtp, media=audio, clock-rate=16000, "
                   "encoding-name=SIREN"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        out = []
        pts = None
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            if h is None:
                continue
            if pts is None:
                pts = h["timestamp"] * 1_000_000_000 // 16000
            payload = h["payload"]
            out.append(payload[:len(payload) // _FRAME_BYTES
                               * _FRAME_BYTES])
        if not out:
            return None
        data = b"".join(out)
        return buf.with_(data=data, pts=pts,
                         duration=(len(data) // _FRAME_BYTES)
                         * 20_000_000)
