"""lc3enc / lc3dec — Bluetooth LE-Audio LC3 codec elements.

Caps contract mirrors the reference liblc3 wrapper
(gst-plugins-bad/ext/lc3/gstlc3common.h:24-33, gstlc3enc.c:69-83,
gstlc3dec.c): coded caps are ``audio/x-lc3`` with ``rate``,
``channels``, ``frame-bytes`` in [20, 400] and ``frame-duration-us``
in {10000, 7500}; raw side is interleaved S16LE at
8/16/24/32/48 kHz.  Each output buffer carries ``frame-bytes`` bytes
per channel, channels back to back (gstlc3enc.c:323-326).

The codec is the clean-room LC3 re-spec in ``codecs/lc3.py`` (no LC3
implementation exists in this environment to wrap or verify against;
see that module's header for the documented reduction).

A port of the JAX package's ``elements/lc3_elements.py``: the encoder copies
each tick's samples to the host (``host_array``), the decoder takes host
frames (``HOST_INPUT``) and puts its PCM on the element's device in one copy
(``device_array``).  One difference: at end of stream lc3enc zero-pads the
last partial frame and codes it, as gstlc3enc does; the JAX package drops
those samples (ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..codecs.lc3 import (MAX_FRAME_BYTES, MIN_FRAME_BYTES, Lc3Decoder,
                          Lc3Encoder, default_frame_bytes)
from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve

_RATES = "{ 8000, 16000, 24000, 32000, 48000 }"
_RAW = ("audio/x-raw, format=S16LE, rate=" + _RATES +
        ", channels=[1,8], layout=interleaved")
_LC3 = ("audio/x-lc3, rate=" + _RATES + ", channels=[1,8], "
        "frame-bytes=[%d,%d], frame-duration-us={ 10000, 7500 }"
        % (MIN_FRAME_BYTES, MAX_FRAME_BYTES))


def _blobs(buf: Buffer) -> List[bytes]:
    d = buf.data
    if isinstance(d, (list, tuple)):
        return [bytes(x) if isinstance(x, (bytes, bytearray))
                else host_array(x).tobytes() for x in d]
    if isinstance(d, (bytes, bytearray)):
        return [bytes(d)]
    return [host_array(d).tobytes()]


@register_element
class Lc3Enc(TransformElement):
    FACTORY = "lc3enc"
    DESCRIPTION = "LC3 (Bluetooth LE Audio) encoder"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _RAW),
        PadTemplate("src", PadDirection.SRC, _LC3),
    ]
    PROPERTIES = {
        "frame-bytes": (int, 0, "coded bytes per channel per frame "
                        "(0 = from downstream caps or 96 kbit/s)"),
        "frame-duration-us": (int, 10000, "frame duration (10000/7500)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._enc: Optional[Lc3Encoder] = None
        self._cfg = None
        self._pending = np.zeros((0, 1), np.int16)
        self._nin = 0
        self._rate = 48000
        self._channels = 1
        self._decouple = True       # a host_process(None) at end of stream
        self._pending_buf = None    # set while samples wait for a frame

    def start(self):
        # negotiation (set_info) may already have configured us
        self._enc = Lc3Encoder(*self._cfg) if self._cfg else None
        self._pending = np.zeros((0, self._channels), np.int16)
        self._pending_buf = None
        self._nin = 0

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            tmpl = _LC3 if direction == PadDirection.SINK else _RAW
            ns = Caps.from_string(tmpl)[0].copy()
            for key in ("rate", "channels"):
                if key in s.fields:
                    ns[key] = s[key]
            if direction == PadDirection.SINK:
                dur = self.props["frame-duration-us"]
                ns["frame-duration-us"] = dur
                if self.props["frame-bytes"]:
                    ns["frame-bytes"] = self.props["frame-bytes"]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction, caps, othercaps):
        s = othercaps[0]
        if not isinstance(s.get("frame-bytes"), int):
            s["frame-bytes"] = (self.props["frame-bytes"] or
                                default_frame_bytes(
                                    self.props["frame-duration-us"]))
        if not isinstance(s.get("frame-duration-us"), int):
            s["frame-duration-us"] = self.props["frame-duration-us"]
        return othercaps.fixate()

    def set_info(self, incaps, outcaps):
        sin, sout = incaps[0], outcaps[0]
        self._rate = sin["rate"]
        self._channels = sin["channels"]
        dur = sout.get("frame-duration-us") or \
            self.props["frame-duration-us"]
        fb = sout.get("frame-bytes") or self.props["frame-bytes"] or \
            default_frame_bytes(dur)
        self._cfg = (self._rate, self._channels, dur, fb)
        self._enc = Lc3Encoder(*self._cfg)
        self._pending = np.zeros((0, self._channels), np.int16)

    def _flush(self) -> Optional[Buffer]:
        """End of stream: the samples short of a frame, zero-padded to a
        whole frame and coded (gstlc3enc drains so)."""
        self._pending_buf = None
        k = len(self._pending)
        if self._enc is None or k == 0:
            return None
        pad = np.zeros((self._enc.nf - k, self._channels), np.int16)
        frame = self._enc.encode_frame(np.concatenate([self._pending, pad]))
        self._pending = self._pending[:0]
        pts = self._nin * 1_000_000_000 // self._rate
        self._nin += k
        return Buffer(data=[frame], batch=1, pts=pts,
                      duration=k * 1_000_000_000 // self._rate)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return self._flush()
        if self._enc is None:
            dur = self.props["frame-duration-us"]
            self._cfg = (self._rate, self._channels, dur,
                         self.props["frame-bytes"]
                         or default_frame_bytes(dur))
            self._enc = Lc3Encoder(*self._cfg)
        raw = b"".join(_blobs(buf))
        x = np.frombuffer(raw, "<i2").reshape(-1, self._channels)
        x = np.concatenate([self._pending, x], axis=0)
        nf = self._enc.nf
        n = (len(x) // nf) * nf
        self._pending = x[n:]
        self._pending_buf = True if len(self._pending) else None
        if n == 0:
            return None
        frames = [self._enc.encode_frame(x[i:i + nf])
                  for i in range(0, n, nf)]
        pts = self._nin * 1_000_000_000 // self._rate
        self._nin += n
        return buf.with_(data=frames, batch=1, pts=pts,
                         duration=n * 1_000_000_000 // self._rate)


@register_element
class Lc3Dec(TransformElement):
    FACTORY = "lc3dec"
    DESCRIPTION = "LC3 (Bluetooth LE Audio) decoder"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host frames
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _LC3),
        PadTemplate("src", PadDirection.SRC, _RAW),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._dec: Optional[Lc3Decoder] = None
        self._cfg = None
        self._pending = b""
        self._nout = 0
        self._rate = 48000
        self._channels = 1

    def start(self):
        self._dec = Lc3Decoder(*self._cfg) if self._cfg else None
        self._pending = b""
        self._nout = 0

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            tmpl = _RAW if direction == PadDirection.SINK else _LC3
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
        self._rate = s["rate"]
        self._channels = s["channels"]
        dur = s.get("frame-duration-us") or 10000
        fb = s.get("frame-bytes") or default_frame_bytes(dur)
        self._cfg = (self._rate, self._channels, dur, fb)
        self._dec = Lc3Decoder(*self._cfg)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        if self._dec is None:
            caps = self.sink_pads()[0].caps
            if caps is None:
                return None
            self.set_info(caps, None)
        data = self._pending + b"".join(_blobs(buf))
        step = self._dec.frame_bytes * self._channels
        n = (len(data) // step) * step
        self._pending = data[n:]
        if n == 0:
            return None
        outs = [self._dec.decode_frame(data[i:i + step])
                for i in range(0, n, step)]
        pcm = np.concatenate(outs, axis=0)
        pts = self._nout * 1_000_000_000 // self._rate
        self._nout += pcm.shape[0]
        return buf.with_(data=device_array(pcm, resolve(self.device)),
                         batch=1, pts=pts,
                         duration=pcm.shape[0] * 1_000_000_000
                         // self._rate)
