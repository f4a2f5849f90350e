"""Raw-audio RTP profiles L8 / L24 + the Asterisk H.263 shim.

References (gst-plugins-good/gst/rtp/):
* gstrtpL8pay.c:57-70 / gstrtpL8depay.c — RFC 3551 §4.5.10 L8: 8-bit
  offset-binary (caps format U8), encoding-name L8.
* gstrtpL24pay.c / gstrtpL24depay.c — RFC 3190 §4 L24: 24-bit linear
  big-endian (caps format S24BE), encoding-name L24.
* gstasteriskh263.c — repacks RTP H.263 payloads into Asterisk's
  ``application/x-asteriskh263`` framing: a 6-byte header per packet
  (4-byte BE timestamp delta in samples, 2-byte BE payload length with
  the RTP marker in the top bit) followed by the payload verbatim
  (chain at gstasteriskh263.c: asterisk_len |= 0x8000 when M).

A copy of the JAX package's ``net/rtp_raw_audio.py``. The payloaders copy
each tick's samples to the host (``host_array``); the depayloaders put
theirs on the element's device (``device_array``).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve
from .rtp import parse_rtp_header, rtp_header


class _RawAudioPayBase(TransformElement):
    HOST_ELEMENT = True
    PROPERTIES = {
        "mtu": (int, 1400, ""),
        "pt": (int, 96, ""),
        "ssrc": (int, 0xBEEF, ""),
    }
    _BPS = 1             # bytes per sample on the wire
    _NPFMT = None        # numpy wire dtype (None = passthrough bytes)

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0
        self._ts = 0
        self._ainfo = None

    def start(self):
        self._seq = 0
        self._ts = 0

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-rtp")
               if direction == PadDirection.SINK
               else self.sink_pads()[0].template_caps)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        from ..audio.info import AudioInfo
        self._ainfo = AudioInfo.from_caps_structure(incaps[0])

    def _wire(self, x: np.ndarray) -> bytes:
        raise NotImplementedError

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        x = host_array(buf.data)
        if x.ndim == 1:
            x = x[:, None]
        # the negotiated channel count frames the wire bytes: packed
        # 24-bit input is one row of bytes per frame (or one flat row),
        # which the array's shape does not count in channels (the JAX
        # package takes x.shape[1]: ROADMAP.md section 3)
        ch = self._ainfo.channels if self._ainfo is not None else x.shape[1]
        wire = self._wire(x)
        bpf = self._BPS * ch
        room = max(bpf, (self.props["mtu"] - 12) // bpf * bpf)
        pkts = []
        for off in range(0, len(wire), room):
            chunk = wire[off:off + room]
            hdr = rtp_header(self.props["pt"], self._seq, self._ts,
                             self.props["ssrc"])
            self._seq = (self._seq + 1) & 0xFFFF
            self._ts = (self._ts + len(chunk) // bpf) & 0xFFFFFFFF
            pkts.append(hdr + chunk)
        return buf.with_(data=pkts)


class _RawAudioDepayBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PROPERTIES = {
        "caps": (object, None, "output audio caps (rate/channels)"),
    }
    _RAW = "audio/x-raw"

    def __init__(self, name=None, **props):
        if "caps" in props and isinstance(props["caps"], str):
            props["caps"] = Caps.from_string(props["caps"])
        super().__init__(name=name, **props)
        self._ainfo = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = self.props["caps"] or self.src_pads()[0].template_caps
        else:
            res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        from ..audio.info import AudioInfo
        self._ainfo = AudioInfo.from_caps_structure(outcaps[0])

    def _unwire(self, raw: bytes, ch: int) -> np.ndarray:
        raise NotImplementedError

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        pkts = buf.data if isinstance(buf.data, list) else [
            host_array(buf.data).tobytes()]
        chunks = []
        for pkt in pkts:
            if isinstance(pkt, (np.ndarray, torch.Tensor)):
                pkt = host_array(pkt).tobytes()
            chunks.append(parse_rtp_header(pkt)["payload"])
        raw = b"".join(chunks)
        ch = self._ainfo.channels if self._ainfo else 1
        return buf.with_(data=device_array(self._unwire(raw, ch),
                                           resolve(self.device)))


@register_element
class RtpL8Pay(_RawAudioPayBase):
    FACTORY = "rtpL8pay"
    DESCRIPTION = "Payload L8 (8-bit offset-binary) audio as RTP"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=U8"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    _BPS = 1

    def _wire(self, x: np.ndarray) -> bytes:
        return x.astype(np.uint8).tobytes()


@register_element
class RtpL8Depay(_RawAudioDepayBase):
    FACTORY = "rtpL8depay"
    DESCRIPTION = "Depayload L8 audio from RTP"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=U8"),
    ]

    def _unwire(self, raw: bytes, ch: int) -> np.ndarray:
        n = len(raw) // ch * ch
        return np.frombuffer(raw[:n], np.uint8).reshape(-1, ch)


@register_element
class RtpL24Pay(_RawAudioPayBase):
    FACTORY = "rtpL24pay"
    DESCRIPTION = "Payload L24 (24-bit big-endian) audio as RTP " \
                  "(RFC 3190)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=S24BE"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    _BPS = 3

    def _wire(self, x: np.ndarray) -> bytes:
        # input arrives as packed 3-byte BE samples (uint8 view) or as
        # int32 values to be truncated to 24 bits
        if x.dtype == np.uint8:
            return x.tobytes()
        x32 = x.astype(">i4").view(np.uint8).reshape(-1, 4)
        return x32[:, 1:].tobytes()      # drop the high byte -> 24-bit


@register_element
class RtpL24Depay(_RawAudioDepayBase):
    FACTORY = "rtpL24depay"
    DESCRIPTION = "Depayload L24 audio from RTP (RFC 3190)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=S24BE"),
    ]

    def _unwire(self, raw: bytes, ch: int) -> np.ndarray:
        bpf = 3 * ch
        n = len(raw) // bpf * bpf
        return np.frombuffer(raw[:n], np.uint8).reshape(-1, 3 * ch)


@register_element
class AsteriskH263(TransformElement):
    """asteriskh263: RTP H.263 -> Asterisk PBX framing."""
    FACTORY = "asteriskh263"
    DESCRIPTION = "Extracts H263 video from RTP and encodes in " \
                  "Asterisk H263 format"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/x-rtp, media=video, clock-rate=90000, "
                    "encoding-name=H263-1998"),
        PadTemplate("src", PadDirection.SRC,
                    "application/x-asteriskh263"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._lastts = None

    def start(self):
        self._lastts = None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "application/x-asteriskh263"
            if direction == PadDirection.SINK else
            "application/x-rtp, media=video, clock-rate=90000, "
            "encoding-name=H263-1998")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        pkts = buf.data if isinstance(buf.data, list) else [
            host_array(buf.data).tobytes()]
        outs = []
        for pkt in pkts:
            if isinstance(pkt, (np.ndarray, torch.Tensor)):
                pkt = host_array(pkt).tobytes()
            info = parse_rtp_header(pkt)
            payload = info["payload"]
            ts = info["timestamp"]
            if self._lastts is None:
                self._lastts = ts
            samples = (ts - self._lastts) & 0xFFFFFFFF
            self._lastts = ts
            alen = len(payload)
            if info.get("marker"):
                alen |= 0x8000
            outs.append(struct.pack(">IH", samples, alen) + payload)
        if not outs:
            return None
        return buf.with_(data=outs)
