"""RTP payloaders/depayloaders for coded media + RTP routing + DTMF.

References (gst-plugins-good/gst/rtp/ and gst/dtmf/, gst/rtpmanager/):
* rtppcmupay/rtppcmudepay, rtppcmapay/rtppcmadepay
  (gstrtppcmupay.c/gstrtppcmadepay.c...): RFC 3551 static payload
  types 0 (PCMU) and 8 (PCMA) at an 8 kHz clock, raw law bytes as
  payload, split at the MTU.
* rtph264pay/rtph264depay (gstrtph264pay.c/gstrtph264depay.c):
  RFC 6184 — single-NAL-unit packets when they fit the MTU, FU-A
  fragmentation (S/E bits in the FU header) otherwise; the depayloader
  also accepts STAP-A aggregates.  Output is byte-stream/au with the
  marker bit closing each access unit.
* rtpptdemux (gstrtpptdemux.c): routes packets to a src pad per
  payload type; rtpssrcdemux (gstrtpssrcdemux.c): per SSRC.
* rtpdtmfsrc (gst/dtmf/gstrtpdtmfsrc.c): RFC 4733 telephone-event
  packets — 4-byte event payload (event, E|R|volume, duration),
  timestamp frozen for the tone, redundant end packets;
  rtpdtmfdepay (gstrtpdtmfdepay.c): synthesizes the dual-sine tone
  back to S16 8 kHz audio from the event stream.

A copy of the JAX package's ``net/rtp_payloaders.py``. Packets and coded
frames stay host bytes; the depayloaders of PCM (PCMU, PCMA, DTMF) put
their samples on the element's device (``device_array``). It builds on the
port's ``elements.jpegformat`` and ``elements.dtmf_icy``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadPresence, PadTemplate,
                            SourceElement, TransformElement,
                            register_element)
from ..core.structure import Structure
from ..device import resolve
from .rtp import parse_rtp_header, rtp_header


def _blobs(buf: Buffer) -> List[bytes]:
    d = buf.data
    if isinstance(d, (list, tuple)):
        return [bytes(x) if isinstance(x, (bytes, bytearray))
                else host_array(x).tobytes() for x in d]
    arr = host_array(d)
    if arr.ndim > 1:
        return [bytes(r.tobytes()) for r in arr]
    return [bytes(arr.tobytes())]


# ---------------------------------------------------------------------------
# PCMU / PCMA (RFC 3551)
# ---------------------------------------------------------------------------

class _LawPayBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    _MEDIA = ""
    _PT = 0
    PROPERTIES = {
        "mtu": (int, 1400, "max packet size"),
        "pt": (int, -1, "payload type (-1 = static default)"),
        "ssrc": (int, 0x1234, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-rtp")
               if direction == PadDirection.SINK
               else self.sink_pads()[0].template_caps)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._seq = 0

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        raw = b"".join(_blobs(buf))
        pt = self.props["pt"] if self.props["pt"] >= 0 else self._PT
        room = self.props["mtu"] - 12
        ts = ((buf.pts or 0) * 8000) // 1_000_000_000
        pkts = []
        for off in range(0, len(raw), room):
            chunk = raw[off:off + room]
            pkts.append(rtp_header(pt, self._seq, ts + off,
                                   self.props["ssrc"]) + chunk)
            self._seq = (self._seq + 1) & 0xFFFF
        return buf.with_(data=pkts)


class _LawDepayBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    _MEDIA = ""

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string(
            f"{self._MEDIA}, rate=8000, channels=1")
            if direction == PadDirection.SINK
            else Caps.from_string("application/x-rtp"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        out = []
        pts = None
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            if pts is None:
                pts = h["timestamp"] * 1_000_000_000 // 8000
            out.append(np.frombuffer(h["payload"], np.uint8))
        if not out:
            return None
        samples = np.concatenate(out).reshape(-1, 1)
        return buf.with_(data=device_array(samples, resolve(self.device)),
                         pts=pts,
                         duration=samples.shape[0] * 1_000_000_000
                         // 8000)


@register_element
class RtpPcmuPay(_LawPayBase):
    FACTORY = "rtppcmupay"
    DESCRIPTION = "Payload-encodes PCMU audio into a RTP packet"
    _MEDIA, _PT = "audio/x-mulaw", 0
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-mulaw, rate=8000, channels=1"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]


@register_element
class RtpPcmuDepay(_LawDepayBase):
    FACTORY = "rtppcmudepay"
    DESCRIPTION = "Extracts PCMU audio from RTP packets"
    _MEDIA = "audio/x-mulaw"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-mulaw, rate=8000, channels=1"),
    ]


@register_element
class RtpPcmaPay(_LawPayBase):
    FACTORY = "rtppcmapay"
    DESCRIPTION = "Payload-encodes PCMA audio into a RTP packet"
    _MEDIA, _PT = "audio/x-alaw", 8
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-alaw, rate=8000, channels=1"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]


@register_element
class RtpPcmaDepay(_LawDepayBase):
    FACTORY = "rtppcmadepay"
    DESCRIPTION = "Extracts PCMA audio from RTP packets"
    _MEDIA = "audio/x-alaw"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-alaw, rate=8000, channels=1"),
    ]


# ---------------------------------------------------------------------------
# H.264 (RFC 6184)
# ---------------------------------------------------------------------------

def _split_annexb(raw: bytes) -> List[bytes]:
    out = []
    pos = 0
    while True:
        i = raw.find(b"\x00\x00\x01", pos)
        if i < 0:
            return out
        j = raw.find(b"\x00\x00\x01", i + 3)
        end = len(raw) if j < 0 else j - (1 if raw[j - 1] == 0 else 0)
        if end > i + 3:
            out.append(raw[i + 3:end])
        pos = i + 3
    return out


@register_element
class RtpH264Pay(TransformElement):
    FACTORY = "rtph264pay"
    DESCRIPTION = "Payload-encode H264 video into RTP packets " \
                  "(RFC 6184)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-h264, stream-format=byte-stream, "
                    "alignment=au"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "mtu": (int, 1400, "max packet size"),
        "pt": (int, 96, "payload type"),
        "ssrc": (int, 0x64646464, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-rtp")
               if direction == PadDirection.SINK
               else self.sink_pads()[0].template_caps)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._seq = 0

    def _pkt(self, payload: bytes, ts: int, marker: bool) -> bytes:
        hdr = rtp_header(self.props["pt"], self._seq, ts,
                         self.props["ssrc"], marker=marker)
        self._seq = (self._seq + 1) & 0xFFFF
        return hdr + payload

    def _pay_au(self, au: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 12
        nals = _split_annexb(au)
        pkts = []
        for n, nal in enumerate(nals):
            last_nal = n == len(nals) - 1
            if len(nal) <= room:
                pkts.append(self._pkt(nal, ts, last_nal))
                continue
            # FU-A (RFC 6184 5.8): indicator keeps F/NRI, type 28
            indicator = (nal[0] & 0xE0) | 28
            ntype = nal[0] & 0x1F
            body = nal[1:]
            off = 0
            while off < len(body):
                take = min(room - 2, len(body) - off)
                start = off == 0
                end = off + take >= len(body)
                fu_hdr = (0x80 if start else 0) | (0x40 if end else 0) \
                    | ntype
                pkts.append(self._pkt(
                    bytes([indicator, fu_hdr]) + body[off:off + take],
                    ts, last_nal and end))
                off += take
        return pkts

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        ts0 = buf.pts or 0
        dur = buf.duration or 0
        pkts = []
        for k, au in enumerate(_blobs(buf)):
            ts90 = ((ts0 + k * dur) * 90000) // 1_000_000_000
            pkts.extend(self._pay_au(au, ts90))
        return buf.with_(data=pkts)


@register_element
class RtpH264Depay(TransformElement):
    FACTORY = "rtph264depay"
    DESCRIPTION = "Extracts H264 video from RTP packets (RFC 6184)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    _decouple = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-h264, stream-format=byte-stream, "
                    "alignment=au"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._au = bytearray()
        self._fu = bytearray()

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string(
            "video/x-h264, stream-format=byte-stream, alignment=au")
            if direction == PadDirection.SINK
            else Caps.from_string("application/x-rtp"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._au = bytearray()
        self._fu = bytearray()

    @property
    def _pending_buf(self):
        return True if self._au else None

    def _push_nal(self, nal: bytes) -> None:
        self._au += b"\x00\x00\x00\x01" + nal

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:                          # EOS drain
            if not self._au:
                return None
            au = bytes(self._au)
            self._au = bytearray()
            return Buffer(data=np.frombuffer(au, np.uint8), batch=1)
        aus = []
        pts = buf.pts
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            payload = h["payload"]
            if not payload:
                continue
            ntype = payload[0] & 0x1F
            if ntype == 28:                      # FU-A
                fu = payload[1]
                if fu & 0x80:                    # start
                    self._fu = bytearray(
                        [(payload[0] & 0xE0) | (fu & 0x1F)])
                self._fu += payload[2:]
                if fu & 0x40:                    # end
                    self._push_nal(bytes(self._fu))
                    self._fu = bytearray()
            elif ntype == 24:                    # STAP-A
                p = 1
                while p + 2 <= len(payload):
                    ln = struct.unpack(">H", payload[p:p + 2])[0]
                    self._push_nal(payload[p + 2:p + 2 + ln])
                    p += 2 + ln
            elif 1 <= ntype <= 23:
                self._push_nal(payload)
            if h["marker"] and self._au:
                aus.append(bytes(self._au))
                self._au = bytearray()
        if not aus:
            return None
        data = [np.frombuffer(a, np.uint8) for a in aus]
        return buf.with_(data=data if len(data) > 1 else data[0],
                         pts=pts, batch=len(data))


# ---------------------------------------------------------------------------
# rtpptdemux / rtpssrcdemux (gstrtpmanager)
# ---------------------------------------------------------------------------

class _RtpDemuxBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src_%u", PadDirection.SRC, "application/x-rtp",
                    PadPresence.REQUEST),
    ]

    def _key(self, hdr: dict) -> int:
        raise NotImplementedError

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._keys: List[int] = []

    def start(self):
        self._keys = []

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        return buf

    def route_outputs(self, buf: Buffer) -> Dict[str, Buffer]:
        groups: Dict[int, List[bytes]] = {}
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            groups.setdefault(self._key(h), []).append(pkt)
        out = {}
        pads = self.src_pads()
        for key, pkts in groups.items():
            if key not in self._keys:
                self._keys.append(key)
            idx = self._keys.index(key)
            if idx < len(pads):
                out[pads[idx].name] = buf.with_(
                    data=pkts, meta=dict(buf.meta or {},
                                         rtp_key=key))
        return out


@register_element
class RtpPtDemux(_RtpDemuxBase):
    FACTORY = "rtpptdemux"
    DESCRIPTION = "Parses codec streams transmitted in the same RTP " \
                  "session"

    def _key(self, hdr: dict) -> int:
        return hdr["payload_type"]


@register_element
class RtpSsrcDemux(_RtpDemuxBase):
    FACTORY = "rtpssrcdemux"
    DESCRIPTION = "Splits RTP streams based on the SSRC"

    def _key(self, hdr: dict) -> int:
        return hdr["ssrc"]


# ---------------------------------------------------------------------------
# DTMF over RTP (RFC 4733)
# ---------------------------------------------------------------------------

_DTMF_EVENTS = "0123456789*#ABCD"


@register_element
class RtpDtmfSrc(SourceElement):
    """rtpdtmfsrc: telephone-event packets for a key sequence.  The
    reference is driven by dtmf-event upstream events; here the
    `tones` property mirrors our dtmfsrc."""
    FACTORY = "rtpdtmfsrc"
    DESCRIPTION = "Generates RTP DTMF packets"
    PAD_TEMPLATES = [PadTemplate(
        "src", PadDirection.SRC,
        "application/x-rtp, media=audio, encoding-name=TELEPHONE-EVENT")]
    PROPERTIES = {
        "tones": (str, "", "key sequence, e.g. '123#'"),
        "tone-duration": (int, 250, "per-tone ms"),
        "volume": (int, 0, "attenuation in dBm0"),
        "pt": (int, 96, "payload type"),
        "ssrc": (int, 0x44544D46, ""),
        "packet-interval": (int, 50, "ms between event packets"),
        "packet-redundancy": (int, 3, "end-packet retransmits "
                                      "(gstrtpdtmfsrc.c)"),
    }
    RATE = 8000

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._packets: Optional[List[bytes]] = None
        self._pos = 0

    def get_caps(self, filter=None):
        caps = self.src_pads()[0].template_caps
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def _event_payload(self, event: int, end: bool,
                       duration: int) -> bytes:
        b1 = (0x80 if end else 0) | (self.props["volume"] & 0x3F)
        return struct.pack("!BBH", event, b1, duration & 0xFFFF)

    def _build(self) -> List[bytes]:
        pkts = []
        seq = 0
        ts = 0
        interval = self.props["packet-interval"]
        dur_ms = self.props["tone-duration"]
        for c in self.props["tones"].upper():
            if c not in _DTMF_EVENTS:
                continue
            event = _DTMF_EVENTS.index(c)
            # ts frozen for the duration of the event (RFC 4733 2.5.1.2)
            first = True
            elapsed = interval
            while elapsed < dur_ms:
                pkts.append(rtp_header(self.props["pt"], seq, ts,
                                       self.props["ssrc"],
                                       marker=first)
                            + self._event_payload(
                                event, False, elapsed * 8))
                seq = (seq + 1) & 0xFFFF
                first = False
                elapsed += interval
            for _ in range(self.props["packet-redundancy"]):
                pkts.append(rtp_header(self.props["pt"], seq, ts,
                                       self.props["ssrc"],
                                       marker=first)
                            + self._event_payload(
                                event, True, dur_ms * 8))
                seq = (seq + 1) & 0xFFFF
                first = False
            ts += dur_ms * 8
        return pkts

    def start(self):
        self._packets = self._build()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._packets):
            return None
        take = self._packets[self._pos:self._pos + max(1, n_frames) * 4]
        self._pos += len(take)
        # arrays (not bytes) so fully-fused pipelines can carry them
        return Buffer(data=[np.frombuffer(p, np.uint8) for p in take],
                      batch=len(take))


@register_element
class RtpDtmfDepay(TransformElement):
    """rtpdtmfdepay: RFC 4733 events -> synthesized S16 8 kHz tone
    audio (gstrtpdtmfdepay.c generates the dual sine per event)."""
    FACTORY = "rtpdtmfdepay"
    DESCRIPTION = "Generates DTMF sound from telephone-event RTP " \
                  "packets"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=S16LE, rate=8000, channels=1, "
                    "layout=interleaved"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._done: Dict[int, int] = {}          # ts -> samples emitted

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string(
            "audio/x-raw, format=S16LE, rate=8000, channels=1, "
            "layout=interleaved")
            if direction == PadDirection.SINK
            else Caps.from_string("application/x-rtp"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._done = {}

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        from ..elements.dtmf_icy import generate_dtmf
        out = []
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            p = h["payload"]
            if len(p) < 4:
                continue
            event, b1, dur = struct.unpack("!BBH", p[:4])
            if event >= len(_DTMF_EVENTS):
                continue
            volume = b1 & 0x3F
            ts = h["timestamp"]
            emitted = self._done.get(ts, 0)
            if dur <= emitted:
                continue                         # redundant end packet
            key = _DTMF_EVENTS[event]
            out.append(generate_dtmf(key, dur - emitted, 8000,
                                     volume, start_sample=emitted))
            self._done[ts] = dur
        if not out:
            return None
        samples = np.concatenate(out).reshape(-1, 1)
        return buf.with_(data=device_array(samples, resolve(self.device)),
                         duration=samples.shape[0] * 1_000_000_000
                         // 8000)


# ---------------------------------------------------------------------------
# JPEG (RFC 2435) — gstrtpjpegpay.c / gstrtpjpegdepay.c
# ---------------------------------------------------------------------------

_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

# RFC 2435 4.2 default tables (gstrtpjpegdepay.c jpeg_luma_quantizer)
_JPEG_LUMA_Q = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
    92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
    100, 103, 99)
_JPEG_CHROMA_Q = (
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99)

# huffman specs shared with the depay header builder
_LUM_DC = (bytes((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)),
           bytes(range(12)))
_LUM_AC_CODELENS = bytes((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0,
                          1, 0x7D))
_LUM_AC_SYMBOLS = bytes((
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA))
_CHM_DC = (bytes((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)),
           bytes(range(12)))
_CHM_AC_CODELENS = bytes((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1,
                          2, 0x77))
_CHM_AC_SYMBOLS = bytes((
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
    0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
    0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
    0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
    0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA))


def rfc2435_make_tables(q: int) -> bytes:
    """MakeTables (gstrtpjpegdepay.c): Annex-K tables scaled by Q in
    zigzag order, clamped to [1,255]."""
    factor = min(max(q, 1), 99)
    scale = 5000 // factor if q < 50 else 200 - factor * 2
    out = bytearray(128)
    for i in range(64):
        lq = (_JPEG_LUMA_Q[_ZIGZAG[i]] * scale + 50) // 100
        cq = (_JPEG_CHROMA_Q[_ZIGZAG[i]] * scale + 50) // 100
        out[i] = min(max(lq, 1), 255)
        out[i + 64] = min(max(cq, 1), 255)
    return bytes(out)


def rfc2435_make_headers(jtype: int, width8: int, height8: int,
                         qt: bytes, precision: int, dri: int) -> bytes:
    """MakeHeaders (gstrtpjpegdepay.c:362-459): rebuild the JPEG
    interchange headers from the RTP/JPEG fields."""
    def quant_hdr(tab, table_no):
        return bytes([0xFF, 0xDB, 0, len(tab) + 3, table_no]) + tab

    def huff_hdr(codelens, symbols, table_no, table_class):
        return bytes([0xFF, 0xC4, 0,
                      3 + len(codelens) + len(symbols),
                      (table_class << 4) | table_no]) \
            + codelens + symbols

    p = bytearray(b"\xff\xd8")
    size = 128 if precision & 1 else 64
    p += quant_hdr(qt[:size], 0)
    off = size
    size2 = 128 if precision & 2 else 64
    p += quant_hdr(qt[off:off + size2], 1)
    if dri:
        p += bytes([0xFF, 0xDD, 0, 4, dri >> 8, dri & 0xFF])
    w, h = width8 * 8, height8 * 8
    samp0 = 0x21 if (jtype & 0x3F) == 0 else 0x22
    p += bytes([0xFF, 0xC0, 0, 17, 8, h >> 8, h & 0xFF, w >> 8,
                w & 0xFF, 3, 0, samp0, 0, 1, 0x11, 1, 2, 0x11, 1])
    p += huff_hdr(_LUM_DC[0], _LUM_DC[1], 0, 0)
    p += huff_hdr(_LUM_AC_CODELENS, _LUM_AC_SYMBOLS, 0, 1)
    p += huff_hdr(_CHM_DC[0], _CHM_DC[1], 1, 0)
    p += huff_hdr(_CHM_AC_CODELENS, _CHM_AC_SYMBOLS, 1, 1)
    p += bytes([0xFF, 0xDA, 0, 12, 3, 0, 0, 1, 0x11, 2, 0x11, 0,
                63, 0])
    return bytes(p)


@register_element
class RtpJpegPay(TransformElement):
    """rtpjpegpay (RFC 2435): scans the image for DQT/SOF/DRI/SOS,
    strips the headers and sends scan data with the 8-byte RTP/JPEG
    main header (+ restart-marker header, + in-band quant tables on
    the first fragment for Q >= 128)."""
    FACTORY = "rtpjpegpay"
    DESCRIPTION = "Payload-encodes JPEG pictures into RTP packets " \
                  "(RFC 2435)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "image/jpeg"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "mtu": (int, 1400, "max packet size"),
        "pt": (int, 26, "payload type (26 = static JPEG)"),
        "quality": (int, 255, "quality factor signalled in Q "
                              "(>=128: tables in-band)"),
        "ssrc": (int, 0x4A504547, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-rtp")
               if direction == PadDirection.SINK
               else Caps.from_string("image/jpeg"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._seq = 0

    def _pay_image(self, img: bytes, ts: int) -> List[bytes]:
        from ..elements.jpegformat import parse_sof, walk_markers
        markers, scan, complete = walk_markers(img)
        if not complete or scan is None:
            return []
        tables: Dict[int, bytes] = {}
        sof = None
        dri = 0
        for marker, off, payload in markers:
            if marker == 0xDB:                  # DQT
                p = 0
                while p < len(payload):
                    prec_id = payload[p]
                    tsize = 128 if prec_id >> 4 else 64
                    tables[prec_id & 0x0F] = payload[p + 1:
                                                     p + 1 + tsize]
                    p += 1 + tsize
            elif marker in (0xC0, 0xC1):
                sof = parse_sof(payload)
            elif marker == 0xDD:                # DRI
                dri = struct.unpack(">H", payload[:2])[0]
        if sof is None or not tables or len(sof["components"]) != 3:
            return []
        comps = sorted(sof["components"], key=lambda c: c["id"])
        samp0 = (comps[0]["h"] << 4) | comps[0]["v"]
        jtype = 0 if samp0 == 0x21 else 1
        if dri:
            jtype += 64
        q = self.props["quality"]
        w8 = (sof["width"] + 7) // 8
        h8 = (sof["height"] + 7) // 8
        qdata = b""
        if q > 127:
            precision = 0
            tabs = b""
            for i in range(2):
                t = tables.get(comps[i]["tq"], b"")
                if len(t) != 64:
                    precision |= 1 << i
                tabs += t
            qdata = struct.pack("!BBH", 0, precision, len(tabs)) + tabs

        pkts = []
        offset = 0
        mtu = self.props["mtu"]
        total = len(scan)
        while offset < total or not pkts:
            hdr_extra = (4 if dri else 0) + len(qdata)
            room = mtu - 12 - 8 - hdr_extra
            take = min(room, total - offset)
            last = offset + take >= total
            main = bytes([0]) + offset.to_bytes(3, "big") \
                + bytes([jtype, q, w8, h8])
            body = main
            if dri:
                body += struct.pack("!HH", dri, 0xFFFF)
            body += qdata
            qdata = b""                          # first packet only
            pkts.append(rtp_header(self.props["pt"], self._seq, ts,
                                   self.props["ssrc"], marker=last)
                        + body + scan[offset:offset + take])
            self._seq = (self._seq + 1) & 0xFFFF
            offset += take
        return pkts

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        ts0 = buf.pts or 0
        dur = buf.duration or 0
        pkts = []
        for k, img in enumerate(_blobs(buf)):
            ts90 = ((ts0 + k * dur) * 90000) // 1_000_000_000
            pkts.extend(self._pay_image(img, ts90))
        if not pkts:
            return None
        return buf.with_(data=pkts)


@register_element
class RtpJpegDepay(TransformElement):
    """rtpjpegdepay (RFC 2435): reassembles fragments, rebuilds the
    interchange headers (MakeHeaders) with in-band or Q-derived quant
    tables, and appends EOI if missing."""
    FACTORY = "rtpjpegdepay"
    DESCRIPTION = "Extracts JPEG video from RTP packets (RFC 2435)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "image/jpeg"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frag = bytearray()
        self._hdr = None
        self._qtables: Dict[int, bytes] = {}

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("image/jpeg")
               if direction == PadDirection.SINK
               else Caps.from_string("application/x-rtp"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._frag = bytearray()
        self._hdr = None
        self._qtables = {}

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        images = []
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            p = h["payload"]
            if len(p) < 8:
                continue
            off24 = int.from_bytes(p[1:4], "big")
            jtype, q, w8, h8 = p[4], p[5], p[6], p[7]
            pos = 8
            dri = 0
            if 64 <= (jtype & 0x7F):
                dri = struct.unpack(">H", p[pos:pos + 2])[0]
                pos += 4
            if off24 == 0:
                if q >= 128:
                    _, prec, qlen = struct.unpack("!BBH",
                                                  p[pos:pos + 4])
                    pos += 4
                    qt = p[pos:pos + qlen]
                    pos += qlen
                    if len(qt) == 64:            # single shared table
                        qt = qt + qt
                    self._qtables[q] = qt
                    prec_bits = prec
                else:
                    self._qtables[q] = rfc2435_make_tables(q)
                    prec_bits = 0
                self._frag = bytearray(
                    rfc2435_make_headers(jtype, w8, h8,
                                         self._qtables[q],
                                         prec_bits, dri))
            self._frag += p[pos:]
            if h["marker"]:
                img = bytes(self._frag)
                if not img.endswith(b"\xff\xd9"):
                    img += b"\xff\xd9"           # EOI if absent
                images.append(np.frombuffer(img, np.uint8))
                self._frag = bytearray()
        if not images:
            return None
        return buf.with_(data=images if len(images) > 1 else images[0],
                         batch=len(images))


# ---------------------------------------------------------------------------
# rtpmux / rtpdtmfmux / rtpfunnel (gstrtpmux.c, gstrtpdtmfmux.c,
# gstrtpfunnel.c)
# ---------------------------------------------------------------------------

def _rewrite_packet(pkt: bytes, seq: int, ts_off: int,
                    ssrc: int) -> bytes:
    """Rewrite seq/ts/ssrc in a packet copy (gstrtpmux.c
    process_buffer_locked: outgoing packets share one series)."""
    b = bytearray(pkt)
    struct.pack_into("!H", b, 2, seq & 0xFFFF)
    old_ts = struct.unpack_from("!I", b, 4)[0]
    struct.pack_into("!I", b, 4, (old_ts + ts_off) & 0xFFFFFFFF)
    struct.pack_into("!I", b, 8, ssrc & 0xFFFFFFFF)
    return bytes(b)


@register_element
class RtpMux(TransformElement):
    """rtpmux: interleave several RTP streams into one, rewriting
    seqnums into a single series and forcing a common SSRC.  In the
    batched model the element is fed the per-tick packet lists of all
    upstreams via an aggregator-style dict when multiple sink pads
    are linked; with one stream it is a seq/ssrc rewriter."""
    FACTORY = "rtpmux"
    DESCRIPTION = "multiplex N rtp streams into one"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "ssrc": (int, 0x4D55580A, "forced SSRC"),
        "seqnum-offset": (int, 0, "first output seqnum"),
        "timestamp-offset": (int, 0, "added to all timestamps"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._seq = self.props["seqnum-offset"]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        out = []
        for pkt in _blobs(buf):
            out.append(_rewrite_packet(
                pkt, self._seq, self.props["timestamp-offset"],
                self.props["ssrc"]))
            self._seq = (self._seq + 1) & 0xFFFF
        return buf.with_(data=out)


@register_element
class RtpDtmfMux(RtpMux):
    """rtpdtmfmux: rtpmux whose priority (DTMF) sink wins while a
    telephone-event is active — in the collapsed single-stream form
    the DTMF stream is simply passed with the same rewrite rules."""
    FACTORY = "rtpdtmfmux"
    DESCRIPTION = "mixes RTP DTMF streams into other RTP streams"


@register_element
class RtpFunnel(TransformElement):
    """rtpfunnel: forward many RTP streams through one pad, KEEPING
    their SSRCs (unlike rtpmux) — a passthrough in the collapsed
    form; also answers caps queries with application/x-rtp."""
    FACTORY = "rtpfunnel"
    DESCRIPTION = "Funnel RTP streams"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        return buf


# ---------------------------------------------------------------------------
# RTP retransmission (RFC 4588) — gstrtprtxsend.c / gstrtprtxreceive.c
# ---------------------------------------------------------------------------

@register_element
class RtpRtxSend(TransformElement):
    """rtprtxsend: keeps a history of sent packets; retransmission
    requests (request_retransmit(seq) / GstRTPRetransmissionRequest
    upstream events) emit RFC 4588 rtx packets — payload starts with
    the 2-byte original seqnum, sent with rtx ssrc/pt and their own
    seqnum series."""
    FACTORY = "rtprtxsend"
    DESCRIPTION = "Retransmit RTP packets when needed, according to " \
                  "RFC4588"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "max-size-packets": (int, 100, "history length"),
        "rtx-ssrc": (int, 0x52545821, "ssrc of rtx packets"),
        "rtx-payload-type": (int, 97, "payload type of rtx packets"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._history: Dict[int, bytes] = {}
        self._order: List[int] = []
        self._rtx_seq = 0
        self.num_rtx_requests = 0
        self.num_rtx_packets = 0
        self._pending_rtx: List[bytes] = []

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._history = {}
        self._order = []
        self._rtx_seq = 0
        self._pending_rtx = []
        self.num_rtx_requests = 0
        self.num_rtx_packets = 0

    def request_retransmit(self, seq: int) -> bool:
        """Queue an rtx packet for `seq` (RFC 4588 payload: OSN +
        original payload)."""
        self.num_rtx_requests += 1
        pkt = self._history.get(seq & 0xFFFF)
        if pkt is None:
            return False
        h = parse_rtp_header(pkt)
        rtx = rtp_header(self.props["rtx-payload-type"], self._rtx_seq,
                         h["timestamp"], self.props["rtx-ssrc"],
                         marker=h["marker"]) \
            + struct.pack("!H", seq & 0xFFFF) + h["payload"]
        self._rtx_seq = (self._rtx_seq + 1) & 0xFFFF
        self._pending_rtx.append(rtx)
        self.num_rtx_packets += 1
        return True

    def src_event(self, pad, event) -> bool:
        if getattr(event, "type", None) == "rtx-request":
            return self.request_retransmit(
                (event.data or {}).get("seqnum", -1))
        return super().src_event(pad, event)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        pkts = _blobs(buf)
        maxlen = self.props["max-size-packets"]
        for pkt in pkts:
            h = parse_rtp_header(pkt)
            self._history[h["seq"]] = pkt
            self._order.append(h["seq"])
            while len(self._order) > maxlen:
                old = self._order.pop(0)
                self._history.pop(old, None)
        out = pkts + self._pending_rtx
        self._pending_rtx = []
        return buf.with_(data=out)


@register_element
class RtpRtxReceive(TransformElement):
    """rtprtxreceive: recognizes rtx packets by payload type, strips
    the 2-byte OSN and restores the original seqnum/ssrc/pt."""
    FACTORY = "rtprtxreceive"
    DESCRIPTION = "Receive retransmitted RTP packets according to " \
                  "RFC4588"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "rtx-payload-type": (int, 97, "payload type of rtx packets"),
        "orig-payload-type": (int, 96, "pt restored on rtx packets"),
        "orig-ssrc": (int, 0, "ssrc restored on rtx packets "
                              "(0 = learn from stream)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.num_rtx_packets = 0
        self._learned_ssrc = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self.num_rtx_packets = 0
        self._learned_ssrc = 0

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        out = []
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            if h["payload_type"] == self.props["rtx-payload-type"] \
                    and len(h["payload"]) >= 2:
                osn = struct.unpack("!H", h["payload"][:2])[0]
                ssrc = self.props["orig-ssrc"] or self._learned_ssrc
                restored = rtp_header(
                    self.props["orig-payload-type"], osn,
                    h["timestamp"], ssrc, marker=h["marker"]) \
                    + h["payload"][2:]
                out.append(restored)
                self.num_rtx_packets += 1
            else:
                self._learned_ssrc = h["ssrc"]
                out.append(pkt)
        return buf.with_(data=out)


@register_element
class RtpRtxQueue(RtpRtxSend):
    """rtprtxqueue: like rtprtxsend but retransmits the ORIGINAL
    packet (no RFC 4588 encapsulation; gstrtprtxqueue.c)."""
    FACTORY = "rtprtxqueue"
    DESCRIPTION = "Keep RTP packets in a queue for retransmission"

    def request_retransmit(self, seq: int) -> bool:
        self.num_rtx_requests += 1
        pkt = self._history.get(seq & 0xFFFF)
        if pkt is None:
            return False
        self._pending_rtx.append(pkt)
        self.num_rtx_packets += 1
        return True


# ---------------------------------------------------------------------------
# VP8 (RFC 7741), VP9 (draft-ietf-payload-vp9) and Opus (RFC 7587)
# ---------------------------------------------------------------------------

class _FramePayBase(TransformElement):
    """Shared frame-fragmenting payloader: a 1..n-byte payload
    descriptor prefixes each fragment; marker closes the frame.
    `add_extension()` attaches RFC 8285 header extensions
    (gst_rtp_base_payload_add_extension analog)."""
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    _CLOCK = 90000
    PROPERTIES = {
        "mtu": (int, 1400, "max packet size"),
        "pt": (int, 96, "payload type"),
        "ssrc": (int, 0x56505856, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0
        self._extensions = []

    def add_extension(self, ext) -> None:
        self._extensions.append(ext)

    def _ext_block(self) -> bytes:
        if not self._extensions:
            return b""
        from .rtp_hdrext import build_one_byte_extensions
        return build_one_byte_extensions(
            [(e.ext_id, e.write()) for e in self._extensions])

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-rtp")
               if direction == PadDirection.SINK
               else self.sink_pads()[0].template_caps)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._seq = 0

    def _descriptor(self, first: bool) -> bytes:
        raise NotImplementedError

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 12 - len(self._descriptor(True))
        pkts = []
        off = 0
        first = True
        while off < len(frame) or first:
            chunk = frame[off:off + room]
            off += len(chunk)
            last = off >= len(frame)
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + self._descriptor(first) + chunk)
            first = False
        return pkts

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        ts0 = buf.pts or 0
        dur = buf.duration or 0
        pkts = []
        for k, frame in enumerate(_blobs(buf)):
            ts = ((ts0 + k * dur) * self._CLOCK) // 1_000_000_000
            pkts.extend(self._pay_frame(frame, ts))
        return buf.with_(data=pkts)


class _FrameDepayBase(TransformElement):
    """Shared depayloader: strip the descriptor, accumulate until the
    marker bit, emit whole frames."""
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    _decouple = True

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frame = bytearray()

    def transform_caps(self, direction, caps, filter=None):
        res = (self.src_pads()[0].template_caps
               if direction == PadDirection.SINK
               else Caps.from_string("application/x-rtp"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._frame = bytearray()

    @property
    def _pending_buf(self):
        return True if self._frame else None

    def _strip(self, payload: bytes) -> bytes:
        raise NotImplementedError

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            if not self._frame:
                return None
            out = bytes(self._frame)
            self._frame = bytearray()
            return Buffer(data=np.frombuffer(out, np.uint8), batch=1)
        frames = []
        pts = buf.pts
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            body = self._strip(h["payload"])
            self._frame += body
            if h["marker"] and self._frame:
                frames.append(bytes(self._frame))
                self._frame = bytearray()
        if not frames:
            return None
        data = [np.frombuffer(f, np.uint8) for f in frames]
        return buf.with_(data=data if len(data) > 1 else data[0],
                         pts=pts, batch=len(data))


@register_element
class RtpVP8Pay(_FramePayBase):
    """rtpvp8pay (gstrtpvp8pay.c, RFC 7741): minimal payload
    descriptor — S bit set on the first fragment, PID 0."""
    FACTORY = "rtpvp8pay"
    DESCRIPTION = "Puts VP8 video in RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-vp8"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _descriptor(self, first: bool) -> bytes:
        return bytes([0x10 if first else 0x00])


@register_element
class RtpVP8Depay(_FrameDepayBase):
    FACTORY = "rtpvp8depay"
    DESCRIPTION = "Extracts VP8 video from RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "video/x-vp8"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        if not payload:
            return b""
        b0 = payload[0]
        p = 1
        if b0 & 0x80:                    # X: extended control bits
            x = payload[p]
            p += 1
            if x & 0x80:                 # I: PictureID
                p += 2 if payload[p] & 0x80 else 1
            if x & 0x40:                 # L: TL0PICIDX
                p += 1
            if x & 0x30:                 # T/K: TID/KEYIDX
                p += 1
        return payload[p:]


@register_element
class RtpVP9Pay(_FramePayBase):
    """rtpvp9pay (draft-ietf-payload-vp9): minimal descriptor with
    B (begin) / E (end) markers, flexible mode."""
    FACTORY = "rtpvp9pay"
    DESCRIPTION = "Puts VP9 video in RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-vp9"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 13
        pkts = []
        off = 0
        first = True
        while off < len(frame) or first:
            chunk = frame[off:off + room]
            off += len(chunk)
            last = off >= len(frame)
            desc = bytes([(0x08 if first else 0)   # B bit
                          | (0x04 if last else 0)])  # E bit
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + desc + chunk)
            first = False
        return pkts

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00"


@register_element
class RtpVP9Depay(_FrameDepayBase):
    FACTORY = "rtpvp9depay"
    DESCRIPTION = "Extracts VP9 video from RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "video/x-vp9"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        if not payload:
            return b""
        b0 = payload[0]
        p = 1
        if b0 & 0x80:                    # I: PictureID
            p += 2 if payload[p] & 0x80 else 1
        if b0 & 0x40:                    # L: layer indices
            p += 1
            if not b0 & 0x10:            # non-flexible: TL0PICIDX
                p += 1
        if b0 & 0x10 and b0 & 0x20:      # F+P: ref diffs
            while p < len(payload) and payload[p] & 0x01:
                p += 1
            p += 1
        if b0 & 0x02:                    # V: scalability structure
            # minimal SS skip: N_S/Y/G byte + optional dims
            ss = payload[p]
            p += 1
            n_s = (ss >> 5) + 1
            if ss & 0x10:                # Y: widths/heights
                p += 4 * n_s
            if ss & 0x08:                # G: picture groups
                ng = payload[p]
                p += 1
                for _ in range(ng):
                    tmp = payload[p]
                    p += 1 + ((tmp >> 2) & 0x3)
        return payload[p:]


@register_element
class RtpOpusPay(_FramePayBase):
    """rtpopuspay (RFC 7587): one Opus packet per RTP packet, 48 kHz
    RTP clock, marker on every packet."""
    FACTORY = "rtpopuspay"
    DESCRIPTION = "Puts Opus audio in RTP packets"
    _CLOCK = 48000
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-opus"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _descriptor(self, first: bool) -> bytes:
        return b""

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        hdr = rtp_header(self.props["pt"], self._seq, ts,
                         self.props["ssrc"], marker=True,
                         extension=self._ext_block())
        self._seq = (self._seq + 1) & 0xFFFF
        return [hdr + frame]


@register_element
class RtpOpusDepay(_FrameDepayBase):
    FACTORY = "rtpopusdepay"
    DESCRIPTION = "Extracts Opus audio from RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "audio/x-opus"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        return payload
