"""RTP payloaders/depayloaders, batch 2: the remaining software
pay/depay family from gst-plugins-good/gst/rtp/.

Clean-room re-specifications (reference files cited per class):
* RFC 3551 static-PT audio (G.722/G.723/G.726/G.729/GSM/iLBC/Speex/
  Siren/BroadVoice): raw codec bytes split at the MTU —
  gstrtpg722pay.c, gstrtpg723pay.c, gstrtpg726pay.c, gstrtpg729pay.c,
  gstrtpgsmpay.c, gstrtpilbcpay.c, gstrtpspeexpay.c, gstrtpsirenpay.c,
  gstrtpbvpay.c (+ matching *depay.c).
* RFC 7798 H.265 (single NAL / FU type 49 / AP type 48) —
  gstrtph265pay.c / gstrtph265depay.c.
* RFC 4629 H.263-1998 (2-byte header, P bit start-code elision) and
  RFC 4587 H.261 (4-byte header) — gstrtph263ppay.c, gstrtph261pay.c.
* RFC 2250 MPEG (audio 4-byte frag header PT 14; video 4-byte header
  PT 32; MPEG2-TS 188-byte aggregation PT 33) — gstrtpmpapay.c,
  gstrtpmpvpay.c, gstrtpmp2tpay.c, gstrtpmp1sdepay.c.
* RFC 3016 MPEG-4 video/audio and RFC 3640 mpeg4-generic AU headers —
  gstrtpmp4vpay.c, gstrtpmp4apay.c, gstrtpmp4gpay.c (+ depay).
* RFC 4184 AC-3 (2-byte FT/NF header) — gstrtpac3pay.c.
* RFC 4867 AMR octet-aligned (CMR + ToC) — gstrtpamrpay.c.
* RFC 6597 KLV, RFC 6469 DV, RFC 5371 JPEG 2000, SBC (bluez a2dp
  draft) — gstrtpklvpay.c, gstrtpdvpay.c, gstrtpj2kpay.c,
  gstrtpsbcpay.c.
* RFC 5215 Vorbis / draft-Theora (ident + F/TDT/pkts header, 2-byte
  length-prefixed packets) — gstrtpvorbispay.c, gstrtptheorapay.c.
* application/x-rtp-stream RFC 4571 2-byte framing — gstrtpstreampay.c.
* gst-buffer-over-RTP (reduced) — gstrtpgstpay.c.
* RFC 2198 redundancy + RFC 5109 ULPFEC + rtpstorage —
  gstrtpredenc.c, gstrtpreddec.c, gstrtpulpfecenc.c,
  gstrtpulpfecdec.c, gstrtpstorage.c (gst/rtpmanager/).
* rtppassthroughpay (gstrtppassthroughpay.c), rtpqcelpdepay
  (gstrtpqcelpdepay.c).

All payload formats here are host-side packet framing (control
plane); media decode stays on the device path.

A copy of the JAX package's ``net/rtp_payloaders2.py``. Packets and coded
frames stay host bytes; every element that takes packets sets
``HOST_INPUT``.  Three differences, each a fault of the JAX package
(ROADMAP.md section 3): rtpredenc leaves out a redundant block that RFC
2198's header cannot describe (a payload over 1023 bytes or a timestamp
offset over 14 bits) instead of writing a header that misframes every
packet; rtpulpfecdec keeps its 256 newest packets by sequence number
across the 16-bit wrap; and rtpgstpay carries raw video frame by frame in
the format's bytes (the JAX one pays a batch plane by plane), which
rtpgstdepay, when its source caps name raw video, puts back into planes on
the element's device in one copy (the JAX one hands the converter bytes).
"""

from __future__ import annotations

import struct
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve
from ..video.format import from_bytes, to_bytes
from ..video.info import VideoInfo
from .rtp import parse_rtp_header, rtp_header
from .rtp_payloaders import (_FrameDepayBase, _FramePayBase, _blobs,
                             _split_annexb)


def _raw_video(caps) -> Optional[VideoInfo]:
    """The VideoInfo of fixed raw-video caps, else None."""
    if caps is None or caps.is_any or not len(caps) \
            or caps[0].name != "video/x-raw":
        return None
    try:
        return VideoInfo.from_caps_structure(caps[0])
    except (KeyError, TypeError, ValueError):
        return None


# ---------------------------------------------------------------------------
# Generic raw-audio payloaders (RFC 3551 profiles)
# ---------------------------------------------------------------------------

class _RawPay(_FramePayBase):
    """Raw codec bytes; whole buffer split at the MTU, marker on the
    final fragment (gstrtpg722pay.c style)."""
    _PT = 96

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        if self.props.get("pt", 96) == 96 and self._PT != 96:
            self.props["pt"] = self._PT

    def _descriptor(self, first: bool) -> bytes:
        return b""


class _RawDepay(_FrameDepayBase):
    def _strip(self, payload: bytes) -> bytes:
        return payload


def _make_raw_pair(factory_base: str, media_caps: str, pt: int,
                   clock: int, ref: str):
    """Build and register a pay/depay pair for a raw-payload codec."""

    pay_cls = type(
        "Rtp" + factory_base.capitalize() + "Pay", (_RawPay,), {
            "__doc__": f"rtp{factory_base}pay ({ref})",
            "FACTORY": f"rtp{factory_base}pay",
            "DESCRIPTION":
                f"Payload-encodes {factory_base} into RTP packets",
            "_PT": pt, "_CLOCK": clock,
            "PAD_TEMPLATES": [
                PadTemplate("sink", PadDirection.SINK, media_caps),
                PadTemplate("src", PadDirection.SRC,
                            "application/x-rtp"),
            ],
        })
    depay_cls = type(
        "Rtp" + factory_base.capitalize() + "Depay", (_RawDepay,), {
            "__doc__": f"rtp{factory_base}depay ({ref})",
            "FACTORY": f"rtp{factory_base}depay",
            "DESCRIPTION":
                f"Extracts {factory_base} from RTP packets",
            "PAD_TEMPLATES": [
                PadTemplate("sink", PadDirection.SINK,
                            "application/x-rtp"),
                PadTemplate("src", PadDirection.SRC, media_caps),
            ],
        })
    register_element(pay_cls)
    register_element(depay_cls)
    return pay_cls, depay_cls


# Static/dynamic PT raw audio formats (gst-plugins-good/gst/rtp).
# G.722's RTP clock is 8000 despite 16 kHz sampling (RFC 3551 §4.5.2).
_make_raw_pair("g722", "audio/G722, rate=8000, channels=1", 9, 8000,
               "gstrtpg722pay.c, RFC 3551")
_make_raw_pair("g723", "audio/G723, rate=8000, channels=1", 4, 8000,
               "gstrtpg723pay.c, RFC 3551")
_make_raw_pair("g726", "audio/x-adpcm, layout=g726", 96, 8000,
               "gstrtpg726pay.c, RFC 3551")
_make_raw_pair("g729", "audio/G729, rate=8000, channels=1", 18, 8000,
               "gstrtpg729pay.c, RFC 3551")
_make_raw_pair("gsm", "audio/x-gsm, rate=8000, channels=1", 3, 8000,
               "gstrtpgsmpay.c, RFC 3551")
_make_raw_pair("ilbc", "audio/x-iLBC", 96, 8000,
               "gstrtpilbcpay.c, RFC 3952")
_make_raw_pair("speex", "audio/x-speex", 96, 16000,
               "gstrtpspeexpay.c, RFC 5574")
_make_raw_pair("siren", "audio/x-siren", 96, 16000,
               "gstrtpsirenpay.c")
_make_raw_pair("bv", "audio/x-bv", 96, 8000,
               "gstrtpbvpay.c, RFC 4298")
# depay-only legacy: QCELP (RFC 2658) — payload is the raw frame train
_make_raw_pair("qcelp", "audio/qcelp, rate=8000, channels=1", 12, 8000,
               "gstrtpqcelpdepay.c, RFC 2658")
# KLV metadata (RFC 6597): raw KLV unit fragmented at the MTU
_make_raw_pair("klv", "meta/x-klv", 96, 90000,
               "gstrtpklvpay.c, RFC 6597")
# DV (RFC 6469): whole-frame DIF block train fragmented at the MTU
_make_raw_pair("dv", "video/x-dv", 96, 90000,
               "gstrtpdvpay.c, RFC 6469")
# MPEG-4 video (RFC 3016 §4): raw VOP bytes, no extra header
_make_raw_pair("mp4v", "video/mpeg, mpegversion=4, systemstream=false",
               96, 90000, "gstrtpmp4vpay.c, RFC 3016")
# MPEG-4 audio LATM (RFC 3016 §5): one audioMuxElement per packet
_make_raw_pair("mp4a", "audio/mpeg, mpegversion=4, "
               "stream-format=loas", 96, 90000,
               "gstrtpmp4apay.c, RFC 3016")


# ---------------------------------------------------------------------------
# H.265 (RFC 7798) — 2-byte NAL header, FU type 49, AP type 48
# ---------------------------------------------------------------------------

@register_element
class RtpH265Pay(_FramePayBase):
    """rtph265pay (gstrtph265pay.c, RFC 7798): single-NAL packets when
    they fit, FU (type 49) fragmentation otherwise."""
    FACTORY = "rtph265pay"
    DESCRIPTION = "Payload-encode H265 video into RTP packets " \
                  "(RFC 7798)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-h265, stream-format=byte-stream, "
                    "alignment=au"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _descriptor(self, first: bool) -> bytes:
        return b""

    def _pay_frame(self, au: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 12
        pkts = []
        nals = _split_annexb(au)
        for n, nal in enumerate(nals):
            last_nal = n == len(nals) - 1
            if len(nal) <= room:
                hdr = rtp_header(self.props["pt"], self._seq, ts,
                                 self.props["ssrc"], marker=last_nal,
                                 extension=self._ext_block())
                self._seq = (self._seq + 1) & 0xFFFF
                pkts.append(hdr + nal)
                continue
            # FU (RFC 7798 §4.4.3): PayloadHdr type=49 keeps
            # layer/TID; FU header carries S/E + original type
            ntype = (nal[0] >> 1) & 0x3F
            ph = bytes([(nal[0] & 0x81) | (49 << 1), nal[1]])
            body = nal[2:]
            off = 0
            while off < len(body):
                take = min(room - 3, len(body) - off)
                start = off == 0
                end = off + take >= len(body)
                fu = (0x80 if start else 0) | (0x40 if end else 0) \
                    | ntype
                hdr = rtp_header(self.props["pt"], self._seq, ts,
                                 self.props["ssrc"],
                                 marker=last_nal and end,
                                 extension=self._ext_block())
                self._seq = (self._seq + 1) & 0xFFFF
                pkts.append(hdr + ph + bytes([fu])
                            + body[off:off + take])
                off += take
        return pkts


@register_element
class RtpH265Depay(_FrameDepayBase):
    """rtph265depay (gstrtph265depay.c, RFC 7798)."""
    FACTORY = "rtph265depay"
    DESCRIPTION = "Extracts H265 video from RTP packets (RFC 7798)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-h265, stream-format=byte-stream, "
                    "alignment=au"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._fu = bytearray()

    def start(self):
        super().start()
        self._fu = bytearray()

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return super().host_process(None)
        aus = []
        pts = buf.pts
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            payload = h["payload"]
            if len(payload) < 2:
                continue
            ntype = (payload[0] >> 1) & 0x3F
            if ntype == 49:                      # FU
                fu = payload[2]
                if fu & 0x80:                    # start: rebuild hdr
                    orig = fu & 0x3F
                    self._fu = bytearray([
                        (payload[0] & 0x81) | (orig << 1),
                        payload[1]])
                self._fu += payload[3:]
                if fu & 0x40:
                    self._frame += b"\x00\x00\x00\x01" \
                        + bytes(self._fu)
                    self._fu = bytearray()
            elif ntype == 48:                    # AP aggregate
                p = 2
                while p + 2 <= len(payload):
                    ln = struct.unpack(">H", payload[p:p + 2])[0]
                    self._frame += b"\x00\x00\x00\x01" \
                        + payload[p + 2:p + 2 + ln]
                    p += 2 + ln
            else:
                self._frame += b"\x00\x00\x00\x01" + payload
            if h["marker"] and self._frame:
                aus.append(bytes(self._frame))
                self._frame = bytearray()
        if not aus:
            return None
        data = [np.frombuffer(a, np.uint8) for a in aus]
        return buf.with_(data=data if len(data) > 1 else data[0],
                         pts=pts, batch=len(data))


# ---------------------------------------------------------------------------
# H.263 / H.263-1998 / H.261
# ---------------------------------------------------------------------------

@register_element
class RtpH263PPay(_FramePayBase):
    """rtph263ppay (gstrtph263ppay.c, RFC 4629): 2-byte header; the P
    bit on the first fragment replaces the two leading zero bytes of
    the picture start code."""
    FACTORY = "rtph263ppay"
    DESCRIPTION = "Payload-encodes H263/+/++ video in RTP packets " \
                  "(RFC 4629)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-h263, variant=itu"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 14
        pkts = []
        first = True
        # P=1 start elides the 00 00 start-code prefix (RFC 4629 §5.1)
        if frame[:2] == b"\x00\x00":
            frame = frame[2:]
        off = 0
        while off < len(frame) or first:
            chunk = frame[off:off + room]
            off += len(chunk)
            last = off >= len(frame)
            hdr2 = struct.pack(">H", 0x0400 if first else 0x0000)
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + hdr2 + chunk)
            first = False
        return pkts

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00\x00"


@register_element
class RtpH263PDepay(_FrameDepayBase):
    """rtph263pdepay (gstrtph263pdepay.c, RFC 4629)."""
    FACTORY = "rtph263pdepay"
    DESCRIPTION = "Extracts H263/+/++ video from RTP packets " \
                  "(RFC 4629)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-h263, variant=itu"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        if len(payload) < 2:
            return b""
        h = struct.unpack(">H", payload[:2])[0]
        plen = (h >> 3) & 0x3F                   # PLEN extra header
        body = payload[2 + plen + (1 if h & 0x0200 else 0):]
        if h & 0x0400:                           # P: restore 00 00
            return b"\x00\x00" + body
        return body


@register_element
class RtpH263Pay(_FramePayBase):
    """rtph263pay (gstrtph263pay.c, RFC 2190 Mode A reduced): 4-byte
    Mode A header, byte-aligned fragments."""
    FACTORY = "rtph263pay"
    DESCRIPTION = "Payload-encodes H263 video in RTP packets " \
                  "(RFC 2190)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-h263, variant=itu, h263version=h263"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = dict(_FramePayBase.PROPERTIES)
    PROPERTIES["pt"] = (int, 34, "payload type (static 34, RFC 3551)")

    def _descriptor(self, first: bool) -> bytes:
        # Mode A: F=0 P=0 SBIT/EBIT=0, SRC/I/U/S/A + DBQ/TRB/TR zeroed
        # for byte-aligned whole-GOB fragments
        return b"\x00\x00\x00\x00"


@register_element
class RtpH263Depay(_FrameDepayBase):
    """rtph263depay (gstrtph263depay.c, RFC 2190)."""
    FACTORY = "rtph263depay"
    DESCRIPTION = "Extracts H263 video from RTP packets (RFC 2190)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-h263, variant=itu, h263version=h263"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        if len(payload) < 4:
            return b""
        b0 = payload[0]
        if b0 & 0x80:                            # F=1: Mode B/C
            return payload[8 + (4 if b0 & 0x40 else 0):]
        return payload[4:]


@register_element
class RtpH261Pay(_FramePayBase):
    """rtph261pay (gstrtph261pay.c, RFC 4587): 4-byte H.261 header;
    byte-aligned fragments use SBIT/EBIT=0."""
    FACTORY = "rtph261pay"
    DESCRIPTION = "Payload-encodes H261 video in RTP packets " \
                  "(RFC 4587)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-h261"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = dict(_FramePayBase.PROPERTIES)
    PROPERTIES["pt"] = (int, 31, "payload type (static 31, RFC 3551)")

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00\x00\x00\x00"


@register_element
class RtpH261Depay(_FrameDepayBase):
    """rtph261depay (gstrtph261depay.c, RFC 4587)."""
    FACTORY = "rtph261depay"
    DESCRIPTION = "Extracts H261 video from RTP packets (RFC 4587)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "video/x-h261"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        return payload[4:]


# ---------------------------------------------------------------------------
# RFC 2250 MPEG elementary/system payloads
# ---------------------------------------------------------------------------

@register_element
class RtpMpaPay(_FramePayBase):
    """rtpmpapay (gstrtpmpapay.c, RFC 2250 §3.5): 4-byte header — 16
    MBZ bits + 16-bit fragmentation offset; static PT 14, 90 kHz."""
    FACTORY = "rtpmpapay"
    DESCRIPTION = "Payload MPEG audio as RTP packets (RFC 2250)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/mpeg, mpegversion=1"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = dict(_FramePayBase.PROPERTIES)
    PROPERTIES["pt"] = (int, 14, "payload type (static 14)")

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 16
        pkts = []
        off = 0
        first = True
        while off < len(frame) or first:
            chunk = frame[off:off + room]
            last = off + len(chunk) >= len(frame)
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + struct.pack(">HH", 0, off) + chunk)
            off += len(chunk)
            first = False
        return pkts

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00\x00\x00\x00"


@register_element
class RtpMpaDepay(_FrameDepayBase):
    """rtpmpadepay (gstrtpmpadepay.c, RFC 2250)."""
    FACTORY = "rtpmpadepay"
    DESCRIPTION = "Extracts MPEG audio from RTP packets (RFC 2250)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/mpeg, mpegversion=1"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        return payload[4:]


@register_element
class RtpMpvPay(RtpMpaPay):
    """rtpmpvpay (gstrtpmpvpay.c, RFC 2250 §3.4): 4-byte MPEG video
    header (zeroed for byte-aligned slices); static PT 32."""
    FACTORY = "rtpmpvpay"
    DESCRIPTION = "Payload MPEG1/2 video as RTP packets (RFC 2250)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/mpeg, systemstream=false"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = dict(_FramePayBase.PROPERTIES)
    PROPERTIES["pt"] = (int, 32, "payload type (static 32)")

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 16
        pkts = []
        off = 0
        first = True
        while off < len(frame) or first:
            chunk = frame[off:off + room]
            last = off + len(chunk) >= len(frame)
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + b"\x00\x00\x00\x00" + chunk)
            off += len(chunk)
            first = False
        return pkts


@register_element
class RtpMpvDepay(_FrameDepayBase):
    """rtpmpvdepay (gstrtpmpvdepay.c, RFC 2250)."""
    FACTORY = "rtpmpvdepay"
    DESCRIPTION = "Extracts MPEG1/2 video from RTP packets (RFC 2250)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/mpeg, systemstream=false"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        return payload[4:]


@register_element
class RtpMp2tPay(_FramePayBase):
    """rtpmp2tpay (gstrtpmp2tpay.c, RFC 2250 §2): aggregates whole
    188-byte TS packets up to the MTU; static PT 33."""
    FACTORY = "rtpmp2tpay"
    DESCRIPTION = "Payload MPEG2-TS as RTP packets (RFC 2250)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/mpegts, systemstream=true"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = dict(_FramePayBase.PROPERTIES)
    PROPERTIES["pt"] = (int, 33, "payload type (static 33)")

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        per = max(1, (self.props["mtu"] - 12) // 188)
        pkts = []
        n = max(1, (len(frame) + 187) // 188)
        for i in range(0, n, per):
            chunk = frame[i * 188:(i + per) * 188]
            last = (i + per) >= n
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + chunk)
        return pkts

    def _descriptor(self, first: bool) -> bytes:
        return b""


@register_element
class RtpMp2tDepay(_FrameDepayBase):
    """rtpmp2tdepay (gstrtpmp2tdepay.c, RFC 2250)."""
    FACTORY = "rtpmp2tdepay"
    DESCRIPTION = "Extracts MPEG2-TS from RTP packets (RFC 2250)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/mpegts, systemstream=true"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        # drop a trailing partial TS packet (RFC 2250 §2.1); a payload
        # shorter than one TS packet yields nothing rather than a
        # truncated packet
        return payload[:188 * (len(payload) // 188)]


@register_element
class RtpMp1sDepay(_FrameDepayBase):
    """rtpmp1sdepay (gstrtpmp1sdepay.c, RFC 2250): raw MPEG-1 system
    stream payload."""
    FACTORY = "rtpmp1sdepay"
    DESCRIPTION = "Extracts MPEG1 System Streams from RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/mpeg, systemstream=true"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        return payload


# ---------------------------------------------------------------------------
# RFC 3640 mpeg4-generic (AU headers)
# ---------------------------------------------------------------------------

@register_element
class RtpMp4gPay(_FramePayBase):
    """rtpmp4gpay (gstrtpmp4gpay.c, RFC 3640 AAC-hbr): 16-bit
    AU-headers-length (in bits) then one 13-bit-size + 3-bit-index AU
    header per access unit."""
    FACTORY = "rtpmp4gpay"
    DESCRIPTION = "Payload MPEG4 ES into RTP packets (RFC 3640)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/mpeg, mpegversion=4, stream-format=raw"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 16
        pkts = []
        off = 0
        first = True
        while off < len(frame) or first:
            chunk = frame[off:off + room]
            off += len(chunk)
            last = off >= len(frame)
            # single AU (or fragment) per packet: one 16-bit header
            au_hdr = struct.pack(">HH", 16, len(chunk) << 3)
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + au_hdr + chunk)
            first = False
        return pkts

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00\x00\x00\x00"


@register_element
class RtpMp4gDepay(_FrameDepayBase):
    """rtpmp4gdepay (gstrtpmp4gdepay.c, RFC 3640): parses the AU
    header section and re-emits the access units."""
    FACTORY = "rtpmp4gdepay"
    DESCRIPTION = "Extracts MPEG4 ES from RTP packets (RFC 3640)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/mpeg, mpegversion=4, stream-format=raw"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        if len(payload) < 2:
            return b""
        hbits = struct.unpack(">H", payload[:2])[0]
        hbytes = (hbits + 7) // 8
        body = payload[2 + hbytes:]
        out = bytearray()
        pos = 0
        # walk 16-bit AU headers: size is the top 13 bits
        for i in range(hbits // 16):
            h = struct.unpack(">H", payload[2 + 2 * i:4 + 2 * i])[0]
            size = h >> 3
            out += body[pos:pos + size]
            pos += size
        return bytes(out) if out else body


# ---------------------------------------------------------------------------
# AC-3 (RFC 4184) and AMR (RFC 4867)
# ---------------------------------------------------------------------------

@register_element
class RtpAc3Pay(_FramePayBase):
    """rtpac3pay (gstrtpac3pay.c, RFC 4184): 2-byte payload header —
    frame type + number of frames/fragments."""
    FACTORY = "rtpac3pay"
    DESCRIPTION = "Payload AC3 audio as RTP packets (RFC 4184)"
    _CLOCK = 48000
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-ac3"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 14
        pkts = []
        if len(frame) <= room:
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=True,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            # FT=0: one or more complete frames, NF=1
            return [hdr + b"\x00\x01" + frame]
        off = 0
        nfrag = (len(frame) + room - 1) // room
        first = True
        while off < len(frame):
            chunk = frame[off:off + room]
            off += len(chunk)
            last = off >= len(frame)
            ft = 1 if first else 3               # initial / continuation
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + bytes([ft, nfrag]) + chunk)
            first = False
        return pkts

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00\x00"


@register_element
class RtpAc3Depay(_FrameDepayBase):
    """rtpac3depay (gstrtpac3depay.c, RFC 4184)."""
    FACTORY = "rtpac3depay"
    DESCRIPTION = "Extracts AC3 audio from RTP packets (RFC 4184)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "audio/x-ac3"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        return payload[2:]


_AMR_NB_SIZES = [12, 13, 15, 17, 19, 20, 26, 31, 5]   # RFC 4867 §3.6


@register_element
class RtpAmrPay(_FramePayBase):
    """rtpamrpay (gstrtpamrpay.c, RFC 4867 octet-aligned): CMR byte
    then a ToC entry per frame, then the frame data."""
    FACTORY = "rtpamrpay"
    DESCRIPTION = "Payload-encode AMR audio into RTP packets " \
                  "(RFC 4867)"
    _CLOCK = 8000
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/AMR"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        ft = 8                                   # default: SID-size
        for i, sz in enumerate(_AMR_NB_SIZES):
            if len(frame) == sz:
                ft = i
                break
        toc = (ft << 3) | 0x04                   # F=0, Q=1
        hdr = rtp_header(self.props["pt"], self._seq, ts,
                         self.props["ssrc"], marker=True,
                         extension=self._ext_block())
        self._seq = (self._seq + 1) & 0xFFFF
        return [hdr + bytes([0xF0, toc]) + frame]

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00\x00"


@register_element
class RtpAmrDepay(_FrameDepayBase):
    """rtpamrdepay (gstrtpamrdepay.c, RFC 4867 octet-aligned)."""
    FACTORY = "rtpamrdepay"
    DESCRIPTION = "Extracts AMR audio from RTP packets (RFC 4867)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "audio/AMR"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        if len(payload) < 2:
            return b""
        p = 1                                    # skip CMR
        tocs = []
        while p < len(payload):
            tocs.append(payload[p])
            follows = payload[p] & 0x80
            p += 1
            if not follows:
                break
        return payload[p:]


# ---------------------------------------------------------------------------
# SBC (Bluetooth A2DP) and JPEG 2000 (RFC 5371)
# ---------------------------------------------------------------------------

@register_element
class RtpSbcPay(_FramePayBase):
    """rtpsbcpay (gstrtpsbcpay.c): 1-byte header — fragmentation
    flags + frame count."""
    FACTORY = "rtpsbcpay"
    DESCRIPTION = "Payload SBC audio as RTP packets"
    _CLOCK = 48000
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-sbc"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _descriptor(self, first: bool) -> bytes:
        return bytes([0x01])                     # one frame, no frag


@register_element
class RtpSbcDepay(_FrameDepayBase):
    """rtpsbcdepay (gstrtpsbcdepay.c)."""
    FACTORY = "rtpsbcdepay"
    DESCRIPTION = "Extracts SBC audio from RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "audio/x-sbc"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        return payload[1:]


@register_element
class RtpJ2kPay(_FramePayBase):
    """rtpj2kpay (gstrtpj2kpay.c, RFC 5371): 8-byte main header with a
    24-bit fragment offset."""
    FACTORY = "rtpj2kpay"
    DESCRIPTION = "Payload JPEG 2000 as RTP packets (RFC 5371)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "image/x-jpc"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 20
        pkts = []
        off = 0
        first = True
        while off < len(frame) or first:
            chunk = frame[off:off + room]
            last = off + len(chunk) >= len(frame)
            # RFC 5371 main header: tp(2)|MHF(2)|mh_id(3)|T(1), priority,
            # 16-bit tile, reserved byte, then the 24-bit fragment offset
            # at bytes 5-7 (gstrtpj2kpay.c layout). T=1: no tile header.
            mhf = 3 if first else 0
            hdr8 = struct.pack(">BBHB", (mhf << 4) | 1, 0xFF, 0, 0) \
                + off.to_bytes(3, "big")
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + hdr8 + chunk)
            off += len(chunk)
            first = False
        return pkts

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00" * 8


@register_element
class RtpJ2kDepay(_FrameDepayBase):
    """rtpj2kdepay (gstrtpj2kdepay.c, RFC 5371)."""
    FACTORY = "rtpj2kdepay"
    DESCRIPTION = "Extracts JPEG 2000 from RTP packets (RFC 5371)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "image/x-jpc"),
    ]

    def _strip(self, payload: bytes) -> bytes:
        return payload[8:]


# ---------------------------------------------------------------------------
# Vorbis (RFC 5215) / Theora (draft-barbato-avt-rtp-theora)
# ---------------------------------------------------------------------------

class _XiphPayBase(_FramePayBase):
    """Shared Vorbis/Theora payload: 4-byte header (24-bit ident +
    2-bit F + 2-bit TDT + 4-bit packet count); each packet is 2-byte
    length-prefixed (RFC 5215 §2.2)."""

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 18
        pkts = []
        if len(frame) <= room:
            h4 = struct.pack(">I", (0 << 8) | (0 << 6) | (0 << 4) | 1)
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=True,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            return [hdr + h4 + struct.pack(">H", len(frame)) + frame]
        off = 0
        first = True
        while off < len(frame):
            chunk = frame[off:off + room]
            off += len(chunk)
            last = off >= len(frame)
            frag = 1 if first else (3 if last else 2)
            h4 = struct.pack(">I", (frag << 6) | 0)
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + h4 + struct.pack(">H", len(chunk))
                        + chunk)
            first = False
        return pkts

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00" * 6


class _XiphDepayBase(_FrameDepayBase):
    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return super().host_process(None)
        frames = []
        pts = buf.pts
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            payload = h["payload"]
            if len(payload) < 6:
                continue
            h4 = struct.unpack(">I", payload[:4])[0]
            frag = (h4 >> 6) & 0x3
            npkts = h4 & 0xF
            p = 4
            if frag == 0:                        # whole packets
                for _ in range(max(1, npkts)):
                    if p + 2 > len(payload):
                        break
                    ln = struct.unpack(">H", payload[p:p + 2])[0]
                    frames.append(payload[p + 2:p + 2 + ln])
                    p += 2 + ln
            else:                                # fragmented packet
                ln = struct.unpack(">H", payload[p:p + 2])[0]
                if frag == 1:
                    self._frame = bytearray()
                self._frame += payload[p + 2:p + 2 + ln]
                if frag == 3:
                    frames.append(bytes(self._frame))
                    self._frame = bytearray()
        if not frames:
            return None
        data = [np.frombuffer(f, np.uint8) for f in frames]
        return buf.with_(data=data if len(data) > 1 else data[0],
                         pts=pts, batch=len(data))


@register_element
class RtpVorbisPay(_XiphPayBase):
    """rtpvorbispay (gstrtpvorbispay.c, RFC 5215)."""
    FACTORY = "rtpvorbispay"
    DESCRIPTION = "Payload-encode Vorbis audio into RTP packets " \
                  "(RFC 5215)"
    _CLOCK = 48000
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-vorbis"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]


@register_element
class RtpVorbisDepay(_XiphDepayBase):
    """rtpvorbisdepay (gstrtpvorbisdepay.c, RFC 5215)."""
    FACTORY = "rtpvorbisdepay"
    DESCRIPTION = "Extracts Vorbis audio from RTP packets (RFC 5215)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "audio/x-vorbis"),
    ]


@register_element
class RtpTheoraPay(_XiphPayBase):
    """rtptheorapay (gstrtptheorapay.c, draft-barbato-avt-rtp-theora)."""
    FACTORY = "rtptheorapay"
    DESCRIPTION = "Payload-encode Theora video into RTP packets " \
                  "(draft-barbato)"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-theora"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]


@register_element
class RtpTheoraDepay(_XiphDepayBase):
    """rtptheoradepay (gstrtptheoradepay.c)."""
    FACTORY = "rtptheoradepay"
    DESCRIPTION = "Extracts Theora video from RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "video/x-theora"),
    ]


# ---------------------------------------------------------------------------
# application/x-rtp-stream (RFC 4571) and gst-buffer payload
# ---------------------------------------------------------------------------

@register_element
class RtpStreamPay(TransformElement):
    """rtpstreampay (gstrtpstreampay.c, RFC 4571): prefixes each RTP
    packet with a 16-bit big-endian length for stream transports."""
    FACTORY = "rtpstreampay"
    DESCRIPTION = "Payloads RTP packets for streaming protocols " \
                  "(RFC 4571)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC,
                    "application/x-rtp-stream"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-rtp-stream")
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
        out = b"".join(struct.pack(">H", len(p)) + p
                       for p in _blobs(buf))
        return buf.with_(data=np.frombuffer(out, np.uint8), batch=1)


@register_element
class RtpStreamDepay(TransformElement):
    """rtpstreamdepay (gstrtpstreamdepay.c, RFC 4571)."""
    FACTORY = "rtpstreamdepay"
    DESCRIPTION = "Depayloads RTP from streaming protocols (RFC 4571)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "application/x-rtp-stream"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._acc = bytearray()

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string("application/x-rtp")
               if direction == PadDirection.SINK
               else Caps.from_string("application/x-rtp-stream"))
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._acc = bytearray()

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        for blob in _blobs(buf):
            self._acc += blob
        pkts = []
        while len(self._acc) >= 2:
            ln = struct.unpack(">H", self._acc[:2])[0]
            if len(self._acc) < 2 + ln:
                break
            pkts.append(bytes(self._acc[2:2 + ln]))
            del self._acc[:2 + ln]
        if not pkts:
            return None
        return buf.with_(data=pkts, batch=len(pkts))


@register_element
class RtpGstPay(_FramePayBase):
    """rtpgstpay (gstrtpgstpay.c, reduced): gst buffers over RTP with
    a 1-byte flags + 24-bit fragment-offset header; the C bit carries
    an inline caps string on the first packet of a frame."""
    FACTORY = "rtpgstpay"
    DESCRIPTION = "Payloads arbitrary buffers as RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "ANY"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._caps_str = b""
        self._caps_sent = False
        self._video: Optional[VideoInfo] = None

    def set_info(self, incaps, outcaps):
        self._video = _raw_video(incaps)
        if incaps is not None:
            self._caps_str = str(incaps).encode() + b"\x00"
            self._caps_sent = False

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        info = self._video
        if buf is not None and info is not None \
                and isinstance(buf.data, tuple):
            raw = to_bytes(info.finfo, tuple(host_array(p) for p in
                                             buf.data),
                           info.width, info.height)
            buf = buf.with_(data=list(raw.reshape(buf.batch, -1)))
        return super().host_process(buf)

    def _pay_frame(self, frame: bytes, ts: int) -> List[bytes]:
        room = self.props["mtu"] - 16
        pkts = []
        off = 0
        first = True
        while off < len(frame) or first:
            chunk = frame[off:off + room]
            last = off + len(chunk) >= len(frame)
            flags = 0
            body = chunk
            if first and not self._caps_sent and self._caps_str:
                flags |= 0x80                    # C: caps inline
                body = self._caps_str + chunk
                self._caps_sent = True
            hdr4 = bytes([flags]) + struct.pack(">I", off)[1:]
            hdr = rtp_header(self.props["pt"], self._seq, ts,
                             self.props["ssrc"], marker=last,
                             extension=self._ext_block())
            self._seq = (self._seq + 1) & 0xFFFF
            pkts.append(hdr + hdr4 + body)
            off += len(chunk)
            first = False
        return pkts

    def _descriptor(self, first: bool) -> bytes:
        return b"\x00" * 4


@register_element
class RtpGstDepay(_FrameDepayBase):
    """rtpgstdepay (gstrtpgstdepay.c, reduced)."""
    FACTORY = "rtpgstdepay"
    DESCRIPTION = "Extracts buffers from gst RTP packets"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "ANY"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.last_caps: Optional[str] = None
        self._video: Optional[VideoInfo] = None

    def set_info(self, incaps, outcaps):
        self._video = _raw_video(outcaps)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        out = super().host_process(buf)
        info = self._video
        if out is None or info is None:
            return out
        frames = out.data if isinstance(out.data, list) else [out.data]
        planes = from_bytes(info.finfo, np.stack(frames), info.width,
                            info.height)
        return out.with_(data=device_planes(planes, resolve(self.device)),
                         batch=len(frames))

    def transform_caps(self, direction, caps, filter=None):
        # the real caps travel inline (C bit; gstrtpgstdepay.c sets
        # src caps from the in-band caps packet, not negotiation) —
        # negotiate an opaque placeholder when downstream accepts ANY
        if direction == PadDirection.SINK:
            if filter is None or getattr(filter, "_any", False):
                return Caps.from_string("application/x-rtp-carried")
            return filter
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def _strip(self, payload: bytes) -> bytes:
        if len(payload) < 4:
            return b""
        body = payload[4:]
        if payload[0] & 0x80:                    # inline caps string
            z = body.find(b"\x00")
            if z >= 0:
                self.last_caps = body[:z].decode(errors="replace")
                body = body[z + 1:]
        return body


# ---------------------------------------------------------------------------
# rtppassthroughpay
# ---------------------------------------------------------------------------

@register_element
class RtpPassthroughPay(TransformElement):
    """rtppassthroughpay (gstrtppassthroughpay.c): forwards RTP
    packets, optionally rewriting the payload type."""
    FACTORY = "rtppassthroughpay"
    DESCRIPTION = "Passes through RTP packets, rewriting the PT"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "pt": (int, -1, "rewrite payload type (-1 = keep)"),
    }

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        pt = self.props["pt"]
        if pt < 0:
            return buf
        out = []
        for pkt in _blobs(buf):
            b = bytearray(pkt)
            b[1] = (b[1] & 0x80) | (pt & 0x7F)
            out.append(bytes(b))
        return buf.with_(data=out)


# ---------------------------------------------------------------------------
# RFC 2198 redundancy (rtpredenc / rtpreddec)
# ---------------------------------------------------------------------------

_RED_LENGTH_MAX = 0x3FF
_RED_OFFSET_MAX = 0x3FFF


@register_element
class RtpRedEnc(TransformElement):
    """rtpredenc (gst/rtpmanager/gstrtpredenc.c, RFC 2198): wraps each
    RTP payload in a RED block train; `distance` > 0 adds the previous
    packet's payload as a redundant block."""
    FACTORY = "rtpredenc"
    DESCRIPTION = "RTP Redundant Audio Data (RED) encoder (RFC 2198)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "pt": (int, 122, "RED payload type"),
        "distance": (int, 1, "packets of redundancy (0 = none)"),
        "allow-no-red-blocks": (bool, True, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._hist: deque = deque(maxlen=4)

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._hist.clear()

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        out = []
        dist = self.props["distance"]
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            blocks = b""
            reds = b""
            ppt, pts_, ppay = self._hist[-1] if self._hist else (0, 0, b"")
            ts_off = (h["timestamp"] - pts_) & 0xFFFFFFFF
            # RFC 2198 section 3: a block's length has 10 bits and its
            # timestamp offset 14 (gstrtpredenc.c leaves out a block that
            # does not fit)
            if dist > 0 and self._hist and len(ppay) <= _RED_LENGTH_MAX \
                    and ts_off <= _RED_OFFSET_MAX:
                # F=1 block header: PT, 14-bit ts offset, 10-bit len
                blocks += bytes([0x80 | (ppt & 0x7F)]) + struct.pack(
                    ">H", (ts_off << 2) | (len(ppay) >> 8)) \
                    + bytes([len(ppay) & 0xFF])
                reds += ppay
            blocks += bytes([h["payload_type"] & 0x7F])  # primary
            hdr = rtp_header(self.props["pt"], h["seq"],
                             h["timestamp"], h["ssrc"],
                             marker=h["marker"])
            out.append(hdr + blocks + reds + h["payload"])
            self._hist.append((h["payload_type"], h["timestamp"],
                               h["payload"]))
        return buf.with_(data=out)


@register_element
class RtpRedDec(TransformElement):
    """rtpreddec (gstrtpreddec.c, RFC 2198): outputs the primary
    payload; recovers a lost packet from a redundant block when a
    sequence gap is observed."""
    FACTORY = "rtpreddec"
    DESCRIPTION = "RTP Redundant Audio Data (RED) decoder (RFC 2198)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "pt": (int, 122, "RED payload type to decode"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._last_seq: Optional[int] = None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._last_seq = None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        out = []
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            if h["payload_type"] != self.props["pt"]:
                out.append(pkt)
                self._last_seq = h["seq"]
                continue
            payload = h["payload"]
            # parse block headers
            p = 0
            blocks = []                          # (pt, ts_off, length)
            while p < len(payload) and payload[p] & 0x80:
                bpt = payload[p] & 0x7F
                w = struct.unpack(">H", payload[p + 1:p + 3])[0]
                ln = ((w & 0x3) << 8) | payload[p + 3]
                blocks.append((bpt, w >> 2, ln))
                p += 4
            prim_pt = payload[p] & 0x7F
            p += 1
            rpos = p
            reds = []
            for bpt, ts_off, ln in blocks:
                reds.append((bpt, ts_off, payload[rpos:rpos + ln]))
                rpos += ln
            prim = payload[rpos:]
            gap = (self._last_seq is not None
                   and ((h["seq"] - self._last_seq) & 0xFFFF) == 2)
            if gap and reds:
                bpt, ts_off, rpay = reds[-1]
                rec = rtp_header(bpt, (h["seq"] - 1) & 0xFFFF,
                                 (h["timestamp"] - ts_off)
                                 & 0xFFFFFFFF, h["ssrc"]) + rpay
                out.append(rec)
            hdr = rtp_header(prim_pt, h["seq"], h["timestamp"],
                             h["ssrc"], marker=h["marker"])
            out.append(hdr + prim)
            self._last_seq = h["seq"]
        if not out:
            return None
        return buf.with_(data=out)


# ---------------------------------------------------------------------------
# RFC 5109 ULPFEC (rtpulpfecenc / rtpulpfecdec) + rtpstorage
# ---------------------------------------------------------------------------

def _xor_bytes(a: bytes, b: bytes) -> bytes:
    if len(a) < len(b):
        a, b = b, a
    arr = bytearray(a)
    for i, v in enumerate(b):
        arr[i] ^= v
    return bytes(arr)


@register_element
class RtpUlpFecEnc(TransformElement):
    """rtpulpfecenc (gst/rtpmanager/gstrtpulpfecenc.c, RFC 5109):
    emits one level-0 FEC packet per group of `group-size` media
    packets, XOR-protecting headers and payloads."""
    FACTORY = "rtpulpfecenc"
    DESCRIPTION = "RTP FEC encoder (RFC 5109)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "pt": (int, 122, "FEC payload type"),
        "percentage": (int, 100, "FEC coverage percent"),
        "group-size": (int, 4, "media packets per FEC packet"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._group: List[bytes] = []

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._group = []

    def _fec_packet(self) -> bytes:
        pkts = self._group
        h0 = parse_rtp_header(pkts[0])
        sn_base = h0["seq"]
        # recovery fields: XOR over (PT | M) byte, timestamps, lengths
        ptrec = 0
        tsrec = 0
        lenrec = 0
        paylen = 0
        for pkt in pkts:
            h = parse_rtp_header(pkt)
            ptrec ^= pkt[1]
            tsrec ^= h["timestamp"]
            lenrec ^= len(h["payload"])
            paylen = max(paylen, len(h["payload"]))
        mask = 0
        for pkt in pkts:
            h = parse_rtp_header(pkt)
            mask |= 1 << (15 - ((h["seq"] - sn_base) & 0xFFFF))
        # First byte 0x00: E=0, L=0 (short 16-bit mask), P/X/CC recovery
        # unused here — matches rtpulpfeccommon.h short-mask framing.
        fec_hdr = struct.pack(
            ">BBHIH", 0x00, ptrec & 0xFF, sn_base & 0xFFFF,
            tsrec & 0xFFFFFFFF, lenrec & 0xFFFF)
        level = struct.pack(">HH", paylen, mask)
        body = b""
        for pkt in pkts:
            h = parse_rtp_header(pkt)
            body = _xor_bytes(body, h["payload"].ljust(paylen, b"\0"))
        hdr = rtp_header(self.props["pt"], h0["seq"],
                         h0["timestamp"], h0["ssrc"])
        return hdr + fec_hdr + level + body

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        out = []
        for pkt in _blobs(buf):
            out.append(pkt)
            self._group.append(pkt)
            if len(self._group) >= self.props["group-size"]:
                out.append(self._fec_packet())
                self._group = []
        return buf.with_(data=out)


def ulpfec_header(payload: bytes) -> Optional[dict]:
    """A ULPFEC packet's FEC header and level-0 header (RFC 5109 sections
    7.3-7.4, the 16-bit mask): the recovery fields, the protection length,
    the protected sequence numbers and the level-0 payload; None when the
    payload is too short."""
    if len(payload) < 14:
        return None
    sn_base, tsrec, lenrec, paylen, mask = struct.unpack(
        ">HIHHH", payload[2:14])
    return {"pt_rec": payload[1], "sn_base": sn_base, "ts_rec": tsrec,
            "len_rec": lenrec, "paylen": paylen,
            "protected": [(sn_base + (15 - i)) & 0xFFFF
                          for i in range(16) if mask & (1 << i)],
            "body": payload[14:]}


@register_element
class RtpUlpFecDec(TransformElement):
    """rtpulpfecdec (gstrtpulpfecdec.c, RFC 5109): recovers a single
    lost media packet per FEC group from the XOR parity."""
    FACTORY = "rtpulpfecdec"
    DESCRIPTION = "RTP FEC decoder (RFC 5109)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "pt": (int, 122, "FEC payload type"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._media: Dict[int, bytes] = {}

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._media = {}

    def _recover(self, fec: bytes) -> Optional[bytes]:
        h = parse_rtp_header(fec)
        f = ulpfec_header(h["payload"])
        if f is None:
            return None
        protected, paylen = f["protected"], f["paylen"]
        missing = [s for s in protected if s not in self._media]
        if len(missing) != 1:
            return None
        seq = missing[0]
        pt = f["pt_rec"]
        ts = f["ts_rec"]
        ln = f["len_rec"]
        pay = f["body"][:paylen]
        for s in protected:
            if s == seq:
                continue
            pk = self._media[s]
            hh = parse_rtp_header(pk)
            pt ^= pk[1]
            ts ^= hh["timestamp"]
            ln ^= len(hh["payload"])
            pay = _xor_bytes(pay, hh["payload"].ljust(paylen, b"\0"))
        marker = bool(pt & 0x80)
        hdr = rtp_header(pt & 0x7F, seq, ts & 0xFFFFFFFF, h["ssrc"],
                         marker=marker)
        return hdr + pay[:ln & 0xFFFF]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        out = []
        for pkt in _blobs(buf):
            h = parse_rtp_header(pkt)
            if h["payload_type"] == self.props["pt"]:
                rec = self._recover(pkt)
                if rec is not None:
                    hr = parse_rtp_header(rec)
                    self._media[hr["seq"]] = rec
                    out.append(rec)
                continue
            self._media[h["seq"]] = pkt
            if len(self._media) > 256:
                # the oldest by distance behind this packet, across the
                # 16-bit wrap
                for k in sorted(self._media, key=lambda s, n=h["seq"]:
                                (n - s) & 0xFFFF)[256:]:
                    del self._media[k]
            out.append(pkt)
        if not out:
            return None
        return buf.with_(data=out)


@register_element
class RtpStorage(TransformElement):
    """rtpstorage (gst/rtpmanager/gstrtpstorage.c): passthrough that
    retains recent packets for FEC/RTX consumers via
    `get_packets()`."""
    FACTORY = "rtpstorage"
    DESCRIPTION = "Helper element for various purposes " \
                  "(ex. recovering from packet loss)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "size-time": (int, 1_000_000_000, "amount kept (ns, approx)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._store: deque = deque(maxlen=512)

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._store.clear()

    def get_packets(self) -> List[bytes]:
        return list(self._store)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        for pkt in _blobs(buf):
            self._store.append(pkt)
        return buf
