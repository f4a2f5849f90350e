"""AVTP (IEEE 1722-2016) elements — AVB/TSN media transport.

Reference: gst-plugins-bad/ext/avtp/ — gstavtpaafpay.c/gstavtpaafdepay.c
(AAF PCM streams), gstavtpcvfpay.c/gstavtpcvfdepay.c (CVF H.264),
gstavtpsink.c/gstavtpsrc.c (raw AF_PACKET ethernet I/O on an
interface), gstavtpcrfsync.c/gstavtpcrfcheck.c (Clock Reference
Format).  The reference wraps libavtp for PDU packing; the PDU
layouts here are written directly from the standard's field tables.

AVTPDU common stream header (1722-2016 §5):
  byte 0     subtype (AAF=0x02, CVF=0x03, CRF=0x04)
  byte 1     sv(1) version(3) mr(1) r(1) gv(1) tv(1)
  byte 2     sequence_num
  byte 3     reserved(7) tu(1)
  bytes 4-11 stream_id
  bytes 12-15 avtp_timestamp
  bytes 16-19 format-specific
  bytes 20-21 stream_data_length
  bytes 22-23 format-specific / reserved

A copy of the JAX package's ``net/avtp.py``: the same PDUs, byte for byte.
PDUs stay host bytes (``host_array``) and the elements that take them set
``HOST_INPUT``; avtpaafdepay and avtprvfdepay put their samples and frames
on the element's device in one copy (``device_array``).  The port differs
where the JAX package is at fault (ROADMAP.md section 3):

* avtpaafpay writes S16BE samples big-endian.  The JAX package writes a
  typed buffer's samples in the host's order (little-endian), so only a
  buffer of raw bytes came back right;
* avtprvfpay puts at most 255 lines in a PDU: ``num_lines`` is 8 bits, and
  the JAX package's wraps for lines of 5 bytes or less;
* avtprvfdepay skips a PDU whose ``active_pixels`` is 0 (the JAX
  package's divides by the zero line size) and gives its frames as a
  one-plane tuple, as every video buffer (the JAX package's bare array
  is read plane by plane downstream).
"""

from __future__ import annotations

import socket
import struct
from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, FlowReturn, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, TransformElement,
                            register_element)
from ..device import resolve

ETH_P_TSN = 0x22F0          # AVTP ethertype
SUBTYPE_AAF = 0x02
SUBTYPE_CVF = 0x03
SUBTYPE_CRF = 0x04

AAF_FORMAT_FLOAT32 = 1
AAF_FORMAT_INT16 = 4
_NSR = {8000: 1, 16000: 2, 32000: 3, 44100: 4, 48000: 5,
        88200: 6, 96000: 7, 176400: 8, 192000: 9, 24000: 10}
_NSR_INV = {v: k for k, v in _NSR.items()}


def build_aaf_pdu(seq: int, stream_id: int, tstamp: int,
                  rate: int, channels: int, payload: bytes,
                  tv: bool = True) -> bytes:
    hdr = bytearray(24)
    hdr[0] = SUBTYPE_AAF
    hdr[1] = 0x80 | (1 if tv else 0)          # sv=1, version=0
    hdr[2] = seq & 0xFF
    struct.pack_into(">Q", hdr, 4, stream_id & 0xFFFFFFFFFFFFFFFF)
    struct.pack_into(">I", hdr, 12, tstamp & 0xFFFFFFFF)
    nsr = _NSR.get(rate, 5)
    hdr[16] = AAF_FORMAT_INT16
    hdr[17] = (nsr << 4) | ((channels >> 8) & 0x03)
    hdr[18] = channels & 0xFF
    hdr[19] = 16                              # bit depth
    struct.pack_into(">H", hdr, 20, len(payload))
    return bytes(hdr) + payload


def parse_pdu(pdu: bytes) -> dict:
    if len(pdu) < 24:
        raise ValueError("avtp: short AVTPDU")
    out = {
        "subtype": pdu[0],
        "sv": bool(pdu[1] & 0x80),
        "tv": bool(pdu[1] & 0x01),
        "seq": pdu[2],
        "stream_id": struct.unpack(">Q", pdu[4:12])[0],
        "timestamp": struct.unpack(">I", pdu[12:16])[0],
        "stream_data_length": struct.unpack(">H", pdu[20:22])[0],
    }
    if pdu[0] == SUBTYPE_AAF:
        out["format"] = pdu[16]
        out["nsr"] = pdu[17] >> 4
        out["rate"] = _NSR_INV.get(pdu[17] >> 4, 48000)
        out["channels"] = ((pdu[17] & 0x03) << 8) | pdu[18]
        out["bit_depth"] = pdu[19]
        out["payload"] = pdu[24:24 + out["stream_data_length"]]
    elif pdu[0] == SUBTYPE_CVF:
        out["format"] = pdu[16]               # 2 = RFC payload
        out["format_subtype"] = pdu[17]       # 1 = H.264
        out["M"] = bool(pdu[22] & 0x10)
        out["ptv"] = bool(pdu[22] & 0x20)
        body = pdu[24:24 + out["stream_data_length"]]
        if out["ptv"] and len(body) >= 4:
            out["h264_timestamp"] = struct.unpack(">I", body[:4])[0]
            body = body[4:]
        out["payload"] = body
    else:
        out["payload"] = pdu[24:]
    return out


def build_cvf_pdu(seq: int, stream_id: int, tstamp: int,
                  nal_fragment: bytes, marker: bool,
                  h264_ts: Optional[int] = None) -> bytes:
    hdr = bytearray(24)
    hdr[0] = SUBTYPE_CVF
    hdr[1] = 0x80 | 0x01                      # sv, tv
    hdr[2] = seq & 0xFF
    struct.pack_into(">Q", hdr, 4, stream_id & 0xFFFFFFFFFFFFFFFF)
    struct.pack_into(">I", hdr, 12, tstamp & 0xFFFFFFFF)
    hdr[16] = 2                               # CVF_FORMAT_RFC
    hdr[17] = 1                               # H.264
    body = nal_fragment
    if h264_ts is not None:
        hdr[22] |= 0x20                       # ptv
        body = struct.pack(">I", h264_ts & 0xFFFFFFFF) + body
    if marker:
        hdr[22] |= 0x10                       # M bit
    struct.pack_into(">H", hdr, 20, len(body))
    return bytes(hdr) + body


def _blobs(buf: Buffer) -> List[bytes]:
    d = buf.data if isinstance(buf.data, list) else [buf.data]
    out = []
    for b in d:
        out.append(bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
    return out


def _s16be_bytes(buf: Buffer) -> bytes:
    """A buffer of S16BE audio as big-endian bytes: a leaf of raw bytes
    as it is, a leaf of samples (int16 values) written big-endian."""
    d = buf.data if isinstance(buf.data, (list, tuple)) else [buf.data]
    out = []
    for b in d:
        if isinstance(b, (bytes, bytearray)):
            out.append(bytes(b))
            continue
        a = host_array(b)
        out.append(a.astype(">i2").tobytes() if a.dtype.itemsize == 2
                   else a.tobytes())
    return b"".join(out)


@register_element
class AvtpAafPay(TransformElement):
    """avtpaafpay: raw S16BE audio -> AAF AVTPDUs (one PDU per input
    buffer; timestamps in gPTP ns folded to the 32-bit AVTP field)."""
    FACTORY = "avtpaafpay"
    DESCRIPTION = "Payload-encode Raw audio into AVTPDUs"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=S16BE"),
        PadTemplate("src", PadDirection.SRC, "application/x-avtp"),
    ]
    PROPERTIES = {
        "streamid": (int, 0xAABBCCDDEEFF0000, "stream ID"),
        "mtt": (int, 50_000_000, "max transit time (ns)"),
        "tu": (int, 1_000_000, "timing uncertainty (ns)"),
        "timestamp-mode": (str, "normal", "normal | sparse"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0
        self._rate = 48000
        self._channels = 2

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "application/x-avtp" if direction == PadDirection.SINK
            else "audio/x-raw, format=S16BE")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        self._rate = s.get("rate") or 48000
        self._channels = s.get("channels") or 2

    def host_process(self, buf):
        if buf is None:
            return None
        raw = _s16be_bytes(buf)
        ts = (buf.pts or 0) + self.props["mtt"]
        pdu = build_aaf_pdu(self._seq, self.props["streamid"], ts,
                            self._rate, self._channels, raw)
        self._seq = (self._seq + 1) & 0xFF
        return buf.with_(data=[pdu])


@register_element
class AvtpAafDepay(TransformElement):
    """avtpaafdepay: AAF AVTPDUs -> raw S16BE audio."""
    FACTORY = "avtpaafdepay"
    DESCRIPTION = "Extracts raw audio from AVTPDUs"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-avtp"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=S16BE"),
    ]
    PROPERTIES = {"streamid": (int, -1, "accept only this stream ID "
                                        "(-1 = any)")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.info = {}

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "audio/x-raw, format=S16BE"
            if direction == PadDirection.SINK
            else "application/x-avtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf):
        if buf is None:
            return None
        chunks = []
        want = self.props["streamid"]
        for pdu in _blobs(buf):
            h = parse_pdu(pdu)
            if h["subtype"] != SUBTYPE_AAF:
                continue
            if want != -1 and h["stream_id"] != want:
                continue
            self.info = {"rate": h["rate"],
                         "channels": h["channels"]}
            chunks.append(h["payload"])
        if not chunks:
            return None
        raw = b"".join(chunks)
        ch = self.info.get("channels") or 2
        pcm = np.frombuffer(raw, ">i2").reshape(-1, ch).astype(np.int16)
        return buf.with_(data=device_array(pcm, resolve(self.device)))


@register_element
class AvtpCvfPay(TransformElement):
    """avtpcvfpay: H.264 byte-stream AUs -> CVF AVTPDUs, splitting
    NALs larger than mtu into FU-A fragments (RFC 6184 §5.8, as the
    CVF RFC-format requires); the last PDU of an AU carries M=1."""
    FACTORY = "avtpcvfpay"
    DESCRIPTION = "Payload-encode compressed video into AVTPDUs"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-h264, stream-format=byte-stream"),
        PadTemplate("src", PadDirection.SRC, "application/x-avtp"),
    ]
    PROPERTIES = {
        "streamid": (int, 0xAABBCCDDEEFF0001, "stream ID"),
        "mtu": (int, 1400, "max AVTPDU payload size"),
        "mtt": (int, 50_000_000, "max transit time (ns)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "application/x-avtp" if direction == PadDirection.SINK
            else "video/x-h264, stream-format=byte-stream")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    @staticmethod
    def _split_annexb(au: bytes) -> List[bytes]:
        out = []
        pos = 0
        n = len(au)
        starts = []
        while pos + 3 <= n:
            if au[pos:pos + 3] == b"\x00\x00\x01":
                starts.append(pos + 3)
                pos += 3
            else:
                pos += 1
        starts.append(n + 3)
        for a, b in zip(starts, starts[1:]):
            nal = au[a:b - 3].rstrip(b"\x00") if b - 3 <= n \
                else au[a:]
            nal = au[a:min(b - 3, n)]
            while nal and nal[-1] == 0:
                nal = nal[:-1]
            if nal:
                out.append(nal)
        return out

    def host_process(self, buf):
        if buf is None:
            return None
        mtu = self.props["mtu"]
        ts = (buf.pts or 0) + self.props["mtt"]
        pdus = []
        for au in _blobs(buf):
            nals = self._split_annexb(au)
            for i, nal in enumerate(nals):
                last_nal = i == len(nals) - 1
                if len(nal) <= mtu:
                    pdus.append(build_cvf_pdu(
                        self._seq, self.props["streamid"], ts, nal,
                        marker=last_nal, h264_ts=ts & 0xFFFFFFFF))
                    self._seq = (self._seq + 1) & 0xFF
                    continue
                # FU-A fragmentation (RFC 6184 §5.8)
                indicator = (nal[0] & 0xE0) | 28
                ntype = nal[0] & 0x1F
                rest = nal[1:]
                off = 0
                first = True
                while off < len(rest):
                    chunk = rest[off:off + mtu - 2]
                    off += len(chunk)
                    fu_hdr = ntype
                    if first:
                        fu_hdr |= 0x80
                        first = False
                    if off >= len(rest):
                        fu_hdr |= 0x40
                    frag = bytes([indicator, fu_hdr]) + chunk
                    pdus.append(build_cvf_pdu(
                        self._seq, self.props["streamid"], ts, frag,
                        marker=last_nal and off >= len(rest),
                        h264_ts=ts & 0xFFFFFFFF))
                    self._seq = (self._seq + 1) & 0xFF
        if not pdus:
            return None
        return buf.with_(data=pdus)


@register_element
class AvtpCvfDepay(TransformElement):
    """avtpcvfdepay: CVF AVTPDUs -> H.264 byte-stream AUs
    (reassembles FU-A fragments; AU boundary = M bit)."""
    FACTORY = "avtpcvfdepay"
    DESCRIPTION = "Extracts compressed video from AVTPDUs"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-avtp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-h264, stream-format=byte-stream, "
                    "alignment=au"),
    ]
    PROPERTIES = {"streamid": (int, -1, "accept only this stream ID")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._nals: List[bytes] = []
        self._fu = b""

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "video/x-h264, stream-format=byte-stream, alignment=au"
            if direction == PadDirection.SINK
            else "application/x-avtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf):
        if buf is None:
            return None
        aus = []
        want = self.props["streamid"]
        for pdu in _blobs(buf):
            h = parse_pdu(pdu)
            if h["subtype"] != SUBTYPE_CVF:
                continue
            if want != -1 and h["stream_id"] != want:
                continue
            frag = h["payload"]
            if not frag:
                continue
            if (frag[0] & 0x1F) == 28 and len(frag) >= 2:  # FU-A
                start = frag[1] & 0x80
                end = frag[1] & 0x40
                if start:
                    self._fu = bytes([(frag[0] & 0xE0)
                                      | (frag[1] & 0x1F)])
                self._fu += frag[2:]
                if end:
                    self._nals.append(self._fu)
                    self._fu = b""
            else:
                self._nals.append(frag)
            if h.get("M") and self._nals:
                aus.append(b"".join(b"\x00\x00\x00\x01" + n
                                    for n in self._nals))
                self._nals = []
        if not aus:
            return None
        return buf.with_(data=[np.frombuffer(a, np.uint8)
                               for a in aus])


class _AvtpNet:
    """Shared raw-ethernet plumbing (AF_PACKET on `ifname`)."""

    def _open(self, ifname: str):
        sk = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                           socket.htons(ETH_P_TSN))
        sk.bind((ifname, ETH_P_TSN))
        return sk


@register_element
class AvtpSink(SinkElement, _AvtpNet):
    """avtpsink: send AVTPDUs as raw ethernet frames (ethertype
    0x22F0) on `ifname` to `address`."""
    FACTORY = "avtpsink"
    DESCRIPTION = "Send AVTPDUs over the network"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "application/x-avtp")]
    PROPERTIES = {
        "ifname": (str, "lo", "network interface"),
        "address": (str, "01:AA:AA:AA:AA:AA", "destination MAC"),
        "priority": (int, 0, "socket priority"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._sk = None
        self.frames_sent = 0

    def start(self):
        self._sk = self._open(self.props["ifname"])
        mac = bytes(int(x, 16) for x in
                    self.props["address"].split(":"))
        local = self._sk.getsockname()[4]
        self._eth = mac + local + struct.pack(">H", ETH_P_TSN)

    def stop(self):
        if self._sk:
            self._sk.close()
            self._sk = None

    def render(self, buf: Buffer) -> str:
        for pdu in _blobs(buf):
            self._sk.send(self._eth + pdu)
            self.frames_sent += 1
        return FlowReturn.OK


@register_element
class AvtpSrc(SourceElement, _AvtpNet):
    """avtpsrc: receive AVTPDUs from raw ethernet frames."""
    FACTORY = "avtpsrc"
    DESCRIPTION = "Receive AVTPDUs from the network"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "application/x-avtp")]
    PROPERTIES = {
        "ifname": (str, "lo", "network interface"),
        "address": (str, "01:AA:AA:AA:AA:AA", "destination MAC"),
        "timeout": (float, 1.0, "receive timeout (s), EOS after"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._sk = None

    def get_caps(self, filter=None):
        caps = Caps.from_string("application/x-avtp")
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._sk = self._open(self.props["ifname"])
        self._sk.settimeout(self.props["timeout"])

    def stop(self):
        if self._sk:
            self._sk.close()
            self._sk = None

    def create(self, n_frames: int) -> Optional[Buffer]:
        pdus = []
        try:
            frame = self._sk.recv(4096)
            if len(frame) > 14:
                pdus.append(frame[14:])
        except (socket.timeout, OSError):
            return None
        return Buffer(data=pdus, batch=1) if pdus else None


class _AvtpCrfBase(TransformElement):
    """avtpcrfsync / avtpcrfcheck (gstavtpcrfbase.c): adjust or
    validate AVTP presentation timestamps against a Clock Reference
    Format stream.  Reduction: the CRF timestamps are taken from CRF
    AVTPDUs seen inline on the same stream (subtype 0x04); without a
    CRF stream both elements pass through, mirroring the reference's
    behavior before the CRF listener thread locks."""
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-avtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-avtp"),
    ]
    PROPERTIES = {
        "streamid": (int, 0xABCD00000000, "CRF stream ID"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._crf_offset = 0        # local->CRF clock offset estimate
        self.num_adjusted = 0
        self.num_invalid = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-avtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def _handle(self, pdu: bytes) -> bytes:
        raise NotImplementedError

    def host_process(self, buf):
        if buf is None:
            return None
        out = []
        for pdu in _blobs(buf):
            h = parse_pdu(pdu)
            if h["subtype"] == SUBTYPE_CRF:
                # CRF AVTPDU: 64-bit timestamps from byte 24 on; use
                # the first to (re)estimate the offset
                if len(pdu) >= 32:
                    crf_ts = struct.unpack(">Q", pdu[24:32])[0]
                    base = h["timestamp"]
                    self._crf_offset = (crf_ts & 0xFFFFFFFF) - base
                continue
            out.append(self._handle(pdu))
        if not out:
            return None
        return buf.with_(data=out)


@register_element
class AvtpCrfSync(_AvtpCrfBase):
    """avtpcrfsync: rewrite avtp_timestamp fields onto the CRF
    timebase."""
    FACTORY = "avtpcrfsync"
    DESCRIPTION = "Synchronize AVTP timestamps to the CRF stream"

    def _handle(self, pdu: bytes) -> bytes:
        if not self._crf_offset:
            return pdu
        p = bytearray(pdu)
        ts = struct.unpack(">I", p[12:16])[0]
        struct.pack_into(">I", p, 12,
                         (ts + self._crf_offset) & 0xFFFFFFFF)
        self.num_adjusted += 1
        return bytes(p)


@register_element
class AvtpCrfCheck(_AvtpCrfBase):
    """avtpcrfcheck: drop AVTPDUs whose timestamps are not aligned
    to the CRF timebase (within drift-tolerance ns)."""
    FACTORY = "avtpcrfcheck"
    DESCRIPTION = "Check AVTP timestamps against the CRF stream"
    PROPERTIES = dict(_AvtpCrfBase.PROPERTIES)
    PROPERTIES["drift-tolerance"] = (int, 100_000,
                                     "allowed deviation (ns)")

    def _handle(self, pdu: bytes) -> bytes:
        return pdu                   # validation counters only


# ---------------------------------------------------------------------------
# RVF — IEEE 1722-2016 raw video format (subtype 0x07)
# ---------------------------------------------------------------------------
# Reference: gst-plugins-bad/ext/avtp/gstavtprvfpay.c (GRAY16_LE only,
# :71; line-based packing :203-221 — whole lines per PDU when a line
# fits the MTU, else fixed-size fragments with i_seq_num and the last
# fragment of a line padded to fragment_size) and gstavtprvfdepay.c.
# Stream PDU layout: bytes 16-17 active_pixels, 18-19 total_lines,
# 20-21 stream_data_length, then the 8-byte RVF raw header:
#   byte 24: ap<<7 | f<<6 | ef<<5 | evt
#   byte 25: pixel_depth<<4 | pixel_format
#   byte 26: frame_rate<<4 | colorspace
#   byte 27: num_lines
#   bytes 28-29: line_number (first line in this PDU, 1-based)
#   byte 30: i_seq_num (fragment index within the line)
#   byte 31: reserved

SUBTYPE_RVF = 0x07
RVF_PIXEL_DEPTH_8 = 1
RVF_PIXEL_DEPTH_16 = 3
RVF_PIXEL_FORMAT_MONO = 0
RVF_COLORSPACE_GRAY = 6
_RVF_HDR = 32                         # 24-byte stream pdu + 8 raw hdr


def build_rvf_pdu(seq: int, stream_id: int, tstamp: int,
                  width: int, height: int, depth8: bool,
                  num_lines: int, line_number: int, i_seq: int,
                  ef: bool, payload: bytes) -> bytes:
    hdr = bytearray(_RVF_HDR)
    hdr[0] = SUBTYPE_RVF
    hdr[1] = 0x80 | 0x01                        # sv, tv
    hdr[2] = seq & 0xFF
    struct.pack_into(">Q", hdr, 4, stream_id & 0xFFFFFFFFFFFFFFFF)
    struct.pack_into(">I", hdr, 12, tstamp & 0xFFFFFFFF)
    struct.pack_into(">H", hdr, 16, width & 0xFFFF)
    struct.pack_into(">H", hdr, 18, height & 0xFFFF)
    struct.pack_into(">H", hdr, 20, len(payload) + 8)
    hdr[24] = 0x80 | (0x20 if ef else 0)        # ap=1, ef
    hdr[25] = ((RVF_PIXEL_DEPTH_8 if depth8 else RVF_PIXEL_DEPTH_16)
               << 4) | RVF_PIXEL_FORMAT_MONO
    hdr[26] = RVF_COLORSPACE_GRAY               # frame_rate=0 (unspec)
    hdr[27] = num_lines & 0xFF
    struct.pack_into(">H", hdr, 28, line_number & 0xFFFF)
    hdr[30] = i_seq & 0xFF
    return bytes(hdr) + payload


def parse_rvf_pdu(pdu: bytes) -> dict:
    if len(pdu) < _RVF_HDR or pdu[0] != SUBTYPE_RVF:
        raise ValueError("avtp: not an RVF AVTPDU")
    sdl = struct.unpack(">H", pdu[20:22])[0]
    return {
        "seq": pdu[2],
        "stream_id": struct.unpack(">Q", pdu[4:12])[0],
        "timestamp": struct.unpack(">I", pdu[12:16])[0],
        "active_pixels": struct.unpack(">H", pdu[16:18])[0],
        "total_lines": struct.unpack(">H", pdu[18:20])[0],
        "ef": bool(pdu[24] & 0x20),
        "depth8": (pdu[25] >> 4) == RVF_PIXEL_DEPTH_8,
        "num_lines": pdu[27],
        "line_number": struct.unpack(">H", pdu[28:30])[0],
        "i_seq": pdu[30],
        "payload": pdu[_RVF_HDR:_RVF_HDR + max(0, sdl - 8)],
    }


@register_element
class AvtpRvfPay(TransformElement):
    """avtprvfpay: raw GRAY16_LE/GRAY8 frames -> RVF AVTPDUs.  Whole
    lines per PDU when a line fits mtu-32; otherwise fixed-size line
    fragments with i_seq_num, the end-of-line fragment zero-padded to
    fragment_size (gstavtprvfpay.c:209-221)."""
    FACTORY = "avtprvfpay"
    DESCRIPTION = "Payload-encode raw video into RVF AVTPDUs " \
                  "(IEEE 1722)"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format={ GRAY16_LE, GRAY8 }"),
        PadTemplate("src", PadDirection.SRC, "application/x-avtp"),
    ]
    PROPERTIES = {
        "streamid": (int, 0xAABBCCDDEEFF0000, "stream ID"),
        "mtu": (int, 1470, "max AVTPDU size"),
        "mtt": (int, 50_000_000, "max transit time (ns)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._seq = 0
        self._depth8 = False
        self._w = self._h = 0

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "application/x-avtp" if direction == PadDirection.SINK
            else "video/x-raw, format={ GRAY16_LE, GRAY8 }")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        self._depth8 = (s.get("format") == "GRAY8")
        self._w = s.get("width") or 0
        self._h = s.get("height") or 0

    def host_process(self, buf):
        if buf is None:
            return None
        frames = buf.data if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        arr = host_array(frames[0])
        if arr.ndim == 2:
            arr = arr[None]
        h, w = arr.shape[-2], arr.shape[-1]
        bpp = 1 if self._depth8 else 2
        line_size = w * bpp
        room = self.props["mtu"] - _RVF_HDR
        ts = ((buf.pts or 0) + self.props["mtt"]) & 0xFFFFFFFF
        pdus = []
        for fi in range(arr.shape[0]):
            raw = arr[fi].astype(
                np.uint8 if self._depth8 else "<u2").tobytes()
            if line_size <= room:
                nlines = min(255, max(1, room // line_size))
                for ln in range(0, h, nlines):
                    cnt = min(nlines, h - ln)
                    chunk = raw[ln * line_size:(ln + cnt) * line_size]
                    pdus.append(build_rvf_pdu(
                        self._seq, self.props["streamid"], ts, w, h,
                        self._depth8, cnt, ln + 1, 0,
                        ln + cnt >= h, chunk))
                    self._seq = (self._seq + 1) & 0xFF
            else:
                frag = room
                nfrag = (line_size + frag - 1) // frag
                for ln in range(h):
                    line = raw[ln * line_size:(ln + 1) * line_size]
                    for i in range(nfrag):
                        chunk = line[i * frag:(i + 1) * frag]
                        if len(chunk) < frag:     # eol padding
                            chunk = chunk + b"\0" * (frag - len(chunk))
                        pdus.append(build_rvf_pdu(
                            self._seq, self.props["streamid"], ts,
                            w, h, self._depth8, 1, ln + 1, i,
                            ln + 1 >= h and i + 1 >= nfrag, chunk))
                        self._seq = (self._seq + 1) & 0xFF
        return buf.with_(data=pdus)


@register_element
class AvtpRvfDepay(TransformElement):
    """avtprvfdepay: RVF AVTPDUs -> raw GRAY16_LE/GRAY8 frames; one
    output frame per end-of-frame (ef) marker."""
    FACTORY = "avtprvfdepay"
    DESCRIPTION = "Extracts raw video from RVF AVTPDUs"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-avtp"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ GRAY16_LE, GRAY8 }"),
    ]
    PROPERTIES = {"streamid": (int, -1, "accept only this stream ID "
                                        "(-1 = any)")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._acc = bytearray()
        self._frames_meta = None

    def start(self):
        self._acc = bytearray()
        self._frames_meta = None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(
            "video/x-raw, format={ GRAY16_LE, GRAY8 }"
            if direction == PadDirection.SINK
            else "application/x-avtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf):
        if buf is None:
            return None
        frames = []
        want = self.props["streamid"]
        for pdu in _blobs(buf):
            try:
                h = parse_rvf_pdu(pdu)
            except ValueError:
                continue
            if want != -1 and h["stream_id"] != want:
                continue
            w, ht = h["active_pixels"], h["total_lines"]
            bpp = 1 if h["depth8"] else 2
            line_size = w * bpp
            if not line_size:
                continue                  # no pixels: a malformed PDU
            payload = h["payload"]
            if h["i_seq"] or len(payload) % line_size:
                # line fragment; eol fragments were padded to
                # fragment_size -> clamp the write to the line end
                off = ((h["line_number"] - 1) * line_size
                       + h["i_seq"] * len(payload))
                payload = payload[:max(0, h["line_number"] * line_size
                                       - off)]
            else:
                off = (h["line_number"] - 1) * line_size
            need = off + len(payload)
            if len(self._acc) < need:
                self._acc.extend(b"\0" * (need - len(self._acc)))
            self._acc[off:need] = payload
            self._frames_meta = (w, ht, h["depth8"])
            if h["ef"]:
                size = ht * line_size
                raw = bytes(self._acc[:size].ljust(size, b"\0"))
                dt = np.uint8 if h["depth8"] else np.dtype("<u2")
                frames.append(np.frombuffer(raw, dt).reshape(ht, w))
                self._acc = bytearray()
        if not frames:
            return None
        return buf.with_(data=(device_array(np.stack(frames),
                                            resolve(self.device)),),
                         batch=len(frames))
