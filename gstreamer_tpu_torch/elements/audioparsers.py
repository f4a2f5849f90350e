"""audioparsers — mpegaudioparse / ac3parse / flacparse.

Frame parsers on the BaseParse scaffold, porting the sync/size logic
of gst-plugins-good/gst/audioparsers/:
* mpegaudioparse (gstmpegaudioparse.c): 11-bit sync, version/layer/
  bitrate/samplerate tables (ISO 11172-3), frame size
  144*bitrate/rate(+pad) for layer III, 1152-sample duration;
  free-format rejected like the reference default.
* ac3parse (gstac3parse.c): 0x0B77 sync, fscod + frmsizecod table
  (ATSC A/52 Table 5.18, sizes in 16-bit words), 1536-sample frames.
* flacparse (gstflacparse.c): passes the fLaC header blocks, then
  frames located by the 14-bit sync with CRC-8 header verification
  (reusing the codec's parser) — a frame ends where the next verified
  header begins.

A copy of the JAX package's ``elements/audioparsers.py`` on the port's
``core/baseparse.py``, with the JAX package's aacparse (from its
``elements/dtmf_icy.py``): ADTS 0xFFF sync, frame length from the header
bits (gstaacparse.c:394-397), next-header confirmation; it frames an ADTS
file for faad.  The parsers take a source's host bytes
(``HOST_INPUT``): a file is not staged on the card to come back.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from ..core.baseparse import BaseParse
from ..core.caps import Caps
from ..core.element import PadDirection, PadTemplate, register_element

# ISO 11172-3 bitrate table (kbps), index by [version-idx][layer-1]
_MP3_BITRATES_V1 = {
    1: [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384,
        416, 448],
    2: [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320,
        384],
    3: [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
        320],
}
_MP3_BITRATES_V2 = {
    1: [0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224,
        256],
    2: [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
    3: [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
}
_MP3_RATES = {0b11: [44100, 48000, 32000],      # MPEG1
              0b10: [22050, 24000, 16000],      # MPEG2
              0b00: [11025, 12000, 8000]}       # MPEG2.5


def mp3_frame_info(b: bytes) -> Optional[Tuple[int, int, int, int, int]]:
    """4 header bytes -> (frame_size, version, layer, rate, channels)
    or None."""
    if len(b) < 4 or b[0] != 0xFF or (b[1] & 0xE0) != 0xE0:
        return None
    ver_code = (b[1] >> 3) & 0x3
    layer_code = (b[1] >> 1) & 0x3
    if ver_code == 0b01 or layer_code == 0:
        return None
    layer = 4 - layer_code
    br_idx = (b[2] >> 4) & 0xF
    sr_idx = (b[2] >> 2) & 0x3
    pad = (b[2] >> 1) & 1
    if br_idx in (0, 15) or sr_idx == 3:
        return None                  # free-format / invalid
    v1 = ver_code == 0b11
    bitrate = (_MP3_BITRATES_V1 if v1
               else _MP3_BITRATES_V2)[layer][br_idx] * 1000
    rate = _MP3_RATES[ver_code][sr_idx]
    if layer == 1:
        size = (12 * bitrate // rate + pad) * 4
    elif layer == 2 or v1:
        size = 144 * bitrate // rate + pad
    else:                            # layer 3, MPEG2/2.5
        size = 72 * bitrate // rate + pad
    channels = 1 if ((b[3] >> 6) & 0x3) == 0b11 else 2
    version = 1 if v1 else 2
    return size, version, layer, rate, channels


# ATSC A/52 Table 5.18: frame sizes in 16-bit WORDS per
# (frmsizecod, fscod); fscod 0=48k 1=44.1k 2=32k
_AC3_FRMSIZE = [
    (64, 69, 96), (64, 70, 96), (80, 87, 120), (80, 88, 120),
    (96, 104, 144), (96, 105, 144), (112, 121, 168), (112, 122, 168),
    (128, 139, 192), (128, 140, 192), (160, 174, 240), (160, 175, 240),
    (192, 208, 288), (192, 209, 288), (224, 243, 336), (224, 244, 336),
    (256, 278, 384), (256, 279, 384), (320, 348, 480), (320, 349, 480),
    (384, 417, 576), (384, 418, 576), (448, 487, 672), (448, 488, 672),
    (512, 557, 768), (512, 558, 768), (640, 696, 960), (640, 697, 960),
    (768, 835, 1152), (768, 836, 1152), (896, 975, 1344),
    (896, 976, 1344), (1024, 1114, 1536), (1024, 1115, 1536),
    (1152, 1253, 1728), (1152, 1254, 1728), (1280, 1393, 1920),
    (1280, 1394, 1920),
]
_AC3_RATES = [48000, 44100, 32000]


def ac3_frame_info(b: bytes) -> Optional[Tuple[int, int]]:
    """5 header bytes -> (frame_size_bytes, rate) or None."""
    if len(b) < 5 or b[0] != 0x0B or b[1] != 0x77:
        return None
    fscod = (b[4] >> 6) & 0x3
    frmsizecod = b[4] & 0x3F
    if fscod == 3 or frmsizecod >= len(_AC3_FRMSIZE):
        return None
    words = _AC3_FRMSIZE[frmsizecod][{0: 0, 1: 1, 2: 2}[fscod]]
    return words * 2, _AC3_RATES[fscod]


class _ParserBase(BaseParse):
    HOST_INPUT = True       # takes the source's host bytes
    _SRC_CAPS = "ANY"

    def transform_caps(self, direction, caps, filter=None):
        res = (Caps.from_string(self._SRC_CAPS)
               if direction == PadDirection.SINK else Caps.any())
        if filter is not None:
            res = res.intersect(filter)
        return res


@register_element
class MpegAudioParse(_ParserBase):
    FACTORY = "mpegaudioparse"
    DESCRIPTION = "Parses and frames mpeg1 audio streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "audio/mpeg, mpegversion=1, layer=[1,3], "
                    "rate=[8000,48000], channels=[1,2], parsed=true"),
    ]
    _SRC_CAPS = ("audio/mpeg, mpegversion=1, layer=[1,3], "
                 "rate=[8000,48000], channels=[1,2], parsed=true")

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(4)

    def handle_frame(self, view) -> Tuple[int, int]:
        b = bytes(view[:6])
        info = mp3_frame_info(b)
        if info is None:
            return 0, 1                      # resync byte by byte
        size, version, layer, rate, channels = info
        spf = (384 if layer == 1
               else 1152 if (layer == 2 or version == 1) else 576)
        self.set_frame_rate(rate, spf)
        self._stream_info = (layer, rate, channels)
        if len(view) < size + 4:
            # require the NEXT header to confirm sync
            # (gst_mpeg_audio_parse_handle_frame draining rule)
            if len(view) < size:
                return 0, 0
            return size, 0
        if mp3_frame_info(bytes(view[size:size + 4])) is None:
            return 0, 1
        return size, 0


@register_element
class Ac3Parse(_ParserBase):
    FACTORY = "ac3parse"
    DESCRIPTION = "AC3 parser"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-ac3, rate=[32000,48000], channels=[1,6]"),
    ]
    _SRC_CAPS = "audio/x-ac3, rate=[32000,48000], channels=[1,6]"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(8)

    def handle_frame(self, view) -> Tuple[int, int]:
        info = ac3_frame_info(bytes(view[:5]))
        if info is None:
            return 0, 1
        size, rate = info
        self.set_frame_rate(rate, 1536)
        if len(view) < size + 5:
            if len(view) < size:
                return 0, 0
            return size, 0
        if ac3_frame_info(bytes(view[size:size + 5])) is None:
            return 0, 1
        return size, 0


@register_element
class FlacParse(_ParserBase):
    FACTORY = "flacparse"
    DESCRIPTION = "Parses audio with the FLAC lossless audio codec"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-flac, framed=true"),
    ]
    _SRC_CAPS = "audio/x-flac, framed=true"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(16)
        self._header_done = False

    def start(self):
        super().start()
        self._header_done = False

    @staticmethod
    def _is_frame_header(b: bytes) -> bool:
        from ..codecs.flac import crc8
        if len(b) < 6 or b[0] != 0xFF or (b[1] & 0xFC) != 0xF8:
            return False
        # find the CRC8 byte by walking the variable-length header
        # (sync..coded-number [+ blocksize/samplerate bytes])
        n = 4
        b0 = b[n] if n < len(b) else 0
        extra = 0
        if b0 >= 0xFE:
            extra = 6
        elif b0 >= 0xFC:
            extra = 5
        elif b0 >= 0xF8:
            extra = 4
        elif b0 >= 0xF0:
            extra = 3
        elif b0 >= 0xE0:
            extra = 2
        elif b0 >= 0xC0:
            extra = 1
        elif b0 >= 0x80:
            return False
        n += 1 + extra
        bs_code = (b[2] >> 4) & 0xF
        sr_code = b[2] & 0xF
        if bs_code == 6:
            n += 1
        elif bs_code == 7:
            n += 2
        if sr_code == 12:
            n += 1
        elif sr_code in (13, 14):
            n += 2
        if n + 1 > len(b):
            return False
        return crc8(b[:n]) == b[n]

    def handle_frame(self, view) -> Tuple[int, int]:
        b = bytes(view[:64])
        if not self._header_done:
            if b[:4] == b"fLaC":
                # emit marker + metadata blocks as one header frame
                pos = 4
                while pos + 4 <= len(view):
                    hdr = view[pos:pos + 4]
                    last = hdr[0] & 0x80
                    size = (int(hdr[1]) << 16) | (int(hdr[2]) << 8) \
                        | int(hdr[3])
                    pos += 4 + size
                    if last:
                        self._header_done = True
                        return pos, 0
                return 0, 0
            self._header_done = True         # headerless frame stream
        if not self._is_frame_header(b):
            return 0, 1
        # frame ends at the next verified header (or needs more data)
        raw = bytes(view)
        pos = 2
        while True:
            idx = raw.find(b"\xff", pos)
            if idx < 0 or idx + 16 > len(raw):
                if self.draining:            # EOS: rest is the frame
                    return len(raw), 0
                return 0, 0                  # need more bytes
            if self._is_frame_header(raw[idx:idx + 24]):
                return idx, 0
            pos = idx + 1


# ---------------------------------------------------------------------------
# sbcparse (gstsbcparse.c)
# ---------------------------------------------------------------------------

def _sbc_crc_table():
    """CRC-8 poly 0x1D (gstsbcparse.c crc_table, generated)."""
    tab = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1D if crc & 0x80 else crc << 1) & 0xFF
        tab.append(crc)
    return tab


_SBC_CRC_TABLE = _sbc_crc_table()


def sbc_crc8(data: bytes, crc_bits: int) -> int:
    """gst_sbc_calculate_crc8: init 0x0F, bitwise tail."""
    crc = 0x0F
    pos = 0
    while crc_bits >= 8:
        crc = _SBC_CRC_TABLE[crc ^ data[pos]]
        crc_bits -= 8
        pos += 1
    octet = data[pos] if crc_bits > 0 else 0
    while crc_bits > 0:
        bit = ((octet ^ crc) & 0x80) >> 7
        crc = ((crc & 0x7F) << 1) ^ (0x1D if bit else 0)
        octet = (octet << 1) & 0xFF
        crc_bits -= 1
    return crc


_SBC_RATES = (16000, 32000, 44100, 48000)
_SBC_BLOCKS = (4, 8, 12, 16)
_SBC_MODES = ("mono", "dual", "stereo", "joint")
_SBC_ALLOC = ("loudness", "snr")


def sbc_calc_framelen(subbands: int, mode: int, blocks: int,
                      bitpool: int) -> int:
    """gst_sbc_calc_framelen (per channel mode)."""
    if mode == 0:                                    # mono
        return 4 + (subbands * 1) // 2 + (blocks * 1 * bitpool + 7) // 8
    if mode == 1:                                    # dual
        return 4 + (subbands * 2) // 2 + (blocks * 2 * bitpool + 7) // 8
    if mode == 2:                                    # stereo
        return 4 + (subbands * 2) // 2 + (blocks * bitpool + 7) // 8
    return 4 + (subbands * 2) // 2 \
        + (subbands + blocks * bitpool + 7) // 8     # joint


def sbc_parse_header(data: bytes) -> Optional[dict]:
    """Syncbyte + field decode + header CRC check
    (gst_sbc_parse_header).  Returns None on any mismatch."""
    if len(data) < 7 or data[0] != 0x9C:
        return None
    rate = _SBC_RATES[(data[1] >> 6) & 0x03]
    blocks = _SBC_BLOCKS[(data[1] >> 4) & 0x03]
    mode = (data[1] >> 2) & 0x03
    alloc = (data[1] >> 1) & 0x01
    subbands = 8 if data[1] & 0x01 else 4
    bitpool = data[2]
    if bitpool < 2:
        return None
    crc_bits = 16
    if mode == 3:                                    # joint: join flags
        crc_bits += subbands
    crc_bits += subbands * (1 if mode == 0 else 2) * 4
    need = 1 + (crc_bits + 7) // 8 + 1
    if len(data) < need:
        return None
    crc_data = bytearray(11)
    crc_data[0] = data[1]
    crc_data[1] = data[2]
    i = 16
    while i < crc_bits:
        crc_data[i // 8] = data[1 + (i // 8) + 1]
        i += 8
    if i > crc_bits:
        crc_data[(i // 8) - 1] &= 0xF0
    if sbc_crc8(bytes(crc_data), crc_bits) != data[3]:
        return None
    return {"rate": rate, "blocks": blocks, "mode": mode,
            "alloc": alloc, "subbands": subbands, "bitpool": bitpool,
            "frame_len": sbc_calc_framelen(subbands, mode, blocks,
                                           bitpool)}


@register_element
class SbcParse(_ParserBase):
    FACTORY = "sbcparse"
    DESCRIPTION = "Parses an SBC bluetooth audio stream"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-sbc"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-sbc, parsed=true"),
    ]
    _SRC_CAPS = "audio/x-sbc, parsed=true"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(
            sbc_calc_framelen(4, 0, 4, 2))           # minimal mono frame
        self.hdr: Optional[dict] = None

    def start(self):
        super().start()
        self.hdr = None

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        hdr = sbc_parse_header(raw)
        if hdr is None:
            # resync: scan for the next plausible syncbyte
            nxt = raw.find(b"\x9c", 1)
            return 0, (nxt if nxt > 0 else max(1, len(raw) - 3))
        if hdr["frame_len"] > len(raw):
            return 0, 0
        if self.hdr is None or self.hdr != hdr:
            self.hdr = hdr
            self.set_frame_rate(hdr["rate"],
                                hdr["subbands"] * hdr["blocks"])
        return hdr["frame_len"], 0

    def pre_push_frame(self, buf):
        if self.hdr:
            from ..core.structure import Structure
            h = self.hdr
            s = Structure("audio/x-sbc", {
                "rate": h["rate"],
                "channels": 1 if h["mode"] == 0 else 2,
                "channel-mode": _SBC_MODES[h["mode"]],
                "blocks": h["blocks"], "subbands": h["subbands"],
                "allocation-method": _SBC_ALLOC[h["alloc"]],
                "bitpool": h["bitpool"], "parsed": True})
            buf = buf.with_(meta=dict(buf.meta or {},
                                      caps=Caps([s])))
        return buf


# ---------------------------------------------------------------------------
# wavpackparse (gstwavpackparse.c)
# ---------------------------------------------------------------------------

_WVPK_RATES = (6000, 8000, 9600, 11025, 12000, 16000, 22050,
               24000, 32000, 44100, 48000, 64000, 88200, 96000, 192000)
_WVPK_FLAG_MONO = 4
_WVPK_FLAG_FLOAT = 0x80
_WVPK_FLAG_FINAL = 0x1000


def wvpk_header(data: bytes) -> Optional[dict]:
    """32-byte WavPack block header (gstwavpackparse.c:425-470)."""
    if len(data) < 32 or data[:4] != b"wvpk":
        return None
    (ck_size, version, _track, _index, total, block_index,
     block_samples, flags, crc) = struct.unpack(
         "<IHBBIIIII", data[4:32])
    srate_i = (flags >> 23) & 0x0F
    return {
        "ck_size": ck_size, "version": version,
        "total_samples": total, "block_index": block_index,
        "block_samples": block_samples, "flags": flags, "crc": crc,
        "rate": (_WVPK_RATES[srate_i] if srate_i < 15 else 44100),
        "width": ((flags & 3) + 1) * 8,
        "channels": 1 if flags & _WVPK_FLAG_MONO else 2,
        "final": bool(flags & _WVPK_FLAG_FINAL),
    }


@register_element
class WavpackParse(_ParserBase):
    FACTORY = "wavpackparse"
    DESCRIPTION = "Wavpack parser"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-wavpack; audio/x-wavpack-correction"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-wavpack, framed=true"),
    ]
    _SRC_CAPS = "audio/x-wavpack, framed=true"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(32)
        self.hdr: Optional[dict] = None

    def start(self):
        super().start()
        self.hdr = None

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        off = raw.find(b"wvpk")
        if off < 0:
            return 0, max(1, len(raw) - 3)
        if off > 0:
            return 0, off
        hdr = wvpk_header(raw)
        if hdr is None:
            return 0, 0
        # a frame spans blocks until FLAG_FINAL_BLOCK
        # (multichannel segments, gstwavpackparse.c:540-560)
        frmsize = hdr["ck_size"] + 8
        h = hdr
        while not h["final"]:
            if len(raw) < frmsize + 32:
                return 0, 0
            h = wvpk_header(raw[frmsize:])
            if h is None:
                return 0, 2                      # bad chain: resync
            frmsize += h["ck_size"] + 8
        if len(raw) < frmsize:
            return 0, 0
        self.hdr = hdr
        if hdr["rate"] and hdr["block_samples"]:
            self.set_frame_rate(hdr["rate"], hdr["block_samples"])
        return frmsize, 0

    def pre_push_frame(self, buf):
        if self.hdr:
            from ..core.structure import Structure
            h = self.hdr
            s = Structure("audio/x-wavpack", {
                "rate": h["rate"], "channels": h["channels"],
                "depth": h["width"], "framed": True})
            buf = buf.with_(meta=dict(buf.meta or {},
                                      caps=Caps([s])))
        return buf


# ---------------------------------------------------------------------------
# aacparse (the JAX package's elements/dtmf_icy.py)
# ---------------------------------------------------------------------------

_ADTS_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
               16000, 12000, 11025, 8000, 7350, 0, 0, 0]


def adts_frame_len(b: bytes) -> Optional[int]:
    if len(b) < 6 or b[0] != 0xFF or (b[1] & 0xF6) != 0xF0:
        return None
    return ((b[3] & 0x03) << 11) | (b[4] << 3) | ((b[5] & 0xE0) >> 5)


@register_element
class AacParse(_ParserBase):
    FACTORY = "aacparse"
    DESCRIPTION = "Advanced Audio Coding parser"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "audio/mpeg, mpegversion={ 2, 4 }, framed=true, "
                    "stream-format=adts"),
    ]
    _SRC_CAPS = ("audio/mpeg, mpegversion={ 2, 4 }, framed=true, "
                 "stream-format=adts")

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(7)

    def handle_frame(self, view) -> Tuple[int, int]:
        b = bytes(view[:8])
        size = adts_frame_len(b)
        if size is None or size < 7:
            return 0, 1
        sr_idx = (b[2] >> 2) & 0xF
        rate = _ADTS_RATES[sr_idx]
        if rate:
            self.set_frame_rate(rate, 1024)
        if len(view) < size + 6:
            if len(view) < size:
                return 0, 0
            return size, 0
        if adts_frame_len(bytes(view[size:size + 8])) is None:
            return 0, 1
        return size, 0
