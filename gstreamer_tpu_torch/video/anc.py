"""SDI video ancillary data (SMPTE S291M) — VBI parser/encoder,
closed-caption types, AFD/Bar metadata.

TPU-native counterpart of gst-plugins-base/gst-libs/gst/video/video-anc.c:
- ADF scan + checksum: get_ancillary_16/get_ancillary_8
  (video-anc.c:95,202) — component ADF 0x000 0x3ff 0x3ff, composite
  0x3fc/0xfc, 9-bit checksum with inverted-bit-9 for 10-bit data.
- line (de)mux: convert_line_from_v210/uyvy (video-anc.c:397,450) —
  SD (<1280 px) makes no Y/UV distinction; HD splits luma then chroma.
- encoder: SET_WITH_PARITY puts even/odd parity in bits 8/9
  (video-anc.c:681), add_ancillary (video-anc.c:711),
  write_line (video-anc.c:905).
- caption caps mapping: gst_video_caption_type_from_caps /
  _to_caps (video-anc.c:1125,1165).

The ANC path is host metadata plumbing (a few hundred words per frame
line), so it runs on numpy; the word (un)packing is vectorized.

A copy of the JAX package's ``video/anc.py``: the lines are host bytes,
word for word the same.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dfield
from typing import List, Optional

import numpy as np


class AncillaryDID(enum.IntEnum):
    """video-anc.h:63 GstVideoAncillaryDID."""
    UNDEFINED = 0x00
    DELETION = 0x80
    HANC_3G_AUDIO_DATA_FIRST = 0xA0
    HANC_3G_AUDIO_DATA_LAST = 0xA7
    HANC_HDTV_AUDIO_DATA_FIRST = 0xE0
    HANC_HDTV_AUDIO_DATA_LAST = 0xE7
    HANC_SDTV_AUDIO_DATA_1_FIRST = 0xEC
    HANC_SDTV_AUDIO_DATA_1_LAST = 0xEF
    CAMERA_POSITION = 0xF0
    HANC_ERROR_DETECTION = 0xF4
    HANC_SDTV_AUDIO_DATA_2_FIRST = 0xF8
    HANC_SDTV_AUDIO_DATA_2_LAST = 0xFF


class AncillaryDID16(enum.IntEnum):
    """video-anc.h:100 GstVideoAncillaryDID16 (DID<<8 | SDID)."""
    S334_EIA_708 = 0x6101
    S334_EIA_608 = 0x6102
    S2016_3_AFD_BAR = 0x4105


@dataclass
class VideoAncillary:
    """One SMPTE S291M ancillary packet (video-anc.h GstVideoAncillary)."""
    DID: int = 0
    SDID_block_number: int = 0
    data: bytes = b""

    @property
    def data_count(self) -> int:
        return len(self.data)

    @property
    def did16(self) -> int:
        """GST_VIDEO_ANCILLARY_DID16 (video-anc.h:88)."""
        return (self.DID << 8) | self.SDID_block_number


def _checksum(words: np.ndarray, bit16: bool) -> int:
    """SMPTE S291 3.2.1 checksum over DID..data words.

    10-bit data: sum of low 9 bits, bit 9 = NOT bit 8
    (video-anc.c:168-171).  8-bit data: plain 8-bit sum."""
    if bit16:
        cs = int((words & 0x1FF).sum()) & 0x1FF
        return cs | ((0 if (cs >> 8) else 1) << 9)
    return int(words.sum()) & 0xFF


def _with_parity(vals: np.ndarray) -> np.ndarray:
    """SET_WITH_PARITY (video-anc.c:681): even/odd parity of the 8-bit
    value in bits 8/9 — bit8 if odd parity, bit9 if even."""
    v = vals.astype(np.uint16)
    p = v.copy()
    for s in (4, 2, 1):
        p ^= p >> s
    odd = (p & 1).astype(bool)
    return v | np.where(odd, 0x100, 0x200).astype(np.uint16)


def _scan_words(words: np.ndarray, bit16: bool) -> List[VideoAncillary]:
    """ADF scan over a demuxed word stream (get_ancillary_16/8,
    video-anc.c:95,202)."""
    adf0 = 0x3FC if bit16 else 0xFC
    c0, c1 = (0x000, 0x3FF) if bit16 else (0x00, 0xFF)
    out: List[VideoAncillary] = []
    n = len(words)
    off = 0
    while off + 3 < n:
        if words[off] == adf0:
            i, composite = 1, True
        elif (words[off] == c0 and words[off + 1] == c1
              and words[off + 2] == c1):
            i, composite = 3, False
        else:
            off += 1
            continue
        if off + i + 4 >= n:
            break                       # not enough data for DID/SDID/DC/CS
        did = int(words[off + i]) & 0xFF
        sdid = int(words[off + i + 1]) & 0xFF
        dc = int(words[off + i + 2]) & 0xFF
        i += 3
        if off + i + dc + 1 >= n:
            break                       # user data + checksum would overrun
        payload = (words[off + i:off + i + dc] & 0xFF).astype(np.uint8)
        i += dc
        cs = _checksum(words[off + (1 if composite else 3):off + i], bit16)
        got = int(words[off + i]) & (0x3FF if bit16 else 0xFF)
        if cs != got:
            off += 1                    # checksum mismatch: resync
            continue
        out.append(VideoAncillary(did, sdid, payload.tobytes()))
        off += i + 1
    return out


def _v210_unpack(line: bytes, width: int) -> np.ndarray:
    """v210 line -> 2*width 10-bit words in sample order
    (convert_line_from_v210, video-anc.c:450)."""
    groups = width // 6
    u32 = np.frombuffer(line[:groups * 16], dtype="<u4")
    w = np.empty((len(u32), 3), np.uint16)
    w[:, 0] = u32 & 0x3FF
    w[:, 1] = (u32 >> 10) & 0x3FF
    w[:, 2] = (u32 >> 20) & 0x3FF
    return w.reshape(-1)                # C Y C Y ... interleaved


@dataclass
class VideoVBIParser:
    """gst_video_vbi_parser_new (video-anc.c:338): v210 or UYVY only.
    add_line() then get_ancillary() per reference call protocol; here
    get_ancillaries() returns all packets of the line at once."""
    format: str                         # "v210" | "UYVY"
    pixel_width: int

    def __post_init__(self):
        if self.format not in ("v210", "UYVY"):
            raise ValueError("VBI parser supports v210/UYVY only "
                             "(video-anc.c:344)")
        self.bit16 = self.format == "v210"
        self._pending: List[VideoAncillary] = []

    def _demux(self, data: bytes) -> np.ndarray:
        w = self.pixel_width
        if self.bit16:
            words = _v210_unpack(data, w)
        else:
            words = np.frombuffer(data[:2 * w], np.uint8)
        if w < 1280:
            return words                # SD: no Y/UV distinction
        # HD: luma samples first, then chroma (video-anc.c:411,480)
        return np.concatenate([words[1::2], words[0::2]])

    def add_line(self, data: bytes) -> None:
        self._pending = _scan_words(self._demux(bytes(data)), self.bit16)

    def get_ancillary(self) -> Optional[VideoAncillary]:
        """One packet per call; None when the line is exhausted
        (GST_VIDEO_VBI_PARSER_RESULT_DONE)."""
        return self._pending.pop(0) if self._pending else None

    def get_ancillaries(self) -> List[VideoAncillary]:
        out, self._pending = self._pending, []
        return out


@dataclass
class VideoVBIEncoder:
    """gst_video_vbi_encoder_new (video-anc.c:619)."""
    format: str
    pixel_width: int

    def __post_init__(self):
        if self.format not in ("v210", "UYVY"):
            raise ValueError("VBI encoder supports v210/UYVY only")
        self.bit16 = self.format == "v210"
        self._size = 2 * self.pixel_width
        self._work = np.zeros(self._size,
                              np.uint16 if self.bit16 else np.uint8)
        self._offset = 0

    def add_ancillary(self, composite: bool, DID: int, SDID: int,
                      data: bytes) -> bool:
        """video-anc.c:711 — False if the line is full."""
        data = bytes(data)
        if len(data) > 255:
            raise ValueError("ancillary data_count must be < 256")
        if self._offset + len(data) + (5 if composite else 7) > self._size:
            return False
        w, i = self._work, self._offset
        if composite:
            w[i] = 0x3FC if self.bit16 else 0xFC
            i += 1
        else:
            w[i] = 0
            w[i + 1] = w[i + 2] = 0x3FF if self.bit16 else 0xFF
            i += 3
        hdr = np.array([DID, SDID, len(data)], np.uint8)
        body = np.frombuffer(data, np.uint8)
        words = np.concatenate([hdr, body])
        w[i:i + len(words)] = _with_parity(words) if self.bit16 else words
        i += len(words)
        start = self._offset + (1 if composite else 3)
        w[i] = _checksum(w[start:i], self.bit16)
        self._offset = i + 1
        return True

    def write_line(self) -> bytes:
        """video-anc.c:905 — produce the packed line, reset state."""
        w = self.pixel_width
        words = self._work
        if w >= 1280:
            # HD: first w words are luma, next w chroma; re-interleave
            # C Y C Y (convert_line_to_v210 HD branch, video-anc.c:833)
            inter = np.empty(2 * w, words.dtype)
            inter[1::2] = words[:w]
            inter[0::2] = words[w:]
            words = inter
        if self.bit16:
            g = words.reshape(-1, 3).astype(np.uint32)
            u32 = g[:, 0] | (g[:, 1] << 10) | (g[:, 2] << 20)
            line = u32.astype("<u4").tobytes()
        else:
            line = words.tobytes()
        self._offset = 0
        self._work = np.zeros_like(self._work)
        return line


# -- closed captions ----------------------------------------------------------

class VideoCaptionType(enum.IntEnum):
    """video-anc.h GstVideoCaptionType."""
    UNKNOWN = 0
    CEA608_RAW = 1
    CEA608_S334_1A = 2
    CEA708_RAW = 3
    CEA708_CDP = 4


_CAPTION_CAPS = {
    VideoCaptionType.CEA608_RAW: "closedcaption/x-cea-608, format=raw",
    VideoCaptionType.CEA608_S334_1A:
        "closedcaption/x-cea-608, format=s334-1a",
    VideoCaptionType.CEA708_RAW: "closedcaption/x-cea-708, format=cc_data",
    VideoCaptionType.CEA708_CDP: "closedcaption/x-cea-708, format=cdp",
}


def caption_type_to_caps(ctype: VideoCaptionType):
    """gst_video_caption_type_to_caps (video-anc.c:1165)."""
    from ..core.caps import Caps
    s = _CAPTION_CAPS.get(VideoCaptionType(ctype))
    if s is None:
        raise ValueError(f"invalid caption type {ctype}")
    return Caps.from_string(s)


def caption_type_from_caps(caps) -> VideoCaptionType:
    """gst_video_caption_type_from_caps (video-anc.c:1125)."""
    s = caps[0]
    fmt = s.get("format")
    if s.name == "closedcaption/x-cea-608":
        if fmt == "raw":
            return VideoCaptionType.CEA608_RAW
        if fmt == "s334-1a":
            return VideoCaptionType.CEA608_S334_1A
    elif s.name == "closedcaption/x-cea-708":
        if fmt == "cc_data":
            return VideoCaptionType.CEA708_RAW
        if fmt == "cdp":
            return VideoCaptionType.CEA708_CDP
    return VideoCaptionType.UNKNOWN


@dataclass
class VideoCaptionMeta:
    """GstVideoCaptionMeta (video-anc.h:230) — always copied on
    transform (gst_video_caption_meta_transform, video-anc.c:952)."""
    caption_type: VideoCaptionType
    data: bytes


# -- AFD / Bar ----------------------------------------------------------------

class VideoAFDSpec(enum.IntEnum):
    """video-anc.h:332 GstVideoAFDSpec."""
    DVB_ETSI = 0
    ATSC_A53 = 1
    SMPTE_ST2016_1 = 2


class VideoAFDValue(enum.IntEnum):
    """video-anc.h:252 GstVideoAFDValue (SMPTE ST2016-1 table 1)."""
    UNAVAILABLE = 0
    A16_9_TOP_ALIGNED = 2
    A14_9_TOP_ALIGNED = 3
    GREATER_THAN_16_9 = 4
    A4_3_FULL_16_9_FULL = 8
    A4_3_FULL_4_3_PILLAR = 9
    A16_9_LETTER_16_9_FULL = 10
    A14_9_LETTER_14_9_PILLAR = 11
    A4_3_FULL_14_9_CENTER = 13
    A16_9_LETTER_14_9_CENTER = 14
    A16_9_LETTER_4_3_CENTER = 15


@dataclass
class VideoAFDMeta:
    """GstVideoAFDMeta (video-anc.h:356)."""
    field: int = 0
    spec: VideoAFDSpec = VideoAFDSpec.ATSC_A53
    afd: VideoAFDValue = VideoAFDValue.UNAVAILABLE


@dataclass
class VideoBarMeta:
    """GstVideoBarMeta (video-anc.h SMPTE ST2016-1 bar data): when
    is_letterbox, bar_data1/2 are last line above / first line below the
    bars; otherwise first/last horizontal pixel positions."""
    field: int = 0
    is_letterbox: bool = True
    bar_data1: int = 0
    bar_data2: int = 0
