"""MXF (SMPTE 377M) — mxfmux / mxfdemux, reduced OP1a.

References: gst-plugins-bad/gst/mxf/ — mxfmux.c (partition/primer/
metadata/essence writing), mxfdemux.c (KLV walk, metadata resolve,
essence tracks), mxful.c (the SMPTE UL registry; the 16-byte keys
below are SMPTE-registered constants, not creative content),
mxfup.c (uncompressed picture mapping), mxfaes-bwf.c (BWF/AES PCM).

Reduced OP1a profile:
* single body partition layout: header partition (closed complete) +
  primer + structural metadata (Preface, Identification,
  ContentStorage, EssenceContainerData, Material/Source packages with
  timeline tracks, Sequence, SourceClip, CDCI picture descriptor and/
  or WAVE audio descriptor), frame-wrapped essence KLVs, footer
  partition + RIP;
* picture essence: UYVY 8-bit 4:2:2 via the CDCI descriptor
  (horizontal subsampling 2); sound essence: interleaved PCM S16LE
  via the WAVE descriptor;
* local tags are the SMPTE 377M static tags, declared in the primer.

The demuxer is a source-style element (location + stream selection,
like wavparse/avidemux) resolving caps from the descriptors.

A port of the JAX package's ``elements/mxf.py``: the KLV writing and
walking are copies; mxfmux copies each tick's planes and samples to the
host (``host_array``), mxfdemux gives host arrays that the pipeline
stages on its device pad by pad.  Instance ids come from ``_uuid``
(``uuid.uuid4``), as in the JAX package.
"""

from __future__ import annotations

import struct
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..audio import format as afmt
from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement,
                            MultiStreamSourceElement, PadDirection,
                            PadPresence, PadTemplate, SourceElement,
                            register_element)
from ..core.value import Fraction
from ..video.format import frame_size, from_bytes, to_bytes
from ..video.info import VideoInfo

# -- SMPTE ULs (mxful.c; SMPTE 377M / 379M / 378M) --------------------------

UL_PARTITION_PREFIX = bytes((0x06, 0x0E, 0x2B, 0x34, 0x02, 0x05,
                             0x01, 0x01, 0x0D, 0x01, 0x02, 0x01,
                             0x01))          # + kind, status, 0x00
UL_PRIMER = bytes((0x06, 0x0E, 0x2B, 0x34, 0x02, 0x05, 0x01, 0x01,
                   0x0D, 0x01, 0x02, 0x01, 0x01, 0x05, 0x01, 0x00))
UL_FILL = bytes((0x06, 0x0E, 0x2B, 0x34, 0x01, 0x01, 0x01, 0x01,
                 0x03, 0x01, 0x02, 0x10, 0x01, 0x00, 0x00, 0x00))
UL_RIP = bytes((0x06, 0x0E, 0x2B, 0x34, 0x02, 0x05, 0x01, 0x01,
                0x0D, 0x01, 0x02, 0x01, 0x01, 0x11, 0x01, 0x00))
UL_OP1A = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x01,
                 0x0D, 0x01, 0x02, 0x01, 0x01, 0x01, 0x09, 0x00))


def _meta_ul(setid: int) -> bytes:
    """Structural metadata set key (377M: 06.0E.2B.34.02.53...)."""
    return bytes((0x06, 0x0E, 0x2B, 0x34, 0x02, 0x53, 0x01, 0x01,
                  0x0D, 0x01, 0x01, 0x01, 0x01, 0x01, setid, 0x00))


SET_PREFACE = 0x2F
SET_IDENTIFICATION = 0x30
SET_CONTENT_STORAGE = 0x18
SET_ESSENCE_CONTAINER_DATA = 0x23
SET_MATERIAL_PACKAGE = 0x36
SET_SOURCE_PACKAGE = 0x37
SET_TIMELINE_TRACK = 0x3B
SET_SEQUENCE = 0x0F
SET_SOURCE_CLIP = 0x11
SET_MULTIPLE_DESCRIPTOR = 0x44
SET_CDCI_DESCRIPTOR = 0x28
SET_RGBA_DESCRIPTOR = 0x29
SET_WAVE_DESCRIPTOR = 0x48
SET_AES3_DESCRIPTOR = 0x47
SET_GENERIC_SOUND = 0x42
SET_MPEG_DESCRIPTOR = 0x51

# data definitions (SMPTE 331M/377M track data kinds)
DD_PICTURE = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x01,
                    0x01, 0x03, 0x02, 0x02, 0x01, 0x00, 0x00, 0x00))
DD_SOUND = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x01,
                  0x01, 0x03, 0x02, 0x02, 0x02, 0x00, 0x00, 0x00))
DD_TIMECODE = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x01,
                     0x01, 0x03, 0x02, 0x01, 0x01, 0x00, 0x00, 0x00))

# generic container essence element key prefix (379M 7.1)
ESSENCE_PREFIX = bytes((0x06, 0x0E, 0x2B, 0x34, 0x01, 0x02, 0x01,
                        0x01, 0x0D, 0x01, 0x03, 0x01))
TRACKNUM_PICTURE = 0x15010500        # CP picture, uncompressed
TRACKNUM_SOUND = 0x16010100          # CP sound, wave PCM
TRACKNUM_MPEG = 0x15010600           # GC picture, MPEG/AVC frame-wrap

# essence container labels (379M/382M/384M family)
ECL_UNC_PICTURE = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01,
                         0x01, 0x0D, 0x01, 0x03, 0x01, 0x02, 0x05,
                         0x01, 0x01))
ECL_BWF = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x01,
                 0x0D, 0x01, 0x03, 0x01, 0x02, 0x06, 0x01, 0x00))
# 381M MPEG-ES frame-wrapped / 381-3 AVC byte-stream
ECL_MPEG_ES = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x02,
                     0x0D, 0x01, 0x03, 0x01, 0x02, 0x04, 0x60, 0x01))
ECL_AVC = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x0A,
                 0x0D, 0x01, 0x03, 0x01, 0x02, 0x10, 0x60, 0x01))

# picture/sound essence coding labels
PEC_UNC = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x01,
                 0x04, 0x01, 0x02, 0x01, 0x7F, 0x00, 0x00, 0x00))
PEC_MPEG2 = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x03,
                   0x04, 0x01, 0x02, 0x02, 0x01, 0x01, 0x11, 0x00))
PEC_AVC = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x0A,
                 0x04, 0x01, 0x02, 0x02, 0x01, 0x31, 0x11, 0x01))
SEC_PCM = bytes((0x06, 0x0E, 0x2B, 0x34, 0x04, 0x01, 0x01, 0x01,
                 0x04, 0x02, 0x02, 0x01, 0x00, 0x00, 0x00, 0x00))

# operational pattern ULs (377M annex; byte 13-14 = item/package
# complexity): exposed by the demuxer as a string
_OP_NAMES = {
    (0x01, 0x01): "op1a", (0x01, 0x02): "op1b", (0x01, 0x03): "op1c",
    (0x02, 0x01): "op2a", (0x02, 0x02): "op2b", (0x02, 0x03): "op2c",
    (0x03, 0x01): "op3a", (0x03, 0x02): "op3b", (0x03, 0x03): "op3c",
    (0x10, 0x00): "opatom",
}


def op_name(ul: bytes) -> str:
    if len(ul) == 16 and ul[:12] == UL_OP1A[:12]:
        return _OP_NAMES.get((ul[12], ul[13]), ul.hex())
    return ul.hex() if ul else "unknown"


def ber(n: int) -> bytes:
    """BER long-form length (mxfmux writes 4-byte long form)."""
    return bytes((0x83,)) + n.to_bytes(3, "big")


def read_ber(data: bytes, pos: int) -> Tuple[int, int]:
    b0 = data[pos]
    if b0 < 0x80:
        return b0, pos + 1
    n = b0 & 0x7F
    return int.from_bytes(data[pos + 1:pos + 1 + n], "big"), \
        pos + 1 + n


def klv(key: bytes, value: bytes) -> bytes:
    return key + ber(len(value)) + value


def _umid(material: bytes) -> bytes:
    """SMPTE 330M basic UMID wrapping a 16-byte unique material id."""
    prefix = bytes((0x06, 0x0A, 0x2B, 0x34, 0x01, 0x01, 0x01, 0x05,
                    0x01, 0x01, 0x0D, 0x00, 0x13, 0x00, 0x00, 0x00))
    return prefix + material


def _local(tag: int, value: bytes) -> bytes:
    return struct.pack(">HH", tag, len(value)) + value


def _uuid() -> bytes:
    return uuid.uuid4().bytes


def _batch(uls: List[bytes]) -> bytes:
    return struct.pack(">II", len(uls), 16) + b"".join(uls)


# static local tags (SMPTE 377M) used by both ends
TAG_INSTANCE_UID = 0x3C0A
TAG_CONTENT_STORAGE = 0x3B03
TAG_OPERATIONAL_PATTERN = 0x3B09
TAG_ESSENCE_CONTAINERS = 0x3B0A
TAG_VERSION = 0x3B05
TAG_PACKAGES = 0x1901
TAG_ESSENCE_DATA = 0x1902
TAG_PACKAGE_UID = 0x4401
TAG_TRACKS = 0x4403
TAG_DESCRIPTOR = 0x4701
TAG_TRACK_ID = 0x4801
TAG_TRACK_NUMBER = 0x4804
TAG_EDIT_RATE = 0x4B01
TAG_ORIGIN = 0x4B02
TAG_SEQUENCE = 0x4803
TAG_DATA_DEFINITION = 0x0201
TAG_DURATION = 0x0202
TAG_STRUCTURAL_COMPONENTS = 0x1001
TAG_START_POSITION = 0x1201
TAG_SOURCE_PACKAGE_ID = 0x1101
TAG_SOURCE_TRACK_ID = 0x1102
TAG_LINKED_TRACK_ID = 0x3006
TAG_SAMPLE_RATE = 0x3001
TAG_CONTAINER_DURATION = 0x3002
TAG_ESSENCE_CONTAINER = 0x3004
TAG_STORED_HEIGHT = 0x3202
TAG_STORED_WIDTH = 0x3203
TAG_ASPECT_RATIO = 0x320E
TAG_FRAME_LAYOUT = 0x320C
TAG_PICTURE_CODING = 0x3201
TAG_H_SUBSAMPLING = 0x3302
TAG_V_SUBSAMPLING = 0x3308
TAG_AUDIO_RATE = 0x3D03
TAG_CHANNEL_COUNT = 0x3D07
TAG_QUANT_BITS = 0x3D01
TAG_BLOCK_ALIGN = 0x3D0A
TAG_AVG_BPS = 0x3D09
TAG_SUB_DESCRIPTORS = 0x3F01
TAG_LINKED_PACKAGE_UID = 0x2701
TAG_INDEX_SID = 0x3F06
TAG_BODY_SID = 0x3F07


def _partition_pack(kind: int, status: int, this_off: int,
                    footer_off: int, header_bytes: int,
                    body_sid: int, op: bytes,
                    containers: List[bytes]) -> bytes:
    """kind: 2 header / 4 footer; status: 4 = closed complete."""
    key = UL_PARTITION_PREFIX + bytes((kind, status, 0x00))
    v = struct.pack(">HHIQQ", 1, 2, 1, this_off, 0)   # ver, kag, this, prev
    v += struct.pack(">Q", footer_off)
    v += struct.pack(">QQ", header_bytes, 0)          # header, index bytes
    v += struct.pack(">IQI", 0, 0, body_sid)          # indexSID, bodyOff
    v += op
    v += _batch(containers)
    return klv(key, v)


# ---------------------------------------------------------------------------
# mxfmux
# ---------------------------------------------------------------------------

@register_element
class MxfMux(AggregatorElement):
    FACTORY = "mxfmux"
    DESCRIPTION = "Muxes video/audio streams into a MXF stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("video_%u", PadDirection.SINK,
                    "video/x-raw, format=UYVY; video/mpeg, "
                    "mpegversion=2; video/x-h264, "
                    "stream-format=byte-stream",
                    presence=PadPresence.REQUEST),
        PadTemplate("audio_%u", PadDirection.SINK,
                    "audio/x-raw, format=S16LE, layout=interleaved",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC,
                    "application/mxf"),
    ]
    PROPERTIES = {"location": (str, "out.mxf", "output path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._vinfo: Optional[VideoInfo] = None
        self._ainfo: Optional[AudioInfo] = None
        self._vcoded: Optional[str] = None   # video/mpeg | video/x-h264
        self._vgeom = (0, 0, 25, 1)          # coded w/h/fps
        self._file = None
        self._vframes = 0
        self._asamples = 0

    def negotiate_output(self, in_caps, allowed):
        for pad_name, caps in in_caps.items():
            s = caps.fixate()[0]
            if pad_name.startswith("video"):
                if s.name in ("video/mpeg", "video/x-h264"):
                    # coded picture essence (381M MPEG / 381-3 AVC)
                    self._vcoded = s.name
                    fps = s.get("framerate") or Fraction(25, 1)
                    self._vgeom = (int(s.get("width") or 0),
                                   int(s.get("height") or 0),
                                   fps.num, fps.denom)
                else:
                    self._vinfo = VideoInfo.from_caps_structure(s)
            else:
                self._ainfo = AudioInfo.from_caps_structure(s)
        return Caps.from_string("application/mxf")

    @property
    def _has_video(self) -> bool:
        return self._vinfo is not None or self._vcoded is not None

    def _video_ecl(self) -> bytes:
        if self._vcoded == "video/mpeg":
            return ECL_MPEG_ES
        if self._vcoded == "video/x-h264":
            return ECL_AVC
        return ECL_UNC_PICTURE

    def _containers(self) -> List[bytes]:
        out = []
        if self._has_video:
            out.append(self._video_ecl())
        if self._ainfo is not None:
            out.append(ECL_BWF)
        return out

    def _edit_rate(self) -> Tuple[int, int]:
        if self._vinfo is not None:
            fps = self._vinfo.fps
            return fps.num, fps.denom
        if self._vcoded is not None:
            return self._vgeom[2], self._vgeom[3]
        return self._ainfo.rate, 1

    def _track_descs(self):
        """[(track_id, track_number, data_def)] for essence tracks."""
        out = []
        tid = 2                        # 1 reserved for timecode-ish
        if self._has_video:
            tnum = (TRACKNUM_MPEG if self._vcoded
                    else TRACKNUM_PICTURE)
            out.append((tid, tnum, DD_PICTURE))
            tid += 1
        if self._ainfo is not None:
            out.append((tid, TRACKNUM_SOUND, DD_SOUND))
        return out

    def _metadata(self, duration: int) -> bytes:
        er_n, er_d = self._edit_rate()
        material_uid = _umid(_uuid())
        source_uid = _umid(_uuid())
        sets: List[bytes] = []
        uid_preface = _uuid()
        uid_cstore = _uuid()
        uid_ecd = _uuid()
        uid_mp = _uuid()
        uid_sp = _uuid()
        tracks = self._track_descs()
        # per track: (mp_track, mp_seq, mp_clip, sp_track, sp_seq,
        #             sp_clip) uids
        tuids = [[_uuid() for _ in range(6)] for _ in tracks]
        uid_desc = _uuid()
        uid_subdescs = [_uuid() for _ in tracks]

        def track_set(uid, seq_uid, tid, tnum):
            v = _local(TAG_INSTANCE_UID, uid)
            v += _local(TAG_TRACK_ID, struct.pack(">I", tid))
            v += _local(TAG_TRACK_NUMBER, struct.pack(">I", tnum))
            v += _local(TAG_EDIT_RATE, struct.pack(">II", er_n, er_d))
            v += _local(TAG_ORIGIN, struct.pack(">q", 0))
            v += _local(TAG_SEQUENCE, seq_uid)
            return klv(_meta_ul(SET_TIMELINE_TRACK), v)

        def seq_set(uid, clip_uid, dd):
            v = _local(TAG_INSTANCE_UID, uid)
            v += _local(TAG_DATA_DEFINITION, dd)
            v += _local(TAG_DURATION, struct.pack(">q", duration))
            v += _local(TAG_STRUCTURAL_COMPONENTS,
                        _batch([clip_uid]))
            return klv(_meta_ul(SET_SEQUENCE), v)

        def clip_set(uid, dd, src_pkg, src_tid):
            v = _local(TAG_INSTANCE_UID, uid)
            v += _local(TAG_DATA_DEFINITION, dd)
            v += _local(TAG_DURATION, struct.pack(">q", duration))
            v += _local(TAG_START_POSITION, struct.pack(">q", 0))
            v += _local(TAG_SOURCE_PACKAGE_ID, src_pkg)
            v += _local(TAG_SOURCE_TRACK_ID,
                        struct.pack(">I", src_tid))
            return klv(_meta_ul(SET_SOURCE_CLIP), v)

        # preface
        v = _local(TAG_INSTANCE_UID, uid_preface)
        v += _local(TAG_VERSION, struct.pack(">H", 0x0102))
        v += _local(TAG_CONTENT_STORAGE, uid_cstore)
        v += _local(TAG_OPERATIONAL_PATTERN, UL_OP1A)
        v += _local(TAG_ESSENCE_CONTAINERS,
                    _batch(self._containers()))
        sets.append(klv(_meta_ul(SET_PREFACE), v))
        # content storage
        v = _local(TAG_INSTANCE_UID, uid_cstore)
        v += _local(TAG_PACKAGES, _batch([uid_mp, uid_sp]))
        v += _local(TAG_ESSENCE_DATA, _batch([uid_ecd]))
        sets.append(klv(_meta_ul(SET_CONTENT_STORAGE), v))
        # essence container data
        v = _local(TAG_INSTANCE_UID, uid_ecd)
        v += _local(TAG_LINKED_PACKAGE_UID, source_uid)
        v += _local(TAG_INDEX_SID, struct.pack(">I", 0))
        v += _local(TAG_BODY_SID, struct.pack(">I", 1))
        sets.append(klv(_meta_ul(SET_ESSENCE_CONTAINER_DATA), v))
        # material package
        v = _local(TAG_INSTANCE_UID, uid_mp)
        v += _local(TAG_PACKAGE_UID, material_uid)
        v += _local(TAG_TRACKS, _batch([t[0] for t in tuids]))
        sets.append(klv(_meta_ul(SET_MATERIAL_PACKAGE), v))
        for (tid, tnum, dd), uids in zip(tracks, tuids):
            sets.append(track_set(uids[0], uids[1], tid, 0))
            sets.append(seq_set(uids[1], uids[2], dd))
            sets.append(clip_set(uids[2], dd, source_uid, tid))
        # source package
        v = _local(TAG_INSTANCE_UID, uid_sp)
        v += _local(TAG_PACKAGE_UID, source_uid)
        v += _local(TAG_TRACKS, _batch([t[3] for t in tuids]))
        v += _local(TAG_DESCRIPTOR, uid_desc)
        sets.append(klv(_meta_ul(SET_SOURCE_PACKAGE), v))
        for (tid, tnum, dd), uids in zip(tracks, tuids):
            sets.append(track_set(uids[3], uids[4], tid, tnum))
            sets.append(seq_set(uids[4], uids[5], dd))
            sets.append(clip_set(uids[5], dd, b"\x00" * 32, 0))
        # descriptors
        sub = []
        for (tid, tnum, dd), sub_uid in zip(tracks, uid_subdescs):
            if dd == DD_PICTURE and self._vcoded is not None:
                # MPEG video descriptor (381M; mxfmpeg.c): CDCI-
                # inherited geometry + the coded PictureEssenceCoding
                w, h, _, _ = self._vgeom
                pec = (PEC_MPEG2 if self._vcoded == "video/mpeg"
                       else PEC_AVC)
                d = _local(TAG_INSTANCE_UID, sub_uid)
                d += _local(TAG_LINKED_TRACK_ID,
                            struct.pack(">I", tid))
                d += _local(TAG_SAMPLE_RATE,
                            struct.pack(">II", er_n, er_d))
                d += _local(TAG_ESSENCE_CONTAINER, self._video_ecl())
                d += _local(TAG_STORED_WIDTH, struct.pack(">I", w))
                d += _local(TAG_STORED_HEIGHT, struct.pack(">I", h))
                d += _local(TAG_FRAME_LAYOUT, b"\x00")
                d += _local(TAG_ASPECT_RATIO,
                            struct.pack(">II", max(w, 1), max(h, 1)))
                d += _local(TAG_PICTURE_CODING, pec)
                sets.append(klv(_meta_ul(SET_MPEG_DESCRIPTOR), d))
            elif dd == DD_PICTURE:
                vi = self._vinfo
                d = _local(TAG_INSTANCE_UID, sub_uid)
                d += _local(TAG_LINKED_TRACK_ID,
                            struct.pack(">I", tid))
                d += _local(TAG_SAMPLE_RATE,
                            struct.pack(">II", er_n, er_d))
                d += _local(TAG_ESSENCE_CONTAINER, ECL_UNC_PICTURE)
                d += _local(TAG_STORED_WIDTH,
                            struct.pack(">I", vi.width))
                d += _local(TAG_STORED_HEIGHT,
                            struct.pack(">I", vi.height))
                d += _local(TAG_FRAME_LAYOUT, b"\x00")   # full frame
                d += _local(TAG_ASPECT_RATIO,
                            struct.pack(">II", vi.width, vi.height))
                d += _local(TAG_PICTURE_CODING, PEC_UNC)
                d += _local(TAG_H_SUBSAMPLING,
                            struct.pack(">I", 2))
                d += _local(TAG_V_SUBSAMPLING,
                            struct.pack(">I", 1))
                sets.append(klv(_meta_ul(SET_CDCI_DESCRIPTOR), d))
            else:
                ai = self._ainfo
                d = _local(TAG_INSTANCE_UID, sub_uid)
                d += _local(TAG_LINKED_TRACK_ID,
                            struct.pack(">I", tid))
                d += _local(TAG_SAMPLE_RATE,
                            struct.pack(">II", er_n, er_d))
                d += _local(TAG_ESSENCE_CONTAINER, ECL_BWF)
                d += _local(TAG_AUDIO_RATE,
                            struct.pack(">II", ai.rate, 1))
                d += _local(TAG_CHANNEL_COUNT,
                            struct.pack(">I", ai.channels))
                d += _local(TAG_QUANT_BITS, struct.pack(">I", 16))
                d += _local(TAG_BLOCK_ALIGN,
                            struct.pack(">H", 2 * ai.channels))
                d += _local(TAG_AVG_BPS, struct.pack(
                    ">I", ai.rate * 2 * ai.channels))
                sets.append(klv(_meta_ul(SET_WAVE_DESCRIPTOR), d))
            sub.append(sub_uid)
        # multiple descriptor glue (one essence type keeps a direct
        # descriptor in real muxers; we always use the wrapper)
        v = _local(TAG_INSTANCE_UID, uid_desc)
        v += _local(TAG_SAMPLE_RATE, struct.pack(">II", er_n, er_d))
        v += _local(TAG_SUB_DESCRIPTORS, _batch(sub))
        sets.append(klv(_meta_ul(SET_MULTIPLE_DESCRIPTOR), v))
        return b"".join(sets)

    def start(self):
        self._file = open(self.props["location"], "wb")
        self._vframes = 0
        self._asamples = 0
        self._essence: List[Tuple[int, bytes]] = []

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        for pad_name in sorted(ins):
            buf = ins[pad_name]
            if pad_name.startswith("video"):
                if self._vcoded is not None:
                    from .container_elements import _video_blobs
                    for blob in _video_blobs(buf):
                        self._essence.append((TRACKNUM_MPEG, blob))
                        self._vframes += 1
                    continue
                vi = self._vinfo
                raw = to_bytes(vi.finfo,
                               tuple(host_array(p) for p in buf.data),
                               vi.width, vi.height)
                raw = raw.reshape(buf.batch, -1)
                for k in range(buf.batch):
                    self._essence.append((TRACKNUM_PICTURE,
                                          raw[k].tobytes()))
                    self._vframes += 1
            else:
                samples = host_array(buf.data)
                raw = afmt.to_bytes(self._ainfo.finfo, samples)
                self._essence.append((TRACKNUM_SOUND, raw.tobytes()))
                self._asamples += samples.shape[0]
        first = next(iter(ins.values()))
        return first.with_(data=np.zeros(1, np.uint8))

    def stop(self):
        if self._file is None:
            return
        duration = self._vframes or self._asamples
        meta = self._metadata(duration)
        containers = self._containers()
        hdr = _partition_pack(0x02, 0x04, 0, 0, 0, 1, UL_OP1A,
                              containers)
        header_bytes = len(meta)
        hdr = _partition_pack(0x02, 0x04, 0, 0, header_bytes, 1,
                              UL_OP1A, containers)
        body = bytearray()
        for tnum, payload in self._essence:
            key = ESSENCE_PREFIX + struct.pack(">I", tnum)
            body += klv(key, payload)
        footer_off = len(hdr) + len(meta) + len(body)
        hdr = _partition_pack(0x02, 0x04, 0, footer_off, header_bytes,
                              1, UL_OP1A, containers)
        footer = _partition_pack(0x04, 0x04, footer_off, footer_off,
                                 0, 0, UL_OP1A, containers)
        rip_body = struct.pack(">IQ", 1, 0) \
            + struct.pack(">IQ", 0, footer_off)
        rip_body += struct.pack(">I", 16 + 4 + len(rip_body) + 4)
        rip = klv(UL_RIP, rip_body)
        self._file.write(hdr)
        self._file.write(meta)
        self._file.write(bytes(body))
        self._file.write(footer)
        self._file.write(rip)
        self._file.close()
        self._file = None


# ---------------------------------------------------------------------------
# mxfdemux
# ---------------------------------------------------------------------------

_VIDEO_DESC_SETS = {SET_CDCI_DESCRIPTOR: "video",
                    SET_RGBA_DESCRIPTOR: "video",
                    SET_MPEG_DESCRIPTOR: "video"}
_AUDIO_DESC_SETS = {SET_WAVE_DESCRIPTOR: "audio",
                    SET_AES3_DESCRIPTOR: "audio",
                    SET_GENERIC_SOUND: "audio"}


def _parse_mxf(path: str):
    """One KLV walk: essence keyed by track number, every known
    descriptor family (CDCI/RGBA/MPEG picture, WAVE/AES3/generic
    sound), timeline-track metadata (track id -> essence track
    number, edit rate), and the preface's operational pattern —
    mirroring mxfdemux.c's metadata resolve, reduced."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    descriptors = []            # (kind, set_id, locals)
    tracks: Dict[int, List[bytes]] = {}
    track_meta: Dict[int, Dict[str, object]] = {}  # track_id -> info
    op_ul = b""
    meta_prefix = _meta_ul(0)[:14]
    while pos + 17 <= len(data):
        key = data[pos:pos + 16]
        length, vpos = read_ber(data, pos + 16)
        value = data[vpos:vpos + length]
        if key[:12] == ESSENCE_PREFIX:
            tnum = struct.unpack(">I", key[12:16])[0]
            tracks.setdefault(tnum, []).append(value)
        elif key[:14] == meta_prefix:
            set_id = key[14]
            if set_id in _VIDEO_DESC_SETS or set_id in _AUDIO_DESC_SETS:
                kind = _VIDEO_DESC_SETS.get(
                    set_id, _AUDIO_DESC_SETS.get(set_id))
                descriptors.append((kind, set_id,
                                    _parse_locals(value)))
            elif set_id == SET_TIMELINE_TRACK:
                d = _parse_locals(value)
                if TAG_TRACK_ID in d and TAG_TRACK_NUMBER in d:
                    tid = struct.unpack(">I", d[TAG_TRACK_ID])[0]
                    tnum = struct.unpack(">I",
                                         d[TAG_TRACK_NUMBER])[0]
                    info: Dict[str, object] = {"number": tnum}
                    if TAG_EDIT_RATE in d:
                        info["edit_rate"] = struct.unpack(
                            ">II", d[TAG_EDIT_RATE])
                    # essence track numbers are non-zero only on the
                    # source package's tracks
                    if tnum:
                        track_meta[tid] = info
            elif set_id == SET_PREFACE:
                d = _parse_locals(value)
                op_ul = d.get(TAG_OPERATIONAL_PATTERN, b"")
        pos = vpos + length
    return descriptors, tracks, track_meta, op_ul


def _parse_locals(value: bytes) -> Dict[int, bytes]:
    out = {}
    pos = 0
    while pos + 4 <= len(value):
        tag, ln = struct.unpack(">HH", value[pos:pos + 4])
        out[tag] = value[pos + 4:pos + 4 + ln]
        pos += 4 + ln
    return out


class _MxfStream:
    """One demuxed essence stream: descriptor-derived caps + frames."""

    def __init__(self, kind: str, set_id: int, d: Dict[int, bytes],
                 frames: List[bytes]):
        self.kind = kind
        self.frames = frames
        self.coded: Optional[str] = None
        if kind == "video":
            w = struct.unpack(">I", d[TAG_STORED_WIDTH])[0]
            h = struct.unpack(">I", d[TAG_STORED_HEIGHT])[0]
            n, den = struct.unpack(">II", d[TAG_SAMPLE_RATE])
            self.fps = Fraction(n, den)
            pec = d.get(TAG_PICTURE_CODING, b"")
            if set_id == SET_MPEG_DESCRIPTOR or pec in (PEC_MPEG2,
                                                        PEC_AVC):
                self.coded = ("video/x-h264" if pec == PEC_AVC
                              else "video/mpeg")
                self.w, self.h = w, h
                self.info = None
            else:
                fmt = ("RGB" if set_id == SET_RGBA_DESCRIPTOR
                       else "UYVY")
                self.info = VideoInfo(format=fmt, width=w, height=h,
                                      fps=self.fps)
        else:
            rate = struct.unpack(">II", d[TAG_AUDIO_RATE])[0]
            ch = struct.unpack(">I", d[TAG_CHANNEL_COUNT])[0]
            bits = struct.unpack(
                ">I", d.get(TAG_QUANT_BITS, b"\0\0\0\x10"))[0]
            fmt = {16: "S16LE", 24: "S24LE", 32: "S32LE"}.get(
                bits, "S16LE")
            self.info = AudioInfo(format=fmt, rate=rate, channels=ch)

    def caps(self) -> Caps:
        if self.coded:
            extra = (", mpegversion=2, systemstream=false"
                     if self.coded == "video/mpeg"
                     else ", stream-format=byte-stream, "
                          "alignment=au")
            return Caps.from_string(
                f"{self.coded}, width={self.w}, height={self.h}, "
                f"framerate={self.fps.num}/{self.fps.denom}" + extra)
        return Caps([self.info.to_caps_structure()])

    def buffer_at(self, pos: int, n: int) -> Tuple[Buffer, int]:
        """Buffer for frames[pos:pos+n] and the new position."""
        if self.kind == "video" and self.coded is None:
            info = self.info
            take = self.frames[pos:pos + max(1, n)]
            raws = np.stack([np.frombuffer(f, np.uint8)
                             for f in take])
            planes = from_bytes(info.finfo, raws, info.width,
                                info.height)
            fps = info.fps
            pts = pos * 1_000_000_000 * fps.denom // fps.num
            dur = 1_000_000_000 * fps.denom // fps.num
            return Buffer(data=planes, pts=pts, duration=dur,
                          batch=len(take)), pos + len(take)
        if self.kind == "video":
            fps = self.fps
            pts = pos * 1_000_000_000 * fps.denom // fps.num
            return Buffer(
                data=np.frombuffer(self.frames[pos], np.uint8),
                pts=pts,
                duration=1_000_000_000 * fps.denom // fps.num,
                batch=1), pos + 1
        info = self.info
        raw = self.frames[pos]
        samples = afmt.from_bytes(
            info.finfo, np.frombuffer(raw, np.uint8), info.channels)
        return Buffer(data=samples, batch=1,
                      duration=samples.shape[0] * 1_000_000_000
                      // info.rate), pos + 1


@register_element
class MxfDemux(MultiStreamSourceElement):
    """mxfdemux (mxfdemux.c, reduced): single-stream `stream=` mode on
    the always pad, or one-parse multi-stream via `video_0`/`audio_0`
    sometimes-pads; caps resolve from the descriptor family (CDCI/
    RGBA/MPEG picture, WAVE/AES3 sound), essence tracks resolve
    through the source package's timeline-track metadata, and the
    preface's operational pattern is exposed as a property."""
    FACTORY = "mxfdemux"
    DESCRIPTION = "Demux MXF files"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, Caps.any()),
        PadTemplate("video_%u", PadDirection.SRC, Caps.any(),
                    presence=PadPresence.SOMETIMES),
        PadTemplate("audio_%u", PadDirection.SRC, Caps.any(),
                    presence=PadPresence.SOMETIMES),
    ]
    PROPERTIES = {
        "location": (str, "", "mxf file path"),
        "stream": (str, "video", "video | audio (single-pad mode)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._loaded = False
        self._pos: Dict[str, int] = {}
        self.operational_pattern = "unknown"

    def _load(self):
        if self._loaded:
            return
        descriptors, tracks, track_meta, op_ul = _parse_mxf(
            self.props["location"])
        self.operational_pattern = op_name(op_ul)
        # essence track numbers from the metadata, in track-id order,
        # split by essence key item type (0x15 picture / 0x16 sound)
        pic_nums = [m["number"] for _, m in sorted(track_meta.items())
                    if (m["number"] >> 24) == 0x15]
        snd_nums = [m["number"] for _, m in sorted(track_meta.items())
                    if (m["number"] >> 24) == 0x16]
        self._streams: Dict[str, _MxfStream] = {}
        vi = ai = 0
        for kind, set_id, d in descriptors:
            if kind == "video":
                nums = pic_nums[vi:vi + 1]
                name = f"video_{vi}"
                vi += 1
            else:
                nums = snd_nums[ai:ai + 1]
                name = f"audio_{ai}"
                ai += 1
            # fall back to the fixed CP numbers for files without
            # resolvable track metadata
            tnum = nums[0] if nums else (
                TRACKNUM_PICTURE if kind == "video" else TRACKNUM_SOUND)
            frames = tracks.get(tnum, [])
            if not frames and kind == "video":
                frames = tracks.get(TRACKNUM_MPEG, [])
            self._streams[name] = _MxfStream(kind, set_id, d, frames)
        self._loaded = True

    def _stream_for(self, sel: str) -> _MxfStream:
        for name, st in self._streams.items():
            if name.startswith(sel):
                return st
        raise ValueError(f"mxfdemux: no {sel!r} stream")

    # -- single-pad mode ------------------------------------------------------
    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
                caps = self._stream_for(self.props["stream"]).caps()
            except (OSError, ValueError, KeyError):
                return Caps.any()
        else:
            return Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._load()
        self._pos = {}

    def create(self, n_frames: int) -> Optional[Buffer]:
        st = self._stream_for(self.props["stream"])
        pos = self._pos.get("src", 0)
        if pos >= len(st.frames):
            return None
        buf, self._pos["src"] = st.buffer_at(pos, n_frames)
        return buf

    # -- one-parse multi-stream mode ------------------------------------------
    def get_caps_for_pad(self, pad, filter=None):
        self._load()
        caps = self._streams[pad.name].caps()
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def create_multi(self, n_frames: int):
        out = {}
        for pad in self.multi_pads():
            st = self._streams.get(pad.name)
            if st is None:
                continue
            pos = self._pos.get(pad.name, 0)
            if pos >= len(st.frames):
                continue
            buf, self._pos[pad.name] = st.buffer_at(pos, n_frames)
            out[pad.name] = buf
        return out or None
