"""videoparsers — h264parse / mpegvideoparse.

Reduced-scope ports of gst-plugins-bad/gst/videoparsers/ for
byte-stream inputs:
* h264parse (gsth264parse.c): Annex-B start-code scan, access-unit
  framing (a new AU starts at an AUD or at the first VCL NAL whose
  first_mb_in_slice == 0), SPS parsing (profile/level, exp-Golomb
  width/height with frame cropping and emulation-prevention removal)
  feeding the output caps: video/x-h264, stream-format=byte-stream,
  alignment=au, width/height/profile.
* mpegvideoparse (gstmpegvideoparse.c): MPEG-1/2 video elementary
  streams — frames delimited at sequence/GOP/picture start codes,
  sequence header (0x000001B3) width/height/fps parsing.
* ivfparse (gst-plugins-bad/gst/ivfparse/gstivfparse.c): the 32-byte
  DKIF header (fourcc VP80/VP90/AV01 -> video/x-vp8|vp9|av1 caps with
  width/height/framerate, :250-300), 12-byte LE frame headers with
  pts scaled by fps (:300-380), and VP8 keyframe resolution updates
  from the 10-byte uncompressed chunk (:347-356).

A copy of the JAX package's ``elements/videoparsers.py`` on the port's
``core/baseparse.py``; the parsers take a source's host bytes
(``HOST_INPUT``, as ``audioparsers._ParserBase``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import struct

import numpy as np

from ..core.baseparse import BaseParse
from ..core.buffer import host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate,
                            TransformElement, register_element)
from .audioparsers import _ParserBase


class _BitR:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def bit(self) -> int:
        b = (self.d[self.p >> 3] >> (7 - (self.p & 7))) & 1
        self.p += 1
        return b

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def ue(self) -> int:
        zeros = 0
        while self.bit() == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("h264: bad exp-golomb")
        return (1 << zeros) - 1 + (self.bits(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def _rbsp(data: bytes) -> bytes:
    """Remove emulation-prevention 0x03 bytes."""
    out = bytearray()
    i = 0
    while i < len(data):
        if i + 2 < len(data) and data[i] == 0 and data[i + 1] == 0 \
                and data[i + 2] == 3:
            out += b"\0\0"
            i += 3
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


_PROFILES = {66: "baseline", 77: "main", 88: "extended", 100: "high",
             110: "high-10", 122: "high-4:2:2", 244: "high-4:4:4"}


def parse_sps(nal: bytes) -> dict:
    """SPS -> {profile, level, width, height} (ITU-T H.264 7.3.2.1)."""
    r = _BitR(_rbsp(nal[1:]))
    profile_idc = r.bits(8)
    r.bits(8)                        # constraint flags + reserved
    level_idc = r.bits(8)
    r.ue()                           # seq_parameter_set_id
    chroma_format_idc = 1
    if profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        chroma_format_idc = r.ue()
        if chroma_format_idc == 3:
            r.bit()                  # separate_colour_plane
        r.ue()                       # bit_depth_luma_minus8
        r.ue()                       # bit_depth_chroma_minus8
        r.bit()                      # qpprime
        if r.bit():                  # seq_scaling_matrix_present
            for i in range(8 if chroma_format_idc != 3 else 12):
                if r.bit():
                    # scaling list
                    size = 16 if i < 6 else 64
                    last, nxt = 8, 8
                    for _ in range(size):
                        if nxt != 0:
                            nxt = (last + r.se() + 256) % 256
                        last = nxt if nxt else last
    r.ue()                           # log2_max_frame_num_minus4
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()
    elif poc_type == 1:
        r.bit()
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()                           # max_num_ref_frames
    r.bit()                          # gaps_in_frame_num
    pic_width_mbs = r.ue() + 1
    pic_height_units = r.ue() + 1
    frame_mbs_only = r.bit()
    if not frame_mbs_only:
        r.bit()                      # mb_adaptive
    r.bit()                          # direct_8x8
    crop_l = crop_r = crop_t = crop_b = 0
    if r.bit():                      # frame_cropping
        crop_l = r.ue()
        crop_r = r.ue()
        crop_t = r.ue()
        crop_b = r.ue()
    width = pic_width_mbs * 16
    height = pic_height_units * 16 * (2 - frame_mbs_only)
    # crop units for 4:2:0: x2 horizontally, x2 (x4 interlaced) vert.
    sub_x = 2 if chroma_format_idc in (1, 2) else 1
    sub_y = 2 if chroma_format_idc == 1 else 1
    width -= (crop_l + crop_r) * sub_x
    height -= (crop_t + crop_b) * sub_y * (2 - frame_mbs_only)
    return {"profile": _PROFILES.get(profile_idc, str(profile_idc)),
            "level": level_idc, "width": width, "height": height}


def _nal_positions(data: bytes) -> List[int]:
    """Offsets of start codes (at the 00 00 01)."""
    out = []
    pos = 0
    while True:
        i = data.find(b"\x00\x00\x01", pos)
        if i < 0:
            return out
        out.append(i)
        pos = i + 3


@register_element
class H264Parse(_ParserBase):
    FACTORY = "h264parse"
    DESCRIPTION = "Parses H.264 streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-h264, stream-format=byte-stream, "
                    "alignment=au"),
    ]
    _SRC_CAPS = ("video/x-h264, stream-format=byte-stream, "
                 "alignment=au")

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(5)
        self.sps: Optional[dict] = None

    def start(self):
        super().start()
        self.sps = None

    def _is_au_start(self, data: bytes, off: int) -> bool:
        """NAL at `off` begins a new access unit (7.4.1.2.3: the
        first AUD/SPS/PPS/SEI after the previous AU's last VCL NAL,
        or a VCL NAL with first_mb_in_slice == 0)."""
        p = off + 3
        if p >= len(data):
            return False
        ntype = data[p] & 0x1F
        if ntype in (6, 7, 8, 9):             # SEI/SPS/PPS/AUD
            return True
        if ntype in (1, 5):                   # VCL slice
            try:
                r = _BitR(_rbsp(data[p + 1:p + 5]))
                return r.ue() == 0            # first_mb_in_slice
            except (IndexError, ValueError):
                return False
        return False

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        nals = _nal_positions(raw)
        if not nals:
            return 0, max(0, len(raw) - 2)
        if nals[0] > (1 if raw[0] == 0 else 0):
            # garbage before the first start code (keep a leading
            # zero: 4-byte start codes carry one)
            lead = nals[0] - (1 if raw[nals[0] - 1] == 0 else 0)
            if lead > 0:
                return 0, lead
        # find AU boundaries: the first VCL NAL belongs to this AU;
        # the AU ends before the next AU-starting NAL
        saw_vcl = False
        for k, off in enumerate(nals):
            p = off + 3
            if p >= len(raw):
                break
            ntype = raw[p] & 0x1F
            if ntype == 7:
                try:
                    end = nals[k + 1] if k + 1 < len(nals) else len(raw)
                    self.sps = parse_sps(raw[p:end])
                except (IndexError, ValueError):
                    pass
            if saw_vcl and self._is_au_start(raw, off):
                end = off - (1 if raw[off - 1] == 0 else 0)
                return end, 0
            if ntype in (1, 5):
                saw_vcl = True
        if self.draining and saw_vcl:
            return len(raw), 0
        return 0, 0

    def pre_push_frame(self, buf):
        if self.sps:
            from ..core.structure import Structure
            s = Structure("video/x-h264", {
                "stream-format": "byte-stream", "alignment": "au",
                "width": self.sps["width"],
                "height": self.sps["height"],
                "profile": self.sps["profile"]})
            buf = buf.with_(meta=dict(buf.meta or {}, caps=Caps([s])))
        return buf


@register_element
class MpegVideoParse(_ParserBase):
    FACTORY = "mpegvideoparse"
    DESCRIPTION = "Parses and frames MPEG-1 and MPEG-2 elementary " \
                  "video streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/mpeg, mpegversion=[1,2], "
                    "systemstream=false, parsed=true"),
    ]
    _SRC_CAPS = ("video/mpeg, mpegversion=[1,2], systemstream=false, "
                 "parsed=true")

    _FPS = {1: (24000, 1001), 2: (24, 1), 3: (25, 1), 4: (30000, 1001),
            5: (30, 1), 6: (50, 1), 7: (60000, 1001), 8: (60, 1)}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(8)
        self.info: Optional[dict] = None

    def start(self):
        super().start()
        self.info = None

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        # frames are delimited at picture start codes (0x00) with
        # any preceding sequence/GOP headers attached
        starts = []
        pos = 0
        while True:
            i = raw.find(b"\x00\x00\x01", pos)
            if i < 0 or i + 3 >= len(raw):
                break
            starts.append((i, raw[i + 3]))
            pos = i + 3
        if not starts:
            return 0, max(0, len(raw) - 2)
        if starts[0][0] > 0:
            return 0, starts[0][0]
        for off, code in starts:
            if code == 0xB3 and off + 8 <= len(raw):
                w = (raw[off + 4] << 4) | (raw[off + 5] >> 4)
                h = ((raw[off + 5] & 0x0F) << 8) | raw[off + 6]
                fps = self._FPS.get(raw[off + 7] & 0x0F)
                self.info = {"width": w, "height": h, "fps": fps}
                if fps:
                    self.set_frame_rate(*fps)
        # one frame = up to (and excluding) the NEXT picture or
        # sequence start after the first picture code
        saw_pic = False
        for off, code in starts:
            if saw_pic and code in (0x00, 0xB3, 0xB8):
                return off, 0
            if code == 0x00:
                saw_pic = True
        if self.draining and saw_pic:
            return len(raw), 0
        return 0, 0


@register_element
class IvfParse(_ParserBase):
    FACTORY = "ivfparse"
    DESCRIPTION = "IVF parser"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-ivf"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-vp8; video/x-vp9; video/x-av1"),
    ]
    _SRC_CAPS = "video/x-vp8"

    _MEDIA = {b"VP80": "video/x-vp8", b"VP90": "video/x-vp9",
              b"AV01": "video/x-av1"}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(32)
        self.hdr = None

    def start(self):
        super().start()
        self.hdr = None

    def handle_frame(self, view):
        import struct as _s
        raw = bytes(view)
        if self.hdr is None:
            if len(raw) < 32:
                return 0, 0
            magic, version, hsize = raw[0:4], *_s.unpack("<HH", raw[4:8])
            fourcc = raw[8:12]
            if magic != b"DKIF" or version != 0 or hsize != 32 \
                    or fourcc not in self._MEDIA:
                raise ValueError("ivfparse: not an IVF stream")
            w, h = _s.unpack("<HH", raw[12:16])
            fps_n, fps_d = _s.unpack("<II", raw[16:24])
            self.hdr = {"media": self._MEDIA[fourcc], "width": w,
                        "height": h, "fps_n": fps_n, "fps_d": fps_d,
                        "fourcc": fourcc}
            if fps_n and fps_d:
                self.set_frame_rate(fps_n, fps_d)
            self.set_min_frame_size(12)      # IVF_FRAME_HEADER_SIZE
            return 0, 32                     # skip the file header
        if len(raw) < 12:
            return 0, 0
        fsize, = _s.unpack("<I", raw[0:4])
        if len(raw) < 12 + fsize:
            return 0, 0
        # VP8 keyframe resolution update (gstivfparse.c:347-356)
        if self.hdr["fourcc"] == b"VP80" and fsize >= 10:
            tag = int.from_bytes(raw[12:15], "little")
            if not (tag & 0x01):
                self.hdr["width"] = _s.unpack("<H", raw[18:20])[0] & 0x3FFF
                self.hdr["height"] = _s.unpack("<H", raw[20:22])[0] & 0x3FFF
        return 12 + fsize, 0

    def take_frame(self, raw: bytes):
        """Strip the 12-byte frame header; pts from the header."""
        import struct as _s
        fsize, fpts = _s.unpack("<IQ", raw[0:12])
        pts = None
        if self.hdr["fps_n"]:
            pts = (1_000_000_000 * fpts * self.hdr["fps_d"]
                   // self.hdr["fps_n"])
        return raw[12:12 + fsize], pts

    def pre_push_frame(self, buf):
        from ..core.structure import Structure as _St
        from ..core.value import Fraction as _Fr
        d = buf.data
        if isinstance(d, np.ndarray) and d.ndim > 1:
            raws = [bytes(row.tobytes()) for row in d]
        elif isinstance(d, (list, tuple)):
            raws = [bytes(host_array(x).tobytes()) for x in d]
        else:
            raws = [bytes(host_array(d).tobytes())]
        payloads = []
        pts0 = None
        for raw in raws:
            payload, pts = self.take_frame(raw)
            payloads.append(np.frombuffer(payload, np.uint8))
            if pts0 is None:
                pts0 = pts
        f = {"width": self.hdr["width"], "height": self.hdr["height"]}
        if self.hdr["fps_n"] and self.hdr["fps_d"]:
            f["framerate"] = _Fr(self.hdr["fps_n"], self.hdr["fps_d"])
        if self.hdr["media"] == "video/x-av1":
            f["alignment"] = "tu"
        caps = Caps([_St(self.hdr["media"], f)])
        data = payloads[0] if len(payloads) == 1 else payloads
        buf = buf.with_(data=data, meta=dict(buf.meta or {}, caps=caps))
        if pts0 is not None:
            buf = buf.with_(pts=pts0)
        return buf


@register_element
class H265Parse(_ParserBase):
    """h265parse (gst-plugins-bad/gst/videoparsers/gsth265parse.c):
    Annex-B NAL walk, AU split on VPS/SPS/PPS/AUD/prefix-SEI or a
    first-slice VCL NAL (first_slice_segment_in_pic_flag)."""
    FACTORY = "h265parse"
    DESCRIPTION = "Parses H.265 streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-h265, stream-format=byte-stream, "
                    "alignment=au"),
    ]
    _SRC_CAPS = ("video/x-h265, stream-format=byte-stream, "
                 "alignment=au")

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(6)

    def _is_au_start(self, data: bytes, off: int) -> bool:
        p = off + 3
        if p + 2 >= len(data):
            return False
        ntype = (data[p] >> 1) & 0x3F
        if ntype in (32, 33, 34, 35, 39):
            return True
        if ntype <= 31:                     # VCL
            # first_slice_segment_in_pic_flag is the MSB after the
            # 2-byte NAL header
            return bool(data[p + 2] & 0x80)
        return False

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        nals = _nal_positions(raw)
        if not nals:
            return 0, max(0, len(raw) - 2)
        if nals[0] > (1 if raw[0] == 0 else 0):
            lead = nals[0] - (1 if raw[nals[0] - 1] == 0 else 0)
            if lead > 0:
                return 0, lead
        saw_vcl = False
        for off in nals:
            p = off + 3
            if p >= len(raw):
                break
            ntype = (raw[p] >> 1) & 0x3F
            if saw_vcl and self._is_au_start(raw, off):
                return off - (1 if raw[off - 1] == 0 else 0), 0
            if ntype <= 31:
                saw_vcl = True
        if self.draining and saw_vcl:
            return len(raw), 0
        return 0, 0


@register_element
class Mpeg4VideoParse(_ParserBase):
    """mpeg4videoparse (gstmpeg4videoparse.c): frames split at VOP
    start codes (0xB6) with preceding VOS/VO/VOL headers attached."""
    FACTORY = "mpeg4videoparse"
    DESCRIPTION = "Parses MPEG-4 Part 2 elementary video streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "video/mpeg, mpegversion=4, systemstream=false, "
                    "parsed=true"),
    ]
    _SRC_CAPS = ("video/mpeg, mpegversion=4, systemstream=false, "
                 "parsed=true")

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(5)

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        starts = []
        pos = 0
        while True:
            i = raw.find(b"\x00\x00\x01", pos)
            if i < 0 or i + 3 >= len(raw):
                break
            starts.append((i, raw[i + 3]))
            pos = i + 3
        if not starts:
            return 0, max(0, len(raw) - 2)
        if starts[0][0] > 0:
            return 0, starts[0][0]
        saw_vop = False
        for off, code in starts:
            if saw_vop:
                return off, 0
            if code == 0xB6:
                saw_vop = True
        if self.draining and saw_vop:
            return len(raw), 0
        return 0, 0


@register_element
class Av1Parse(_ParserBase):
    """av1parse (gstav1parse.c): temporal units split at temporal
    delimiter OBUs (type 2) in the low-overhead stream."""
    FACTORY = "av1parse"
    DESCRIPTION = "Parses AV1 streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, "video/x-av1"),
    ]
    _SRC_CAPS = "video/x-av1"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(2)

    @staticmethod
    def _obu_walk(raw: bytes):
        """-> [(offset, type, end)] for sized OBUs."""
        out = []
        pos = 0
        while pos < len(raw):
            b0 = raw[pos]
            if b0 & 0x80:                   # forbidden bit
                break
            otype = (b0 >> 3) & 0xF
            p = pos + 1 + (1 if b0 & 0x04 else 0)
            if not b0 & 0x02:               # unsized: rest of data
                out.append((pos, otype, len(raw)))
                break
            size = 0
            shift = 0
            ok = False
            while p < len(raw):
                byte = raw[p]
                p += 1
                size |= (byte & 0x7F) << shift
                shift += 7
                if not byte & 0x80:
                    ok = True
                    break
            if not ok:
                break
            out.append((pos, otype, p + size))
            pos = p + size
        return out

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        obus = self._obu_walk(raw)
        if not obus:
            return 0, 1
        saw_payload = False
        for off, otype, end in obus:
            if otype == 2 and saw_payload:
                return off, 0
            if otype != 2:
                saw_payload = True
        if self.draining and saw_payload:
            return obus[-1][2], 0
        return 0, 0


@register_element
class Vp9Parse(TransformElement):
    """vp9parse (gstvp9parse.c): splits VP9 superframes into
    individual frames via the trailing superframe index."""
    FACTORY = "vp9parse"
    DESCRIPTION = "Parses VP9 streams"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-vp9"),
        PadTemplate("src", PadDirection.SRC, "video/x-vp9"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("video/x-vp9")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    @staticmethod
    def split_superframe(raw: bytes):
        if not raw:
            return [raw]
        marker = raw[-1]
        if (marker & 0xE0) != 0xC0:
            return [raw]
        nframes = (marker & 0x7) + 1
        mag = ((marker >> 3) & 0x3) + 1
        index_size = 2 + mag * nframes
        if len(raw) < index_size or raw[-index_size] != marker:
            return [raw]
        sizes = []
        pos = len(raw) - index_size + 1
        for _ in range(nframes):
            sizes.append(int.from_bytes(raw[pos:pos + mag], "little"))
            pos += mag
        frames = []
        off = 0
        for sz in sizes:
            frames.append(raw[off:off + sz])
            off += sz
        return frames if off <= len(raw) - index_size else [raw]

    def host_process(self, buf):
        if buf is None:
            return None
        import numpy as _np
        blobs = buf.data if isinstance(buf.data, list) else [buf.data]
        out = []
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            out.extend(self.split_superframe(raw))
        arrs = [_np.frombuffer(f, _np.uint8) for f in out if f]
        if not arrs:
            return None
        return buf.with_(data=arrs if len(arrs) > 1 else arrs[0],
                         batch=len(arrs))


@register_element
class PngParse(_ParserBase):
    """pngparse (gstpngparse.c): one whole PNG (signature through
    IEND) per frame, dims from IHDR."""
    FACTORY = "pngparse"
    DESCRIPTION = "Parses PNG files"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, "image/png"),
    ]
    _SRC_CAPS = "image/png"

    _SIG = b"\x89PNG\r\n\x1a\n"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(8)

    def handle_frame(self, view) -> Tuple[int, int]:
        raw = bytes(view)
        i = raw.find(self._SIG)
        if i < 0:
            return 0, max(1, len(raw) - 7)
        if i > 0:
            return 0, i
        pos = 8
        while pos + 8 <= len(raw):
            ln = struct.unpack(">I", raw[pos:pos + 4])[0]
            tag = raw[pos + 4:pos + 8]
            pos += 12 + ln
            if tag == b"IEND":
                return min(pos, len(raw)), 0
        return 0, 0
