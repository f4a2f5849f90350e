"""RealMedia demuxers — rmdemux / rademux (clean-room).

Reference: gst-plugins-ugly/gst/realmedia/rmdemux.c (RealMedia .rm
container) and rademux.c (standalone RealAudio .ra files).  The
container is chunked: fourcc + u32 size + u16 version, with PROP
(file properties), MDPR (one per stream: bitrates, mime type and a
type-specific blob — a VIDO struct for video, a complete RealAudio
header for audio), CONT, DATA (packet stream) and INDX chunks.

Video frames are fragmented across data packets with a per-fragment
sub-header (2-bit type: 0 partial / 1 whole-frame-slice / 2 last
partial / 3 sub-frame); reassembled frames are emitted in the slice
layout libavcodec's RealVideo decoders consume: u8 (nb_slices-1),
nb_slices x (u32le 1, u32le offset), payload.  Audio packets pass
through whole (lpcJ/dnet); cook/sipr interleaving is carried in the
caps for downstream deinterleavers.

A copy of the JAX package's ``elements/realmedia.py``: the packets are
host arrays of bytes, staged like any source's unless the pad's peer takes
host bytes; no decoder.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (MultiStreamSourceElement, PadDirection,
                            PadPresence, PadTemplate, SourceElement,
                            register_element)
from ..core.structure import Structure
from ..core.value import Fraction


def _get_num(data: bytes, pos: int) -> Tuple[int, int]:
    """14/30-bit length fields in video fragment sub-headers."""
    n = struct.unpack(">H", data[pos:pos + 2])[0]
    if n >= 0x4000:
        return n - 0x4000, pos + 2
    n1 = struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return (n << 16) | n1, pos + 4


def _parse_ra_header(ts: bytes) -> Dict:
    """Parse a RealAudio header blob (.ra\\xfd v3/v4/v5)."""
    if ts[:4] != b".ra\xfd":
        raise ValueError("realmedia: bad RealAudio header magic")
    version = struct.unpack(">H", ts[4:6])[0]
    out = {"raversion": version, "codec": "", "rate": 8000,
           "channels": 1, "sample_size": 16, "extradata": b"",
           "interleaver": "", "coded_frame_size": 0,
           "sub_packet_h": 0, "frame_size": 0, "sub_packet_size": 0}
    if version == 3:
        # v3: header_size u16, 10 unknown bytes, data size u32,
        # then metadata strings; always 8 kHz mono lpcJ (14.4)
        out.update(codec="lpcJ", rate=8000, channels=1)
        return out
    # v4/v5 share the leading layout
    p = 6
    p += 2                        # unused
    p += 4                        # '.ra4' / '.ra5'
    p += 4                        # data size
    p += 2                        # version2
    p += 4                        # header size
    p += 2                        # flavor
    out["coded_frame_size"] = struct.unpack(">I", ts[p:p + 4])[0]
    p += 4
    p += 12                       # three unknown u32
    out["sub_packet_h"] = struct.unpack(">H", ts[p:p + 2])[0]
    p += 2
    out["frame_size"] = struct.unpack(">H", ts[p:p + 2])[0]
    p += 2
    out["sub_packet_size"] = struct.unpack(">H", ts[p:p + 2])[0]
    p += 2
    p += 2                        # unknown
    if version == 5:
        p += 6
    out["rate"] = struct.unpack(">H", ts[p:p + 2])[0]
    p += 4                        # rate + unknown
    out["sample_size"] = struct.unpack(">H", ts[p:p + 2])[0]
    p += 2
    out["channels"] = struct.unpack(">H", ts[p:p + 2])[0]
    p += 2
    if version == 4:
        n = ts[p]
        out["interleaver"] = ts[p + 1:p + 1 + n].decode(
            "ascii", "replace")
        p += 1 + n
        n = ts[p]
        out["codec"] = ts[p + 1:p + 1 + n].decode("ascii", "replace")
        p += 1 + n
    else:
        out["interleaver"] = ts[p:p + 4].decode("ascii", "replace")
        out["codec"] = ts[p + 4:p + 8].decode("ascii", "replace")
        p += 8
    p += 3                        # unknown u8 x3
    if version == 5:
        p += 1
    if p + 4 <= len(ts):          # cook/atrc carry extradata
        elen = struct.unpack(">I", ts[p:p + 4])[0]
        out["extradata"] = ts[p + 4:p + 4 + elen]
    return out


def _parse_rm(path: str):
    """Walk the chunk structure -> (streams dict, packets list)."""
    data = open(path, "rb").read()
    if data[:4] != b".RMF":
        raise ValueError("rmdemux: not a RealMedia file")
    streams: Dict[int, Dict] = {}
    packets: List[Tuple[int, int, int, bytes]] = []
    pos = 0
    while pos + 10 <= len(data):
        fcc = data[pos:pos + 4]
        size = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        if size < 10:
            break
        body = data[pos + 10:pos + size]
        if fcc == b"MDPR":
            (snum,) = struct.unpack(">H", body[:2])
            p = 30
            nl = body[p]
            p += 1 + nl
            ml = body[p]
            mime = body[p + 1:p + 1 + ml].decode("ascii", "replace")
            p += 1 + ml
            (tl,) = struct.unpack(">I", body[p:p + 4])
            ts = body[p + 4:p + 4 + tl]
            info = {"mime": mime, "type_specific": ts}
            if mime == "video/x-pn-realvideo" and len(ts) >= 26:
                info["fourcc"] = ts[8:12].decode("ascii", "replace")
                info["width"], info["height"] = struct.unpack(
                    ">HH", ts[12:16])
                fps = struct.unpack(">H", ts[22:24])[0] or 25
                info["fps"] = fps
                info["extradata"] = ts[26:]
            elif mime == "audio/x-pn-realaudio":
                info.update(_parse_ra_header(ts))
            streams[snum] = info
        elif fcc == b"DATA":
            (npkts,) = struct.unpack(">I", body[:4])
            p = 8
            for _ in range(npkts):
                if p + 12 > len(body):
                    break
                ver, ln, snum, ts_ms = struct.unpack(
                    ">HHHI", body[p:p + 10])
                hdr = 12 if ver == 0 else 13
                payload = body[p + hdr:p + ln]
                flags = body[p + 11] if ver == 0 else 0
                packets.append((snum, ts_ms, flags, payload))
                p += ln
        pos += size
    return streams, packets


def _assemble_video(pkts: List[Tuple[int, bytes]]
                    ) -> List[Tuple[int, bytes]]:
    """Reassemble fragmented video frames into the libavcodec slice
    layout (rmdemux.c gst_rmdemux_descramble_* analog)."""
    frames: List[Tuple[int, bytes]] = []
    slices: List[bytes] = []
    cur_pic = None
    expect_len = 0
    got = 0

    def emit(ts):
        if not slices:
            return
        n = len(slices)
        head = bytearray([n - 1])
        off = 0
        for s in slices:
            head += struct.pack("<II", 1, off)
            off += len(s)
        frames.append((ts, bytes(head) + b"".join(slices)))
        slices.clear()

    for ts_ms, payload in pkts:
        p = 0
        while p < len(payload):
            b0 = payload[p]
            typ = b0 >> 6
            p += 1
            if typ != 3:
                p += 1                       # sequence number
            if typ != 1:
                len2, p = _get_num(payload, p)
                pos_in, p = _get_num(payload, p)
                pic = payload[p]
                p += 1
            if typ == 1:                     # whole frame, one slice
                frag = payload[p:]
                p = len(payload)
                frames.append((ts_ms, bytes([0])
                               + struct.pack("<II", 1, 0) + frag))
                continue
            if typ == 3:                     # sub-frame inside packet
                frag = payload[p:p + len2]
                p += len2
                frames.append((pos_in, bytes([0])
                               + struct.pack("<II", 1, 0) + frag))
                continue
            # partial (0) / last partial (2)
            take = len(payload) - p
            if typ == 2:
                take = min(take, pos_in)
            frag = payload[p:p + take]
            p += take
            if cur_pic != pic:
                emit(ts_ms)
                cur_pic = pic
                expect_len = len2
                got = 0
            slices.append(frag)
            got += len(frag)
            if typ == 2 or got >= expect_len:
                emit(ts_ms)
                cur_pic = None
    emit(0)
    return frames


@register_element
class RmDemux(MultiStreamSourceElement):
    """rmdemux: RealMedia container -> compressed per-stream pads
    (video/x-pn-realvideo for avdec_rv10/rv20, audio/x-pn-realaudio
    for avdec_real_144/cook/...)."""
    FACTORY = "rmdemux"
    DESCRIPTION = "Demultiplex a RealMedia file into audio and " \
                  "video streams"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, Caps.any()),
        PadTemplate("video_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.SOMETIMES),
        PadTemplate("audio_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.SOMETIMES),
    ]
    PROPERTIES = {
        "location": (str, "", "rm file path"),
        "stream": (str, "video", "video | audio | stream index"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._parsed = None
        self._emitted: Dict[str, bool] = {}

    def _load(self):
        if self._parsed is None:
            streams, packets = _parse_rm(self.props["location"])
            vids = sorted(n for n, s in streams.items()
                          if s["mime"] == "video/x-pn-realvideo")
            auds = sorted(n for n, s in streams.items()
                          if s["mime"] == "audio/x-pn-realaudio")
            per: Dict[int, List] = {n: [] for n in streams}
            for snum, ts_ms, flags, payload in packets:
                if snum in per:
                    per[snum].append((ts_ms, payload))
            self._parsed = (streams, per, vids, auds)
        return self._parsed

    def _stream_for(self, pad_name: str) -> int:
        streams, per, vids, auds = self._load()
        kind, _, n = pad_name.rpartition("_")
        group = vids if kind == "video" else auds
        if int(n) >= len(group):
            raise ValueError(f"rmdemux: no {kind} stream {n}")
        return group[int(n)]

    def _caps_for_stream(self, snum: int) -> Caps:
        streams = self._load()[0]
        info = streams[snum]
        if info["mime"] == "video/x-pn-realvideo":
            ver = int(info.get("fourcc", "RV20")[2])
            return Caps([Structure("video/x-pn-realvideo", {
                "rmversion": ver,
                "width": info["width"], "height": info["height"],
                "framerate": Fraction(info["fps"], 1)})])
        ra_ver = {"lpcJ": 1, "28_8": 2, "cook": 8,
                  "dnet": 3, "sipr": 4}.get(info.get("codec", ""), 1)
        return Caps([Structure("audio/x-pn-realaudio", {
            "raversion": ra_ver, "rate": info["rate"],
            "channels": info["channels"]})])

    def get_caps_for_pad(self, pad, filter=None):
        caps = self._caps_for_stream(self._stream_for(pad.name))
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def get_caps(self, filter=None):
        if not self.props["location"]:
            return Caps.any()
        try:
            streams, per, vids, auds = self._load()
        except (OSError, ValueError):
            return Caps.any()
        sel = self.props["stream"]
        group = vids if sel == "video" else auds
        if sel not in ("video", "audio"):
            snum = int(sel)
        elif group:
            snum = group[0]
        else:
            return Caps.any()
        caps = self._caps_for_stream(snum)
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._emitted = {}

    def _buffer_for_stream(self, snum: int) -> Optional[Buffer]:
        streams, per, vids, auds = self._load()
        info = streams[snum]
        pkts = per[snum]
        if info["mime"] == "video/x-pn-realvideo":
            frames = _assemble_video(pkts)
            blobs = [np.frombuffer(f, np.uint8) for _, f in frames]
            meta = {"codec_data": info.get("extradata", b""),
                    "width": info["width"], "height": info["height"]}
            return Buffer(data=blobs, batch=len(blobs), pts=0,
                          meta=meta)
        blobs = [np.frombuffer(pl, np.uint8) for _, pl in pkts if pl]
        meta = {"codec_data": info.get("extradata", b""),
                "rate": info["rate"], "channels": info["channels"],
                "block_align": info.get("coded_frame_size", 0)
                or len(blobs[0]) if blobs else 0,
                "ra": {k: info.get(k) for k in
                       ("codec", "interleaver", "sub_packet_h",
                        "frame_size", "sub_packet_size",
                        "coded_frame_size")}}
        return Buffer(data=blobs, batch=len(blobs), pts=0, meta=meta)

    def create(self, n_frames: int) -> Optional[Buffer]:
        sel = self.props["stream"]
        streams, per, vids, auds = self._load()
        if sel not in ("video", "audio"):
            snum = int(sel)
        else:
            group = vids if sel == "video" else auds
            if not group:
                return None
            snum = group[0]
        if self._emitted.get("src"):
            return None
        self._emitted["src"] = True
        return self._buffer_for_stream(snum)

    def create_multi(self, n_frames: int):
        out = {}
        for pad in self.multi_pads():
            if self._emitted.get(pad.name):
                continue
            self._emitted[pad.name] = True
            out[pad.name] = self._buffer_for_stream(
                self._stream_for(pad.name))
        return out or None


@register_element
class RaDemux(SourceElement):
    """rademux: standalone RealAudio (.ra) file parser -> compressed
    audio stream with the same caps convention as rmdemux."""
    FACTORY = "rademux"
    DESCRIPTION = "Demultiplex a RealAudio file"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"location": (str, "", "ra file path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._info = None
        self._data = b""
        self._done = False

    def _load(self):
        if self._info is not None:
            return
        raw = open(self.props["location"], "rb").read()
        info = _parse_ra_header(raw)
        if info["raversion"] == 3:
            hsize = struct.unpack(">H", raw[6:8])[0]
            hdr_len = 8 + hsize
        else:
            # v4/v5: header_size (u32 after version2) counts from
            # offset 16, so data starts at 16 + header_size
            hsize = struct.unpack(">I", raw[18:22])[0]
            hdr_len = 16 + hsize
        if not (0 < hdr_len <= len(raw)):
            raise ValueError("rademux: cannot find data start")
        self._info = info
        self._data = raw[hdr_len:]

    def get_caps(self, filter=None):
        if not self.props["location"]:
            return Caps.any()
        try:
            self._load()
        except (OSError, ValueError):
            return Caps.any()
        info = self._info
        ra_ver = {"lpcJ": 1, "28_8": 2, "cook": 8, "dnet": 3,
                  "sipr": 4}.get(info.get("codec", ""), 1)
        caps = Caps([Structure("audio/x-pn-realaudio", {
            "raversion": ra_ver, "rate": info["rate"],
            "channels": info["channels"]})])
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._done = False

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._done:
            return None
        self._load()
        self._done = True
        info = self._info
        frame = info.get("coded_frame_size") or 20
        blobs = [np.frombuffer(self._data[o:o + frame], np.uint8)
                 for o in range(0, len(self._data) - frame + 1, frame)]
        meta = {"codec_data": info.get("extradata", b""),
                "rate": info["rate"], "channels": info["channels"],
                "block_align": frame}
        return Buffer(data=blobs, batch=max(len(blobs), 1), pts=0,
                      meta=meta)


@register_element
class PnmSrc(SourceElement):
    """pnmsrc (gst-plugins-ugly/gst/realmedia/pnmsrc.c): the legacy
    Progressive Networks Media protocol source.  Exactly like the
    reference, the only thing it does is post a "redirect" element
    message rewriting pnm:// to rtsp:// and end the stream — modern
    RealMedia servers speak RTSP."""
    FACTORY = "pnmsrc"
    DESCRIPTION = "Receive data over the network via PNM"
    PAD_TEMPLATES = [PadTemplate(
        "src", PadDirection.SRC, "application/vnd.rn-realmedia")]
    PROPERTIES = {"location": (str, "", "pnm:// URL")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._done = False
        self.redirect_location = None

    def get_caps(self, filter=None):
        caps = Caps.from_string("application/vnd.rn-realmedia")
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._done = False

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._done:
            return None
        self._done = True
        loc = self.props["location"]
        if not loc.startswith("pnm://"):
            raise ValueError("pnmsrc: location must be a pnm:// URL")
        url = "rtsp" + loc[3:]
        self.redirect_location = url
        pipe = getattr(self, "pipeline", None) or \
            getattr(self, "parent", None)
        bus = getattr(pipe, "bus", None)
        if bus is not None:
            from ..core.pipeline import Message
            bus.post(Message("element", self.name,
                             {"structure": "redirect",
                              "new-location": url}))
        return None                     # immediate EOS
