"""qtmux / qtdemux — ISO base-media (QuickTime .mov/.mp4) container.

Raw-codec family port of gst-plugins-good/gst/isomp4/ (the reference's
atoms.c/gstqtmux.c writer and qtdemux.c reader), scoped like the
avi/matroska modules: uncompressed video, PCM/G.711 audio, and MJPEG
('jpeg' sample entries carrying our native JPEG codec's frames).

Box layout written (gstqtmux.c gst_qt_mux_start_file/_stop_file):
  ftyp('qt  ') | mdat(samples) | moov(mvhd, trak*)
  trak = tkhd, mdia(mdhd, hdlr, minf(vmhd|smhd, dinf(dref url),
         stbl(stsd, stts, stsc, stsz, stco)))
Video track timescale = fps numerator with stts delta = denominator
(sample-exact timing); audio timescale = sample rate.

fourcc mapping follows qtdemux.c:19280-19310 ('2vuy'=UYVY,
'v308'/'v210'/'v216'/'r210' 1:1, 'raw ' depth 24 = RGB) and
:9368-9385 ('sowt'=S16LE, 'twos'=S16BE, 'raw '=U8, 'ulaw'/'alaw' =
audio/x-mulaw|x-alaw), 'jpeg' = image/jpeg.

qtdemux mirrors avidemux's pull-mode collapse: one element demuxes one
stream selected by the `stream` property; the full
stts/stsc/stsz/stco(co64) sample-table walk recovers per-sample
offsets/sizes.

A port of the JAX package's ``elements/isomp4.py``: the box writing and
walking are copies; the muxers copy each tick's planes, samples and blobs
to the host (``host_array``), qtdemux gives host arrays that the pipeline
stages on its device pad by pad.  An 'mp4a' track is decoded on the
host: AAC by ``codecs/aac.py``, MP3 (object type 0x6B) by
``codecs/mp3.py``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..audio import format as afmt
from ..audio.info import AudioInfo
from ..codecs.aac import SAMPLE_RATES
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, MultiStreamSourceElement,
                            PadDirection, PadPresence, PadTemplate,
                            SinkElement, SourceElement, register_element)
from ..core.value import Fraction
from ..video.format import from_bytes, to_bytes
from ..video.info import VideoInfo

VIDEO_FOURCC = {"UYVY": b"2vuy", "v308": b"v308", "v210": b"v210",
                "v216": b"v216", "r210": b"r210", "RGB": b"raw "}
FOURCC_VIDEO = {v: k for k, v in VIDEO_FOURCC.items()}
AUDIO_FOURCC = {"S16LE": b"sowt", "S16BE": b"twos", "U8": b"raw "}
FOURCC_AUDIO = {v: k for k, v in AUDIO_FOURCC.items()}

_MUX_VIDEO_CAPS = ("video/x-raw, format={ UYVY, v308, v210, v216, r210, "
                   "RGB }; image/jpeg; "
                   "video/x-h264, stream-format=byte-stream, "
                   "alignment=au; "
                   "video/x-h265, stream-format=byte-stream, "
                   "alignment=au; video/x-av1")
_MUX_AUDIO_CAPS = ("audio/x-raw, format={ S16LE, S16BE, U8 }, "
                   "layout=interleaved; audio/x-mulaw; audio/x-alaw; "
                   "audio/mpeg, mpegversion=4, stream-format=raw")


def _make_asc(rate: int, channels: int) -> bytes:
    """AudioSpecificConfig for AAC-LC (ISO 14496-3 §1.6.2.1)."""
    sfi = SAMPLE_RATES.index(rate)
    v = (2 << 11) | (sfi << 7) | (channels << 3)
    return bytes([v >> 8, v & 0xFF])


def _make_esds(rate: int, channels: int) -> bytes:
    """esds box with ES/DecoderConfig/DecoderSpecificInfo descriptors
    (ISO 14496-1 §7.2.6; objectType 0x40 = AAC)."""
    asc = _make_asc(rate, channels)
    dsi = bytes([0x05, len(asc)]) + asc
    dcd = bytes([0x04, 13 + len(dsi), 0x40, 0x15, 0, 0, 0,
                 0, 2, 0, 0, 0, 2, 0, 0]) + dsi
    sl = bytes([0x06, 1, 2])
    es = bytes([0x03, 3 + len(dcd) + len(sl), 0, 0, 0]) + dcd + sl
    return _full(b"esds", 0, 0, es)


def _box(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + tag + payload


def _full(tag: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(tag, struct.pack(">B3s", version,
                                 flags.to_bytes(3, "big")) + payload)


def _matrix() -> bytes:
    """Identity transformation matrix (16.16 / 2.30 fixed)."""
    return struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                       0x40000000)


class _Track:
    def __init__(self, kind: str):
        self.kind = kind            # "video" | "audio" | "jpeg"
        self.vinfo: Optional[VideoInfo] = None
        self.ainfo: Optional[AudioInfo] = None
        self.coded_audio: Optional[str] = None    # "ulaw"/"alaw"
        self.samples: List[bytes] = []            # video/jpeg frames
        self.audio_blob: List[bytes] = []
        self.audio_frames = 0
        self.jpeg_wh = (0, 0)
        self.sps = self.pps = self.vps = None


@register_element
class QtMux(AggregatorElement):
    FACTORY = "qtmux"
    DESCRIPTION = "Multiplex audio and video into a QuickTime file"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("video_%u", PadDirection.SINK, _MUX_VIDEO_CAPS,
                    presence=PadPresence.REQUEST),
        PadTemplate("audio_%u", PadDirection.SINK, _MUX_AUDIO_CAPS,
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, "video/quicktime"),
    ]
    PROPERTIES = {
        "location": (str, "out.mov", "output path"),
        "moov-recovery-file": (str, "", "write a recovery journal "
                               "and the mdat incrementally so "
                               "qtmoovrecover can rebuild the moov "
                               "after a crash"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._tracks: Dict[str, _Track] = {}
        self._journal_caps: Dict[str, str] = {}
        self._rec_file = None
        self._rec_journal = None
        self._rec_offsets: Dict[str, List[int]] = {}
        self._rec_sizes: Dict[str, List[int]] = {}

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed):
        self._tracks = {}
        self._journal_caps = {
            pad: str(caps.fixate()) for pad, caps in in_caps.items()}
        for pad_name, caps in in_caps.items():
            s = caps.fixate()[0]
            if pad_name.startswith("video"):
                if s.name == "video/x-av1":
                    t = _Track("av1")
                    t.vinfo = VideoInfo(
                        format="I420",
                        width=s.get("width") or 0,
                        height=s.get("height") or 0,
                        fps=s.get("framerate") or Fraction(30, 1))
                    t.jpeg_wh = (s.get("width") or 0,
                                 s.get("height") or 0)
                elif s.name in ("video/x-h264", "video/x-h265"):
                    t = _Track("h264" if s.name == "video/x-h264"
                               else "h265")
                    t.vinfo = VideoInfo(
                        format="I420",
                        width=s.get("width") or 0,
                        height=s.get("height") or 0,
                        fps=s.get("framerate") or Fraction(30, 1))
                    t.jpeg_wh = (s.get("width") or 0,
                                 s.get("height") or 0)
                    t.sps = t.pps = t.vps = None
                elif s.name == "image/jpeg":
                    t = _Track("jpeg")
                    t.vinfo = VideoInfo(
                        format="I420",
                        width=s.get("width") or 0,
                        height=s.get("height") or 0,
                        fps=s.get("framerate") or Fraction(30, 1))
                    # remember real dims from caps
                    t.jpeg_wh = (s.get("width") or 0,
                                 s.get("height") or 0)
                else:
                    t = _Track("video")
                    t.vinfo = VideoInfo.from_caps_structure(s)
            else:
                t = _Track("audio")
                if s.name == "audio/x-mulaw":
                    t.coded_audio = "ulaw"
                    t.ainfo = AudioInfo(format="U8", rate=s["rate"],
                                        channels=s["channels"])
                elif s.name == "audio/x-alaw":
                    t.coded_audio = "alaw"
                    t.ainfo = AudioInfo(format="U8", rate=s["rate"],
                                        channels=s["channels"])
                elif s.name == "audio/mpeg":
                    t = _Track("aac")
                    t.ainfo = AudioInfo(format="S16LE",
                                        rate=s["rate"],
                                        channels=s["channels"])
                else:
                    t.ainfo = AudioInfo.from_caps_structure(s)
            self._tracks[pad_name] = t
        return Caps.from_string("video/quicktime")

    def start(self):
        for t in self._tracks.values():
            t.samples = []
            t.audio_blob = []
            t.audio_frames = 0
        self._rec_file = self._rec_journal = None
        self._rec_offsets, self._rec_sizes = {}, {}
        rec = self.props.get("moov-recovery-file", "")
        if rec:
            import json

            ftyp = _box(b"ftyp", b"qt  " + struct.pack(">I", 0x200)
                        + b"qt  ")
            self._rec_file = open(self.props["location"], "wb")
            self._rec_file.write(ftyp)
            # 16-byte mdat header: size=1 + 64-bit largesize
            # placeholder (patched in stop; qtmoovrecover ignores it)
            self._rec_file.write(struct.pack(">I", 1) + b"mdat"
                                 + struct.pack(">Q", 0))
            self._rec_file.flush()
            self._rec_base = len(ftyp) + 16
            self._rec_journal = open(rec, "w")
            self._rec_journal.write(json.dumps(
                {"tracks": self._journal_caps,
                 "mdat_base": self._rec_base}) + "\n")
            self._rec_journal.flush()

    def _rec_sample(self, pad_name: str, data: bytes,
                    frames: int = 0) -> None:
        """Recovery mode: append the sample to the open mdat and
        journal its location."""
        import json

        off = self._rec_file.tell()
        self._rec_file.write(data)
        self._rec_file.flush()
        self._rec_offsets.setdefault(pad_name, []).append(off)
        self._rec_sizes.setdefault(pad_name, []).append(len(data))
        rec = {"pad": pad_name, "off": off, "size": len(data)}
        if frames:
            rec["frames"] = frames
        self._rec_journal.write(json.dumps(rec) + "\n")
        self._rec_journal.flush()

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        for pad_name, buf in ins.items():
            t = self._tracks[pad_name]
            if t.kind == "video":
                raw = to_bytes(t.vinfo.finfo,
                               tuple(host_array(p) for p in buf.data),
                               t.vinfo.width, t.vinfo.height)
                raw = raw.reshape(buf.batch, -1)
                for k in range(buf.batch):
                    t.samples.append(raw[k].tobytes())
            elif t.kind == "jpeg":
                blobs = buf.data if isinstance(buf.data, list) \
                    else [buf.data]
                for b in blobs:
                    t.samples.append(
                        b if isinstance(b, (bytes, bytearray))
                        else host_array(b).tobytes())
            elif t.kind == "av1":
                blobs = buf.data if isinstance(buf.data, list) \
                    else [buf.data]
                from .container_elements import _av1_seq_obu
                for b in blobs:
                    raw = (bytes(b)
                           if isinstance(b, (bytes, bytearray))
                           else host_array(b).tobytes())
                    if t.sps is None:
                        seq = _av1_seq_obu(raw)
                        if seq:
                            t.sps = seq
                    t.samples.append(raw)
            elif t.kind in ("h264", "h265"):
                if isinstance(buf.data, list):
                    blobs = buf.data
                else:
                    arr = host_array(buf.data)
                    blobs = ([arr[k] for k in range(arr.shape[0])]
                             if arr.ndim == 2
                             and buf.batch == arr.shape[0]
                             else [arr])
                for b in blobs:
                    raw = (bytes(b)
                           if isinstance(b, (bytes, bytearray))
                           else host_array(b).tobytes())
                    t.samples.append(
                        self._annexb_to_avcc(t, raw)
                        if t.kind == "h264"
                        else self._annexb_to_hvcc(t, raw))
            elif t.kind == "aac":
                blobs = buf.data if isinstance(buf.data, list) \
                    else [buf.data]
                for b in blobs:
                    t.samples.append(
                        bytes(b) if isinstance(b, (bytes, bytearray))
                        else host_array(b).tobytes())
                    t.audio_frames += 1024
            else:
                x = host_array(buf.data)
                if t.coded_audio is not None:
                    t.audio_blob.append(
                        x.astype(np.uint8).tobytes())
                else:
                    t.audio_blob.append(
                        afmt.to_bytes(t.ainfo.finfo, x).tobytes())
                t.audio_frames += x.shape[0]
        if self._rec_file is not None:
            for pad_name in ins:
                t = self._tracks[pad_name]
                done = len(self._rec_offsets.get(pad_name, []))
                if t.kind == "audio":
                    for blob in t.audio_blob[done:]:
                        self._rec_sample(pad_name, blob,
                                         frames=t.audio_frames)
                else:
                    for s in t.samples[done:]:
                        self._rec_sample(pad_name, s)
        first = next(iter(ins.values()))
        return first.with_(data=np.zeros(1, np.uint8))

    # -- moov writer -------------------------------------------------------
    def _stsd_video(self, t: _Track, fourcc: bytes) -> bytes:
        vi = t.vinfo
        w, h = (t.jpeg_wh
                if t.kind in ("jpeg", "h264", "h265", "av1")
                and t.jpeg_wh[0]
                else (vi.width, vi.height))
        depth = 24
        entry = (b"\0" * 6 + struct.pack(">H", 1)      # data ref index
                 + struct.pack(">HH4sIIHH", 0, 0, b"\0\0\0\0", 0, 0,
                               w, h)
                 + struct.pack(">IIIHB", 0x00480000, 0x00480000, 0, 1,
                               0)
                 + b"\0" * 31                           # compressor name
                 + struct.pack(">Hh", depth, -1))
        if t.kind == "h264" and t.sps:
            avcc = (bytes([1, t.sps[1], t.sps[2], t.sps[3], 0xFF])
                    + bytes([0xE1]) + struct.pack(">H", len(t.sps))
                    + t.sps)
            if t.pps:
                avcc += (bytes([1]) + struct.pack(">H", len(t.pps))
                         + t.pps)
            else:
                avcc += bytes([0])
            entry += _box(b"avcC", avcc)
        elif t.kind == "h265" and t.sps:
            from .container_elements import _make_hvcc
            entry += _box(b"hvcC",
                          _make_hvcc(t.vps or b"", t.sps,
                                     t.pps or b""))
        elif t.kind == "av1":
            entry += _box(b"av1C", bytes([0x81, 0, 0, 0])
                          + (t.sps or b""))
        return _full(b"stsd", 0, 0, struct.pack(">I", 1)
                     + _box(fourcc, entry))

    @staticmethod
    def _split_nals(raw: bytes):
        out = []
        pos = 0
        while True:
            i = raw.find(b"\x00\x00\x01", pos)
            if i < 0:
                break
            start = i + 3
            j = raw.find(b"\x00\x00\x01", start)
            end = j - (1 if j > 0 and raw[j - 1] == 0 else 0) \
                if j >= 0 else len(raw)
            out.append(raw[start:end])
            pos = start
        return out

    def _annexb_to_avcc(self, t: _Track, raw: bytes) -> bytes:
        """AnnexB AU -> 4-byte length-prefixed sample; harvests
        SPS/PPS into the avcC config (parameter sets are not repeated
        in samples, matching gstqtmux)."""
        sample = bytearray()
        for nal in self._split_nals(raw):
            if not nal:
                continue
            ntype = nal[0] & 0x1F
            if ntype == 7:
                t.sps = nal
                continue
            if ntype == 8:
                t.pps = nal
                continue
            sample += struct.pack(">I", len(nal)) + nal
        return bytes(sample)

    def _annexb_to_hvcc(self, t: _Track, raw: bytes) -> bytes:
        """AnnexB HEVC AU -> length-prefixed sample; harvests
        VPS/SPS/PPS for the hvcC config."""
        sample = bytearray()
        for nal in self._split_nals(raw):
            if not nal:
                continue
            ntype = (nal[0] >> 1) & 0x3F
            if ntype == 32:
                t.vps = nal
                continue
            if ntype == 33:
                t.sps = nal
                continue
            if ntype == 34:
                t.pps = nal
                continue
            sample += struct.pack(">I", len(nal)) + nal
        return bytes(sample)

    def _stsd_audio(self, t: _Track) -> bytes:
        ai = t.ainfo
        if t.kind == "aac":
            entry = (b"\0" * 6 + struct.pack(">H", 1)
                     + struct.pack(">HH4sHHHHI", 0, 0, b"\0\0\0\0",
                                   ai.channels, 16, 0, 0,
                                   ai.rate << 16)
                     + _make_esds(ai.rate, ai.channels))
            return _full(b"stsd", 0, 0, struct.pack(">I", 1)
                         + _box(b"mp4a", entry))
        if t.coded_audio:
            fourcc = t.coded_audio.encode()
            bits = 8
        else:
            fourcc = AUDIO_FOURCC[ai.format]
            bits = 8 if ai.format == "U8" else 16
        entry = (b"\0" * 6 + struct.pack(">H", 1)
                 + struct.pack(">HH4sHHHHI", 0, 0, b"\0\0\0\0",
                               ai.channels, bits, 0, 0,
                               ai.rate << 16))
        return _full(b"stsd", 0, 0, struct.pack(">I", 1)
                     + _box(fourcc, entry))

    def _stbl(self, t: _Track, offsets: List[int],
              sizes: List[int]) -> bytes:
        if t.kind == "aac":
            n = len(t.samples)
            stts = _full(b"stts", 0, 0,
                         struct.pack(">III", 1, n, 1024))
            stsc = _full(b"stsc", 0, 0,
                         struct.pack(">IIII", 1, 1, 1, 1))
            stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n)
                         + b"".join(struct.pack(">I", x)
                                    for x in sizes))
            stco = _full(b"stco", 0, 0,
                         struct.pack(">I", len(offsets))
                         + b"".join(struct.pack(">I", o)
                                    for o in offsets))
            return _box(b"stbl", self._stsd_audio(t) + stts + stsc
                        + stsz + stco)
        if t.kind in ("video", "jpeg", "h264", "h265", "av1"):
            fps = t.vinfo.fps
            n = len(t.samples)
            stts = _full(b"stts", 0, 0,
                         struct.pack(">III", 1, n, fps.denom))
            stsc = _full(b"stsc", 0, 0,
                         struct.pack(">IIII", 1, 1, 1, 1))
            if len(set(sizes)) == 1:
                stsz = _full(b"stsz", 0, 0,
                             struct.pack(">II", sizes[0], n))
            else:
                stsz = _full(b"stsz", 0, 0,
                             struct.pack(">II", 0, n)
                             + b"".join(struct.pack(">I", s)
                                        for s in sizes))
            stco = _full(b"stco", 0, 0,
                         struct.pack(">I", len(offsets))
                         + b"".join(struct.pack(">I", o)
                                    for o in offsets))
            if t.kind == "h264":
                fourcc = b"avc1"
            elif t.kind == "h265":
                fourcc = b"hvc1"
            elif t.kind == "av1":
                fourcc = b"av01"
            elif t.kind == "jpeg":
                fourcc = b"jpeg"
            else:
                fourcc = VIDEO_FOURCC[t.vinfo.format]
            stsd = self._stsd_video(t, fourcc)
        else:
            bpf = sizes[0]
            n = t.audio_frames
            stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
            stsc = _full(b"stsc", 0, 0,
                         struct.pack(">IIII", 1, 1, n, 1))
            stsz = _full(b"stsz", 0, 0, struct.pack(">II", bpf, n))
            stco = _full(b"stco", 0, 0,
                         struct.pack(">II", 1, offsets[0]))
            stsd = self._stsd_audio(t)
        return _box(b"stbl", stsd + stts + stsc + stsz + stco)

    def _trak(self, t: _Track, tid: int, offsets: List[int],
              sizes: List[int], movie_dur: int) -> bytes:
        if t.kind in ("video", "jpeg", "h264", "h265", "av1"):
            fps = t.vinfo.fps
            timescale = fps.num
            dur = len(t.samples) * fps.denom
            w, h = (t.jpeg_wh
                    if t.kind in ("jpeg", "h264", "h265", "av1")
                    and t.jpeg_wh[0]
                    else (t.vinfo.width, t.vinfo.height))
            tkhd = _full(b"tkhd", 0, 3, struct.pack(
                ">IIII", 0, 0, tid, 0)
                + struct.pack(">IQHHHH", dur * 600 // timescale, 0,
                              0, 0, 0, 0)
                + _matrix()
                + struct.pack(">II", w << 16, h << 16))
            hdlr = _full(b"hdlr", 0, 0,
                         b"mhlr" + b"vide" + b"\0" * 12 + b"\0")
            mhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
        else:
            timescale = t.ainfo.rate
            dur = t.audio_frames
            tkhd = _full(b"tkhd", 0, 3, struct.pack(
                ">IIII", 0, 0, tid, 0)
                + struct.pack(">IQHHHH", dur * 600 // timescale, 0,
                              0, 0, 0x0100, 0)
                + _matrix()
                + struct.pack(">II", 0, 0))
            hdlr = _full(b"hdlr", 0, 0,
                         b"mhlr" + b"soun" + b"\0" * 12 + b"\0")
            mhd = _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, timescale, dur, 0x55C4, 0))
        dref = _full(b"dref", 0, 0, struct.pack(">I", 1)
                     + _full(b"url ", 0, 1, b""))
        dinf = _box(b"dinf", dref)
        minf = _box(b"minf", mhd + dinf
                    + self._stbl(t, offsets, sizes))
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        return _box(b"trak", tkhd + mdia)

    def stop(self):
        if self._rec_file is not None:
            # clean completion: close the incremental copy and write
            # the standard layout below (the journal + partial file
            # only matter when the process dies mid-record)
            self._rec_file.close()
            self._rec_journal.close()
            self._rec_file = self._rec_journal = None
        if not self._tracks:
            return
        ftyp = _box(b"ftyp", b"qt  " + struct.pack(">I", 0x200)
                    + b"qt  ")
        # mdat layout: per-track runs; video sample-per-chunk, audio
        # one contiguous chunk
        mdat_payload = b""
        offsets: Dict[str, List[int]] = {}
        sizes: Dict[str, List[int]] = {}
        base = len(ftyp) + 8
        for pad_name in sorted(self._tracks):
            t = self._tracks[pad_name]
            offs, szs = [], []
            if t.kind in ("video", "jpeg", "h264", "h265", "av1", "aac"):
                for s in t.samples:
                    offs.append(base + len(mdat_payload))
                    szs.append(len(s))
                    mdat_payload += s
            else:
                blob = b"".join(t.audio_blob)
                offs.append(base + len(mdat_payload))
                bpf = (len(blob) // t.audio_frames
                       if t.audio_frames else 1)
                szs.append(bpf)
                mdat_payload += blob
            offsets[pad_name] = offs
            sizes[pad_name] = szs
        mdat = _box(b"mdat", mdat_payload)
        movie_dur = 0
        traks = b""
        for tid, pad_name in enumerate(sorted(self._tracks), start=1):
            t = self._tracks[pad_name]
            if t.kind in ("video", "jpeg", "h264", "h265",
                          "av1"):
                fps = t.vinfo.fps
                movie_dur = max(movie_dur,
                                len(t.samples) * 600 * fps.denom
                                // max(fps.num, 1))
            else:
                movie_dur = max(movie_dur, t.audio_frames * 600
                                // t.ainfo.rate)
            traks += self._trak(t, tid, offsets[pad_name],
                                sizes[pad_name], movie_dur)
        mvhd = _full(b"mvhd", 0, 0, struct.pack(
            ">IIII", 0, 0, 600, movie_dur)
            + struct.pack(">IH", 0x00010000, 0x0100) + b"\0" * 10
            + _matrix() + b"\0" * 24
            + struct.pack(">I", len(self._tracks) + 1))
        moov = _box(b"moov", mvhd + traks)
        with open(self.props["location"], "wb") as f:
            f.write(ftyp + mdat + moov)


# ---------------------------------------------------------------------------
# Demux
# ---------------------------------------------------------------------------

def _walk_boxes(data: bytes, pos: int, end: int):
    while pos + 8 <= end:
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        yield tag, pos + hdr, pos + size
        pos += max(size, 8)


def _find(data, pos, end, *path):
    for tag, a, b in _walk_boxes(data, pos, end):
        if tag == path[0]:
            if len(path) == 1:
                return a, b
            return _find(data, a, b, *path[1:])
    return None


def _parse_sample_table(data, stbl_a, stbl_b):
    """Full stts/stsc/stsz/stco walk -> (fourcc, entry_bytes,
    [(offset, size)], stts_entries)."""
    r = _find(data, stbl_a, stbl_b, b"stsd")
    a, b = r
    n_entries = struct.unpack(">I", data[a + 4:a + 8])[0]
    entry_pos = a + 8
    esize = struct.unpack(">I", data[entry_pos:entry_pos + 4])[0]
    fourcc = data[entry_pos + 4:entry_pos + 8]
    entry = data[entry_pos + 8:entry_pos + esize]

    a, b = _find(data, stbl_a, stbl_b, b"stsz")
    fixed, count = struct.unpack(">II", data[a + 4:a + 12])
    if fixed:
        sizes = [fixed] * count
    else:
        sizes = list(struct.unpack(f">{count}I",
                                   data[a + 12:a + 12 + 4 * count]))

    co = _find(data, stbl_a, stbl_b, b"stco")
    if co is not None:
        a, b = co
        n = struct.unpack(">I", data[a + 4:a + 8])[0]
        chunk_offs = list(struct.unpack(f">{n}I",
                                        data[a + 8:a + 8 + 4 * n]))
    else:
        a, b = _find(data, stbl_a, stbl_b, b"co64")
        n = struct.unpack(">I", data[a + 4:a + 8])[0]
        chunk_offs = list(struct.unpack(f">{n}Q",
                                        data[a + 8:a + 8 + 8 * n]))

    a, b = _find(data, stbl_a, stbl_b, b"stsc")
    n = struct.unpack(">I", data[a + 4:a + 8])[0]
    stsc = [struct.unpack(">III", data[a + 8 + i * 12:a + 20 + i * 12])
            for i in range(n)]

    a, b = _find(data, stbl_a, stbl_b, b"stts")
    n = struct.unpack(">I", data[a + 4:a + 8])[0]
    stts = [struct.unpack(">II", data[a + 8 + i * 8:a + 16 + i * 8])
            for i in range(n)]

    # expand chunk map -> per-sample (offset, size)
    samples: List[Tuple[int, int]] = []
    si = 0
    for ci, coff in enumerate(chunk_offs):
        per = 1
        for first, spc, _ in stsc:
            if ci + 1 >= first:
                per = spc
        off = coff
        for _ in range(per):
            if si >= len(sizes):
                break
            samples.append((off, sizes[si]))
            off += sizes[si]
            si += 1
    return fourcc, entry, samples, stts


def _parse_esds(ext: bytes) -> Tuple[int, bytes]:
    """Extension boxes of an 'mp4a' entry -> (objectTypeIndication,
    DecoderSpecificInfo bytes) from the esds ES_Descriptor
    (ISO 14496-1 §7.2.6; qtdemux.c gst_qtdemux_handle_esds)."""
    pos = 0
    while pos + 8 <= len(ext):
        bsize = struct.unpack(">I", ext[pos:pos + 4])[0]
        if ext[pos + 4:pos + 8] == b"esds":
            body = ext[pos + 12:pos + max(bsize, 8)]  # skip ver/flags

            def rdlen(p):
                n = 0
                while p < len(body):
                    b = body[p]
                    p += 1
                    n = (n << 7) | (b & 0x7F)
                    if not b & 0x80:
                        break
                return n, p

            p = 0
            otype = 0
            dsi = b""
            while p < len(body):
                tag = body[p]
                ln, p = rdlen(p + 1)
                if tag == 0x03:              # ES_Descriptor: descend
                    flags = body[p + 2]
                    p += 3
                    if flags & 0x80:
                        p += 2               # dependsOn_ES_ID
                    if flags & 0x40:
                        p += 1 + body[p]     # URL string
                    if flags & 0x20:
                        p += 2               # OCR_ES_ID
                elif tag == 0x04:            # DecoderConfigDescriptor
                    otype = body[p]
                    p += 13                  # fixed part, then descend
                elif tag == 0x05:            # DecoderSpecificInfo
                    dsi = body[p:p + ln]
                    p += ln
                else:
                    p += ln
            return otype, dsi
        pos += max(bsize, 8)
    raise ValueError("qtdemux: mp4a entry without esds")


def _parse_trex(data, moov_a, moov_b):
    """mvex/trex defaults -> {track_id: (dur, size)}."""
    out = {}
    mvex = _find(data, moov_a, moov_b, b"mvex")
    if mvex is None:
        return out
    for tag, a, b in _walk_boxes(data, *mvex):
        if tag == b"trex" and b - a >= 24:
            tid, _sdi, ddur, dsize, _dfl = struct.unpack(
                ">IIIII", data[a + 4:a + 24])
            out[tid] = (ddur, dsize)
    return out


def _parse_fragments(data, trex):
    """movie-fragment walk (ISO 14496-12 §8.8; qtdemux.c
    gst_qtdemux_parse_moof): moof/traf/tfhd+tfdt+trun -> per-track
    (offset, size) sample lists, default durations, and fragment
    base decode times (tfdt §8.8.12)."""
    frag_samples = {}
    frag_durs = {}
    frag_tfdts = {}          # tid -> [(sample_index, base_time)]
    for tag, a, b in _walk_boxes(data, 0, len(data)):
        if tag != b"moof":
            continue
        moof_start = a - 8
        for ttag, ta, tb in _walk_boxes(data, a, b):
            if ttag != b"traf":
                continue
            tid = None
            base = moof_start
            cursor = None    # running end-offset within this traf
            d_dur = d_size = None
            for ftag, fa, fb in _walk_boxes(data, ta, tb):
                if ftag == b"tfhd":
                    flags = int.from_bytes(data[fa + 1:fa + 4],
                                           "big")
                    tid = struct.unpack(">I",
                                        data[fa + 4:fa + 8])[0]
                    p = fa + 8
                    if flags & 0x1:          # base-data-offset
                        base = struct.unpack(">Q",
                                             data[p:p + 8])[0]
                        p += 8
                    if flags & 0x2:          # sample-desc index
                        p += 4
                    if flags & 0x8:
                        d_dur = struct.unpack(">I",
                                              data[p:p + 4])[0]
                        p += 4
                    if flags & 0x10:
                        d_size = struct.unpack(">I",
                                               data[p:p + 4])[0]
                        p += 4
                elif ftag == b"tfdt" and tid is not None:
                    bt = (struct.unpack(">Q", data[fa + 4:fa + 12])[0]
                          if data[fa] == 1 else
                          struct.unpack(">I", data[fa + 4:fa + 8])[0])
                    frag_tfdts.setdefault(tid, []).append(
                        (len(frag_samples.get(tid, [])), bt))
                elif ftag == b"trun" and tid is not None:
                    ver = data[fa]
                    flags = int.from_bytes(data[fa + 1:fa + 4],
                                           "big")
                    count = struct.unpack(">I",
                                          data[fa + 4:fa + 8])[0]
                    p = fa + 8
                    # §8.8.8: a trun without data-offset continues
                    # where the previous run in the same traf ended
                    off = base if cursor is None else cursor
                    if flags & 0x1:
                        off = base + struct.unpack(
                            ">i", data[p:p + 4])[0]
                        p += 4
                    if flags & 0x4:          # first-sample-flags
                        p += 4
                    tdef = trex.get(tid, (0, 0))
                    dur_default = (d_dur if d_dur is not None
                                   else tdef[0])
                    size_default = (d_size if d_size is not None
                                    else tdef[1])
                    for _ in range(count):
                        dur = dur_default
                        size = size_default
                        if flags & 0x100:
                            dur = struct.unpack(
                                ">I", data[p:p + 4])[0]
                            p += 4
                        if flags & 0x200:
                            size = struct.unpack(
                                ">I", data[p:p + 4])[0]
                            p += 4
                        if flags & 0x400:
                            p += 4
                        if flags & 0x800:
                            p += 4
                        frag_samples.setdefault(tid, []).append(
                            (off, size))
                        frag_durs.setdefault(tid, []).append(dur)
                        off += size
                    cursor = off
    return frag_samples, frag_durs, frag_tfdts


def _parse_qt(path: str):
    """-> list of track dicts (fragmented movies have their moof/trun
    runs appended to the sample lists)."""
    with open(path, "rb") as f:
        data = f.read()
    moov = _find(data, 0, len(data), b"moov")
    if moov is None:
        raise ValueError("qtdemux: no moov box")
    trex = _parse_trex(data, *moov)
    frag_samples, frag_durs, frag_tfdts = (
        _parse_fragments(data, trex)
        if trex or _find(data, 0, len(data), b"moof")
        else ({}, {}, {}))
    tracks = []
    tid = 0
    for tag, a, b in _walk_boxes(data, *moov):
        if tag != b"trak":
            continue
        tk = _find(data, a, b, b"tkhd")
        track_id = (struct.unpack(">I", data[tk[0] + 12:tk[0] + 16])[0]
                    if tk else tid + 1)
        mdia = _find(data, a, b, b"mdia")
        mh = _find(data, *mdia, b"mdhd")
        timescale, duration = struct.unpack(
            ">II", data[mh[0] + 12:mh[0] + 20])
        hd = _find(data, *mdia, b"hdlr")
        handler = data[hd[0] + 8:hd[0] + 12]
        stbl = _find(data, *mdia, b"minf", b"stbl")
        fourcc, entry, samples, stts = _parse_sample_table(
            data, *stbl)
        frag_base_times = []
        if track_id in frag_samples:
            n_static = len(samples)
            samples = samples + frag_samples[track_id]
            durs = frag_durs[track_id]
            tfdts = frag_tfdts.get(track_id, [])
            # tfdt anchors fragment decode time; when per-sample
            # durations are absent (no trex default, no trun
            # durations), derive them from consecutive tfdt deltas
            if tfdts and durs and not any(durs):
                for (i0, t0), (i1, t1) in zip(tfdts, tfdts[1:]):
                    if i1 > i0 and t1 > t0:
                        per = (t1 - t0) // (i1 - i0)
                        for k in range(i0, i1):
                            durs[k] = per
                if len(tfdts) >= 2 and durs:
                    tail = [d for d in durs if d]
                    fill = tail[-1] if tail else 1
                    for k in range(tfdts[-1][0], len(durs)):
                        durs[k] = durs[k] or fill
            frag_base_times = [(n_static + i, t) for i, t in tfdts]
            if not stts and durs:
                stts = [(len(durs), durs[0] or 1)]
            duration = duration or sum(durs)
            if tfdts and durs:
                # authoritative total: last anchor + its samples
                last_i, last_t = tfdts[-1]
                duration = max(duration,
                               last_t + sum(durs[last_i:]))
        tracks.append({
            "handler": handler, "fourcc": fourcc, "entry": entry,
            "samples": samples, "stts": stts,
            "timescale": timescale, "duration": duration,
            "frag_base_times": frag_base_times,
        })
        tid += 1
    return tracks, data


@register_element
class QtDemux(MultiStreamSourceElement):
    """qtdemux.

    Single-stream mode (`stream=` on the plain src pad) or one-parse
    multi-stream: linking `demux.video_0` / `demux.audio_0`
    sometimes-pads exposes a pad per track from a SINGLE file read +
    moov parse — qtdemux.c's pad-per-track behavior."""
    FACTORY = "qtdemux"
    DESCRIPTION = "Demultiplex a QuickTime file into audio and video"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, Caps.any()),
        PadTemplate("video_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.SOMETIMES),
        PadTemplate("audio_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.SOMETIMES),
    ]
    PROPERTIES = {
        "location": (str, "", "mov/mp4 file path"),
        "stream": (str, "video", "video | audio | stream index"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._loaded = False
        self._pos = 0
        self._children = None

    # -- one-parse multi-stream mode --------------------------------------
    def _ensure_children(self) -> None:
        """Per-pad track readers over ONE shared moov parse
        (incremental: pads linked later reuse the parse)."""
        if self._children is None:
            self._children = {}
        missing = [p for p in self.multi_pads()
                   if p.name not in self._children]
        if not missing:
            return
        parsed = getattr(self, "_parsed_shared", None)
        if parsed is None:
            parsed = _parse_qt(self.props["location"])
            self._parsed_shared = parsed
        tracks = parsed[0]
        by_kind = {"video": [], "audio": []}
        for idx, t in enumerate(tracks):
            if t["handler"] == b"vide":
                by_kind["video"].append(idx)
            elif t["handler"] == b"soun":
                by_kind["audio"].append(idx)
        for pad in missing:
            kind, _, n = pad.name.rpartition("_")
            group = by_kind.get(kind, [])
            if int(n) >= len(group):
                raise ValueError(
                    f"qtdemux: no {kind} track {n} in "
                    f"{self.props['location']!r}")
            child = QtDemux(name=f"{self.name}.{pad.name}",
                            location=self.props["location"],
                            stream=str(group[int(n)]))
            child._preparsed = parsed
            child._load()
            self._children[pad.name] = child

    def get_caps_for_pad(self, pad, filter=None):
        self._ensure_children()
        return self._children[pad.name].get_caps(filter)

    def create_multi(self, n_frames: int):
        self._ensure_children()
        out = {}
        for pname, child in self._children.items():
            buf = child.create(n_frames)
            if buf is not None:
                out[pname] = buf
        return out or None

    def preview_blob_for_pad(self, pad_name: str):
        self._ensure_children()
        return self._children[pad_name].preview_blob()

    def _load(self):
        if self._loaded:
            return
        pre = getattr(self, "_preparsed", None)
        tracks, data = (pre if pre is not None
                        else _parse_qt(self.props["location"]))
        sel = self.props["stream"]
        want = None
        for idx, t in enumerate(tracks):
            if sel == str(idx) or \
               (sel == "video" and t["handler"] == b"vide") or \
               (sel == "audio" and t["handler"] == b"soun"):
                want = idx
                break
        if want is None:
            raise ValueError(f"qtdemux: no stream {sel!r}")
        t = tracks[want]
        self._track = t
        self._data = data
        fourcc = t["fourcc"]
        entry = t["entry"]
        if t["handler"] == b"vide":
            w, h = struct.unpack(">HH", entry[24:28])
            count, delta = t["stts"][0]
            fps = Fraction(t["timescale"], max(delta, 1))
            if fourcc == b"avc1":
                self._mode = "h264"
                self._sps = self._pps = b""
                # extension boxes follow the 70-byte entry remainder
                ext = entry[70:]
                pos2 = 0
                while pos2 + 8 <= len(ext):
                    bsize = struct.unpack(">I", ext[pos2:pos2 + 4])[0]
                    if ext[pos2 + 4:pos2 + 8] == b"avcC":
                        cfg = ext[pos2 + 8:pos2 + bsize]
                        nsps_len = struct.unpack(
                            ">H", cfg[6:8])[0]
                        self._sps = cfg[8:8 + nsps_len]
                        off2 = 8 + nsps_len
                        n_pps = cfg[off2] if off2 < len(cfg) else 0
                        if n_pps:
                            npps_len = struct.unpack(
                                ">H", cfg[off2 + 1:off2 + 3])[0]
                            self._pps = cfg[off2 + 3:
                                            off2 + 3 + npps_len]
                    pos2 += max(bsize, 8)
                self._caps = Caps.from_string(
                    f"video/x-h264, stream-format=byte-stream, "
                    f"alignment=au, width={w}, height={h}, "
                    f"framerate={fps.num}/{fps.denom}")
            elif fourcc == b"av01":
                self._mode = "av1"
                self._caps = Caps.from_string(
                    f"video/x-av1, width={w}, height={h}, "
                    f"framerate={fps.num}/{fps.denom}")
            elif fourcc in (b"hvc1", b"hev1"):
                self._mode = "h265"
                self._sps = self._pps = b""
                params = b""
                ext = entry[70:]
                pos2 = 0
                while pos2 + 8 <= len(ext):
                    bsize = struct.unpack(">I", ext[pos2:pos2 + 4])[0]
                    if ext[pos2 + 4:pos2 + 8] == b"hvcC":
                        from .container_elements import _parse_hvcc
                        nals = _parse_hvcc(ext[pos2 + 8:pos2 + bsize])
                        params = b"".join(b"\x00\x00\x00\x01" + n
                                          for n in nals)
                    pos2 += max(bsize, 8)
                self._sps = params       # pre-joined Annex-B params
                self._caps = Caps.from_string(
                    f"video/x-h265, stream-format=byte-stream, "
                    f"alignment=au, width={w}, height={h}, "
                    f"framerate={fps.num}/{fps.denom}")
            elif fourcc == b"jpeg":
                self._mode = "jpeg"
                self._caps = Caps.from_string(
                    f"image/jpeg, width={w}, height={h}, "
                    f"framerate={fps.num}/{fps.denom}")
            else:
                fmt = FOURCC_VIDEO.get(fourcc)
                if fmt is None:
                    raise ValueError(
                        f"qtdemux: unsupported video {fourcc!r}")
                self._mode = "video"
                self._info = VideoInfo(format=fmt, width=w, height=h,
                                       fps=fps)
                self._caps = Caps([self._info.to_caps_structure()])
        else:
            channels, bits = struct.unpack(">HH", entry[16:20])
            rate = struct.unpack(">I", entry[24:28])[0] >> 16
            if fourcc == b"mp4a":
                self._load_mp4a(t, entry)
            elif fourcc in (b"ulaw", b"alaw"):
                self._mode = fourcc.decode()
                self._channels = channels
                self._rate = rate
                mt = ("audio/x-mulaw" if fourcc == b"ulaw"
                      else "audio/x-alaw")
                self._caps = Caps.from_string(
                    f"{mt}, rate={rate}, channels={channels}")
            else:
                fmt = FOURCC_AUDIO.get(fourcc)
                if fmt is None:
                    raise ValueError(
                        f"qtdemux: unsupported audio {fourcc!r}")
                if fmt == "raw " or bits == 8:
                    fmt = "U8" if fourcc == b"raw " else fmt
                self._mode = "audio"
                self._info = AudioInfo(format=fmt, rate=rate,
                                       channels=channels)
                self._caps = Caps([self._info.to_caps_structure()])
        self._loaded = True

    def _load_mp4a(self, t: dict, entry: bytes) -> None:
        """'mp4a' sample entry: esds -> DecoderConfigDescriptor
        (qtdemux.c esds handling).  objectType 0x40/0x66-0x68 = AAC
        (decoded by the clean-room codecs/aac.py), 0x6B = MP3."""
        otype, dsi = _parse_esds(entry[28:])
        payloads = [self._data[o:o + s] for o, s in t["samples"]]
        if otype in (0x40, 0x66, 0x67, 0x68):
            from ..codecs import aac as paac
            if not dsi:
                raise ValueError("qtdemux: mp4a AAC without ASC")
            pcm, rate, ch = paac.decode_raw(dsi, payloads)
        elif otype == 0x6B:
            from ..codecs import mp3 as pmp3
            pcm, rate, ch = pmp3.decode(b"".join(payloads))
        else:
            raise ValueError(
                f"qtdemux: mp4a object type {otype:#x} unsupported")
        self._mode = "decoded"
        self._adata = np.asarray(pcm, np.float32)
        self._info = AudioInfo(format="F32LE", rate=rate, channels=ch)
        self._caps = Caps([self._info.to_caps_structure()])

    def preview_blob(self) -> Optional[bytes]:
        """First sample bytes (jpegdec caps-peek hook)."""
        try:
            self._load()
        except (OSError, ValueError):
            return None
        off, size = self._track["samples"][0]
        return self._data[off:off + size]

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        caps = self._caps if self._loaded else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        if self.is_multi():
            self._ensure_children()
            for c in self._children.values():
                c.start()
            return
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        samples = self._track["samples"]
        if self._pos >= len(samples):
            return None
        if self._mode == "video":
            info = self._info
            take = samples[self._pos:self._pos + max(1, n_frames)]
            raws = np.stack([np.frombuffer(
                self._data[o:o + s], np.uint8) for o, s in take])
            planes = from_bytes(info.finfo, raws, info.width,
                                info.height)
            fps = info.fps
            pts = self._pos * 1_000_000_000 * fps.denom // fps.num
            dur = 1_000_000_000 * fps.denom // fps.num
            self._pos += len(take)
            return Buffer(data=planes, pts=pts, duration=dur,
                          batch=len(take))
        if self._mode in ("jpeg", "av1"):
            take = samples[self._pos:self._pos + max(1, n_frames)]
            blobs = [self._data[o:o + s] for o, s in take]
            self._pos += len(take)
            return Buffer(data=blobs, batch=len(take),
                          meta={"caps": self._caps})
        if self._mode in ("h264", "h265"):
            take = samples[self._pos:self._pos + max(1, n_frames)]
            blobs = []
            for o, sz in take:
                raw = self._data[o:o + sz]
                au = bytearray()
                if self._pos == 0 and not blobs and self._sps:
                    if self._mode == "h265":
                        au += self._sps      # pre-joined params
                    else:
                        au += b"\x00\x00\x00\x01" + self._sps
                        au += b"\x00\x00\x00\x01" + self._pps
                p2 = 0
                while p2 + 4 <= len(raw):
                    ln = struct.unpack(">I", raw[p2:p2 + 4])[0]
                    au += b"\x00\x00\x00\x01" \
                        + raw[p2 + 4:p2 + 4 + ln]
                    p2 += 4 + ln
                blobs.append(np.frombuffer(bytes(au), np.uint8))
            self._pos += len(take)
            return Buffer(data=blobs, batch=len(take))
        if self._mode == "decoded":
            arr = self._adata
            self._pos = len(samples)
            return Buffer(data=arr, batch=1,
                          duration=arr.shape[0] * 1_000_000_000
                          // self._info.rate)
        # audio: one buffer with everything (contiguous chunk run)
        blob = b"".join(self._data[o:o + s] for o, s in samples)
        self._pos = len(samples)
        if self._mode in ("ulaw", "alaw"):
            arr = np.frombuffer(blob, np.uint8).reshape(
                -1, self._channels)
            return Buffer(data=arr, batch=1,
                          duration=len(arr) * 1_000_000_000
                          // self._rate)
        info = self._info
        raw = np.frombuffer(blob, np.uint8)
        arr = afmt.from_bytes(info.finfo, raw, info.channels)
        if arr.dtype.byteorder == ">":      # device arrays are native
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return Buffer(data=arr, batch=1,
                      duration=arr.shape[0] * 1_000_000_000
                      // info.rate)


@register_element
class CmafMux(AggregatorElement):
    """cmafmux / fmp4mux: fragmented-MP4 (CMAF) writer — init segment
    (ftyp + moov with mvex/trex, empty sample tables) followed by one
    moof+mdat pair per aggregate tick.

    Reference behavior: the fmp4mux element family
    (gst-plugins-rs fmp4; structurally ISO 14496-12 §8.8 like
    qtmux's fragmented modes).  Video: H.264 byte-stream input
    (avcC from harvested parameter sets, length-prefixed samples);
    audio: raw AAC AUs (esds).
    """
    FACTORY = "cmafmux"
    DESCRIPTION = "Fragmented MP4/CMAF muxer"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("video_%u", PadDirection.SINK,
                    "video/x-h264, stream-format=byte-stream, "
                    "alignment=au",
                    presence=PadPresence.REQUEST),
        PadTemplate("audio_%u", PadDirection.SINK,
                    "audio/mpeg, mpegversion=4, stream-format=raw",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, "video/quicktime"),
    ]
    PROPERTIES = {"location": (str, "out.cmaf.mp4", "output path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._file = None
        self._tracks: Dict[str, dict] = {}
        self._seq = 1

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed):
        self._tracks = {}
        tid = 1
        for pad_name in sorted(in_caps):
            s = in_caps[pad_name].fixate()[0]
            if pad_name.startswith("video") \
                    or s.name.startswith(("video", "image")):
                fps = s.get("framerate") or Fraction(30, 1)
                self._tracks[pad_name] = {
                    "id": tid, "kind": "video",
                    "w": s.get("width") or 0,
                    "h": s.get("height") or 0,
                    "timescale": fps.num, "delta": fps.denom,
                    "cfg": {},
                }
            else:
                self._tracks[pad_name] = {
                    "id": tid, "kind": "audio",
                    "rate": s["rate"], "ch": s["channels"],
                    "timescale": s["rate"], "delta": 1024,
                }
            tid += 1
        return Caps.from_string("video/quicktime, variant=cmaf")

    def start(self):
        self._file = open(self.props["location"], "wb")
        self._seq = 1
        self._header_done = False
        self._init_file = None          # separate init-segment target

    def _write_init(self):
        traks = b""
        trexs = b""
        for pad_name in sorted(self._tracks):
            t = self._tracks[pad_name]
            if t["kind"] == "video":
                from .container_elements import _make_avcc
                entry = (b"\0" * 6 + struct.pack(">H", 1)
                         + struct.pack(">HH4sIIHH", 0, 0,
                                       b"\0\0\0\0", 0, 0,
                                       t["w"], t["h"])
                         + struct.pack(">IIIHB", 0x00480000,
                                       0x00480000, 0, 1, 0)
                         + b"\0" * 31 + struct.pack(">Hh", 24, -1)
                         + _box(b"avcC",
                                _make_avcc(t["cfg"]["sps"],
                                           t["cfg"].get("pps"))))
                stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1)
                             + _box(b"avc1", entry))
                hdlr = _full(b"hdlr", 0, 0,
                             b"\0" * 4 + b"vide" + b"\0" * 13)
            else:
                entry = (b"\0" * 6 + struct.pack(">H", 1)
                         + struct.pack(">HH4sHHHHI", 0, 0,
                                       b"\0\0\0\0", t["ch"], 16,
                                       0, 0, t["rate"] << 16)
                         + _make_esds(t["rate"], t["ch"]))
                stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1)
                             + _box(b"mp4a", entry))
                hdlr = _full(b"hdlr", 0, 0,
                             b"\0" * 4 + b"soun" + b"\0" * 13)
            stbl = _box(
                b"stbl", stsd
                + _full(b"stts", 0, 0, struct.pack(">I", 0))
                + _full(b"stsc", 0, 0, struct.pack(">I", 0))
                + _full(b"stsz", 0, 0, struct.pack(">II", 0, 0))
                + _full(b"stco", 0, 0, struct.pack(">I", 0)))
            mdhd = _full(b"mdhd", 0, 0, struct.pack(
                ">IIIIHH", 0, 0, t["timescale"], 0, 0x55C4, 0))
            mdia = _box(b"mdia", mdhd + hdlr + _box(b"minf", stbl))
            wh = ((t["w"] << 16, t["h"] << 16)
                  if t["kind"] == "video" else (0, 0))
            tkhd = _full(b"tkhd", 0, 3,
                         struct.pack(">IIII", 0, 0, t["id"], 0)
                         + b"\0" * 12 + b"\0" * 36
                         + struct.pack(">II", *wh))
            traks += _box(b"trak", tkhd + mdia)
            trexs += _full(b"trex", 0, 0, struct.pack(
                ">IIIII", t["id"], 1, t["delta"], 0, 0))
        mvhd = _full(b"mvhd", 0, 0,
                     struct.pack(">IIII", 0, 0, 600, 0) + b"\0" * 80)
        moov = _box(b"moov", mvhd + traks + _box(b"mvex", trexs))
        ftyp = _box(b"ftyp", b"cmfc" + struct.pack(">I", 0)
                    + b"iso6cmfc")
        target = self._init_file or self._file
        target.write(ftyp + moov)
        if self._init_file is not None:
            self._init_file.close()
            self._init_file = None
        self._header_done = True

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        from .container_elements import (_annexb_to_lenpref,
                                         _harvest_params)
        from .container_elements import _video_blobs
        per_track = {}
        for pad_name in sorted(ins):
            t = self._tracks[pad_name]
            buf = ins[pad_name]
            blobs = _video_blobs(buf)
            if t["kind"] == "video":
                if not self._header_done:
                    for b in blobs:
                        _harvest_params(b, t["cfg"])
                blobs = [x for x in
                         (_annexb_to_lenpref(b) for b in blobs) if x]
            per_track[pad_name] = blobs
        if not self._header_done:
            self._write_init()
        trafs = b""
        mdat = bytearray()
        pending = []                     # (trun offset fixups)
        for pad_name in sorted(per_track):
            t = self._tracks[pad_name]
            group = per_track[pad_name]
            if not group:
                continue
            tfhd = _full(b"tfhd", 0, 0x20000,
                         struct.pack(">I", t["id"]))
            # tfdt (ISO 14496-12 §8.8.12, required by CMAF): the
            # track's accumulated decode time anchors each fragment
            # for seeking/live-edge alignment (isomp4 atoms.c writes
            # one per traf).  Version 1 = 64-bit baseMediaDecodeTime.
            tfdt = _full(b"tfdt", 1, 0,
                         struct.pack(">Q", t.setdefault(
                             "decode_time", 0)))
            t["decode_time"] += len(group) * t["delta"]
            flags = 0x1 | 0x200
            trun = _box(b"trun", struct.pack(
                ">B3s", 0, flags.to_bytes(3, "big"))
                + struct.pack(">I", len(group))
                + struct.pack(">i", 0)
                + b"".join(struct.pack(">I", len(x))
                           for x in group))
            pending.append((len(trafs), len(tfhd) + len(tfdt),
                            len(mdat)))
            trafs += _box(b"traf", tfhd + tfdt + trun)
            for x in group:
                mdat += x
        if not trafs:
            first = next(iter(ins.values()))
            return first.with_(data=np.zeros(1, np.uint8))
        mfhd = _full(b"mfhd", 0, 0, struct.pack(">I", self._seq))
        self._seq += 1
        moof = bytearray(_box(b"moof", mfhd + trafs))
        # fix trun data offsets: moof size + mdat header + payload pos
        base = len(moof) + 8
        traf_region = 8 + len(mfhd)
        for traf_start, tfhd_len, payload_off in pending:
            # moof hdr(8) + mfhd + prior trafs + traf hdr(8) + tfhd
            # + trun hdr(8) + ver/flags(4) + count(4) -> data_offset
            p = traf_region + traf_start + 8 + tfhd_len + 16
            struct.pack_into(">i", moof, p, base + payload_off)
        self._file.write(bytes(moof) + _box(b"mdat", bytes(mdat)))
        first = next(iter(ins.values()))
        return first.with_(data=np.zeros(1, np.uint8))

    def stop(self):
        if self._file is not None:
            if not self._header_done:
                for t in self._tracks.values():
                    t.setdefault("cfg", {}).setdefault("sps", b"\0")
                self._write_init()
            self._file.close()
            self._file = None


@register_element
class Fmp4Mux(CmafMux):
    FACTORY = "fmp4mux"
    DESCRIPTION = "Fragmented MP4 muxer"


def recover_qt_file(broken: str, journal: str, fixed: str) -> int:
    """Rebuild a playable file from a crashed qtmux recording:
    read the journal (caps + per-sample mdat locations), pull the
    sample bytes out of the broken file, and write a fresh complete
    file through the normal muxer. Returns the sample count."""
    import json

    with open(journal) as jf:
        lines = jf.read().splitlines()
    head = json.loads(lines[0])
    with open(broken, "rb") as bf:
        data = bf.read()

    mux = QtMux(name="_recover", location=fixed)
    in_caps = {pad: Caps.from_string(c)
               for pad, c in head["tracks"].items()}
    mux.negotiate_output(in_caps, Caps.any())
    for t in mux._tracks.values():
        t.samples, t.audio_blob, t.audio_frames = [], [], 0
    n = 0
    for line in lines[1:]:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue                    # torn tail write mid-crash
        off, size = rec["off"], rec["size"]
        if off + size > len(data):
            continue                    # sample truncated by the crash
        t = mux._tracks.get(rec["pad"])
        if t is None:
            continue
        blob = data[off:off + size]
        if t.kind == "audio":
            t.audio_blob.append(blob)
            t.audio_frames = rec.get("frames", t.audio_frames)
        else:
            t.samples.append(blob)
        n += 1
    mux.stop()
    return n


@register_element
class QtMoovRecover(SinkElement):
    """qtmoovrecover (gst-plugins-good/gst/isomp4/gstqtmoovrecover.c):
    rebuilds a playable file from a crashed qtmux recording using the
    moov-recovery-file journal.  Like the reference this is not a
    streaming element — set the three path properties and run it; it
    performs the recovery at start and posts an element message
    (qtmoovrecover-done / error on the bus)."""
    FACTORY = "qtmoovrecover"
    DESCRIPTION = "Recovers unfinished qtmux files"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "broken-input": (str, "", "path to the broken (crashed) "
                                  "recording"),
        "recovery-input": (str, "", "path to the moov recovery "
                                    "journal"),
        "fixed-output": (str, "", "path for the recovered file"),
        "fast-start-mode": (bool, False, "accepted for API parity"),
    }

    def start(self):
        root = self
        while getattr(root, "parent", None) is not None:
            root = root.parent
        from ..core.pipeline import Message

        try:
            n = recover_qt_file(self.props["broken-input"],
                                self.props["recovery-input"],
                                self.props["fixed-output"])
        except (OSError, ValueError, KeyError) as e:
            if hasattr(root, "bus"):
                root.bus.post(Message("error", self.name,
                                      {"reason": str(e)}))
            return
        if hasattr(root, "bus"):
            root.bus.post(Message("element", self.name, {
                "name": "qtmoovrecover-done", "samples": n,
                "location": self.props["fixed-output"]}))
