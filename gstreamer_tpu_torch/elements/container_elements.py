"""Container elements: avimux/avidemux and matroskamux/matroskademux
for raw video + PCM audio.

Reference: subprojects/gst-plugins-good/gst/avi/gstavimux.c (hdrl/strl/
movi/idx1 writing), gstavidemux.c (RIFF walking, stream setup),
gst-plugins-good/gst/matroska/matroska-mux.c (EBML writer, TrackEntry,
SimpleBlock lacing) and matroska-demux.c / ebml-read.c (EBML walking).

TPU-native reduction: the demuxers are source-style elements (location
+ stream-selection properties, like wavparse) so each instance feeds one
branch of the batch graph; the muxers are collapsed aggregator sinks
(request video_%u/audio_%u pads + location) that interleave per tick.
Codec coverage is the raw family the framework processes natively:
fourcc video (I420/YUY2/UYVY), BI_RGB, V_UNCOMPRESSED, and PCM
(A_PCM/INT/LIT / WAVEFORMATEX tag 1) — plus coded tracks: H.264
(AVI fourcc 'H264' with byte-stream payload, gstavimux.c:566;
Matroska V_MPEG4/ISO/AVC with avcC CodecPrivate and length-prefixed
blocks, matroska-mux.c) and MJPEG ('MJPG' / V_MJPEG).

Matroska also carries compressed A/V tracks: A_VORBIS and V_THEORA
(three xiph-laced header packets in CodecPrivate, matroska-mux.c
xiph handling / matroska-demux.c), A_OPUS (OpusHead CodecPrivate)
and A_MPEG/L3 are demuxed through the clean-room decoders in
codecs/; matroskamux gains audio-codec=vorbis / video-codec=theora
encode-at-EOS modes backed by the system libvorbisenc/libtheoraenc
(same architecture as the reference's vorbisenc/theoraenc).

A port of the JAX package's ``elements/container_elements.py``.  The
demuxers give host arrays (``from_bytes`` views of the file's bytes) that
the pipeline stages on its device, one pad at a time; the muxers are host
elements that copy each tick's planes and samples to the host
(``host_array``) to write them.  The raw tracks (V_UNCOMPRESSED, the AVI
fourccs, A_PCM/INT/LIT, WAVE PCM) and the coded passthrough that needs no
codec (H.264 / H.265 / AV1 / MJPEG blobs, AAC access units, Opus packets
under an OpusHead) are ported, and so are the coded tracks of the port's
codecs: Vorbis, Theora, MPEG audio, Opus, AAC and VP8 / VP9 (with the
WebM alpha BlockAdditions) decoded on the host by ``codecs/``
(matroskademux, avidemux's MP3) and matroskamux's Vorbis, Theora and VPx
encode-at-EOS modes.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..audio import format as afmt
from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, MultiStreamSourceElement,
                            PadDirection, PadPresence, PadTemplate,
                            SourceElement, register_element)
from ..core.value import Fraction
from ..video.format import format_info, frame_size, from_bytes, to_bytes
from ..video.info import VideoInfo

VIDEO_FOURCC = {"I420": b"I420", "YUY2": b"YUY2", "UYVY": b"UYVY"}
FOURCC_VIDEO = {v: k for k, v in VIDEO_FOURCC.items()}

_CODED_VIDEO_CAPS = ("; video/x-h264, stream-format=byte-stream, "
                     "alignment=au; image/jpeg")


def _split_annexb(raw: bytes) -> List[bytes]:
    """Annex-B byte stream -> NAL payloads (without start codes)."""
    out = []
    pos = 0
    while True:
        i = raw.find(b"\x00\x00\x01", pos)
        if i < 0:
            break
        j = raw.find(b"\x00\x00\x01", i + 3)
        end = len(raw) if j < 0 else j - (1 if raw[j - 1] == 0 else 0)
        if end > i + 3:
            out.append(raw[i + 3:end])
        pos = i + 3
    return out


def _harvest_params(raw: bytes, cfg: dict) -> None:
    """Collect SPS/PPS NALs from an Annex-B AU into cfg."""
    for nal in _split_annexb(raw):
        ntype = nal[0] & 0x1F
        if ntype == 7:
            cfg["sps"] = nal
        elif ntype == 8:
            cfg["pps"] = nal


def _annexb_to_lenpref(raw: bytes) -> bytes:
    """Annex-B AU -> 4-byte length-prefixed AVC sample (parameter
    sets stripped; they live in the avcC config)."""
    sample = bytearray()
    for nal in _split_annexb(raw):
        if (nal[0] & 0x1F) in (7, 8):
            continue
        sample += struct.pack(">I", len(nal)) + nal
    return bytes(sample)


def _make_avcc(sps: bytes, pps: Optional[bytes]) -> bytes:
    """ISO 14496-15 AVCDecoderConfigurationRecord."""
    out = bytearray([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
    out += struct.pack(">H", len(sps)) + sps
    if pps:
        out += bytes([1]) + struct.pack(">H", len(pps)) + pps
    else:
        out += bytes([0])
    return bytes(out)


def _parse_avcc(blob: bytes) -> Tuple[List[bytes], List[bytes]]:
    sps_list, pps_list = [], []
    pos = 5
    nsps = blob[pos] & 0x1F
    pos += 1
    for _ in range(nsps):
        ln = struct.unpack(">H", blob[pos:pos + 2])[0]
        sps_list.append(blob[pos + 2:pos + 2 + ln])
        pos += 2 + ln
    npps = blob[pos]
    pos += 1
    for _ in range(npps):
        ln = struct.unpack(">H", blob[pos:pos + 2])[0]
        pps_list.append(blob[pos + 2:pos + 2 + ln])
        pos += 2 + ln
    return sps_list, pps_list


def _harvest_params_h265(raw: bytes, cfg: dict) -> None:
    """Collect VPS/SPS/PPS NALs (types 32/33/34) from an Annex-B AU."""
    for nal in _split_annexb(raw):
        t = (nal[0] >> 1) & 0x3F
        if t == 32:
            cfg["vps"] = nal
        elif t == 33:
            cfg["sps"] = nal
        elif t == 34:
            cfg["pps"] = nal


def _annexb_to_lenpref_h265(raw: bytes) -> bytes:
    """Annex-B HEVC AU -> 4-byte length-prefixed sample (parameter
    sets stripped; they live in the hvcC config)."""
    sample = bytearray()
    for nal in _split_annexb(raw):
        if ((nal[0] >> 1) & 0x3F) in (32, 33, 34):
            continue
        sample += struct.pack(">I", len(nal)) + nal
    return bytes(sample)


def _unescape_rbsp(data: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in data:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _make_hvcc(vps: bytes, sps: bytes, pps: bytes) -> bytes:
    """ISO 14496-15 §8.3.3 HEVCDecoderConfigurationRecord: the
    profile_tier_level is copied from the SPS; 4:2:0 8-bit assumed
    for the informative fields."""
    rbsp = _unescape_rbsp(sps[2:])
    ptl = rbsp[1:13]                     # 12-byte profile_tier_level
    out = bytearray([1]) + ptl
    out += bytes([0xF0, 0x00])           # min_spatial_segmentation
    out += bytes([0xFC])                 # parallelismType
    out += bytes([0xFC | 1])             # chroma_format 4:2:0
    out += bytes([0xF8, 0xF8])           # bit depths (luma, chroma) 8
    out += bytes([0, 0])                 # avgFrameRate
    out += bytes([0x0F])                 # 1 layer, nested, len-1=3
    out += bytes([3])                    # numOfArrays
    for t, nal in ((32, vps), (33, sps), (34, pps)):
        out += bytes([0x80 | t]) + struct.pack(">HH", 1, len(nal)) \
            + nal
    return bytes(out)


def _parse_hvcc(blob: bytes) -> List[bytes]:
    """hvcC -> parameter-set NALs in array order."""
    nals = []
    pos = 22
    num_arrays = blob[pos]
    pos += 1
    for _ in range(num_arrays):
        pos += 1
        cnt = struct.unpack(">H", blob[pos:pos + 2])[0]
        pos += 2
        for _ in range(cnt):
            ln = struct.unpack(">H", blob[pos:pos + 2])[0]
            pos += 2
            nals.append(blob[pos:pos + ln])
            pos += ln
    return nals


def _av1_seq_obu(blob: bytes) -> bytes:
    """First OBU_SEQUENCE_HEADER in a low-overhead OBU stream (AV1
    spec §5.3; used for the av1C configOBUs)."""
    pos = 0
    while pos < len(blob):
        b0 = blob[pos]
        otype = (b0 >> 3) & 0xF
        has_size = b0 & 0x02
        p = pos + 1
        if b0 & 0x04:                    # extension
            p += 1
        if not has_size:
            return blob[pos:] if otype == 1 else b""
        size = 0
        shift = 0
        while p < len(blob):
            byte = blob[p]
            p += 1
            size |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        end = p + size
        if otype == 1:
            return blob[pos:end]
        pos = end
    return b""


def _xiph_lace(packets: List[bytes]) -> bytes:
    """Xiph-style lacing for CodecPrivate (matroska codec-specs:
    A_VORBIS / V_THEORA carry their three header packets this way —
    count-1, then 255-run sizes for all but the last packet)."""
    out = bytearray([len(packets) - 1])
    for pkt in packets[:-1]:
        n = len(pkt)
        out += b"\xff" * (n // 255) + bytes([n % 255])
    for pkt in packets:
        out += pkt
    return bytes(out)


def _parse_xiph_private(priv: bytes) -> List[bytes]:
    """Inverse of `_xiph_lace` (matroska-demux.c xiph header split)."""
    if not priv:
        raise ValueError("matroska: missing xiph CodecPrivate")
    count = priv[0] + 1
    pos = 1
    sizes = []
    for _ in range(count - 1):
        n = 0
        while True:
            b = priv[pos]
            pos += 1
            n += b
            if b != 255:
                break
        sizes.append(n)
    pkts = []
    for n in sizes:
        pkts.append(priv[pos:pos + n])
        pos += n
    pkts.append(priv[pos:])
    return pkts


def _blob_bytes(b) -> bytes:
    return (bytes(b) if isinstance(b, (bytes, bytearray))
            else host_array(b).tobytes())


def _video_blobs(buf: Buffer) -> List[bytes]:
    d = buf.data
    if isinstance(d, (list, tuple)):
        return [_blob_bytes(x) for x in d]
    arr = host_array(d)
    if arr.ndim > 1:
        return [bytes(r.tobytes()) for r in arr]
    return [_blob_bytes(arr)]


def _video_bytes(info: VideoInfo, planes) -> np.ndarray:
    """(batch) component planes -> per-frame container payloads."""
    return to_bytes(info.finfo, tuple(host_array(p) for p in planes),
                    info.width, info.height)


# ---------------------------------------------------------------------------
# AVI (RIFF)
# ---------------------------------------------------------------------------

@register_element
class AviMux(AggregatorElement):
    """avimux: raw video (+ optional PCM audio) into an .avi file.

    Writes avih/strh/strf headers, interleaved 00db/01wb movi chunks and
    an idx1 index, finalized at EOS (gstavimux.c gst_avi_mux_start_file /
    _stop_file)."""
    FACTORY = "avimux"
    DESCRIPTION = "Muxes audio and video into an avi stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("video_%u", PadDirection.SINK,
                    "video/x-raw, format={ I420, YUY2, UYVY, RGB }"
                    + _CODED_VIDEO_CAPS,
                    presence=PadPresence.REQUEST),
        PadTemplate("audio_%u", PadDirection.SINK,
                    "audio/x-raw, format=S16LE, layout=interleaved",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, "video/x-msvideo"),
    ]
    PROPERTIES = {"location": (str, "out.avi", "output path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._vinfo: Optional[VideoInfo] = None
        self._ainfo: Optional[AudioInfo] = None
        self._vcodec: Optional[str] = None   # None=raw, h264, mjpeg
        self._vdims = (0, 0, Fraction(25, 1))
        self._file = None
        self._index: List[Tuple[bytes, int, int]] = []
        self._vframes = 0
        self._asamples = 0

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed: Caps):
        for pad_name, caps in in_caps.items():
            s = caps.fixate()[0]
            if pad_name.startswith("video"):
                if s.name == "video/x-h264":
                    self._vcodec = "h264"
                elif s.name == "image/jpeg":
                    self._vcodec = "mjpeg"
                if self._vcodec:
                    fps = s.get("framerate") or Fraction(25, 1)
                    if isinstance(fps, tuple):
                        fps = Fraction(*fps)
                    self._vdims = (s.get("width") or 0,
                                   s.get("height") or 0, fps)
                    self._vinfo = True       # marks a video stream
                else:
                    self._vinfo = VideoInfo.from_caps_structure(s)
            else:
                self._ainfo = AudioInfo.from_caps_structure(s)
        return Caps.from_string("video/x-msvideo")

    def _vgeom(self):
        """(width, height, fps) for raw or coded video."""
        if self._vcodec:
            return self._vdims
        vi = self._vinfo
        return vi.width, vi.height, vi.fps

    # -- header pieces -------------------------------------------------------
    def _strl_video(self) -> bytes:
        w, h, fps = self._vgeom()
        if self._vcodec:
            fourcc = b"H264" if self._vcodec == "h264" else b"MJPG"
            compression = fourcc
            bitcount = 24
            fsz = 0
        else:
            vi = self._vinfo
            fmt = vi.finfo.name
            fourcc = VIDEO_FOURCC.get(fmt, b"DIB ")
            bitcount = {"I420": 12, "YUY2": 16, "UYVY": 16,
                        "RGB": 24}[fmt]
            compression = fourcc if fmt != "RGB" else b"\0\0\0\0"
            fsz = frame_size(vi.finfo, vi.width, vi.height)
        strh = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0,
            fps.denom, fps.num, 0, self._vframes, fsz, 0xFFFFFF, 0,
            0, 0, w, h)
        strf = struct.pack(
            "<IiiHH4sIiiII", 40, w, h, 1, bitcount,
            compression, fsz, 0, 0, 0, 0)
        return (b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8
                                      + len(strf))
                + b"strl"
                + b"strh" + struct.pack("<I", len(strh)) + strh
                + b"strf" + struct.pack("<I", len(strf)) + strf)

    def _strl_audio(self) -> bytes:
        ai = self._ainfo
        bpf = ai.channels * 2
        strh = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh", b"auds", b"\0\0\0\0", 0, 0, 0, 0,
            1, ai.rate, 0, self._asamples, bpf * ai.rate, 0xFFFFFF, bpf,
            0, 0, 0, 0)
        strf = struct.pack("<HHIIHH", 1, ai.channels, ai.rate,
                           ai.rate * bpf, bpf, 16)
        return (b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8
                                      + len(strf))
                + b"strl"
                + b"strh" + struct.pack("<I", len(strh)) + strh
                + b"strf" + struct.pack("<I", len(strf)) + strf)

    def _write_headers(self) -> None:
        has_v = self._vinfo is not None
        w, h, fps = self._vgeom() if has_v else (0, 0, Fraction(25, 1))
        streams = (1 if has_v else 0) + (1 if self._ainfo else 0)
        uspf = 1_000_000 * fps.denom // fps.num if has_v else 0
        avih = struct.pack(
            "<IIIIIIIIIIIIII", uspf, 0, 0, 0x10, self._vframes, 0,
            streams, 0x100000, w, h, 0, 0, 0, 0)
        strls = b""
        if self._vinfo is not None:
            strls += self._strl_video()
        if self._ainfo is not None:
            strls += self._strl_audio()
        hdrl = (b"hdrl" + b"avih" + struct.pack("<I", len(avih)) + avih
                + strls)
        self._file.write(b"RIFF\0\0\0\0AVI ")
        self._file.write(b"LIST" + struct.pack("<I", len(hdrl)) + hdrl)
        self._movi_start = self._file.tell()
        self._file.write(b"LIST\0\0\0\0movi")

    def start(self):
        self._file = open(self.props["location"], "wb")
        self._index = []
        self._vframes = 0
        self._asamples = 0
        self._headers_done = False

    def _chunk(self, ckid: bytes, payload: bytes) -> None:
        off = self._file.tell() - self._movi_start - 8
        self._index.append((ckid, off, len(payload)))
        self._file.write(ckid + struct.pack("<I", len(payload)) + payload)
        if len(payload) & 1:
            self._file.write(b"\0")

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        if not self._headers_done:
            self._write_headers()
            self._headers_done = True
        vid_sid = 0
        aud_sid = 1 if self._vinfo is not None else 0
        for pad_name in sorted(ins):
            buf = ins[pad_name]
            if pad_name.startswith("video"):
                if self._vcodec:
                    # compressed chunks use the 'dc' suffix
                    # (gstavimux.c gst_avi_mux_is_uncompressed)
                    for blob in _video_blobs(buf):
                        self._chunk(b"%02ddc" % vid_sid, blob)
                        self._vframes += 1
                    continue
                raw = _video_bytes(self._vinfo, buf.data)
                raw = raw.reshape(buf.batch, -1)
                for k in range(buf.batch):
                    self._chunk(b"%02ddb" % vid_sid, raw[k].tobytes())
                    self._vframes += 1
            else:
                samples = host_array(buf.data)
                raw = afmt.to_bytes(self._ainfo.finfo, samples)
                self._chunk(b"%02dwb" % aud_sid, raw.tobytes())
                self._asamples += samples.shape[0]
        first = next(iter(ins.values()))
        return first.with_(data=np.zeros(1, np.uint8))

    def stop(self):
        if self._file is None:
            return
        if not getattr(self, "_headers_done", False):
            self._write_headers()
        # idx1
        idx = b"".join(ckid + struct.pack("<III", 0x10, off, size)
                       for ckid, off, size in self._index)
        movi_end = self._file.tell()
        self._file.write(b"idx1" + struct.pack("<I", len(idx)) + idx)
        total = self._file.tell()
        # patch sizes + counts
        self._file.seek(4)
        self._file.write(struct.pack("<I", total - 8))
        self._file.seek(self._movi_start + 4)
        self._file.write(struct.pack("<I", movi_end - self._movi_start - 8))
        # re-write headers with final frame counts (fixed-size region)
        self._file.seek(12)
        has_v = self._vinfo is not None
        w, h, fps = self._vgeom() if has_v else (0, 0, Fraction(25, 1))
        streams = (1 if has_v else 0) + (1 if self._ainfo else 0)
        uspf = 1_000_000 * fps.denom // fps.num if has_v else 0
        avih = struct.pack(
            "<IIIIIIIIIIIIII", uspf, 0, 0, 0x10, self._vframes, 0,
            streams, 0x100000, w, h, 0, 0, 0, 0)
        strls = b""
        if self._vinfo is not None:
            strls += self._strl_video()
        if self._ainfo is not None:
            strls += self._strl_audio()
        hdrl = (b"hdrl" + b"avih" + struct.pack("<I", len(avih)) + avih
                + strls)
        self._file.write(b"LIST" + struct.pack("<I", len(hdrl)) + hdrl)
        self._file.close()
        self._file = None


def _parse_avi(path: str):
    """Walk RIFF: returns (streams, movi_chunks) where streams is a list
    of dicts and movi_chunks [(stream_id, payload_offset, size)]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not an AVI file")
    streams = []
    chunks = []

    def walk(pos, end):
        while pos + 8 <= end:
            ckid = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if ckid == b"LIST":
                ltype = data[body:body + 4]
                if ltype in (b"hdrl", b"strl", b"movi"):
                    walk(body + 4, body + size)
            elif ckid == b"strh":
                fcc_type = data[body:body + 4]
                fcc = data[body + 4:body + 8]
                scale, rate = struct.unpack("<II", data[body + 20:body + 28])
                length = struct.unpack("<I",
                                       data[body + 32:body + 36])[0]
                streams.append({"type": fcc_type, "fourcc": fcc,
                                "scale": scale, "rate": rate,
                                "length": length})
            elif ckid == b"strf":
                st = streams[-1]
                if st["type"] == b"vids":
                    (_, w, h, _, bits, comp) = struct.unpack(
                        "<IiiHH4s", data[body:body + 20])
                    st.update(width=w, height=abs(h), bits=bits,
                              compression=comp)
                else:
                    tag, ch, rate2 = struct.unpack(
                        "<HHI", data[body:body + 8])
                    bits = struct.unpack("<H", data[body + 14:body + 16])[0]
                    st.update(tag=tag, channels=ch, arate=rate2, bits=bits)
            elif len(ckid) == 4 and ckid[:2].isdigit():
                chunks.append((int(ckid[:2]), body, size))
            pos = body + size + (size & 1)

    walk(12, len(data))
    return streams, chunks, data


@register_element
class AviDemux(SourceElement):
    """avidemux (source-style): demux ONE stream of an .avi file per
    element instance (`stream` property selects video/audio or index),
    mirroring wavparse's pull-mode collapse."""
    FACTORY = "avidemux"
    DESCRIPTION = "Demultiplex an avi file into audio and video"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "avi file path"),
        "stream": (str, "video", "video | audio | stream index"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._loaded = False
        self._pos = 0
        self._adata = None              # decoded audio (n, ch) f32

    def _load(self):
        if self._loaded:
            return
        streams, chunks, data = _parse_avi(self.props["location"])
        sel = self.props["stream"]
        want = None
        for idx, st in enumerate(streams):
            if sel == str(idx) or \
               (sel == "video" and st["type"] == b"vids") or \
               (sel == "audio" and st["type"] == b"auds"):
                want = idx
                break
        if want is None:
            raise ValueError(f"avidemux: no stream {sel!r}")
        self._stream = streams[want]
        self._chunks = [(off, size) for sid, off, size in chunks
                        if sid == want]
        self._data = data
        st = self._stream
        self._coded = None
        if st["type"] == b"vids":
            if st["compression"] == b"H264":
                self._coded = "video/x-h264"
            elif st["compression"] in (b"MJPG", b"jpeg"):
                self._coded = "image/jpeg"
            if self._coded:
                self._vdims = (st["width"], st["height"],
                               Fraction(st["rate"], st["scale"]))
                self._info = None
                self._loaded = True
                return
            if st["compression"] in FOURCC_VIDEO:
                fmt = FOURCC_VIDEO[st["compression"]]
            elif st["compression"] == b"\0\0\0\0" and st["bits"] == 24:
                fmt = "RGB"
            else:
                raise ValueError("avidemux: unsupported video codec "
                                 f"{st['compression']!r}")
            self._info = VideoInfo(
                format=fmt, width=st["width"], height=st["height"],
                fps=Fraction(st["rate"], st["scale"]))
        else:
            tag = st.get("tag", 1)
            if tag == 0x55:
                # WAVE_FORMAT_MPEGLAYER3 (gstavidemux.c audio tag
                # table): whole mp3 frames in ##wb chunks, decoded by
                # the clean-room codecs/mp3.py
                from ..codecs import mp3 as pmp3
                blob = b"".join(self._data[off:off + size]
                                for off, size in self._chunks)
                pcm, rate, ch = pmp3.decode(blob)
                self._adata = np.asarray(pcm, np.float32)
                self._info = AudioInfo(format="F32LE", rate=rate,
                                       channels=ch)
            elif tag == 1:
                self._info = AudioInfo(format="S16LE", rate=st["arate"],
                                       channels=st["channels"])
            else:
                raise ValueError(
                    f"avidemux: unsupported audio tag {tag:#x}")
        self._loaded = True

    def _coded_caps(self) -> Caps:
        from ..core.structure import Structure
        w, h, fps = self._vdims
        f = {"width": w, "height": h, "framerate": fps}
        if self._coded in ("video/x-h264", "video/x-h265"):
            f.update({"stream-format": "byte-stream",
                      "alignment": "au"})
        return Caps([Structure(self._coded, f)])

    def preview_blob(self) -> Optional[bytes]:
        """First coded chunk for downstream decoders' caps peeking
        (the image_codecs _peek_upstream convention)."""
        try:
            self._load()
        except (OSError, ValueError):
            return None
        if getattr(self, "_coded", None) and self._chunks:
            off, size = self._chunks[0]
            return self._data[off:off + size]
        return None

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        if not self._loaded:
            caps = Caps.any()
        elif getattr(self, "_caps_override", None) is not None:
            caps = self._caps_override
        elif getattr(self, "_coded", None):
            caps = self._coded_caps()
        else:
            caps = Caps([self._info.to_caps_structure()])
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        info = self._info
        if getattr(self, "_cues", None) is not None:
            if self._pos >= len(self._cues):
                return None
            s_ns, e_ns, txt = self._cues[self._pos]
            self._pos += 1
            return Buffer(data=[txt], batch=1, pts=s_ns,
                          duration=e_ns - s_ns,
                          meta={"cues": [(s_ns, e_ns, txt)]})
        if self._adata is not None:
            if self._pos >= len(self._adata):
                return None
            chunk = self._adata[self._pos:self._pos + 4096]
            rate = info.rate
            pts = self._pos * 1_000_000_000 // rate
            self._pos += len(chunk)
            return Buffer(data=chunk, batch=1, pts=pts,
                          duration=len(chunk) * 1_000_000_000 // rate)
        if self._pos >= len(self._chunks):
            return None
        if getattr(self, "_coded", None):
            take = self._chunks[self._pos:self._pos + max(1, n_frames)]
            blobs = [np.frombuffer(self._data[off:off + size], np.uint8)
                     for off, size in take]
            fps = self._vdims[2]
            pts = self._pos * 1_000_000_000 * fps.denom // fps.num
            dur = 1_000_000_000 * fps.denom // fps.num
            self._pos += len(take)
            return Buffer(data=blobs if len(blobs) > 1 else blobs[0],
                          pts=pts, duration=dur, batch=len(blobs),
                          meta={"caps": self._coded_caps()})
        if isinstance(info, VideoInfo):
            take = self._chunks[self._pos:self._pos + max(1, n_frames)]
            raws = np.stack([np.frombuffer(
                self._data[off:off + size], np.uint8) for off, size in take])
            planes = from_bytes(info.finfo, raws, info.width, info.height)
            fps = info.fps
            pts = self._pos * 1_000_000_000 * fps.denom // fps.num
            dur = 1_000_000_000 * fps.denom // fps.num
            self._pos += len(take)
            return Buffer(data=planes, pts=pts, duration=dur,
                          batch=len(take))
        off, size = self._chunks[self._pos]
        self._pos += 1
        raw = np.frombuffer(self._data[off:off + size], np.uint8)
        samples = afmt.from_bytes(info.finfo, raw, info.channels)
        return Buffer(data=samples, batch=1,
                      duration=samples.shape[0] * 1_000_000_000
                      // info.rate)


# ---------------------------------------------------------------------------
# Matroska (EBML)
# ---------------------------------------------------------------------------

def ebml_id(num: int) -> bytes:
    """IDs are stored with their marker bits included."""
    out = []
    while num:
        out.append(num & 0xFF)
        num >>= 8
    return bytes(reversed(out))


def ebml_size(value: int, length: Optional[int] = None) -> bytes:
    """EBML variable-size integer (width marker in the first byte)."""
    if length is None:
        length = 1
        while value >= (1 << (7 * length)) - 1 and length < 8:
            length += 1
    out = value | (1 << (7 * length))
    return out.to_bytes(length, "big")


def ebml_elem(eid: int, payload: bytes) -> bytes:
    return ebml_id(eid) + ebml_size(len(payload)) + payload


def ebml_uint(eid: int, v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return ebml_elem(eid, v.to_bytes(n, "big"))


def ebml_float(eid: int, v: float) -> bytes:
    return ebml_elem(eid, struct.pack(">d", v))


def ebml_str(eid: int, s: str) -> bytes:
    return ebml_elem(eid, s.encode())


# element IDs (matroska-ids.h)
EBML_HEADER = 0x1A45DFA3
SEGMENT = 0x18538067
SEG_INFO = 0x1549A966
TIMESTAMP_SCALE = 0x2AD7B1
MUXING_APP = 0x4D80
WRITING_APP = 0x5741
DURATION = 0x4489
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_UID = 0x73C5
TRACK_TYPE = 0x83
CODEC_ID = 0x86
DEFAULT_DURATION = 0x23E383
VIDEO = 0xE0
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
COLOUR_SPACE = 0x2EB524
AUDIO = 0xE1
SAMPLING_FREQ = 0xB5
CHANNELS = 0x9F
BIT_DEPTH = 0x6264
CLUSTER = 0x1F43B675
CLUSTER_TS = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1
BLOCK_DURATION = 0x9B
BLOCK_ADDITIONS = 0x75A1
BLOCK_MORE = 0xA6
BLOCK_ADD_ID = 0xEE
BLOCK_ADDITIONAL = 0xA5
MAX_BLOCK_ADDITION_ID = 0x55EE
CODEC_PRIVATE = 0x63A2


@register_element
class MatroskaMux(AggregatorElement):
    """matroskamux: V_UNCOMPRESSED video + A_PCM/INT/LIT audio in an
    EBML Segment with per-tick Clusters of SimpleBlocks
    (matroska-mux.c)."""
    FACTORY = "matroskamux"
    DESCRIPTION = "Muxes video/audio streams into a matroska stream"
    HOST_ELEMENT = True
    DOCTYPE = "matroska"
    PAD_TEMPLATES = [
        PadTemplate("video_%u", PadDirection.SINK,
                    "video/x-raw, format={ I420, YUY2, UYVY, A420 }"
                    + _CODED_VIDEO_CAPS
                    + "; video/x-h265, stream-format=byte-stream, "
                      "alignment=au; video/x-av1; video/x-vp8; "
                      "video/x-vp9",
                    presence=PadPresence.REQUEST),
        PadTemplate("audio_%u", PadDirection.SINK,
                    "audio/x-raw, format=S16LE, layout=interleaved; "
                    "audio/mpeg, mpegversion=4, stream-format=raw; "
                    "audio/x-opus",
                    presence=PadPresence.REQUEST),
        PadTemplate("subtitle_%u", PadDirection.SINK,
                    "text/x-raw, format=utf8",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, "video/x-matroska"),
    ]
    PROPERTIES = {
        "location": (str, "out.mkv", "output path"),
        "audio-codec": (str, "", "'' (pcm) | vorbis"),
        "video-codec": (str, "", "'' (raw) | theora | vp8 | vp9"),
        "audio-quality": (float, 0.4, "vorbis VBR quality (-0.1..1)"),
        "video-quality": (int, 48, "theora quality (0..63)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._vinfo = None
        self._ainfo = None
        self._vcodec = None                  # None=raw, h264, mjpeg
        self._vdims = (0, 0, Fraction(25, 1))
        self._avc_cfg = {}
        self._file = None
        self._acodec = None                  # None=pcm, vorbis, aac, opus
        self._venc = None                    # None=raw, theora
        self._defer = False                  # encode-at-EOS mode
        self._araw: List[np.ndarray] = []
        self._vraw: list = []
        self._ahdrs: List[bytes] = []
        self._thdrs: List[bytes] = []

    def negotiate_output(self, in_caps, allowed):
        for pad_name, caps in in_caps.items():
            s = caps.fixate()[0]
            if pad_name.startswith("video"):
                if s.name == "video/x-h264":
                    self._vcodec = "h264"
                elif s.name == "video/x-h265":
                    self._vcodec = "h265"
                elif s.name == "video/x-av1":
                    self._vcodec = "av1"
                elif s.name == "video/x-vp8":
                    self._vcodec = "vp8"
                elif s.name == "video/x-vp9":
                    self._vcodec = "vp9"
                elif s.name == "image/jpeg":
                    self._vcodec = "mjpeg"
                if self._vcodec:
                    fps = s.get("framerate") or Fraction(25, 1)
                    if isinstance(fps, tuple):
                        fps = Fraction(*fps)
                    self._vdims = (s.get("width") or 0,
                                   s.get("height") or 0, fps)
                    self._vinfo = True
                else:
                    self._vinfo = VideoInfo.from_caps_structure(s)
            elif pad_name.startswith("subtitle"):
                self._sinfo = True
            else:
                if s.name == "audio/mpeg":
                    # coded AAC passthrough (A_AAC, ASC CodecPrivate)
                    self._acodec = "aac"
                    self._ainfo = AudioInfo(format="S16LE",
                                            rate=s["rate"],
                                            channels=s["channels"])
                elif s.name == "audio/x-opus":
                    self._acodec = "opus"
                    self._ainfo = AudioInfo(
                        format="S16LE",
                        rate=s.get("rate") or 48000,
                        channels=s.get("channels") or 2)
                else:
                    self._ainfo = AudioInfo.from_caps_structure(s)
        if self.props.get("audio-codec") == "vorbis" \
                and self._ainfo is not None and self._acodec is None:
            self._acodec = "vorbis"
        vc = self.props.get("video-codec")
        if vc in ("theora", "vp8", "vp9") \
                and self._vinfo is not None and not self._vcodec:
            ok = ("I420",) if vc == "theora" else ("I420", "A420")
            if self._vinfo.finfo.name not in ok:
                raise ValueError(
                    f"matroskamux: {vc} needs {'/'.join(ok)} input")
            self._venc = vc
        if self._acodec == "vorbis" and self._vcodec:
            raise ValueError("matroskamux: audio-codec=vorbis cannot "
                             "combine with coded (h264/mjpeg) video")
        self._defer = bool(self._acodec == "vorbis" or self._venc)
        return Caps.from_string("video/x-matroska")

    def _tracks(self) -> bytes:
        entries = b""
        if self._vinfo is not None:
            if self._vcodec:
                w, h, fps = self._vdims
                video = (ebml_uint(PIXEL_WIDTH, w)
                         + ebml_uint(PIXEL_HEIGHT, h))
                codec = {"h264": "V_MPEG4/ISO/AVC",
                         "h265": "V_MPEGH/ISO/HEVC",
                         "av1": "V_AV1",
                         "vp8": "V_VP8",
                         "vp9": "V_VP9",
                         "mjpeg": "V_MJPEG"}[self._vcodec]
                entry = (ebml_uint(TRACK_NUMBER, 1)
                         + ebml_uint(TRACK_UID, 1)
                         + ebml_uint(TRACK_TYPE, 1)
                         + ebml_str(CODEC_ID, codec))
                if self._vcodec == "h264" and self._avc_cfg.get("sps"):
                    entry += ebml_elem(
                        CODEC_PRIVATE,
                        _make_avcc(self._avc_cfg["sps"],
                                   self._avc_cfg.get("pps")))
                elif self._vcodec == "h265" \
                        and self._avc_cfg.get("sps"):
                    entry += ebml_elem(
                        CODEC_PRIVATE,
                        _make_hvcc(self._avc_cfg.get("vps", b""),
                                   self._avc_cfg["sps"],
                                   self._avc_cfg.get("pps", b"")))
                elif self._vcodec == "av1":
                    entry += ebml_elem(
                        CODEC_PRIVATE,
                        bytes([0x81, 0, 0, 0])
                        + self._avc_cfg.get("av1_seq", b""))
                entry += (ebml_uint(DEFAULT_DURATION,
                                    1_000_000_000 * fps.denom
                                    // fps.num)
                          + ebml_elem(VIDEO, video))
                entries += ebml_elem(TRACK_ENTRY, entry)
            elif self._venc:
                vi = self._vinfo
                fps = vi.fps
                video = (ebml_uint(PIXEL_WIDTH, vi.width)
                         + ebml_uint(PIXEL_HEIGHT, vi.height))
                cid = {"theora": "V_THEORA", "vp8": "V_VP8",
                       "vp9": "V_VP9"}[self._venc]
                codec = ebml_str(CODEC_ID, cid)
                if self._venc == "theora":
                    codec += ebml_elem(CODEC_PRIVATE,
                                       _xiph_lace(self._thdrs))
                elif vi.finfo.name == "A420":
                    codec += ebml_uint(MAX_BLOCK_ADDITION_ID, 1)
                entries += ebml_elem(
                    TRACK_ENTRY,
                    ebml_uint(TRACK_NUMBER, 1) + ebml_uint(TRACK_UID, 1)
                    + ebml_uint(TRACK_TYPE, 1) + codec
                    + ebml_uint(DEFAULT_DURATION,
                                1_000_000_000 * fps.denom // fps.num)
                    + ebml_elem(VIDEO, video))
            else:
                vi = self._vinfo
                fps = vi.fps
                video = (ebml_uint(PIXEL_WIDTH, vi.width)
                         + ebml_uint(PIXEL_HEIGHT, vi.height)
                         + ebml_elem(COLOUR_SPACE,
                                     VIDEO_FOURCC[vi.finfo.name]))
                entries += ebml_elem(
                    TRACK_ENTRY,
                    ebml_uint(TRACK_NUMBER, 1) + ebml_uint(TRACK_UID, 1)
                    + ebml_uint(TRACK_TYPE, 1)
                    + ebml_str(CODEC_ID, "V_UNCOMPRESSED")
                    + ebml_uint(DEFAULT_DURATION,
                                1_000_000_000 * fps.denom // fps.num)
                    + ebml_elem(VIDEO, video))
        if self._ainfo is not None:
            ai = self._ainfo
            audio = (ebml_float(SAMPLING_FREQ, float(ai.rate))
                     + ebml_uint(CHANNELS, ai.channels))
            if self._acodec == "vorbis":
                codec = (ebml_str(CODEC_ID, "A_VORBIS")
                         + ebml_elem(CODEC_PRIVATE,
                                     _xiph_lace(self._ahdrs)))
            elif self._acodec == "aac":
                from .isomp4 import _make_asc
                codec = (ebml_str(CODEC_ID, "A_AAC")
                         + ebml_elem(CODEC_PRIVATE,
                                     _make_asc(ai.rate, ai.channels)))
            elif self._acodec == "opus":
                from ..codecs.opus import opus_head
                codec = (ebml_str(CODEC_ID, "A_OPUS")
                         + ebml_elem(CODEC_PRIVATE,
                                     opus_head(ai.channels, 0,
                                               ai.rate)))
            else:
                audio += ebml_uint(BIT_DEPTH, 16)
                codec = ebml_str(CODEC_ID, "A_PCM/INT/LIT")
            entries += ebml_elem(
                TRACK_ENTRY,
                ebml_uint(TRACK_NUMBER, 2) + ebml_uint(TRACK_UID, 2)
                + ebml_uint(TRACK_TYPE, 2) + codec
                + ebml_elem(AUDIO, audio))
        if getattr(self, "_sinfo", None):
            # S_TEXT/UTF8 subtitle track (matroska-mux.c subtitle
            # pads; cues carried as BlockGroup + BlockDuration)
            entries += ebml_elem(
                TRACK_ENTRY,
                ebml_uint(TRACK_NUMBER, 3) + ebml_uint(TRACK_UID, 3)
                + ebml_uint(TRACK_TYPE, 0x11)
                + ebml_str(CODEC_ID, "S_TEXT/UTF8"))
        return ebml_elem(TRACKS, entries)

    def start(self):
        self._file = open(self.props["location"], "wb")
        self._headers_done = False
        self._vframes = 0
        self._apts_ms = 0
        self._apkts = 0

    def _write_headers(self):
        header = (ebml_uint(0x4286, 1) + ebml_uint(0x42F7, 1)
                  + ebml_uint(0x42F2, 4) + ebml_uint(0x42F3, 8)
                  + ebml_str(0x4282, self.DOCTYPE)
                  + ebml_uint(0x4287, 2) + ebml_uint(0x4285, 2))
        self._file.write(ebml_elem(EBML_HEADER, header))
        # unknown-size segment (streamed writing, matroska-mux.c default
        # before finalization)
        self._file.write(ebml_id(SEGMENT) + b"\xFF")
        info = (ebml_uint(TIMESTAMP_SCALE, 1_000_000)
                + ebml_str(MUXING_APP, "gstreamer_tpu")
                + ebml_str(WRITING_APP, "gstreamer_tpu matroskamux"))
        self._file.write(ebml_elem(SEG_INFO, info))
        self._file.write(self._tracks())

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        if self._defer:
            # encode-at-EOS mode (vorbis/theora tracks): accumulate
            # raw media; all EBML writing happens in stop()
            for pad_name in sorted(ins):
                buf = ins[pad_name]
                if pad_name.startswith("video"):
                    if self._venc:
                        planes = [host_array(p) for p in buf.data]
                        for k in range(buf.batch):
                            self._vraw.append(tuple(p[k] for p in planes))
                    else:
                        raw = _video_bytes(
                            self._vinfo, buf.data).reshape(buf.batch, -1)
                        for k in range(buf.batch):
                            self._vraw.append(raw[k].tobytes())
                else:
                    self._araw.append(host_array(buf.data))
            first = next(iter(ins.values()))
            return first.with_(data=np.zeros(1, np.uint8))
        if not self._headers_done:
            if self._vcodec in ("h264", "h265", "av1"):
                # harvest parameter sets for the avcC/hvcC/av1C
                # CodecPrivate before the TrackEntry is written
                # (matroska-mux.c takes them from the caps codec_data)
                for pad_name, buf in ins.items():
                    if pad_name.startswith("video"):
                        for blob in _video_blobs(buf):
                            if self._vcodec == "h264":
                                _harvest_params(blob, self._avc_cfg)
                            elif self._vcodec == "h265":
                                _harvest_params_h265(blob,
                                                     self._avc_cfg)
                            else:
                                seq = _av1_seq_obu(blob)
                                if seq:
                                    self._avc_cfg["av1_seq"] = seq
            self._write_headers()
            self._headers_done = True
        blocks = b""
        cluster_ts = None
        for pad_name in sorted(ins):
            buf = ins[pad_name]
            if pad_name.startswith("video"):
                if self._vcodec:
                    fps = self._vdims[2]
                    for blob in _video_blobs(buf):
                        if self._vcodec == "h264":
                            blob = _annexb_to_lenpref(blob)
                            if not blob:
                                continue
                        elif self._vcodec == "h265":
                            blob = _annexb_to_lenpref_h265(blob)
                            if not blob:
                                continue
                        ts_ms = ((self._vframes * 1000 * fps.denom)
                                 // fps.num)
                        if cluster_ts is None:
                            cluster_ts = ts_ms
                        rel = ts_ms - cluster_ts
                        blocks += ebml_elem(
                            SIMPLE_BLOCK,
                            ebml_size(1) + struct.pack(">h", rel)
                            + b"\x80" + blob)
                        self._vframes += 1
                    continue
                vi = self._vinfo
                fps = vi.fps
                raw = _video_bytes(vi, buf.data).reshape(buf.batch, -1)
                for k in range(buf.batch):
                    ts_ms = ((self._vframes * 1000 * fps.denom)
                             // fps.num)
                    if cluster_ts is None:
                        cluster_ts = ts_ms
                    rel = ts_ms - cluster_ts
                    blocks += ebml_elem(
                        SIMPLE_BLOCK,
                        ebml_size(1) + struct.pack(">h", rel) + b"\x80"
                        + raw[k].tobytes())
                    self._vframes += 1
            elif pad_name.startswith("subtitle"):
                cues = (buf.meta or {}).get("cues")
                if cues is None:
                    texts = (buf.data if isinstance(buf.data, list)
                             else [buf.data])
                    start = buf.pts or 0
                    dur = buf.duration or 1_000_000_000
                    cues = [(start, start + dur,
                             t if isinstance(t, str)
                             else host_array(t).tobytes().decode(
                                 "utf-8", "replace"))
                            for t in texts]
                for s_ns, e_ns, txt in cues:
                    ts_ms = int(s_ns // 1_000_000)
                    dur_ms = max(int((e_ns - s_ns) // 1_000_000), 1)
                    block = (ebml_size(3) + struct.pack(">h", 0)
                             + b"\x00" + txt.encode("utf-8"))
                    group = ebml_elem(
                        BLOCK_GROUP,
                        ebml_elem(BLOCK, block)
                        + ebml_uint(BLOCK_DURATION, dur_ms))
                    # one cluster per cue keeps relative timestamps
                    # within int16 range
                    self._file.write(ebml_elem(
                        CLUSTER, ebml_uint(CLUSTER_TS, ts_ms)
                        + group))
            elif self._acodec == "aac":
                ai = self._ainfo
                for blob in _video_blobs(buf):
                    ts_ms = self._apkts * 1024 * 1000 // ai.rate
                    if cluster_ts is None:
                        cluster_ts = ts_ms
                    rel = ts_ms - cluster_ts
                    blocks += ebml_elem(
                        SIMPLE_BLOCK,
                        ebml_size(2) + struct.pack(">h", rel)
                        + b"\x80" + blob)
                    self._apkts += 1
            elif self._acodec == "opus":
                for blob in _video_blobs(buf):
                    ts_ms = self._apkts * 20       # 20 ms frames
                    if cluster_ts is None:
                        cluster_ts = ts_ms
                    rel = ts_ms - cluster_ts
                    blocks += ebml_elem(
                        SIMPLE_BLOCK,
                        ebml_size(2) + struct.pack(">h", rel)
                        + b"\x80" + blob)
                    self._apkts += 1
            else:
                ai = self._ainfo
                samples = host_array(buf.data)
                raw = afmt.to_bytes(ai.finfo, samples)
                ts_ms = self._apts_ms
                if cluster_ts is None:
                    cluster_ts = ts_ms
                rel = ts_ms - cluster_ts
                blocks += ebml_elem(
                    SIMPLE_BLOCK,
                    ebml_size(2) + struct.pack(">h", rel) + b"\x80"
                    + raw.tobytes())
                self._apts_ms += samples.shape[0] * 1000 // ai.rate
        if blocks and cluster_ts is not None:
            self._file.write(ebml_elem(
                CLUSTER, ebml_uint(CLUSTER_TS, cluster_ts) + blocks))
        first = next(iter(ins.values()))
        return first.with_(data=np.zeros(1, np.uint8))

    def _finalize_deferred(self):
        """Encode accumulated media and write the whole file: headers
        (the encoder header packets feed the CodecPrivate), then
        1-second clusters of timestamp-sorted SimpleBlocks."""
        blocks = []                     # (ts_ms, track_no, flags, data)
        if self._venc == "theora" and self._vraw:
            from ..codecs import theora_enc
            vi = self._vinfo
            fps = vi.fps
            self._thdrs, pkts = theora_enc.encode_packets(
                self._vraw, vi.width, vi.height,
                (fps.num, fps.denom),
                quality=int(self.props["video-quality"]))
            for i, pkt in enumerate(pkts):
                ts = i * 1000 * fps.denom // fps.num
                key = bool(pkt) and not (pkt[0] & 0x40)
                blocks.append((ts, 1, 0x80 if key else 0x00, pkt))
        elif self._venc in ("vp8", "vp9") and self._vraw:
            from ..codecs import vpx as pvpx
            vi = self._vinfo
            fps = vi.fps
            has_alpha = len(self._vraw[0]) == 4
            color = [f[:3] for f in self._vraw]
            pkts = pvpx.encode_frames(
                self._venc, color, vi.width, vi.height,
                (fps.num, fps.denom))
            apkts = None
            if has_alpha:
                grey = [(f[3],
                         np.full(((vi.height + 1) // 2,
                                  (vi.width + 1) // 2), 128,
                                 np.uint8),
                         np.full(((vi.height + 1) // 2,
                                  (vi.width + 1) // 2), 128,
                                 np.uint8)) for f in self._vraw]
                apkts = [p for p, _ in pvpx.encode_frames(
                    self._venc, grey, vi.width, vi.height,
                    (fps.num, fps.denom))]
            for i, (pkt, key) in enumerate(pkts):
                ts = i * 1000 * fps.denom // fps.num
                extra = (apkts[i] if apkts and i < len(apkts)
                         else None)
                blocks.append((ts, 1, 0x80 if key else 0x00, pkt)
                              + ((extra,) if extra is not None
                                 else ()))
        elif self._vinfo is not None and self._vraw:
            fps = self._vinfo.fps
            for i, raw in enumerate(self._vraw):
                ts = i * 1000 * fps.denom // fps.num
                blocks.append((ts, 1, 0x80, raw))
        if self._acodec == "vorbis" and self._araw:
            from ..codecs import vorbis_enc
            ai = self._ainfo
            pcm = np.concatenate(self._araw, axis=0)
            if pcm.dtype != np.float32:
                pcm = pcm.astype(np.float32) / 32768.0
            self._ahdrs, apkts = vorbis_enc.encode_packets(
                pcm, ai.rate,
                quality=float(self.props["audio-quality"]))
            prev = 0
            for pkt, gran in apkts:
                blocks.append((prev * 1000 // ai.rate, 2, 0x80, pkt))
                if gran >= 0:
                    prev = gran
        elif self._ainfo is not None and self._araw:
            ai = self._ainfo
            n = 0
            for samples in self._araw:
                raw = afmt.to_bytes(ai.finfo, samples).tobytes()
                blocks.append((n * 1000 // ai.rate, 2, 0x80, raw))
                n += samples.shape[0]
        self._write_headers()
        blocks.sort(key=lambda b: b[0])
        pos = 0
        while pos < len(blocks):
            cts = blocks[pos][0]
            body = ebml_uint(CLUSTER_TS, cts)
            while pos < len(blocks) and blocks[pos][0] - cts < 1000:
                entry = blocks[pos]
                ts, tno, flags, payload = entry[:4]
                raw = (ebml_size(tno) + struct.pack(">h", ts - cts)
                       + bytes([flags]) + payload)
                if len(entry) > 4:           # alpha BlockAdditional
                    more = ebml_elem(
                        BLOCK_MORE,
                        ebml_uint(BLOCK_ADD_ID, 1)
                        + ebml_elem(BLOCK_ADDITIONAL, entry[4]))
                    body += ebml_elem(
                        BLOCK_GROUP,
                        ebml_elem(BLOCK, raw)
                        + ebml_elem(BLOCK_ADDITIONS, more))
                else:
                    body += ebml_elem(SIMPLE_BLOCK, raw)
                pos += 1
            self._file.write(ebml_elem(CLUSTER, body))

    def stop(self):
        if self._file is None:
            return
        if self._defer:
            self._finalize_deferred()
        elif not getattr(self, "_headers_done", False):
            self._write_headers()
        self._file.close()
        self._file = None


def _ebml_read_id(data: bytes, pos: int) -> Tuple[int, int]:
    first = data[pos]
    length = 1
    for k in range(4):
        if first & (0x80 >> k):
            length = k + 1
            break
    return int.from_bytes(data[pos:pos + length], "big"), pos + length


def _ebml_read_size(data: bytes, pos: int) -> Tuple[Optional[int], int]:
    first = data[pos]
    length = 1
    for k in range(8):
        if first & (0x80 >> k):
            length = k + 1
            break
    raw = int.from_bytes(data[pos:pos + length], "big")
    val = raw - (1 << (7 * length))
    if val == (1 << (7 * length)) - 1:      # all ones: unknown size
        return None, pos + length
    return val, pos + length


def _parse_matroska(path: str, with_additions: bool = False):
    with open(path, "rb") as f:
        data = f.read()
    tracks = []
    blocks = []   # (track_number, abs_ts_ms, offset, size, dur_ms)
    additions = []  # per-block: None or (offset, size) of additional

    def walk(pos, end, cluster_ts=0):
        while pos < end and pos + 2 <= len(data):
            eid, pos = _ebml_read_id(data, pos)
            size, pos = _ebml_read_size(data, pos)
            if size is None:                # unknown size: descend
                continue
            body = pos
            if eid in (SEGMENT, TRACKS, SEG_INFO):
                walk(body, body + size, cluster_ts)
            elif eid == TRACK_ENTRY:
                tracks.append(_parse_track(data, body, body + size))
            elif eid == CLUSTER:
                walk(body, body + size, cluster_ts)
            elif eid == CLUSTER_TS:
                cluster_ts = int.from_bytes(data[body:body + size], "big")
            elif eid == SIMPLE_BLOCK:
                tno, p2 = _ebml_read_size(data, body)
                rel = struct.unpack(">h", data[p2:p2 + 2])[0]
                payload = p2 + 3
                blocks.append((tno, cluster_ts + rel, payload,
                               body + size - payload, None))
                additions.append(None)
            elif eid == BLOCK_GROUP:
                bpos, bend = body, body + size
                binfo = None
                bdur = None
                badd = None
                while bpos < bend:
                    sid, bpos = _ebml_read_id(data, bpos)
                    ssz, bpos2 = _ebml_read_size(data, bpos)
                    bpos = bpos2
                    if sid == BLOCK:
                        tno, p2 = _ebml_read_size(data, bpos)
                        rel = struct.unpack(">h",
                                            data[p2:p2 + 2])[0]
                        payload = p2 + 3
                        binfo = (tno, cluster_ts + rel, payload,
                                 bpos + ssz - payload)
                    elif sid == BLOCK_DURATION:
                        bdur = int.from_bytes(data[bpos:bpos + ssz],
                                              "big")
                    elif sid == BLOCK_ADDITIONS:
                        apos, aend = bpos, bpos + ssz
                        while apos < aend:
                            aid, apos = _ebml_read_id(data, apos)
                            asz, apos = _ebml_read_size(data, apos)
                            if aid == BLOCK_MORE:
                                mpos, mend = apos, apos + asz
                                while mpos < mend:
                                    mid, mpos = _ebml_read_id(
                                        data, mpos)
                                    msz, mpos = _ebml_read_size(
                                        data, mpos)
                                    if mid == BLOCK_ADDITIONAL:
                                        badd = (mpos, msz)
                                    mpos += msz
                            apos += asz
                    bpos += ssz
                if binfo is not None:
                    blocks.append(binfo + (bdur,))
                    additions.append(badd)
            pos = body + size

    walk(0, len(data))
    if with_additions:
        return tracks, blocks, data, additions
    return tracks, blocks, data


def _parse_track(data: bytes, pos: int, end: int) -> dict:
    tr = {}
    while pos < end:
        eid, pos = _ebml_read_id(data, pos)
        size, pos = _ebml_read_size(data, pos)
        body = data[pos:pos + size]
        if eid == TRACK_NUMBER:
            tr["number"] = int.from_bytes(body, "big")
        elif eid == TRACK_TYPE:
            tr["type"] = int.from_bytes(body, "big")
        elif eid == CODEC_ID:
            tr["codec"] = body.decode()
        elif eid == CODEC_PRIVATE:
            tr["codec_private"] = body
        elif eid == DEFAULT_DURATION:
            tr["frame_dur"] = int.from_bytes(body, "big")
        elif eid in (VIDEO, AUDIO):
            p2 = pos
            while p2 < pos + size:
                sid, p2 = _ebml_read_id(data, p2)
                ssz, p2 = _ebml_read_size(data, p2)
                sb = data[p2:p2 + ssz]
                if sid == PIXEL_WIDTH:
                    tr["width"] = int.from_bytes(sb, "big")
                elif sid == PIXEL_HEIGHT:
                    tr["height"] = int.from_bytes(sb, "big")
                elif sid == COLOUR_SPACE:
                    tr["fourcc"] = sb
                elif sid == SAMPLING_FREQ:
                    tr["rate"] = int(struct.unpack(
                        ">d" if ssz == 8 else ">f", sb)[0])
                elif sid == CHANNELS:
                    tr["channels"] = int.from_bytes(sb, "big")
                elif sid == BIT_DEPTH:
                    tr["bits"] = int.from_bytes(sb, "big")
                p2 += ssz
        pos += size
    return tr


@register_element
class WebMMux(MatroskaMux):
    """webmmux: matroskamux restricted to the WebM doctype
    (gst/matroska/webm-mux.c — same writer, doctype 'webm')."""
    FACTORY = "webmmux"
    DESCRIPTION = "Muxes video/audio streams into a WebM stream"
    DOCTYPE = "webm"
    PROPERTIES = dict(MatroskaMux.PROPERTIES,
                      location=(str, "out.webm", "output path"))


@register_element
class MatroskaDemux(MultiStreamSourceElement):
    """matroskademux.

    Two modes, matching the reference's matroska-demux.c:
    - single-stream (backward compatible): the ALWAYS "src" pad with
      the `stream=` property selects one track;
    - one-parse multi-stream: linking sometimes-pads
      (`demux.video_0 ! …  demux.audio_0 ! …`) exposes a pad per
      track from a SINGLE file read + EBML parse — the pad-per-track
      behavior of the reference demuxer (sometimes src pads added on
      stream discovery, matroska-demux.c / qtdemux.c)."""
    FACTORY = "matroskademux"
    DESCRIPTION = "Demuxes Matroska/WebM streams into video/audio"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, Caps.any()),
        PadTemplate("video_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.SOMETIMES),
        PadTemplate("audio_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.SOMETIMES),
        PadTemplate("subtitle_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.SOMETIMES),
    ]
    PROPERTIES = {
        "location": (str, "", "mkv file path"),
        "stream": (str, "video", "video | audio | track number"),
    }

    _TRACK_KINDS = {1: "video", 2: "audio", 0x11: "subtitle"}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._loaded = False
        self._pos = 0
        self._adata = None              # decoded audio (n, ch) f32
        self._frames = None             # decoded video plane tuples
        self._children = None           # multi-stream per-pad readers

    # -- one-parse multi-stream mode --------------------------------------
    def _ensure_children(self) -> None:
        """Create per-pad track readers for every exposed pad; the
        container is read+parsed ONCE and shared (incrementally — a
        pad linked after the first exposure reuses the parse)."""
        if self._children is None:
            self._children = {}
        missing = [p for p in self.multi_pads()
                   if p.name not in self._children]
        if not missing:
            return
        parsed = getattr(self, "_parsed_shared", None)
        if parsed is None:
            parsed = _parse_matroska(self.props["location"],
                                     with_additions=True)
            self._parsed_shared = parsed
        tracks = parsed[0]
        by_kind = {}
        for tr in tracks:
            kind = self._TRACK_KINDS.get(tr.get("type"))
            if kind:
                by_kind.setdefault(kind, []).append(tr)
        for pad in missing:
            kind, _, idx = pad.name.rpartition("_")
            group = by_kind.get(kind, [])
            if int(idx) >= len(group):
                raise ValueError(
                    f"matroskademux: no {kind} track {idx} in "
                    f"{self.props['location']!r}")
            child = MatroskaDemux(
                name=f"{self.name}.{pad.name}",
                location=self.props["location"],
                stream=str(group[int(idx)]["number"]))
            child._preparsed = parsed
            child._load()
            if getattr(child, "HOST_ELEMENT", False):
                self.HOST_ELEMENT = True    # text cues are host data
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

    # -- single-stream mode (and per-track child readers) ------------------
    def _load(self):
        if self._loaded:
            return
        pre = getattr(self, "_preparsed", None)
        tracks, blocks, data, additions = (
            pre if pre is not None else _parse_matroska(
                self.props["location"], with_additions=True))
        sel = self.props["stream"]
        track = None
        for tr in tracks:
            if sel == str(tr.get("number")) or \
               (sel == "video" and tr.get("type") == 1) or \
               (sel == "audio" and tr.get("type") == 2) or \
               (sel in ("subtitle", "text")
                    and tr.get("type") == 0x11):
                track = tr
                break
        if track is None:
            raise ValueError(f"matroskademux: no stream {sel!r}")
        self._track = track
        picked = [k for k, b in enumerate(blocks)
                  if b[0] == track["number"]]
        self._blocks = [(blocks[k][1], blocks[k][2], blocks[k][3])
                        for k in picked]
        self._block_durs = [blocks[k][4] for k in picked]
        self._block_adds = [additions[k] if k < len(additions)
                            else None for k in picked]
        self._data = data
        self._coded = None
        if track.get("type") == 0x11:
            self._cues = [
                (ts * 1_000_000,
                 (ts + (dur if dur is not None else 1000))
                 * 1_000_000,
                 data[off:off + size].decode("utf-8", "replace"))
                for (ts, off, size), dur
                in zip(self._blocks, self._block_durs)]
            from ..core.structure import Structure
            self._info = None
            self._caps_override = Caps([Structure(
                "text/x-raw", {"format": "utf8"})])
            # text cues are host data — keep this instance out of
            # the fused device program
            self.HOST_ELEMENT = True
            self._loaded = True
            return
        if track.get("type") == 1:
            codec = track.get("codec")
            fd = track.get("frame_dur", 40_000_000)
            if codec == "V_MPEG4/ISO/AVC":
                self._coded = "video/x-h264"
            elif codec == "V_MPEGH/ISO/HEVC":
                self._coded = "video/x-h265"
            elif codec == "V_AV1":
                self._coded = "video/x-av1"
            elif codec == "V_MJPEG":
                self._coded = "image/jpeg"
            if self._coded:
                self._vdims = (track.get("width", 0),
                               track.get("height", 0),
                               Fraction(1_000_000_000, fd))
                self._params = b""
                if codec == "V_MPEG4/ISO/AVC" \
                        and track.get("codec_private"):
                    sps, pps = _parse_avcc(track["codec_private"])
                    self._params = b"".join(
                        b"\x00\x00\x00\x01" + n for n in sps + pps)
                elif codec == "V_MPEGH/ISO/HEVC" \
                        and track.get("codec_private"):
                    self._params = b"".join(
                        b"\x00\x00\x00\x01" + n
                        for n in _parse_hvcc(track["codec_private"]))
                self._info = None
                self._loaded = True
                return
            if codec == "V_THEORA":
                self._load_theora(track, fd)
                self._loaded = True
                return
            if codec in ("V_VP8", "V_VP9"):
                self._load_vpx(track, fd,
                               "vp8" if codec == "V_VP8" else "vp9")
                self._loaded = True
                return
            if codec != "V_UNCOMPRESSED":
                raise ValueError("matroskademux: unsupported codec "
                                 f"{codec!r}")
            fmt = FOURCC_VIDEO.get(track.get("fourcc", b""), "I420")
            self._info = VideoInfo(
                format=fmt, width=track["width"], height=track["height"],
                fps=Fraction(1_000_000_000, fd))
        else:
            codec = track.get("codec")
            if codec == "A_VORBIS":
                self._load_vorbis(track)
            elif codec in ("A_MPEG/L3", "A_MPEG/L2", "A_MPEG/L1"):
                self._load_mpeg_audio()
            elif codec and codec.startswith("A_AAC"):
                self._load_aac(track)
            elif codec == "A_OPUS":
                self._load_opus(track)
            elif codec == "A_PCM/INT/LIT":
                self._info = AudioInfo(format="S16LE",
                                       rate=track["rate"],
                                       channels=track.get("channels", 2))
            else:
                raise ValueError("matroskademux: unsupported codec "
                                 f"{codec!r}")
        self._loaded = True

    def _payloads(self) -> List[bytes]:
        return [self._data[off:off + size]
                for _, off, size in self._blocks]

    def _load_vorbis(self, track: dict) -> None:
        """A_VORBIS: three xiph-laced headers in CodecPrivate, one
        vorbis packet per block (matroska-ids.h GST_MATROSKA_CODEC_ID_
        AUDIO_VORBIS; decoded by the clean-room codecs/vorbis.py)."""
        from ..codecs.vorbis import VorbisDecoder
        hdrs = _parse_xiph_private(track.get("codec_private", b""))
        if len(hdrs) != 3:
            raise ValueError("matroskademux: bad vorbis CodecPrivate")
        dec = VorbisDecoder(hdrs[0], hdrs[2], hdrs[1])
        pcm = dec.decode_packets(self._payloads())
        self._adata = np.asarray(pcm, np.float32)
        self._info = AudioInfo(format="F32LE", rate=dec.rate,
                               channels=dec.channels)

    def _load_mpeg_audio(self) -> None:
        """A_MPEG/L3 (also L2/L1): whole frames per block; decoded by
        the clean-room codecs/mp3.py full-stream decoder."""
        from ..codecs import mp3 as pmp3
        pcm, rate, ch = pmp3.decode(b"".join(self._payloads()))
        self._adata = np.asarray(pcm, np.float32)
        self._info = AudioInfo(format="F32LE", rate=rate, channels=ch)

    def _load_opus(self, track: dict) -> None:
        """A_OPUS: CodecPrivate is the RFC 7845 OpusHead; blocks are
        raw opus packets (matroska-demux.c opus handling)."""
        from ..codecs import opus as popus
        priv = track.get("codec_private", b"")
        ch, pre_skip, _rate, gain = popus.parse_opus_head(priv)
        dec = popus.HybridOpusDecoder(ch)
        chunks = [dec.decode(p) for p in self._payloads()]
        pcm = (np.concatenate(chunks, axis=0) if chunks
               else np.zeros((0, ch), np.float32))
        if gain != 1.0:
            pcm = pcm * np.float32(gain)
        self._adata = pcm[pre_skip:]
        self._info = AudioInfo(format="F32LE", rate=48000, channels=ch)

    def _load_aac(self, track: dict) -> None:
        """A_AAC: CodecPrivate is the AudioSpecificConfig, blocks are
        raw access units (matroska codec-specs; decoded by the
        clean-room codecs/aac.py)."""
        from ..codecs import aac as paac
        priv = track.get("codec_private", b"")
        if not priv:
            raise ValueError("matroskademux: A_AAC without ASC")
        pcm, rate, ch = paac.decode_raw(priv, self._payloads())
        self._adata = np.asarray(pcm, np.float32)
        self._info = AudioInfo(format="F32LE", rate=rate, channels=ch)

    def _load_vpx(self, track: dict, frame_dur: int,
                  codec: str) -> None:
        """V_VP8 / V_VP9 (WebM tracks): one packet per block, no
        CodecPrivate; decoded by the libvpx-backed codecs/vpx.py.
        BlockAdditions carry an alpha VP8/VP9 stream (the WebM
        transparency convention; codec-alpha in the reference) —
        decoded as a second stream whose luma becomes the A plane
        (matroska-demux.c vp8/vp9 + codecalpha handling)."""
        from ..codecs import vpx as pvpx
        self._frames = pvpx.decode_packets(codec, self._payloads())
        if not self._frames:
            raise ValueError("matroskademux: empty vpx track")
        fmt = "I420"
        if any(a is not None for a in self._block_adds):
            adec = pvpx.VpxDecoder(codec)
            alphas = []
            for (off, size), frame in zip(
                    (a or (0, 0) for a in self._block_adds),
                    self._frames):
                if size:
                    outs = adec.decode(self._data[off:off + size])
                    alphas.append(outs[0][0] if outs
                                  else np.full_like(frame[0], 255))
                else:
                    alphas.append(np.full_like(frame[0], 255))
            self._frames = [f + (a,) for f, a in
                            zip(self._frames, alphas)]
            fmt = "A420"
        h, w = self._frames[0][0].shape
        fps = (Fraction(1_000_000_000, frame_dur) if frame_dur
               else Fraction(30, 1))
        self._info = VideoInfo(format=fmt,
                               width=track.get("width", w),
                               height=track.get("height", h), fps=fps)

    def _load_theora(self, track: dict, frame_dur: int) -> None:
        """V_THEORA: xiph-laced headers in CodecPrivate, one theora
        packet per block; zero-length blocks repeat the previous frame
        (matroska codec-specs)."""
        from ..codecs.theora import TheoraDecoder
        hdrs = _parse_xiph_private(track.get("codec_private", b""))
        if len(hdrs) != 3:
            raise ValueError("matroskademux: bad theora CodecPrivate")
        dec = TheoraDecoder(hdrs[0], hdrs[1], hdrs[2])
        frames = []
        for pkt in self._payloads():
            out = dec.decode_packet(pkt)
            if out is not None:
                frames.append(dec.crop(out))
            elif frames:
                frames.append(frames[-1])
        self._frames = frames
        fmt = ("I420" if dec.pixel_fmt == 0
               else "Y42B" if dec.pixel_fmt == 2 else "Y444")
        fps = (Fraction(1_000_000_000, frame_dur) if frame_dur
               else Fraction(dec.fps_n, dec.fps_d))
        self._info = VideoInfo(format=fmt, width=dec.pic_width,
                               height=dec.pic_height, fps=fps)

    def _coded_caps(self) -> Caps:
        from ..core.structure import Structure
        w, h, fps = self._vdims
        f = {"width": w, "height": h, "framerate": fps}
        if self._coded in ("video/x-h264", "video/x-h265"):
            f.update({"stream-format": "byte-stream",
                      "alignment": "au"})
        return Caps([Structure(self._coded, f)])

    def preview_blob(self) -> Optional[bytes]:
        """First coded block for downstream decoders' caps peeking."""
        try:
            self._load()
        except (OSError, ValueError):
            return None
        if getattr(self, "_coded", None) and self._blocks:
            _, off, size = self._blocks[0]
            return self._data[off:off + size]
        return None

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        if not self._loaded:
            caps = Caps.any()
        elif getattr(self, "_caps_override", None) is not None:
            caps = self._caps_override
        elif getattr(self, "_coded", None):
            caps = self._coded_caps()
        else:
            caps = Caps([self._info.to_caps_structure()])
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
        info = self._info
        if getattr(self, "_cues", None) is not None:
            if self._pos >= len(self._cues):
                return None
            s_ns, e_ns, txt = self._cues[self._pos]
            self._pos += 1
            return Buffer(data=[txt], batch=1, pts=s_ns,
                          duration=e_ns - s_ns,
                          meta={"cues": [(s_ns, e_ns, txt)]})
        if self._adata is not None:
            if self._pos >= len(self._adata):
                return None
            chunk = self._adata[self._pos:self._pos + 4096]
            rate = info.rate
            pts = self._pos * 1_000_000_000 // rate
            self._pos += len(chunk)
            return Buffer(data=chunk, batch=1, pts=pts,
                          duration=len(chunk) * 1_000_000_000 // rate)
        if self._frames is not None:
            if self._pos >= len(self._frames):
                return None
            take = self._frames[self._pos:self._pos + max(1, n_frames)]
            planes = tuple(np.stack([f[i] for f in take])
                           for i in range(len(take[0])))
            fps = info.fps
            dur = 1_000_000_000 * fps.denom // fps.num
            pts = self._pos * dur
            self._pos += len(take)
            return Buffer(data=planes, pts=pts, duration=dur,
                          batch=len(take))
        if self._pos >= len(self._blocks):
            return None
        if getattr(self, "_coded", None):
            take = self._blocks[self._pos:self._pos + max(1, n_frames)]
            blobs = []
            for ts, off, size in take:
                raw = self._data[off:off + size]
                if self._coded in ("video/x-h264", "video/x-h265"):
                    # length-prefixed sample -> Annex-B, parameter
                    # sets from CodecPrivate prepended on the first AU
                    au = bytearray(self._params if self._pos == 0
                                   and not blobs else b"")
                    p = 0
                    while p + 4 <= len(raw):
                        ln = struct.unpack(">I", raw[p:p + 4])[0]
                        au += b"\x00\x00\x00\x01" + raw[p + 4:p + 4 + ln]
                        p += 4 + ln
                    blobs.append(np.frombuffer(bytes(au), np.uint8))
                else:
                    blobs.append(np.frombuffer(raw, np.uint8))
            fps = self._vdims[2]
            pts = take[0][0] * 1_000_000
            dur = 1_000_000_000 * fps.denom // fps.num
            self._pos += len(take)
            return Buffer(data=blobs if len(blobs) > 1 else blobs[0],
                          pts=pts, duration=dur, batch=len(blobs),
                          meta={"caps": self._coded_caps()})
        if isinstance(info, VideoInfo):
            take = self._blocks[self._pos:self._pos + max(1, n_frames)]
            raws = np.stack([np.frombuffer(
                self._data[off:off + size], np.uint8)
                for _, off, size in take])
            planes = from_bytes(info.finfo, raws, info.width, info.height)
            fps = info.fps
            pts = take[0][0] * 1_000_000
            dur = 1_000_000_000 * fps.denom // fps.num
            self._pos += len(take)
            return Buffer(data=planes, pts=pts, duration=dur,
                          batch=len(take))
        ts, off, size = self._blocks[self._pos]
        self._pos += 1
        raw = np.frombuffer(self._data[off:off + size], np.uint8)
        samples = afmt.from_bytes(info.finfo, raw, info.channels)
        return Buffer(data=samples, pts=ts * 1_000_000, batch=1,
                      duration=samples.shape[0] * 1_000_000_000
                      // info.rate)
