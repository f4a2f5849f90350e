"""oggmux / oggdemux — Ogg container with the FLAC mapping.

References: gst-plugins-base/ext/ogg/ (gstoggmux.c page writer,
gstoggdemux.c) and the Ogg bitstream spec (RFC 3533) + the
"FLAC-to-Ogg mapping" spec:
* pages: "OggS" v0, header-type (0x02 BOS / 0x04 EOS / 0x01 cont),
  64-bit granulepos (LE), serial, page sequence, CRC-32 poly
  0x04C11DB7 (non-reflected, init/xorout 0, computed with the CRC
  field zeroed), 255-lacing segmentation;
* FLAC mapping: BOS packet = 0x7F "FLAC" 1.0 + 16-bit BE header count
  + "fLaC" + STREAMINFO block; audio packets are FLAC frames with
  granulepos = last finished sample.

Collapsed like the other containers here (avimux precedent): since
the only Ogg-mappable codec in this framework is our FLAC, oggmux is
the flacenc!oggmux!filesink chain in one element (raw audio in,
location out) and oggdemux is filesrc!oggdemux!flacdec (location in,
raw audio out).  The page layer itself is codec-agnostic
(ogg_pages/parse_ogg_pages below).

A port of the JAX package's ``elements/ogg.py``: the page layer is a
copy (``ogg_page`` writes whole packets only, as the JAX package's does:
ROADMAP.md section 3); oggdemux gives host arrays that the pipeline
stages on its device, oggmux copies each tick's samples to the host
(``host_array``).  Ogg-Opus decodes through the port's ``codecs/opus.py``,
Ogg-Speex through the port's ``native/av.py`` (libspeex in the system
libavcodec), as in the JAX package.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)

_SINK_CAPS = ("audio/x-raw, format={ S8, S16LE, S24LE, S32LE }, "
              "rate=[1,655350], channels=[1,8], layout=interleaved")
_FMT_BPS = {"S8": 8, "S16LE": 16, "S24LE": 24, "S32LE": 32}
_BPS_FMT = {v: k for k, v in _FMT_BPS.items()}


def _make_crc_table():
    tab = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if c & 0x80000000 \
                else (c << 1) & 0xFFFFFFFF
        tab.append(c)
    return tab


_CRC = _make_crc_table()


def ogg_crc(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFFFFFF) ^ _CRC[((c >> 24) ^ b) & 0xFF]
    return c


def ogg_page(packets: List[bytes], serial: int, seq: int,
             granulepos: int, bos: bool = False, eos: bool = False
             ) -> bytes:
    """Write one page holding whole packets (no spanning)."""
    lacing = bytearray()
    body = bytearray()
    for p in packets:
        n = len(p)
        while n >= 255:
            lacing.append(255)
            n -= 255
        lacing.append(n)
        body += p
    if len(lacing) > 255:
        raise ValueError("ogg: too many segments for one page")
    htype = (0x02 if bos else 0) | (0x04 if eos else 0)
    hdr = struct.pack("<4sBBqIII", b"OggS", 0, htype,
                      granulepos, serial, seq, 0)
    hdr += bytes([len(lacing)]) + bytes(lacing)
    page = bytearray(hdr + bytes(body))
    crc = ogg_crc(bytes(page))
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


def parse_ogg_pages(data: bytes):
    """-> list of (serial, granulepos, packets) with CRC verification;
    packets spanning pages are reassembled."""
    out = []
    pos = 0
    partial = {}
    while pos + 27 <= len(data):
        if data[pos:pos + 4] != b"OggS":
            raise ValueError("ogg: lost page sync")
        (magic, ver, htype, granule, serial, seq,
         crc) = struct.unpack("<4sBBqIII", data[pos:pos + 26])
        nseg = data[pos + 26]
        lacing = data[pos + 27:pos + 27 + nseg]
        body_off = pos + 27 + nseg
        body_len = sum(lacing)
        page = bytearray(data[pos:body_off + body_len])
        page[22:26] = b"\0\0\0\0"
        if ogg_crc(bytes(page)) != crc:
            raise ValueError("ogg: page CRC mismatch")
        packets = []
        cur = bytearray(partial.pop(serial, b""))
        off = body_off
        for i, lace in enumerate(lacing):
            cur += data[off:off + lace]
            off += lace
            if lace < 255:
                packets.append(bytes(cur))
                cur = bytearray()
        if cur:
            partial[serial] = bytes(cur)
        out.append((serial, granule, packets))
        pos = body_off + body_len
    return out


@register_element
class OggMux(SinkElement):
    FACTORY = "oggmux"
    DESCRIPTION = "mux FLAC-coded audio into the ogg container"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, _SINK_CAPS)]
    PROPERTIES = {
        "location": (str, "out.ogg", "output path"),
        "blocksize": (int, 4096, "FLAC frame blocksize"),
        "serial": (int, 0x6774_7075, "ogg stream serial number"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._chunks: List[np.ndarray] = []

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def start(self):
        self._chunks = []

    def render(self, buf: Buffer) -> str:
        x = host_array(buf.data)
        if x.ndim == 1:
            x = x[:, None]
        self._chunks.append(np.asarray(x, np.int64))
        return "ok"

    def stop(self):
        if not self._chunks:
            return
        from ..codecs import flac as pyflac

        samples = np.concatenate(self._chunks, axis=0)
        n, nch = samples.shape
        bps = _FMT_BPS[self._info.format]
        rate = self._info.rate
        blocksize = self.props["blocksize"]
        serial = self.props["serial"] & 0xFFFFFFFF

        import hashlib
        md5 = hashlib.md5()
        md5.update(pyflac._md5_raw_bytes(samples, (bps + 7) // 8))
        stream_hdr = pyflac.encode_streaminfo(
            n, rate, nch, bps, blocksize, md5.digest())
        # FLAC->Ogg mapping BOS packet
        # header-count field: packets AFTER the BOS packet (none here)
        bos = (b"\x7fFLAC\x01\x00" + struct.pack(">H", 0)
               + stream_hdr)
        pages = [ogg_page([bos], serial, 0, 0, bos=True)]
        seq = 1
        done = 0
        nframes = -(-n // blocksize)
        for fi, lo in enumerate(range(0, n, blocksize)):
            frame = pyflac.encode_frame(
                samples[lo:lo + blocksize], fi, rate, bps, blocksize)
            done = min(lo + blocksize, n)
            # one frame per page (small frames could share; the
            # reference also flushes per packet for FLAC)
            pages.append(ogg_page([frame], serial, seq, done,
                                  eos=(fi == nframes - 1)))
            seq += 1
        with open(self.props["location"], "wb") as f:
            for p in pages:
                f.write(p)
        self._chunks = []


@register_element
class OggDemux(SourceElement):
    """oggdemux (collapsed with flacdec: the payload is decoded to raw
    audio, matching how the raw-codec demuxers here expose content)."""
    FACTORY = "oggdemux"
    DESCRIPTION = "demux ogg streams (FLAC, Vorbis, Opus, Theora)"
    PAD_TEMPLATES = [PadTemplate(
        "src", PadDirection.SRC,
        "audio/x-raw, format={ S8, S16LE, S24LE, S32LE, F32LE }, "
        "rate=[1,655350], channels=[1,8], layout=interleaved; "
        "video/x-raw, format={ I420, Y42B, Y444 }")]
    PROPERTIES = {
        "location": (str, "", "ogg file path"),
        "blocksize": (int, 4096, "frames per output buffer"),
        "stream": (str, "", "pick 'audio' or 'video' in A/V files"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._samples = None

    def _load(self):
        if self._samples is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        pages = parse_ogg_pages(data)
        streams: dict = {}
        order: List[int] = []
        for serial, granule, pkts in pages:
            if serial not in streams:
                order.append(serial)
            streams.setdefault(serial, []).extend(pkts)
        if not streams:
            raise ValueError("oggdemux: empty stream")
        want = self.props.get("stream", "")
        packets = None
        for serial in order:
            pkts = streams[serial]
            if not pkts:
                continue
            is_video = pkts[0].startswith(b"\x80theora")
            if want == "video" and is_video:
                packets = pkts
                break
            if want == "audio" and not is_video:
                packets = pkts
                break
            if not want:
                packets = pkts
                break
        if packets is None:
            raise ValueError(f"oggdemux: no {want or 'known'} stream")
        bos = packets[0]
        if bos.startswith(b"\x7fFLAC"):
            self._load_flac(packets)
        elif bos.startswith(b"\x01vorbis"):
            # Vorbis-over-Ogg mapping: clean-room decoder
            from ..codecs import vorbis as pvorbis
            pcm, rate, ch = pvorbis.decode_ogg(data)
            self._samples = np.asarray(pcm, np.float32)
            self._ainfo = AudioInfo(format="F32LE", rate=rate,
                                    channels=ch)
        elif bos.startswith(b"OpusHead"):
            # RFC 7845 Ogg-Opus (the port's codecs/opus.py)
            from ..codecs import opus as popus
            pcm, rate, ch = popus.decode_ogg(data)
            self._samples = np.asarray(pcm, np.float32)
            self._ainfo = AudioInfo(format="F32LE", rate=rate,
                                    channels=ch)
        elif bos.startswith(b"Speex   "):
            # Ogg-Speex mapping: header packet + comment, then
            # fixed-size frames (speexdec wraps libspeex exactly as
            # gst-plugins-good/ext/speex/gstspeexdec.c does)
            from ..native import av as native_av
            rate = struct.unpack("<I", bos[36:40])[0]
            ch = struct.unpack("<I", bos[48:52])[0]
            dec = native_av.AvAudioDecoder("libspeex", bos)
            chunks = []
            for pkt in packets[2:]:
                chunks.extend(dec.decode(pkt))
            chunks.extend(dec.flush())
            pcm = (np.concatenate(chunks) if chunks
                   else np.zeros((0, ch), np.float32))
            self._samples = np.asarray(pcm, np.float32)
            self._ainfo = AudioInfo(format="F32LE", rate=rate,
                                    channels=max(ch, 1))
        elif bos.startswith(b"\x80theora"):
            from ..codecs.theora import TheoraDecoder
            if len(packets) < 3:
                raise ValueError("oggdemux: truncated theora headers")
            dec = TheoraDecoder(packets[0], packets[1], packets[2])
            frames = []
            for pkt in packets[3:]:
                out = dec.decode_packet(pkt)
                if out is not None:
                    frames.append(dec.crop(out))
            self._video = frames
            self._vinfo = ("I420" if dec.pixel_fmt == 0
                           else "Y42B" if dec.pixel_fmt == 2
                           else "Y444",
                           dec.pic_width, dec.pic_height,
                           dec.fps_n, dec.fps_d)
            self._samples = np.zeros((0, 1), np.int16)   # marker
        else:
            raise ValueError("oggdemux: unsupported ogg mapping")
        self._pos = 0

    def _load_flac(self, packets: List[bytes]) -> None:
        from ..codecs import flac as pyflac
        from ..native import flac as nflac

        nheaders = struct.unpack(">H", packets[0][7:9])[0]
        stream_hdr = packets[0][9:]
        if not stream_hdr.startswith(b"fLaC"):
            raise ValueError("oggdemux: bad FLAC mapping header")
        # rebuild a plain FLAC stream: header + audio frames
        blob = stream_hdr + b"".join(packets[1 + nheaders:])
        res = nflac.decode(blob)
        if res is not None:
            samples, rate, ch, bps = res
        else:
            samples, si = pyflac.decode(blob)
            rate, ch, bps = si.sample_rate, si.channels, si.bps
        fmt = _BPS_FMT.get(bps)
        if fmt is None:
            raise ValueError(f"oggdemux: unsupported bps {bps}")
        dt = {"S8": np.int8, "S16LE": np.int16, "S24LE": np.int32,
              "S32LE": np.int32}[fmt]
        self._samples = np.asarray(samples).astype(dt)
        self._ainfo = AudioInfo(format=fmt, rate=rate, channels=ch)

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        if getattr(self, "_video", None) is not None:
            from ..core.structure import Structure
            from ..core.value import Fraction
            fmt, w, h, fn, fd = self._vinfo
            caps = Caps([Structure("video/x-raw", {
                "format": fmt, "width": w, "height": h,
                "framerate": Fraction(fn, fd)})])
        else:
            caps = (Caps([self._ainfo.to_caps_structure()])
                    if self._samples is not None else Caps.any())
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if getattr(self, "_video", None) is not None:
            if self._pos >= len(self._video):
                return None
            take = self._video[self._pos:self._pos + n_frames]
            data = tuple(np.stack([f[c] for f in take])
                         for c in range(3))
            _, _, _, fn, fd = self._vinfo
            pts = self._pos * 1_000_000_000 * fd // fn if fn else None
            dur = 1_000_000_000 * fd // fn if fn else None
            self._pos += len(take)
            return Buffer(data=data, batch=len(take), pts=pts,
                          duration=dur)
        if self._pos >= len(self._samples):
            return None
        take = self.props["blocksize"]
        chunk = self._samples[self._pos:self._pos + take]
        rate = self._ainfo.rate
        pts = self._pos * 1_000_000_000 // rate
        self._pos += len(chunk)
        return Buffer(data=chunk, batch=1, pts=pts,
                      duration=len(chunk) * 1_000_000_000 // rate)
