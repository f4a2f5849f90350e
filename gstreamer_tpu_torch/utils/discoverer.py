"""Discoverer — media introspection (pbutils equivalent).

Reference: subprojects/gst-plugins-base/gst-libs/gst/pbutils/
gstdiscoverer.c — synchronous/async URI introspection returning stream
topology, caps, and duration.

Covers the container/raw formats the framework ingests (y4m, wav, raw
with caps).  Returns a DiscovererInfo with video/audio stream infos.

A copy of the JAX package's ``utils/discoverer.py`` (host only): its
lazy imports are relative, so they load the port's container, QT, FLAC,
MP3 and format modules.  ADTS AAC is reported as AAC (``_discover_adts``),
where the JAX package reports an MP3 stream of a wrong duration.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional

from ..core.caps import Caps
from ..core.value import Fraction


@dataclass
class StreamInfo:
    kind: str                  # "video" | "audio" | "unknown"
    caps: Optional[Caps] = None
    width: int = 0
    height: int = 0
    fps: Optional[Fraction] = None
    rate: int = 0
    channels: int = 0
    format: str = ""


@dataclass
class DiscovererInfo:
    uri: str
    duration_ns: Optional[int] = None
    streams: List[StreamInfo] = field(default_factory=list)

    @property
    def video_streams(self):
        return [s for s in self.streams if s.kind == "video"]

    @property
    def audio_streams(self):
        return [s for s in self.streams if s.kind == "audio"]


class Discoverer:
    """gst_discoverer_discover_uri equivalent for supported inputs."""

    def discover(self, path: str) -> DiscovererInfo:
        if path.startswith("file://"):
            path = path[7:]
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path, "rb") as f:
            head = f.read(64)
        info = DiscovererInfo(uri=path)
        if head.startswith(b"YUV4MPEG2 "):
            self._discover_y4m(path, head, info)
        elif head.startswith(b"RIFF") and head[8:12] == b"WAVE":
            self._discover_wav(path, info)
        elif head.startswith(b"RIFF") and head[8:12] == b"AVI ":
            self._discover_avi(path, info)
        elif head.startswith(b"\x1a\x45\xdf\xa3"):
            self._discover_matroska(path, info)
        elif head[4:8] == b"ftyp" or head[4:8] in (b"moov", b"mdat",
                                                   b"wide"):
            self._discover_qt(path, info)
        elif head.startswith(b"fLaC"):
            self._discover_flac(path, info)
        elif head.startswith(b"OggS"):
            self._discover_ogg(path, info)
        elif head.startswith(b"\xff") and (head[1] & 0xF6) == 0xF0:
            self._discover_adts(path, info)
        elif head.startswith(b"\xff") and (head[1] & 0xE0) == 0xE0 \
                or head.startswith(b"ID3"):
            self._discover_mp3(path, info)
        else:
            info.streams.append(StreamInfo(kind="unknown"))
        return info

    def _discover_avi(self, path, info):
        from ..elements.container_elements import (FOURCC_VIDEO,
                                                   _parse_avi)
        streams, chunks, _ = _parse_avi(path)
        for st in streams:
            if st["type"] == b"vids":
                fps = (Fraction(st["rate"], st["scale"])
                       if st["scale"] else None)
                fmt = FOURCC_VIDEO.get(st.get("compression", b""),
                                       st.get("compression",
                                              b"").decode("latin-1"))
                info.streams.append(StreamInfo(
                    kind="video", width=st.get("width", 0),
                    height=st.get("height", 0), fps=fps, format=fmt))
                if fps and st.get("length"):
                    info.duration_ns = (st["length"] * 1_000_000_000
                                        * fps.denom // fps.num)
            elif st["type"] == b"auds":
                info.streams.append(StreamInfo(
                    kind="audio", rate=st.get("arate", 0),
                    channels=st.get("channels", 0)))

    def _discover_matroska(self, path, info):
        from ..elements.container_elements import (FOURCC_VIDEO,
                                                   _parse_matroska)
        tracks, blocks, _ = _parse_matroska(path)
        last_ts = max((b[1] for b in blocks), default=0)
        info.duration_ns = last_ts * 1_000_000 or None
        for tr in tracks:
            if tr.get("type") == 1:
                fd = tr.get("frame_dur")
                info.streams.append(StreamInfo(
                    kind="video", width=tr.get("width", 0),
                    height=tr.get("height", 0),
                    fps=(Fraction(1_000_000_000, fd) if fd else None),
                    format=tr.get("codec", "")))
            elif tr.get("type") == 2:
                info.streams.append(StreamInfo(
                    kind="audio", rate=tr.get("rate", 0),
                    channels=tr.get("channels", 0),
                    format=tr.get("codec", "")))

    def _discover_qt(self, path, info):
        from ..elements.isomp4 import _parse_qt
        tracks, _ = _parse_qt(path)
        for tr in tracks:
            dur = (tr["duration"] * 1_000_000_000 // tr["timescale"]
                   if tr["timescale"] else None)
            if dur and (info.duration_ns is None
                        or dur > info.duration_ns):
                info.duration_ns = dur
            fourcc = tr["fourcc"].decode("latin-1")
            if tr["handler"] == b"vide":
                w = h = 0
                entry = tr.get("entry") or b""
                if len(entry) >= 28:
                    w, h = struct.unpack(">HH", entry[24:28])
                info.streams.append(StreamInfo(
                    kind="video", width=w, height=h, format=fourcc))
            elif tr["handler"] == b"soun":
                rate = ch = 0
                entry = tr.get("entry") or b""
                if len(entry) >= 28:
                    ch = struct.unpack(">H", entry[16:18])[0]
                    rate = struct.unpack(">I", entry[24:28])[0] >> 16
                info.streams.append(StreamInfo(
                    kind="audio", rate=rate, channels=ch,
                    format=fourcc))

    def _discover_flac(self, path, info):
        from ..codecs.flac import parse_stream_header
        with open(path, "rb") as f:
            data = f.read(65536)
        si, _ = parse_stream_header(data)
        info.duration_ns = (si.total_samples * 1_000_000_000
                            // si.sample_rate
                            if si.sample_rate and si.total_samples
                            else None)
        info.streams.append(StreamInfo(
            kind="audio", rate=si.sample_rate, channels=si.channels,
            format=f"FLAC-{si.bps}bit",
            caps=Caps.from_string(
                f"audio/x-flac, rate={si.sample_rate}, "
                f"channels={si.channels}")))

    def _discover_ogg(self, path, info):
        with open(path, "rb") as f:
            data = f.read(65536)
        # FLAC-in-Ogg mapping (RFC 3533 page 0 BOS payload)
        seg_count = data[26]
        payload = data[27 + seg_count:]
        if payload.startswith(b"\x7fFLAC"):
            from ..codecs.flac import parse_stream_header
            si, _ = parse_stream_header(payload[9:])
            info.duration_ns = (si.total_samples * 1_000_000_000
                                // si.sample_rate
                                if si.sample_rate and si.total_samples
                                else None)
            info.streams.append(StreamInfo(
                kind="audio", rate=si.sample_rate,
                channels=si.channels, format="FLAC"))
        elif payload.startswith(b"\x01vorbis"):
            import struct as _s
            channels = payload[11]
            rate = _s.unpack("<I", payload[12:16])[0]
            info.duration_ns = self._ogg_duration(path, rate)
            info.streams.append(StreamInfo(
                kind="audio", rate=rate, channels=channels,
                format="Vorbis"))
        elif payload.startswith(b"OggS"):
            info.streams.append(StreamInfo(kind="unknown",
                                           format="ogg"))
        elif payload.startswith(b"OpusHead"):
            import struct as _s
            channels = payload[9]
            pre_skip = _s.unpack("<H", payload[10:12])[0]
            dur = self._ogg_duration(path, 48000)
            if dur is not None:
                dur = max(0, dur - pre_skip * 1_000_000_000 // 48000)
            info.duration_ns = dur
            info.streams.append(StreamInfo(
                kind="audio", rate=48000, channels=channels,
                format="Opus"))
        elif payload.startswith(b"\x80theora"):
            fmbw = (payload[10] << 8) | payload[11]
            fmbh = (payload[12] << 8) | payload[13]
            picw = int.from_bytes(payload[14:17], "big")
            pich = int.from_bytes(payload[17:20], "big")
            fps_n = int.from_bytes(payload[22:26], "big")
            fps_d = int.from_bytes(payload[26:30], "big")
            info.streams.append(StreamInfo(
                kind="video", width=picw or fmbw * 16,
                height=pich or fmbh * 16,
                fps=(Fraction(fps_n, fps_d) if fps_d else None),
                format="Theora"))
        else:
            info.streams.append(StreamInfo(kind="unknown",
                                           format="ogg"))

    @staticmethod
    def _ogg_duration(path, rate):
        """Final granule position scan (gstoggdemux duration query)."""
        import struct as _s
        with open(path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            f.seek(max(0, size - 65536))
            tail = f.read()
        pos = tail.rfind(b"OggS")
        while pos >= 0:
            if pos + 14 <= len(tail):
                gran = _s.unpack("<q", tail[pos + 6:pos + 14])[0]
                if gran >= 0 and rate:
                    return gran * 1_000_000_000 // rate
            pos = tail.rfind(b"OggS", 0, pos)
        return None

    def _discover_adts(self, path, info):
        """ADTS AAC (layer bits 00, which MPEG audio never has; the JAX
        package reads it as MP3, ROADMAP.md section 3): the first header's
        rate and channels, the duration of its frames at 1024 samples a
        frame (gstaacparse.c)."""
        from ..elements.audioparsers import _ADTS_RATES, adts_frame_len
        with open(path, "rb") as f:
            data = f.read()
        rate = _ADTS_RATES[(data[2] >> 2) & 0xF]
        channels = ((data[2] & 1) << 2) | (data[3] >> 6)
        frames, pos = 0, 0
        while pos + 7 <= len(data):
            size = adts_frame_len(data[pos:pos + 7])
            if size is None or size < 7:
                break
            frames += 1
            pos += size
        info.duration_ns = (frames * 1024 * 1_000_000_000 // rate
                            if rate else None)
        version = 2 if data[1] & 0x08 else 4
        info.streams.append(StreamInfo(
            kind="audio", rate=rate, channels=channels, format="AAC",
            caps=Caps.from_string(
                f"audio/mpeg, mpegversion={version}, stream-format=adts, "
                f"rate={rate}, channels={channels}")))

    def _discover_mp3(self, path, info):
        from ..elements.audioparsers import mp3_frame_info
        with open(path, "rb") as f:
            data = f.read(65536)
        pos = 0
        if data.startswith(b"ID3"):
            sz = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
                | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
            pos = 10 + sz
        fi = None
        while pos < len(data) - 4:
            fi = mp3_frame_info(data[pos:pos + 8])
            if fi:
                break
            pos += 1
        if fi:
            frame_len, version, layer, rate, channels = fi
            spf = 384 if layer == 1 else (
                1152 if version == 1 or layer == 2 else 576)
            size = os.path.getsize(path) - pos
            n_frames = max(1, size // max(1, frame_len))
            info.duration_ns = (n_frames * spf * 1_000_000_000
                                // rate if rate else None)
            info.streams.append(StreamInfo(
                kind="audio", rate=rate, channels=channels,
                format="MP3",
                caps=Caps.from_string(
                    f"audio/mpeg, mpegversion=1, layer={layer}, "
                    f"rate={rate}, channels={channels}")))
        else:
            info.streams.append(StreamInfo(kind="unknown"))

    def _discover_y4m(self, path, head, info):
        hdr = head.split(b"\n", 1)[0].decode()
        params = {tok[0]: tok[1:] for tok in hdr.split()[1:]}
        w, h = int(params.get("W", 0)), int(params.get("H", 0))
        fps = params.get("F", "30:1").split(":")
        fpsf = Fraction(int(fps[0]), int(fps[1]))
        fmt = {"420": "I420", "420jpeg": "I420", "420mpeg2": "I420",
               "422": "Y42B", "444": "Y444", "mono": "GRAY8",
               }.get(params.get("C", "420jpeg"), "I420")
        from ..video.format import format_info, frame_size
        fsz = frame_size(format_info(fmt), w, h) + 6
        n_frames = (os.path.getsize(path) - len(hdr) - 1) // fsz
        dur = (n_frames * 1_000_000_000 * fpsf.denom // fpsf.num
               if fpsf.num else None)
        info.duration_ns = dur
        info.streams.append(StreamInfo(
            kind="video", width=w, height=h, fps=fpsf, format=fmt,
            caps=Caps.from_string(
                f"video/x-raw, format={fmt}, width={w}, height={h}, "
                f"framerate={fpsf.num}/{fpsf.denom}")))

    def _discover_wav(self, path, info):
        with open(path, "rb") as f:
            data = f.read(256)
        # minimal RIFF/fmt parse
        pos = 12
        rate = channels = bits = 0
        audio_fmt = 1
        data_size = None
        size = os.path.getsize(path)
        while pos + 8 <= len(data):
            cid = data[pos:pos + 4]
            csz = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            if cid == b"fmt ":
                audio_fmt, channels, rate = struct.unpack(
                    "<HHI", data[pos + 8:pos + 16])
                bits = struct.unpack("<H", data[pos + 22:pos + 24])[0]
            if cid == b"data":
                data_size = csz
                break
            pos += 8 + csz + (csz & 1)
        if data_size is None:
            data_size = size - 44
        fmt = {8: "U8", 16: "S16LE", 24: "S24LE", 32: "S32LE"}.get(bits,
                                                                   "S16LE")
        if audio_fmt == 3:
            fmt = "F32LE" if bits == 32 else "F64LE"
        bpf = max(1, (bits // 8) * channels)
        dur = (data_size // bpf) * 1_000_000_000 // rate if rate else None
        info.duration_ns = dur
        info.streams.append(StreamInfo(
            kind="audio", rate=rate, channels=channels, format=fmt,
            caps=Caps.from_string(
                f"audio/x-raw, format={fmt}, rate={rate}, "
                f"channels={channels}, layout=interleaved")))
