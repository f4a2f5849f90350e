"""flvmux / flvdemux — Adobe FLV container.

Port of gst-plugins-good/gst/flv/ (gstflvdemux.c / gstflvmux.c):
* sound format 3 = PCM little-endian (U8/S16LE),
  7 = G.711 A-law, 8 = G.711 mu-law (8 kHz), 10 = AAC
  (AACPacketType 0 = AudioSpecificConfig, 1 = raw AU; decoded by the
  clean-room codecs/aac.py);
* video tag (type 9) codec 7 = AVC: AVCPacketType 0 = avcC sequence
  header, 1 = length-prefixed NALUs (rebuilt to Annex-B);
  width/height recovered from the onMetaData AMF0 script tag;
* audio tag header byte = format<<4 | rate_code<<2 | size_bit<<1 |
  stereo_bit with rate codes {5512:0, 11025:1, 22050:2, 44100:3};
* file layout: "FLV" 0x01 flags(audio=0x04|video=0x01) dataoffset(9)
  then back-pointer-framed tags (types 8/9/18), 24-bit sizes, split
  24+8-bit timestamps.

The mux writes ONE stream per file (audio raw/law/AAC or H.264
video); the demux reads real-world A/V files with the `stream`
property selecting the track.

A port of the JAX package's ``elements/flv.py``: flvmux copies each tick
to the host (``host_array``); flvdemux gives host arrays that the
pipeline stages on its device.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)

_SINK_CAPS = ("audio/x-raw, format={ U8, S16LE }, "
              "rate={ 5512, 11025, 22050, 44100 }, channels=[1,2], "
              "layout=interleaved; "
              "audio/x-mulaw, rate=8000, channels=[1,2]; "
              "audio/x-alaw, rate=8000, channels=[1,2]; "
              "audio/mpeg, mpegversion=4, stream-format=raw; "
              "video/x-h264, stream-format=byte-stream, alignment=au")

_RATE_CODE = {5512: 0, 11025: 1, 22050: 2, 44100: 3}
_CODE_RATE = {v: k for k, v in _RATE_CODE.items()}


def _amf_double(name: str, value: float) -> bytes:
    return (struct.pack(">H", len(name)) + name.encode()
            + b"\x00" + struct.pack(">d", value))


def _amf_metadata(width: int, height: int, fps: float) -> bytes:
    """AMF0 onMetaData script payload (gstflvmux.c metadata tag)."""
    entries = (_amf_double("width", width)
               + _amf_double("height", height)
               + _amf_double("framerate", fps))
    return (b"\x02" + struct.pack(">H", 10) + b"onMetaData"
            + b"\x08" + struct.pack(">I", 3) + entries
            + b"\x00\x00\x09")


def _amf_find_double(payload: bytes, name: str) -> float:
    """Scan an AMF0 script payload for a named number property."""
    key = struct.pack(">H", len(name)) + name.encode() + b"\x00"
    i = payload.find(key)
    if i < 0 or i + len(key) + 8 > len(payload):
        return 0.0
    return struct.unpack(">d", payload[i + len(key):
                                       i + len(key) + 8])[0]


@register_element
class FlvMux(SinkElement):
    FACTORY = "flvmux"
    DESCRIPTION = "Muxes audio streams into a FLV stream"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, _SINK_CAPS)]
    PROPERTIES = {"location": (str, "out.flv", "output path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._file = None
        self._ts_ms = 0

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        self._mt = s.name
        self._avc = {}
        self._nframes = 0
        if self._mt == "audio/x-raw":
            self._ainfo = AudioInfo.from_caps_structure(s)
            self._fmt = 3
            self._rate = self._ainfo.rate
            self._channels = self._ainfo.channels
            self._width16 = self._ainfo.format == "S16LE"
        elif self._mt == "audio/mpeg":
            self._fmt = 10
            self._rate = s["rate"]
            self._channels = s["channels"]
            self._width16 = True
        elif self._mt == "video/x-h264":
            self._fmt = None
            fps = s.get("framerate")
            self._fps = (fps.num, fps.denom) if fps else (30, 1)
            self._wh = (s.get("width") or 0, s.get("height") or 0)
        else:
            self._fmt = 7 if self._mt == "audio/x-alaw" else 8
            self._rate = s["rate"]
            self._channels = s["channels"]
            self._width16 = False

    def start(self):
        self._file = open(self.props["location"], "wb")
        flags = 0x01 if self._mt == "video/x-h264" else 0x04
        self._file.write(b"FLV\x01" + bytes([flags])
                         + struct.pack(">I", 9))
        self._file.write(struct.pack(">I", 0))      # PreviousTagSize0
        self._ts_ms = 0
        self._hdr_written = False

    def _tag(self, ttype: int, ts_ms: int, payload: bytes):
        hdr = (bytes([ttype]) + len(payload).to_bytes(3, "big")
               + (ts_ms & 0xFFFFFF).to_bytes(3, "big")
               + bytes([(ts_ms >> 24) & 0xFF]) + b"\0\0\0")
        self._file.write(hdr + payload)
        self._file.write(struct.pack(">I", 11 + len(payload)))

    def _render_h264(self, buf: Buffer) -> str:
        from .container_elements import (_annexb_to_lenpref,
                                         _harvest_params, _make_avcc)
        blobs = buf.data if isinstance(buf.data, list) else [buf.data]
        num, den = self._fps
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            if not self._hdr_written:
                _harvest_params(raw, self._avc)
                if not self._avc.get("sps"):
                    continue
                if self._wh[0]:
                    self._tag(18, 0, _amf_metadata(
                        self._wh[0], self._wh[1],
                        self._fps[0] / self._fps[1]))
                avcc = _make_avcc(self._avc["sps"],
                                  self._avc.get("pps"))
                # frame_type 1 key | codec 7 AVC, pkt type 0, cts 0
                self._tag(9, 0, bytes([0x17, 0]) + b"\0\0\0" + avcc)
                self._hdr_written = True
            sample = _annexb_to_lenpref(raw)
            if not sample:
                continue
            ts = self._nframes * 1000 * den // num
            key = 0x17 if self._nframes == 0 else 0x27
            self._tag(9, ts, bytes([key, 1]) + b"\0\0\0" + sample)
            self._nframes += 1
        return "ok"

    def _render_aac(self, buf: Buffer) -> str:
        rate_code = _RATE_CODE.get(self._rate, 3)
        hdr = (10 << 4) | (rate_code << 2) | 0x02 \
            | (1 if self._channels == 2 else 0)
        if not self._hdr_written:
            from .isomp4 import _make_asc
            self._tag(8, 0, bytes([hdr, 0])
                      + _make_asc(self._rate, self._channels))
            self._hdr_written = True
        blobs = buf.data if isinstance(buf.data, list) else [buf.data]
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            ts = self._nframes * 1024 * 1000 // self._rate
            self._tag(8, ts, bytes([hdr, 1]) + raw)
            self._nframes += 1
        return "ok"

    def render(self, buf: Buffer) -> str:
        if self._mt == "video/x-h264":
            return self._render_h264(buf)
        if self._mt == "audio/mpeg":
            return self._render_aac(buf)
        x = host_array(buf.data)
        if x.ndim == 1:
            x = x[:, None]
        if self._mt == "audio/x-raw":
            raw = (x.astype("<i2").tobytes() if self._width16
                   else (x.astype(np.int64) & 0xFF).astype(
                       np.uint8).tobytes())
        else:
            raw = x.astype(np.uint8).tobytes()
        rate_code = _RATE_CODE.get(self._rate, 0)
        hdr = ((self._fmt << 4) | (rate_code << 2)
               | ((1 if self._width16 else 0) << 1)
               | (1 if self._channels == 2 else 0))
        ts = (buf.pts // 1_000_000 if buf.pts is not None
              else self._ts_ms)
        self._tag(8, int(ts), bytes([hdr]) + raw)
        self._ts_ms = int(ts) + len(x) * 1000 // self._rate
        return "ok"

    def stop(self):
        if self._file is not None:
            self._file.close()
            self._file = None


@register_element
class FlvDemux(SourceElement):
    FACTORY = "flvdemux"
    DESCRIPTION = "Demuxes FLV streams into audio and video"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "flv file path"),
        "stream": (str, "audio", "audio | video"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._tags = None
        self._pos = 0

    def _load(self):
        if self._tags is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        if data[:3] != b"FLV":
            raise ValueError("flvdemux: bad signature")
        off = struct.unpack(">I", data[5:9])[0]
        pos = off + 4
        audio, video, scripts = [], [], []
        while pos + 11 <= len(data):
            ttype = data[pos]
            size = int.from_bytes(data[pos + 1:pos + 4], "big")
            ts = int.from_bytes(data[pos + 4:pos + 7], "big") \
                | (data[pos + 7] << 24)
            payload = data[pos + 11:pos + 11 + size]
            if ttype == 8 and payload:
                audio.append((ts, payload))
            elif ttype == 9 and payload:
                video.append((ts, payload))
            elif ttype == 18 and payload:
                scripts.append(payload)
            pos += 11 + size + 4
        want = self.props.get("stream", "audio")
        if want == "video":
            self._load_video(video, scripts)
            self._tags = video
            return
        if not audio:
            raise ValueError("flvdemux: no audio tags")
        first_hdr = audio[0][1][0]
        fmt = first_hdr >> 4
        rate_code = (first_hdr >> 2) & 3
        width16 = (first_hdr >> 1) & 1
        stereo = first_hdr & 1
        channels = 2 if stereo else 1
        self._mode = None
        if fmt == 3:
            self._mt = "audio/x-raw"
            self._ainfo = AudioInfo(
                format="S16LE" if width16 else "U8",
                rate=_CODE_RATE[rate_code], channels=channels)
            self._caps = Caps([self._ainfo.to_caps_structure()])
        elif fmt == 10:
            self._load_aac(audio)
        elif fmt in (7, 8):
            self._mt = ("audio/x-alaw" if fmt == 7
                        else "audio/x-mulaw")
            self._rate = 8000
            self._channels = channels
            self._caps = Caps.from_string(
                f"{self._mt}, rate=8000, channels={channels}")
        else:
            raise ValueError(f"flvdemux: unsupported sound format {fmt}")
        self._width16 = bool(width16)
        self._tags = [(ts, pl[1:]) for ts, pl in audio]

    def _load_aac(self, audio) -> None:
        """Sound format 10: AACPacketType 0 carries the ASC; raw AUs
        decoded through the clean-room codecs/aac.py."""
        from ..codecs import aac as paac
        asc = b""
        frames = []
        for _ts, pl in audio:
            if len(pl) < 2:
                continue
            if pl[1] == 0:
                asc = pl[2:]
            else:
                frames.append(pl[2:])
        if not asc:
            raise ValueError("flvdemux: AAC stream without ASC")
        pcm, rate, ch = paac.decode_raw(asc, frames)
        self._mode = "decoded"
        self._adata = np.asarray(pcm, np.float32)
        self._mt = "audio/x-raw"
        self._ainfo = AudioInfo(format="F32LE", rate=rate,
                                channels=ch)
        self._caps = Caps([self._ainfo.to_caps_structure()])

    def _load_video(self, video, scripts) -> None:
        """Video tags, codec 7 = AVC (gstflvdemux.c video handling):
        avcC from the sequence-header packet, samples rebuilt to
        Annex-B."""
        from .container_elements import _parse_avcc
        if not video:
            raise ValueError("flvdemux: no video tags")
        codec = video[0][1][0] & 0x0F
        if codec != 7:
            raise ValueError(
                f"flvdemux: unsupported video codec {codec}")
        params = b""
        aus = []
        for ts, pl in video:
            if len(pl) < 5:
                continue
            pkt_type = pl[1]
            body = pl[5:]
            if pkt_type == 0:
                sps, pps = _parse_avcc(body)
                params = b"".join(b"\x00\x00\x00\x01" + n
                                  for n in sps + pps)
            elif pkt_type == 1:
                au = bytearray(params if not aus else b"")
                p2 = 0
                while p2 + 4 <= len(body):
                    ln = struct.unpack(">I", body[p2:p2 + 4])[0]
                    au += b"\x00\x00\x00\x01" + body[p2 + 4:p2 + 4 + ln]
                    p2 += 4 + ln
                aus.append((ts, bytes(au)))
        self._mode = "h264"
        self._aus = aus
        w = h = 0
        fps = 30.0
        for sc in scripts:
            w = int(_amf_find_double(sc, "width")) or w
            h = int(_amf_find_double(sc, "height")) or h
            fps = _amf_find_double(sc, "framerate") or fps
        f = {"stream-format": "byte-stream", "alignment": "au"}
        if w:
            f.update({"width": w, "height": h})
        from ..core.structure import Structure
        from ..core.value import Fraction
        f["framerate"] = Fraction(int(round(fps * 1000)), 1000)
        self._caps = Caps([Structure("video/x-h264", f)])
        self._mt = "video/x-h264"
        self._tags = aus

    def preview_blob(self):
        """First coded AU for downstream decoder caps peeking."""
        try:
            self._load()
        except (OSError, ValueError):
            return None
        if getattr(self, "_mode", None) == "h264" and self._aus:
            return self._aus[0][1]
        return None

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        caps = self._caps if self._tags is not None else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        mode = getattr(self, "_mode", None)
        if mode == "decoded":
            if self._pos >= len(self._adata):
                return None
        elif mode == "h264":
            if self._pos >= len(self._aus):
                return None
        elif self._pos >= len(self._tags):
            return None
        if getattr(self, "_mode", None) == "h264":
            take = self._aus[self._pos:self._pos + max(1, n_frames)]
            blobs = [np.frombuffer(a, np.uint8) for _, a in take]
            self._pos += len(take)
            return Buffer(data=blobs if len(blobs) > 1 else blobs[0],
                          pts=take[0][0] * 1_000_000,
                          batch=len(blobs),
                          meta={"caps": self._caps})
        if getattr(self, "_mode", None) == "decoded":
            if self._pos >= len(self._adata):
                return None
            chunk = self._adata[self._pos:self._pos + 4096]
            rate = self._ainfo.rate
            pts = self._pos * 1_000_000_000 // rate
            self._pos += len(chunk)
            return Buffer(data=chunk, batch=1, pts=pts,
                          duration=len(chunk) * 1_000_000_000 // rate)
        ts, raw = self._tags[self._pos]
        self._pos += 1
        if self._mt == "audio/x-raw":
            ch = self._ainfo.channels
            if self._width16:
                arr = np.frombuffer(raw, "<i2").reshape(-1, ch) \
                    .astype(np.int16)
            else:
                arr = np.frombuffer(raw, np.uint8).reshape(-1, ch)
            rate = self._ainfo.rate
        else:
            ch = self._channels
            arr = np.frombuffer(raw, np.uint8).reshape(-1, ch)
            rate = self._rate
        return Buffer(data=arr, batch=1, pts=ts * 1_000_000,
                      duration=len(arr) * 1_000_000_000 // rate)
