"""vorbisdec / vorbisenc / opusdec / opusenc — Xiph lossy audio codecs.

Reference: gst-plugins-base/ext/vorbis/gstvorbisdec.c:1 /
gstvorbisenc.c:1 and ext/opus/gstopusdec.c:1 / gstopusenc.c:1.

Decode side for Vorbis is the clean-room spec implementation in
codecs/vorbis.py (batched-matmul IMDCT); Vorbis analysis and the Opus
codec wrap the system libraries exactly as the reference elements do.

Collapsed pull/sink style following flacenc/flacdec (flac_elements.py):
encoders accumulate raw audio and write one Ogg file at EOS; decoders
are location-based sources streaming decoded F32 audio.

A port of the JAX package's ``elements/xiph.py``: the decoders give host
arrays that the pipeline stages on its device; the encoders copy each
tick to the host (``host_array``).  opusdec decodes with the port's
``codecs/opus.py`` (the clean-room CELT and SILK paths, libopus for a
mode-transition packet); opusenc needs the system libopus and raises
``RuntimeError`` without it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, TransformElement,
                            register_element)

_RAW_SINK = ("audio/x-raw, format={ F32LE, S16LE }, "
             "rate=[1,655350], channels=[1,8], layout=interleaved")
_F32_SRC = ("audio/x-raw, format=F32LE, rate=[1,655350], "
            "channels=[1,8], layout=interleaved")


class _OggAudioDec(SourceElement):
    """Shared location-based decoder scaffold."""
    PROPERTIES = {
        "location": (str, "", "ogg file path"),
        "blocksize": (int, 4096, "frames per output buffer"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._samples = None
        self._pos = 0

    def _decode(self, data: bytes):
        raise NotImplementedError

    def _load(self):
        if self._samples is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        pcm, rate, ch = self._decode(data)
        self._samples = np.asarray(pcm, np.float32)
        self._ainfo = AudioInfo(format="F32LE", rate=rate, channels=ch)
        self._pos = 0

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError, RuntimeError):
                return Caps.any()
        caps = (Caps([self._ainfo.to_caps_structure()])
                if self._samples is not None else Caps.any())
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._samples):
            return None
        take = self.props["blocksize"]
        chunk = self._samples[self._pos:self._pos + take]
        rate = self._ainfo.rate
        pts = self._pos * 1_000_000_000 // rate
        self._pos += len(chunk)
        return Buffer(data=chunk, batch=1, pts=pts,
                      duration=len(chunk) * 1_000_000_000 // rate)


@register_element
class VorbisDec(_OggAudioDec):
    FACTORY = "vorbisdec"
    DESCRIPTION = "decode raw vorbis streams to float audio"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, _F32_SRC)]

    def _decode(self, data: bytes):
        from ..codecs import vorbis as pvorbis
        return pvorbis.decode_ogg(data)


@register_element
class OpusDec(_OggAudioDec):
    FACTORY = "opusdec"
    DESCRIPTION = "decode opus streams to float audio"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, _F32_SRC)]

    def _decode(self, data: bytes):
        from ..codecs import opus as popus
        return popus.decode_ogg(data)


class _OggAudioEnc(SinkElement):
    """Shared accumulate-and-write encoder scaffold."""

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._chunks: List[np.ndarray] = []
        self._info: Optional[AudioInfo] = None

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def start(self):
        self._chunks = []

    def render(self, buf: Buffer) -> str:
        x = host_array(buf.data)
        if x.ndim == 1:
            x = x[:, None]
        self._chunks.append(x)
        return "ok"

    def _pcm_float(self) -> np.ndarray:
        pcm = np.concatenate(self._chunks, axis=0)
        if self._info.format == "S16LE":
            pcm = pcm.astype(np.float32) / 32768.0
        return np.asarray(pcm, np.float32)

    def _encode(self, pcm: np.ndarray) -> bytes:
        raise NotImplementedError

    def stop(self):
        if self._info is None or not self._chunks:
            return
        blob = self._encode(self._pcm_float())
        with open(self.props["location"], "wb") as f:
            f.write(blob)
        self._chunks = []


@register_element
class VorbisEnc(_OggAudioEnc):
    FACTORY = "vorbisenc"
    DESCRIPTION = "Encodes audio in Vorbis format (libvorbisenc)"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, _RAW_SINK)]
    PROPERTIES = {
        "location": (str, "out.ogg", "output path"),
        "quality": (float, 0.4, "VBR quality -0.1 .. 1.0"),
    }

    def _encode(self, pcm: np.ndarray) -> bytes:
        from ..codecs import vorbis_enc
        return vorbis_enc.encode_ogg(pcm, self._info.rate,
                                     self.props["quality"])


@register_element
class OpusEnc(TransformElement):
    """opusenc (gst-plugins-base/ext/opus/gstopusenc.c): raw 48 kHz
    audio -> audio/x-opus packet stream (20 ms frames).  `location`
    optionally writes an Ogg-Opus file at EOS (the earlier sink-style
    use); linked downstream it feeds rtpopuspay/avdec_opus etc."""
    FACTORY = "opusenc"
    DESCRIPTION = "Encodes audio in Opus format (libopus)"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format={ F32LE, S16LE }, "
                    "rate=48000, channels=[1,2], "
                    "layout=interleaved"),
        PadTemplate("src", PadDirection.SRC, "audio/x-opus"),
    ]
    PROPERTIES = {
        "location": (str, "", "optional Ogg-Opus dump path"),
        "bitrate": (int, 64000, "target bitrate (bps)"),
        "frame-size": (int, 20, "frame duration (ms)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._enc = None
        self._acc = None
        self._pcm_all = []
        self._info = None
        self._decouple = True
        self._pending_buf = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = Caps.from_string("audio/x-opus, rate=48000")
        else:
            res = Caps.from_string(
                "audio/x-raw, format={ F32LE, S16LE }, rate=48000, "
                "layout=interleaved")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def start(self):
        self._enc = None
        self._acc = None
        self._pcm_all = []
        self._pending_buf = True

    def _frame_len(self) -> int:
        return 48 * self.props["frame-size"]

    def _to_i16(self, x: np.ndarray) -> np.ndarray:
        if x.ndim == 1:
            x = x[:, None]
        if x.dtype != np.int16:
            x = np.clip(np.asarray(x, np.float64) * 32768.0,
                        -32768, 32767).astype(np.int16)
        return x

    def host_process(self, buf):
        from ..codecs import opus as popus
        if buf is None:
            self._pending_buf = None
            pkts = []
            if self._acc is not None and len(self._acc):
                pad = self._frame_len() - len(self._acc)
                tail = np.concatenate(
                    [self._acc, np.zeros((pad, self._acc.shape[1]),
                                         np.int16)])
                pkts.append(self._enc.encode(tail))
                self._acc = None
            if self.props["location"] and self._pcm_all:
                pcm = np.concatenate(self._pcm_all)
                blob = popus.encode_ogg(pcm, 48000,
                                        self.props["bitrate"])
                with open(self.props["location"], "wb") as f:
                    f.write(blob)
            if not pkts:
                return None
            return Buffer(data=[np.frombuffer(p, np.uint8)
                                for p in pkts], batch=len(pkts))
        x = self._to_i16(host_array(buf.data))
        if self.props["location"]:
            self._pcm_all.append(x)
        if self._enc is None:
            self._enc = popus.OpusEncoder(
                x.shape[1], self.props["bitrate"],
                self._frame_len())
        self._acc = (x if self._acc is None
                     else np.concatenate([self._acc, x]))
        n = self._frame_len()
        pkts = []
        while len(self._acc) >= n:
            pkts.append(self._enc.encode(self._acc[:n]))
            self._acc = self._acc[n:]
        if not pkts:
            return None
        return buf.with_(data=[np.frombuffer(p, np.uint8)
                               for p in pkts])


@register_element
class TheoraDec(SourceElement):
    """theoradec (collapsed source like the audio decoders here):
    Ogg/Theora file in, raw planar video out.  Decode is the
    clean-room codecs/theora.py (bit-exact vs libtheoradec)."""
    FACTORY = "theoradec"
    DESCRIPTION = "decode raw theora streams to raw YUV video"
    PAD_TEMPLATES = [PadTemplate(
        "src", PadDirection.SRC,
        "video/x-raw, format={ I420, Y42B, Y444 }")]
    PROPERTIES = {"location": (str, "", "ogg file path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frames = None
        self._pos = 0

    def _load(self):
        if self._frames is not None:
            return
        from ..codecs.theora import decode_ogg
        with open(self.props["location"], "rb") as f:
            data = f.read()
        frames, fps, dims, dec = decode_ogg(data, with_info=True)
        self._frames = frames
        self._fmt = {0: "I420", 2: "Y42B", 3: "Y444"}[dec.pixel_fmt]
        self._dims = dims
        self._fps = fps
        self._pos = 0

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        if self._frames is None:
            return Caps.any()
        from ..core.value import Fraction
        from ..core.structure import Structure
        w, h = self._dims
        n, d = self._fps
        caps = Caps([Structure("video/x-raw", {
            "format": self._fmt, "width": w, "height": h,
            "framerate": Fraction(n, d)})])
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int):
        if self._pos >= len(self._frames):
            return None
        take = self._frames[self._pos:self._pos + n_frames]
        data = tuple(np.stack([f[c] for f in take])
                     for c in range(3))
        n, d = self._fps
        pts = (self._pos * 1_000_000_000 * d // n) if n else None
        dur = 1_000_000_000 * d // n if n else None
        self._pos += len(take)
        return Buffer(data=data, batch=len(take), pts=pts,
                      duration=dur)


@register_element
class TheoraEnc(SinkElement):
    """theoraenc (libtheoraenc-backed, exactly like the reference
    element): raw 4:2:0 video in, Ogg/Theora file out."""
    FACTORY = "theoraenc"
    DESCRIPTION = "encode raw YUV video into a theora stream"
    PAD_TEMPLATES = [PadTemplate(
        "sink", PadDirection.SINK, "video/x-raw, format=I420")]
    PROPERTIES = {
        "location": (str, "out.ogv", "output path"),
        "quality": (int, 48, "encoder quality 0..63"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frames = []
        self._info = None

    def set_info(self, incaps, outcaps):
        from ..video.info import VideoInfo
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def start(self):
        self._frames = []

    def render(self, buf: Buffer) -> str:
        y, cb, cr = (host_array(p) for p in buf.data)
        if y.ndim == 2:
            y, cb, cr = y[None], cb[None], cr[None]
        for k in range(y.shape[0]):
            self._frames.append((y[k], cb[k], cr[k]))
        return "ok"

    def stop(self):
        if not self._frames or self._info is None:
            return
        from ..codecs.theora_enc import encode_ogg
        fps = self._info.fps
        blob = encode_ogg(self._frames, self._info.width,
                          self._info.height,
                          (fps.num, fps.denom) if fps and fps.num
                          else (30, 1),
                          quality=self.props["quality"])
        with open(self.props["location"], "wb") as f:
            f.write(blob)
        self._frames = []


@register_element
class TheoraParse(TransformElement):
    """theoraparse (gst-plugins-base/ext/theora/gsttheoraparse.c):
    passes framed theora packets through, attaching caps parsed from
    the ident header (packets arrive framed from the demuxers in
    this model)."""
    FACTORY = "theoraparse"
    DESCRIPTION = "parse raw theora streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/x-theora"),
        PadTemplate("src", PadDirection.SRC, "video/x-theora"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._caps = None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("video/x-theora")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf):
        if buf is None:
            return None
        import numpy as np
        blobs = buf.data if isinstance(buf.data, list) else [buf.data]
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            if raw.startswith(b"\x80theora"):
                from ..codecs.theora import TheoraDecoder
                try:
                    dec = TheoraDecoder.__new__(TheoraDecoder)
                    dec._parse_ident(raw)
                    from ..core.structure import Structure
                    from ..core.value import Fraction
                    self._caps = Caps([Structure("video/x-theora", {
                        "width": dec.pic_width,
                        "height": dec.pic_height,
                        "framerate": Fraction(dec.fps_n,
                                              dec.fps_d)})])
                except Exception:
                    pass
        if self._caps is not None:
            return buf.with_(meta=dict(buf.meta or {},
                                       caps=self._caps))
        return buf


@register_element
class OpusParse(TransformElement):
    """opusparse (gst-plugins-base/ext/opus/gstopusparse.c):
    passthrough for framed opus packets with duration derived from
    the TOC byte (RFC 6716 §3.1)."""
    FACTORY = "opusparse"
    DESCRIPTION = "parses opus audio"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-opus"),
        PadTemplate("src", PadDirection.SRC, "audio/x-opus"),
    ]

    _FRAME_MS = [10, 20, 40, 60]

    @staticmethod
    def packet_duration_ns(pkt: bytes) -> int:
        """Opus packet duration from the TOC byte (RFC 6716)."""
        if not pkt:
            return 0
        toc = pkt[0]
        config = toc >> 3
        code = toc & 0x3
        if config < 12:                  # SILK: 10/20/40/60 ms
            ms = [10, 20, 40, 60][config % 4]
        elif config < 16:                # hybrid: 10/20 ms
            ms = [10, 20][config % 2]
        else:                            # CELT: 2.5/5/10/20 ms
            ms = [2.5, 5, 10, 20][config % 4]
        nframes = {0: 1, 1: 2, 2: 2}.get(code)
        if nframes is None:
            nframes = pkt[1] & 0x3F if len(pkt) > 1 else 1
        return int(ms * nframes * 1_000_000)

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("audio/x-opus")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf):
        if buf is None:
            return None
        import numpy as np
        blobs = buf.data if isinstance(buf.data, list) else [buf.data]
        total = 0
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            total += self.packet_duration_ns(raw)
        return buf.with_(duration=total or buf.duration)
