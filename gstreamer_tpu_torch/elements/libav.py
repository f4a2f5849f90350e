"""gst-libav analog: avdec_*/avenc_* element families over the system
libavcodec (native/gtpu_av.cpp shim), plus the classic encoder names
x264enc / x265enc.

Reference: gst-libav/ext/libav/gstavviddec.c:1, gstavvidenc.c:1 (one
generated element per libavcodec codec); gst-plugins-ugly/ext/x264/
gstx264enc.c:1 and gst-plugins-bad/ext/x265/gstx265enc.c:1 (which
wrap the same libx264/libx265 the system libavcodec links).

Decoders are transforms consuming the coded buffers the demuxers
emit (video/x-h264 byte-stream etc.) and producing raw I420 batches;
encoders are transforms producing coded buffers the muxers accept.
Elements register only when the system build ships the codec.

A port of the JAX package's ``elements/libav.py``, with the same tables and
registration conditions (``native/av.py``'s ``available()`` and
``have_codec``).  Coded input stays host bytes (the decoders set
``HOST_INPUT``); decoded planes and PCM go to the element's device in one
copy; the encoders copy each tick's planes or samples to the host
(``host_array``).  As in the JAX package, a blob whose decode raises
``ValueError`` is skipped (ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, device_array, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve
from ..native import av as native_av


def _blobs_of(buf: Buffer) -> List[bytes]:
    if isinstance(buf.data, (list, tuple)):
        return [b if isinstance(b, (bytes, bytearray))
                else host_array(b).tobytes() for b in buf.data]
    arr = host_array(buf.data)
    if buf.batch > 1 and arr.ndim > 1:
        return [arr[k].tobytes() for k in range(buf.batch)]
    return [arr.tobytes()]


class _AvVideoDec(TransformElement):
    """Shared libavcodec video-decoder scaffold."""
    AV_CODEC = ""
    SINK_CAPS = ""
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._dec = None
        self._nout = 0
        self._fps = None
        self._decouple = True       # get a host_process(None) drain
        self._pending_buf = None

    def start(self):
        self._dec = None
        self._nout = 0

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            f = {"format": "I420"}
            if caps is not None and len(caps):
                s = caps[0]
                for k in ("width", "height", "framerate"):
                    v = s.get(k)
                    if v is not None:
                        f[k] = v
            from ..core.structure import Structure
            res = Caps([Structure("video/x-raw", f)])
        else:
            res = Caps.from_string(self.SINK_CAPS)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        s0 = incaps[0] if len(incaps) else None
        self._fps = s0.get("framerate") if s0 is not None else None
        self._wh = ((s0.get("width") or 0, s0.get("height") or 0)
                    if s0 is not None else (0, 0))

    def _emit(self, frames) -> Optional[Buffer]:
        if not frames:
            return None
        data = device_planes([np.stack([f[c] for f in frames])
                              for c in range(3)], resolve(self.device))
        fps = self._fps
        dur = None
        pts = None
        if fps is not None and getattr(fps, "num", 0):
            dur = 1_000_000_000 * fps.denom // fps.num
            pts = self._nout * dur
        self._nout += len(frames)
        return Buffer(data=data, batch=len(frames), pts=pts,
                      duration=dur)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:                      # EOS drain
            self._pending_buf = None
            if self._dec is None:
                return None
            return self._emit(self._dec.flush())
        if self._dec is None:
            cd = (buf.meta or {}).get("codec_data", b"")
            w, h = getattr(self, "_wh", (0, 0))
            self._dec = native_av.AvVideoDecoder(
                self.AV_CODEC, bytes(cd), w, h)
            self._pending_buf = True
        frames = []
        for blob in _blobs_of(buf):
            try:
                frames.extend(self._dec.decode(blob))
            except ValueError:
                continue
        return self._emit(frames)


class _AvVideoEnc(TransformElement):
    """Shared libavcodec video-encoder scaffold (1-in-1-out via
    zero-latency settings; tail drained at EOS)."""
    AV_CODEC = ""
    SRC_CAPS = ""
    DEFAULT_OPTS = ""
    GLOBAL_HEADER = False
    HOST_ELEMENT = True
    PROPERTIES = {
        "bitrate": (int, 2048, "bitrate in kbit/sec"),
        "options": (str, "", "extra codec options key=val:..."),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._enc = None
        self._info = None
        self._decouple = True
        self._pending_buf = None

    def start(self):
        self._enc = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            f = {}
            if caps is not None and len(caps):
                s = caps[0]
                for k in ("width", "height", "framerate"):
                    v = s.get(k)
                    if v is not None:
                        f[k] = v
            from ..core.structure import Structure
            base = Caps.from_string(self.SRC_CAPS)[0]
            base = type(base)(base.name, {**base.fields, **f})
            res = Caps([base])
        else:
            res = Caps.from_string("video/x-raw, format=I420")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        from ..video.info import VideoInfo
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def _ensure(self):
        if self._enc is not None:
            return
        vi = self._info
        fps = vi.fps
        fps = (fps.num, fps.denom) if fps and fps.num else (30, 1)
        opts = self.DEFAULT_OPTS
        extra = self.props.get("options", "")
        if extra:
            opts = f"{opts}:{extra}" if opts else extra
        self._enc = native_av.AvVideoEncoder(
            self.AV_CODEC, vi.width, vi.height, fps,
            self.props["bitrate"] * 1000, opts,
            global_header=self.GLOBAL_HEADER)
        self._pending_buf = True

    def _emit(self, pkts, pts=None,
              duration=None) -> Optional[Buffer]:
        if not pkts:
            return None
        blobs = [np.frombuffer(p, np.uint8) for p, _ in pkts]
        meta = {}
        cd = self._enc.extradata()
        if cd:
            meta["codec_data"] = cd
        return Buffer(data=blobs if len(blobs) > 1 else blobs[0],
                      batch=len(blobs), meta=meta, pts=pts,
                      duration=duration)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            self._pending_buf = None
            if self._enc is None:
                return None
            return self._emit(self._enc.flush())
        self._ensure()
        y, u, v = (host_array(p) for p in buf.data)
        if y.ndim == 2:
            y, u, v = y[None], u[None], v[None]
        pkts = []
        for k in range(y.shape[0]):
            pkts.extend(self._enc.encode((y[k], u[k], v[k])))
        return self._emit(pkts, pts=buf.pts, duration=buf.duration)


class _AvAudioDec(TransformElement):
    """Shared libavcodec audio-decoder scaffold (a52dec/dtsdec/...
    analogs, gst-libav gstavauddec.c:1): framed input from the
    audioparsers, interleaved F32 out."""
    AV_CODEC = ""
    SINK_CAPS = ""
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._dec = None
        self._nout = 0
        self._decouple = True
        self._pending_buf = None

    def start(self):
        self._dec = None
        self._nout = 0

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            f = {"format": "F32LE", "layout": "interleaved"}
            if caps is not None and len(caps):
                s = caps[0]
                for k in ("rate", "channels"):
                    v = s.get(k)
                    if v is not None:
                        f[k] = v
            from ..core.structure import Structure
            res = Caps([Structure("audio/x-raw", f)])
        else:
            res = Caps.from_string(self.SINK_CAPS)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def _emit(self, chunks) -> Optional[Buffer]:
        if not chunks:
            return None
        out = np.concatenate(chunks, axis=0).astype(np.float32)
        rate = self._dec.rate or 48000
        pts = self._nout * 1_000_000_000 // rate
        self._nout += len(out)
        return Buffer(data=device_array(out, resolve(self.device)),
                      batch=1, pts=pts,
                      duration=len(out) * 1_000_000_000 // rate)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            self._pending_buf = None
            if self._dec is None:
                return None
            return self._emit(self._dec.flush())
        if self._dec is None:
            meta = buf.meta or {}
            cd = meta.get("codec_data", b"")
            self._dec = native_av.AvAudioDecoder(
                self.AV_CODEC, bytes(cd),
                rate=int(meta.get("rate", 0) or 0),
                channels=int(meta.get("channels", 0) or 0),
                block_align=int(meta.get("block_align", 0) or 0))
            self._pending_buf = True
        chunks = []
        for blob in _blobs_of(buf):
            try:
                chunks.extend(self._dec.decode(blob))
            except ValueError:
                continue
        return self._emit(chunks)


class _AvAudioEnc(TransformElement):
    """Shared libavcodec audio-encoder scaffold (gst-libav
    gstavaudenc.c:1): raw interleaved audio in, coded packets out
    (accumulates to the codec frame size; tail flushed at EOS)."""
    AV_CODEC = ""
    SRC_CAPS = ""
    HOST_ELEMENT = True
    PROPERTIES = {
        "bitrate": (int, 192000, "bitrate in bits/sec"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._enc = None
        self._info = None
        self._acc = None
        self._decouple = True
        self._pending_buf = None

    def start(self):
        self._enc = None
        self._acc = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            f = {}
            if caps is not None and len(caps):
                s = caps[0]
                for k in ("rate", "channels"):
                    v = s.get(k)
                    if v is not None:
                        f[k] = v
            from ..core.structure import Structure
            base = Caps.from_string(self.SRC_CAPS)[0]
            res = Caps([type(base)(base.name,
                                   {**base.fields, **f})])
        else:
            res = Caps.from_string(
                "audio/x-raw, format={ F32LE, S16LE }, "
                "layout=interleaved")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        from ..audio.info import AudioInfo
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def _ensure(self):
        if self._enc is not None:
            return
        ai = self._info
        self._enc = native_av.AvAudioEncoder(
            self.AV_CODEC, ai.rate, ai.channels,
            self.props["bitrate"])
        self._acc = np.zeros((0, ai.channels), np.float32)
        self._pending_buf = True

    def _to_float(self, samples: np.ndarray) -> np.ndarray:
        if samples.dtype == np.int16:
            return samples.astype(np.float32) / 32768.0
        return samples.astype(np.float32)

    def _emit(self, pkts, pts=None) -> Optional[Buffer]:
        if not pkts:
            return None
        blobs = [np.frombuffer(p, np.uint8) for p in pkts]
        meta = {}
        cd = self._enc.extradata()
        if cd:
            meta["codec_data"] = cd
        return Buffer(data=blobs if len(blobs) > 1 else blobs[0],
                      batch=len(blobs), meta=meta, pts=pts)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            self._pending_buf = None
            if self._enc is None:
                return None
            pkts = []
            if len(self._acc):
                pkts = self._encode_frames(flush_tail=True)
            lib = self._enc._lib
            lib.gtpu_avaenc_send(self._enc._h, None)
            pkts.extend(self._enc._recv_all())
            return self._emit(pkts)
        self._ensure()
        samples = self._to_float(host_array(buf.data))
        if samples.ndim == 1:
            samples = samples[:, None]
        self._acc = np.concatenate([self._acc, samples], axis=0)
        return self._emit(self._encode_frames(), pts=buf.pts)

    def _encode_frames(self, flush_tail: bool = False):
        enc = self._enc
        fs = enc.frame_size
        pkts = []
        while len(self._acc) >= fs:
            frame = np.ascontiguousarray(self._acc[:fs])
            self._acc = self._acc[fs:]
            if enc._lib.gtpu_avaenc_send(enc._h,
                                         frame.ctypes.data) < 0:
                raise ValueError("av: audio encode error")
            pkts.extend(enc._recv_all())
        if flush_tail and len(self._acc):
            pad = np.zeros((fs - len(self._acc),
                            self._acc.shape[1]), np.float32)
            frame = np.ascontiguousarray(
                np.concatenate([self._acc, pad]))
            self._acc = self._acc[:0]
            if enc._lib.gtpu_avaenc_send(enc._h,
                                         frame.ctypes.data) >= 0:
                pkts.extend(enc._recv_all())
        return pkts


_H264_CAPS = ("video/x-h264, stream-format=byte-stream, "
              "alignment=au")
_H265_CAPS = ("video/x-h265, stream-format=byte-stream, "
              "alignment=au")

_DECODERS = [
    ("avdec_h264", "h264", _H264_CAPS,
     "libav H.264 decoder"),
    ("avdec_h265", "hevc", _H265_CAPS,
     "libav HEVC decoder"),
    ("avdec_mpeg2video", "mpeg2video",
     "video/mpeg, mpegversion=2, systemstream=false",
     "libav MPEG-2 video decoder"),
    ("avdec_mpeg4", "mpeg4",
     "video/mpeg, mpegversion=4, systemstream=false",
     "libav MPEG-4 part 2 decoder"),
    ("avdec_av1", "libdav1d", "video/x-av1",
     "AV1 decoder (dav1d)"),
    ("avdec_vp8", "vp8", "video/x-vp8",
     "libav VP8 decoder"),
    ("webpdec", "webp", "image/webp",
     "WebP image decoder"),
    ("avdec_ffv1", "ffv1", "video/x-ffv, ffvversion=1",
     "libav FFV1 lossless decoder"),
    ("avdec_vp9", "vp9", "video/x-vp9",
     "libav VP9 decoder"),
    ("avdec_wmv1", "wmv1", "video/x-wmv, wmvversion=1",
     "libav WMV 7 decoder"),
    ("avdec_wmv2", "wmv2", "video/x-wmv, wmvversion=2",
     "libav WMV 8 decoder"),
    ("avdec_wmv3", "wmv3", "video/x-wmv, wmvversion=3",
     "libav WMV 9 decoder"),
    ("avdec_rv10", "rv10", "video/x-pn-realvideo, rmversion=1",
     "libav RealVideo 1.0 decoder"),
    ("avdec_rv20", "rv20", "video/x-pn-realvideo, rmversion=2",
     "libav RealVideo 2.0 decoder"),
    ("avdec_rv30", "rv30", "video/x-pn-realvideo, rmversion=3",
     "libav RealVideo 3.0 decoder"),
    ("avdec_rv40", "rv40", "video/x-pn-realvideo, rmversion=4",
     "libav RealVideo 4.0 decoder"),
    ("avdec_dvvideo", "dvvideo", "video/x-dv, systemstream=false",
     "libav DV (Digital Video) decoder"),
]

_AUDIO_DECODERS = [
    ("a52dec", "ac3", "audio/x-ac3; audio/x-private1-ac3",
     "ATSC A/52 (AC-3) audio decoder"),
    ("avdec_eac3", "eac3", "audio/x-eac3",
     "libav E-AC-3 decoder"),
    ("dtsdec", "dca", "audio/x-dts; audio/x-private1-dts",
     "DTS Coherent Acoustics decoder"),
    ("avdec_wmav2", "wmav2", "audio/x-wma, wmaversion=2",
     "libav WMA v2 decoder"),
    ("avdec_opus", "libopus", "audio/x-opus",
     "Opus decoder (libopus, packet stream)"),
    ("sbcdec", "sbc", "audio/x-sbc",
     "SBC audio decoder"),
    ("speexdec", "libspeex", "audio/x-speex",
     "Speex decoder (libspeex)"),
    ("wavpackdec", "wavpack", "audio/x-wavpack",
     "WavPack decoder"),
    ("gsmdec", "libgsm", "audio/x-gsm",
     "GSM 06.10 decoder (libgsm)"),
    ("amrnbdec", "amrnb", "audio/AMR",
     "AMR narrowband decoder"),
    ("amrwbdec", "amrwb", "audio/AMR-WB",
     "AMR wideband decoder"),
    ("avdec_real_144", "real_144", "audio/x-pn-realaudio, raversion=1",
     "libav RealAudio 1.0 (14.4K) decoder"),
    ("avdec_real_288", "real_288", "audio/x-pn-realaudio, raversion=2",
     "libav RealAudio 2.0 (28.8K) decoder"),
    ("avdec_cook", "cook", "audio/x-pn-realaudio, raversion=8",
     "libav Cook (RealAudio G2) decoder"),
    ("avdec_sipr", "sipr", "audio/x-pn-realaudio, raversion=4",
     "libav RealAudio SIPR decoder"),
    ("avdec_atrac3", "atrac3", "audio/x-atrac3",
     "libav ATRAC3 decoder"),
]

_ENCODERS = [
    ("x264enc", "libx264", _H264_CAPS,
     "H.264 encoder (libx264)",
     "preset=veryfast:tune=zerolatency"),
    ("x265enc", "libx265", _H265_CAPS,
     "H.265 encoder (libx265)",
     "preset=veryfast:tune=zerolatency:x265-params=log-level=none"),
    ("av1enc", "libaom-av1", "video/x-av1",
     "AV1 encoder (libaom)", "usage=realtime:cpu-used=8"),
    ("avenc_vp8", "libvpx", "video/x-vp8",
     "VP8 encoder (libvpx, packet stream)", "deadline=1:lag-in-frames=0"),
    ("webpenc", "libwebp", "image/webp",
     "WebP image encoder (libwebp)", ""),
    ("avenc_ffv1", "ffv1", "video/x-ffv, ffvversion=1",
     "libav FFV1 lossless encoder", "", True),
    ("avenc_vp9", "libvpx-vp9", "video/x-vp9",
     "VP9 encoder (libvpx, packet stream)", "deadline=1:lag-in-frames=0"),
    ("avenc_mpeg2video", "mpeg2video",
     "video/mpeg, mpegversion=2, systemstream=false",
     "libav MPEG-2 video encoder", ""),
    ("avenc_mpeg4", "mpeg4",
     "video/mpeg, mpegversion=4, systemstream=false",
     "libav MPEG-4 part 2 encoder", ""),
]


def _make_dec(factory, codec, sink_caps, desc):
    cls = type(factory, (_AvVideoDec,), {
        "FACTORY": factory,
        "DESCRIPTION": desc,
        "AV_CODEC": codec,
        "SINK_CAPS": sink_caps,
        "PAD_TEMPLATES": [
            PadTemplate("sink", PadDirection.SINK, sink_caps),
            PadTemplate("src", PadDirection.SRC,
                        "video/x-raw, format=I420"),
        ],
    })
    register_element(cls)


def _make_enc(factory, codec, src_caps, desc, opts,
              global_header=False):
    cls = type(factory, (_AvVideoEnc,), {
        "FACTORY": factory,
        "DESCRIPTION": desc,
        "AV_CODEC": codec,
        "SRC_CAPS": src_caps,
        "DEFAULT_OPTS": opts,
        "GLOBAL_HEADER": global_header,
        "PAD_TEMPLATES": [
            PadTemplate("sink", PadDirection.SINK,
                        "video/x-raw, format=I420"),
            PadTemplate("src", PadDirection.SRC, src_caps),
        ],
    })
    register_element(cls)


_AUDIO_ENCODERS = [
    ("avenc_ac3", "ac3", "audio/x-ac3",
     "libav AC-3 encoder", 192000),
    ("avenc_aac", "aac", "audio/mpeg, mpegversion=4, "
                         "stream-format=raw, framed=true",
     "libav AAC-LC encoder", 128000),
    ("avenc_opus", "libopus", "audio/x-opus",
     "Opus encoder (libopus, packet stream)", 64000),
    ("lamemp3enc", "libmp3lame",
     "audio/mpeg, mpegversion=1, layer=3",
     "MP3 encoder (LAME)", 128000),
    ("sbcenc", "sbc", "audio/x-sbc",
     "SBC audio encoder", 0),
    ("twolamemp2enc", "libtwolame",
     "audio/mpeg, mpegversion=1, layer=2",
     "MPEG-1 layer 2 encoder (twolame)", 192000),
    ("speexenc", "libspeex", "audio/x-speex",
     "Speex encoder (libspeex)", 0),
    ("wavpackenc", "wavpack", "audio/x-wavpack",
     "WavPack lossless encoder", 0),
    ("gsmenc", "libgsm", "audio/x-gsm",
     "GSM 06.10 encoder (libgsm)", 13000),
]


def _make_aenc(factory, codec, src_caps, desc, bitrate):
    cls = type(factory, (_AvAudioEnc,), {
        "FACTORY": factory,
        "DESCRIPTION": desc,
        "AV_CODEC": codec,
        "SRC_CAPS": src_caps,
        "PROPERTIES": dict(
            _AvAudioEnc.PROPERTIES,
            bitrate=(int, bitrate, "bitrate in bits/sec")),
        "PAD_TEMPLATES": [
            PadTemplate("sink", PadDirection.SINK,
                        "audio/x-raw, format={ F32LE, S16LE }, "
                        "layout=interleaved"),
            PadTemplate("src", PadDirection.SRC, src_caps),
        ],
    })
    register_element(cls)


def _make_adec(factory, codec, sink_caps, desc):
    cls = type(factory, (_AvAudioDec,), {
        "FACTORY": factory,
        "DESCRIPTION": desc,
        "AV_CODEC": codec,
        "SINK_CAPS": sink_caps,
        "PAD_TEMPLATES": [
            PadTemplate("sink", PadDirection.SINK, sink_caps),
            PadTemplate("src", PadDirection.SRC,
                        "audio/x-raw, format=F32LE, "
                        "layout=interleaved"),
        ],
    })
    register_element(cls)


def codec_of(factory: str):
    """(libavcodec codec name, encoder?) of a factory of this module's
    tables, registered here or not; None for any other factory."""
    for table, enc in ((_DECODERS, False), (_AUDIO_DECODERS, False),
                       (_ENCODERS, True), (_AUDIO_ENCODERS, True)):
        for entry in table:
            if entry[0] == factory:
                return entry[1], enc
    if factory == "mpeg2enc":
        return "mpeg2video", True
    if factory in ("openaptxdec", "openaptxenc", "avdec_aptx",
                   "avdec_aptx_hd"):
        return "aptx", False
    return None


def why_missing(factory: str) -> str:
    """Why an av factory is not registered: the system has no libavcodec
    to build the shim on, or its libavcodec lacks the codec."""
    codec, enc = codec_of(factory)
    absent = native_av.missing()
    if absent is not None:
        return (f"the system libavcodec is missing ({absent}), so no "
                f"libav factory registers")
    return (f"the system libavcodec has no {codec!r} "
            f"{'encoder' if enc else 'decoder'}")


if native_av.available():
    for _f, _c, _caps, _d in _DECODERS:
        if native_av.have_codec(_c):
            _make_dec(_f, _c, _caps, _d)
    for _f, _c, _caps, _d in _AUDIO_DECODERS:
        if native_av.have_codec(_c):
            _make_adec(_f, _c, _caps, _d)
    for _f, _c, _caps, _d, _b in _AUDIO_ENCODERS:
        if native_av.have_codec(_c, encoder=True):
            _make_aenc(_f, _c, _caps, _d, _b)
    for _entry in _ENCODERS:
        _f, _c, _caps, _d, _o = _entry[:5]
        if native_av.have_codec(_c, encoder=True):
            _make_enc(_f, _c, _caps, _d, _o,
                      _entry[5] if len(_entry) > 5 else False)


if native_av.available() and native_av.have_codec("mpeg2video",
                                                  encoder=True):
    _make_enc("mpeg2enc", "mpeg2video",
              "video/mpeg, mpegversion=2, systemstream=false",
              "MPEG-2 video encoder (mpeg2enc analog)", "")


# ---------------------------------------------------------------------------
# aptX / aptX-HD (Bluetooth A2DP): the reference's openaptxenc/
# openaptxdec (gst-plugins-bad/ext/openaptx/gstopenaptxenc.c:1,
# gstopenaptxdec.c:1) wrap libopenaptx; mirroring that architecture,
# these wrap libavcodec's native aptX codec.  Caps match the
# reference: audio/aptx and audio/aptx-hd, stereo only.  gst-libav's
# avdec_aptx/avdec_aptx_hd names are registered as aliases.

class _AptxDecBase(_AvAudioDec):
    HOST_ELEMENT = True

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._rate = 48000
        self._variant = "aptx"

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        self._rate = int(s.get("rate") or 48000)
        self._variant = ("aptx_hd" if s.name == "audio/aptx-hd"
                         else "aptx")

    def host_process(self, buf):
        if buf is not None and self._dec is None:
            self._dec = native_av.AvAudioDecoder(
                self._variant, rate=self._rate, channels=2)
            self._pending_buf = True
        return super().host_process(buf)


class _AptxEncBase(_AvAudioEnc):
    """hd=true selects aptX-HD (the reference negotiates the variant
    from downstream caps; here it is a property — documented
    reduction)."""
    HOST_ELEMENT = True
    PROPERTIES = dict(_AvAudioEnc.PROPERTIES,
                      hd=(bool, False, "encode aptX-HD"))

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            name = "audio/aptx-hd" if self.props["hd"] else "audio/aptx"
            f = {"channels": 2}
            if caps is not None and len(caps):
                v = caps[0].get("rate")
                if v is not None:
                    f["rate"] = v
            from ..core.structure import Structure
            res = Caps([Structure(name, f)])
        else:
            res = Caps.from_string(
                "audio/x-raw, format={ F32LE, S16LE }, channels=2, "
                "layout=interleaved")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def _ensure(self):
        if self._enc is None:
            self.AV_CODEC = "aptx_hd" if self.props["hd"] else "aptx"
        super()._ensure()


def _make_aptx(factory_dec, factory_enc, desc):
    dec = type(factory_dec, (_AptxDecBase,), {
        "FACTORY": factory_dec,
        "DESCRIPTION": f"{desc} decoder (libavcodec)",
        "AV_CODEC": "aptx",
        "SINK_CAPS": "audio/aptx, channels=2; audio/aptx-hd, channels=2",
        "PAD_TEMPLATES": [
            PadTemplate("sink", PadDirection.SINK,
                        "audio/aptx, channels=2; "
                        "audio/aptx-hd, channels=2"),
            PadTemplate("src", PadDirection.SRC,
                        "audio/x-raw, format=F32LE, channels=2, "
                        "layout=interleaved"),
        ],
    })
    register_element(dec)
    if factory_enc:
        enc = type(factory_enc, (_AptxEncBase,), {
            "FACTORY": factory_enc,
            "DESCRIPTION": f"{desc} encoder (libavcodec)",
            "AV_CODEC": "aptx",
            "SRC_CAPS": "audio/aptx, channels=2",
            "PAD_TEMPLATES": [
                PadTemplate("sink", PadDirection.SINK,
                            "audio/x-raw, format={ F32LE, S16LE }, "
                            "channels=2, layout=interleaved"),
                PadTemplate("src", PadDirection.SRC,
                            "audio/aptx, channels=2; "
                            "audio/aptx-hd, channels=2"),
            ],
        })
        register_element(enc)


if native_av.available() and native_av.have_codec("aptx"):
    _make_aptx("openaptxdec", "openaptxenc", "aptX/aptX-HD audio")
    _make_aptx("avdec_aptx", None, "aptX audio")
    _make_aptx("avdec_aptx_hd", None, "aptX-HD audio")
