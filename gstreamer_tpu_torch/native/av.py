"""ctypes bindings for the libavcodec shim (native/gtpu_av.cpp) —
the gst-libav analog.

Reference: gst-libav/ext/libav/gstavviddec.c:1 / gstavvidenc.c:1 /
gstavauddec.c:1 — the reference wraps libavcodec for exactly these
codec families; nothing is reimplemented there.

A copy of the JAX package's ``native/av.py``: the same ctypes signatures,
decoders, encoders and file writers over the same C++ source, which the
port builds through ``native/_build.py`` into ``gstreamer_tpu_torch/_build/``.
Where the JAX loader returns None on any failed build, the condition here
is explicit: ``missing()`` names what the system lacks (g++, libavcodec's
headers, or its libraries to link), and then ``available()`` is False and
no av factory registers, as in the JAX package on such a machine.  Where
the system has them, a failed compile or load raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from . import _build

_LIBS = ("avcodec", "avformat", "avutil", "swscale")
_HEADERS = ("libavcodec/avcodec.h", "libavformat/avformat.h",
            "libavutil/imgutils.h", "libavutil/opt.h",
            "libavutil/channel_layout.h", "libswscale/swscale.h")
_FLAGS = tuple(f"-l{n}" for n in _LIBS)

_lib = None


@functools.lru_cache(maxsize=None)
def missing() -> Optional[str]:
    """What the system lacks to build native/gtpu_av.cpp, or None: g++,
    the headers it includes, or the libraries it links."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "no g++"
    src = "".join(f"#include <{h}>\n" for h in _HEADERS)
    proc = subprocess.run([gxx, "-E", "-x", "c++", "-o", os.devnull, "-"],
                          input=src, capture_output=True, text=True,
                          timeout=60)
    if proc.returncode != 0:
        return "no libavcodec headers (" + ", ".join(_HEADERS) + ")"
    absent = [n for n in _LIBS if not os.path.isabs(subprocess.run(
        [gxx, f"-print-file-name=lib{n}.so"], capture_output=True,
        text=True, timeout=60).stdout.strip())]
    if absent:
        return "no " + ", ".join(f"lib{n}.so" for n in absent) + " to link"
    return None


def get_lib():
    """The bound library; None where ``missing()`` names something the
    system lacks.  A failed build or load raises."""
    global _lib
    if _lib is not None or missing() is not None:
        return _lib
    lib = _build.load("gtpu_av", _FLAGS)
    lib.gtpu_avdec_new.restype = ctypes.c_void_p
    lib.gtpu_avdec_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int]
    lib.gtpu_avdec_new2.restype = ctypes.c_void_p
    lib.gtpu_avdec_new2.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.gtpu_av_write_rm.restype = ctypes.c_int
    lib.gtpu_av_write_rm.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    lib.gtpu_avdec_free.argtypes = [ctypes.c_void_p]
    lib.gtpu_avdec_send.restype = ctypes.c_int
    lib.gtpu_avdec_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_long]
    lib.gtpu_avdec_recv_video.restype = ctypes.c_long
    lib.gtpu_avdec_recv_video.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.gtpu_avdec_recv_audio.restype = ctypes.c_long
    lib.gtpu_avdec_recv_audio.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.gtpu_avenc_new.restype = ctypes.c_void_p
    lib.gtpu_avenc_new.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_long, ctypes.c_char_p, ctypes.c_int]
    lib.gtpu_avenc_free.argtypes = [ctypes.c_void_p]
    lib.gtpu_avenc_send_frame.restype = ctypes.c_int
    lib.gtpu_avenc_send_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p]
    lib.gtpu_avenc_recv_packet.restype = ctypes.c_long
    lib.gtpu_avenc_recv_packet.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int)]
    lib.gtpu_avenc_extradata.restype = ctypes.c_long
    lib.gtpu_avenc_extradata.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.gtpu_av_have_codec.restype = ctypes.c_int
    lib.gtpu_av_have_codec.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.gtpu_avaenc_new.restype = ctypes.c_void_p
    lib.gtpu_avaenc_new.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_long]
    lib.gtpu_avaenc_frame_size.restype = ctypes.c_int
    lib.gtpu_avaenc_frame_size.argtypes = [ctypes.c_void_p]
    lib.gtpu_avaenc_send.restype = ctypes.c_int
    lib.gtpu_avaenc_send.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gtpu_av_write_asf.restype = ctypes.c_int
    lib.gtpu_av_write_asf.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
    lib.gtpu_av_write_mxf.restype = ctypes.c_int
    lib.gtpu_av_write_mxf.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
    lib.gtpu_av_probe.restype = ctypes.c_long
    lib.gtpu_av_probe.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_long]
    lib.gtpu_av_quiet.restype = None
    lib.gtpu_av_quiet()
    _lib = lib
    return _lib




def available() -> bool:
    return get_lib() is not None


def write_asf(path: str, w: int = 160, h: int = 120,
              nframes: int = 25, with_video: bool = True) -> bool:
    """Write a real WMA(+WMV) ASF file via libavformat (test input)."""
    lib = get_lib()
    return bool(lib) and lib.gtpu_av_write_asf(
        path.encode(), w, h, nframes, 1 if with_video else 0) == 0


def write_mxf(path: str, w: int = 160, h: int = 120,
              nframes: int = 25) -> bool:
    """Write a real OP1a MXF (mpeg2video + PCM) via libavformat."""
    lib = get_lib()
    return bool(lib) and lib.gtpu_av_write_mxf(
        path.encode(), w, h, nframes) == 0


def probe(path: str):
    """Demux any container with libavformat; returns per-stream dicts
    (interop oracle for the framework's own muxer outputs)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(1 << 16)
    r = lib.gtpu_av_probe(path.encode(), buf, len(buf))
    if r < 0:
        return None
    out = []
    for line in buf.value.decode().splitlines():
        idx, name, typ, extra, npkt, nbytes = line.split()
        out.append({"index": int(idx), "codec": name, "type": typ,
                    "extradata_size": int(extra),
                    "packets": int(npkt), "bytes": int(nbytes)})
    return out


def have_codec(name: str, encoder: bool = False) -> bool:
    lib = get_lib()
    return bool(lib and lib.gtpu_av_have_codec(name.encode(),
                                               1 if encoder else 0))


class AvVideoDecoder:
    """Any libavcodec video decoder -> I420 plane tuples."""

    def __init__(self, codec: str, extradata: bytes = b"",
                 width: int = 0, height: int = 0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("av: libavcodec shim unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.gtpu_avdec_new(
            codec.encode(), extradata or None, len(extradata),
            width, height))
        if not self._h.value:
            raise RuntimeError(f"av: no decoder {codec!r}")
        self._buf = np.empty(1 << 20, np.uint8)

    def _recv_all(self):
        lib = self._lib
        out = []
        w = ctypes.c_int()
        h = ctypes.c_int()
        while True:
            r = lib.gtpu_avdec_recv_video(
                self._h, self._buf.ctypes.data, len(self._buf),
                ctypes.byref(w), ctypes.byref(h))
            if r < 0:
                self._buf = np.empty(-r, np.uint8)
                continue
            if r == 0:
                break
            W, H = w.value, h.value
            cw, ch_ = (W + 1) // 2, (H + 1) // 2
            y = self._buf[:W * H].reshape(H, W).copy()
            u = self._buf[W * H:W * H + cw * ch_].reshape(
                ch_, cw).copy()
            v = self._buf[W * H + cw * ch_:
                          W * H + 2 * cw * ch_].reshape(ch_, cw).copy()
            out.append((y, u, v))
        return out

    def decode(self, packet: bytes):
        if self._lib.gtpu_avdec_send(self._h, packet,
                                     len(packet)) < 0:
            raise ValueError("av: decode error")
        return self._recv_all()

    def flush(self):
        self._lib.gtpu_avdec_send(self._h, None, 0)
        return self._recv_all()

    def __del__(self):
        try:
            self._lib.gtpu_avdec_free(self._h)
        except Exception:
            pass


class AvAudioDecoder:
    """Any libavcodec audio decoder -> float32 interleaved."""

    def __init__(self, codec: str, extradata: bytes = b"",
                 rate: int = 0, channels: int = 0,
                 block_align: int = 0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("av: libavcodec shim unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.gtpu_avdec_new2(
            codec.encode(), extradata or None, len(extradata),
            rate, channels, block_align))
        if not self._h.value:
            raise RuntimeError(f"av: no decoder {codec!r}")
        self._buf = np.empty(1 << 18, np.float32)
        self.rate = 0
        self.channels = 0

    def _recv_all(self):
        lib = self._lib
        out = []
        rate = ctypes.c_int()
        ch = ctypes.c_int()
        while True:
            # cap is in FLOATS (total interleaved capacity); the C
            # side returns -(n*channels) when it would not fit, so a
            # stream with any channel count resizes safely.
            r = lib.gtpu_avdec_recv_audio(
                self._h, self._buf.ctypes.data, len(self._buf),
                ctypes.byref(rate), ctypes.byref(ch))
            if r < 0:
                self._buf = np.empty(-r * 2, np.float32)
                continue
            if r == 0:
                break
            self.rate = rate.value
            self.channels = ch.value
            out.append(self._buf[:r * ch.value].reshape(
                r, ch.value).copy())
        return out

    def decode(self, packet: bytes):
        if self._lib.gtpu_avdec_send(self._h, packet,
                                     len(packet)) < 0:
            raise ValueError("av: decode error")
        return self._recv_all()

    def flush(self):
        self._lib.gtpu_avdec_send(self._h, None, 0)
        return self._recv_all()

    def __del__(self):
        try:
            self._lib.gtpu_avdec_free(self._h)
        except Exception:
            pass


class AvAudioEncoder:
    """Any libavcodec audio encoder over float interleaved input."""

    def __init__(self, codec: str, rate: int, channels: int,
                 bitrate: int = 0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("av: libavcodec shim unavailable")
        self._lib = lib
        self.rate = rate
        self.channels = channels
        self._h = ctypes.c_void_p(lib.gtpu_avaenc_new(
            codec.encode(), rate, channels, bitrate))
        if not self._h.value:
            raise RuntimeError(f"av: no audio encoder {codec!r}")
        self.frame_size = lib.gtpu_avaenc_frame_size(self._h)
        self._buf = np.empty(1 << 18, np.uint8)

    def _recv_all(self) -> List[bytes]:
        lib = self._lib
        out = []
        key = ctypes.c_int()
        while True:
            r = lib.gtpu_avenc_recv_packet(
                self._h, self._buf.ctypes.data, len(self._buf),
                ctypes.byref(key))
            if r < 0:
                self._buf = np.empty(-r, np.uint8)
                continue
            if r == 0:
                break
            out.append(self._buf[:r].tobytes())
        return out

    def extradata(self) -> bytes:
        buf = np.empty(1 << 16, np.uint8)
        r = self._lib.gtpu_avenc_extradata(self._h, buf.ctypes.data,
                                           len(buf))
        return buf[:r].tobytes() if r > 0 else b""

    def encode_all(self, pcm: np.ndarray) -> List[bytes]:
        """float (n, ch) -> packets (tail zero-padded + flushed)."""
        pcm = np.ascontiguousarray(pcm, np.float32)
        n = len(pcm)
        fs = self.frame_size
        pad = (-n) % fs
        if pad:
            pcm = np.concatenate(
                [pcm, np.zeros((pad, self.channels), np.float32)])
        out = []
        for lo in range(0, len(pcm), fs):
            frame = np.ascontiguousarray(pcm[lo:lo + fs])
            if self._lib.gtpu_avaenc_send(
                    self._h, frame.ctypes.data) < 0:
                raise ValueError("av: audio encode error")
            out.extend(self._recv_all())
        self._lib.gtpu_avaenc_send(self._h, None)
        out.extend(self._recv_all())
        return out

    def __del__(self):
        try:
            self._lib.gtpu_avenc_free(self._h)
        except Exception:
            pass


class AvVideoEncoder:
    """Any libavcodec video encoder over I420 input."""

    def __init__(self, codec: str, width: int, height: int,
                 fps: Tuple[int, int] = (30, 1), bitrate: int = 0,
                 opts: str = "", global_header: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("av: libavcodec shim unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.gtpu_avenc_new(
            codec.encode(), width, height, fps[0], fps[1], bitrate,
            opts.encode(), 1 if global_header else 0))
        if not self._h.value:
            raise RuntimeError(f"av: no encoder {codec!r}")
        self._buf = np.empty(1 << 20, np.uint8)

    def _recv_all(self) -> List[Tuple[bytes, bool]]:
        lib = self._lib
        out = []
        key = ctypes.c_int()
        while True:
            r = lib.gtpu_avenc_recv_packet(
                self._h, self._buf.ctypes.data, len(self._buf),
                ctypes.byref(key))
            if r < 0:
                self._buf = np.empty(-r, np.uint8)
                continue
            if r == 0:
                break
            out.append((self._buf[:r].tobytes(), bool(key.value)))
        return out

    def encode(self, planes) -> List[Tuple[bytes, bool]]:
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in planes)
        if self._lib.gtpu_avenc_send_frame(
                self._h, y.tobytes(), u.tobytes(), v.tobytes()) < 0:
            raise ValueError("av: encode error")
        return self._recv_all()

    def flush(self) -> List[Tuple[bytes, bool]]:
        self._lib.gtpu_avenc_send_frame(self._h, None, None, None)
        return self._recv_all()

    def extradata(self) -> bytes:
        buf = np.empty(1 << 16, np.uint8)
        r = self._lib.gtpu_avenc_extradata(self._h, buf.ctypes.data,
                                           len(buf))
        return buf[:r].tobytes() if r > 0 else b""

    def __del__(self):
        try:
            self._lib.gtpu_avenc_free(self._h)
        except Exception:
            pass
