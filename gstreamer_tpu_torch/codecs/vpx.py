"""VP8/VP9 codec via the system libvpx, plus IVF framing.

The reference's vp8enc/vp8dec/vp9enc/vp9dec
(gst-plugins-good/ext/vpx/gstvp8enc.c:1, gstvp8dec.c:1, gstvp9enc.c:1,
gstvp9dec.c:1) are wrappers around libvpx — the codec is not
reimplemented there.  Same architecture here: ctypes bindings to the
system libvpx (no dev headers in this image, so the two public structs
used — vpx_codec_enc_cfg and vpx_image — are laid out from the stable
public API and SELF-CHECKED at init against the documented
config_default values; a mismatch disables the wrapper rather than
corrupting memory).

IVF encapsulation (the simple framing both libvpx tools and the
reference's ivfparse use) is implemented natively.

Degrades gracefully: `available()` is False when libvpx is absent.

A copy of the JAX package's ``codecs/vpx.py`` (host only, numpy as
there): the same sonames in the same order and the same self-check.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Iterable, List, Optional, Tuple

import numpy as np

_lib = None
_tried = False

# vpx_codec_enc_cfg field offsets (public header order, verified by
# the config_default self-check below)
_CFG_G_W = 12
_CFG_G_H = 16
_CFG_TB_NUM = 28
_CFG_TB_DEN = 32
_CFG_LAG = 44
_CFG_RC_END_USAGE = 72
_CFG_RC_TARGET_BITRATE = 112
_CFG_RC_MIN_Q = 116
_CFG_RC_MAX_Q = 120

# vpx_image offsets: 12 leading u32 fields, then planes[4], stride[4]
_IMG_DW = 24
_IMG_DH = 28
_IMG_XCS = 40
_IMG_YCS = 44
_IMG_PLANES = 48
_IMG_STRIDE = 80

_FMT_I420 = 0x102


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = None
    for name in ("libvpx.so.7", "libvpx.so", "libvpx.so.6"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if lib is None:
        return None
    for f in ("vpx_codec_vp8_cx", "vpx_codec_vp8_dx",
              "vpx_codec_vp9_cx", "vpx_codec_vp9_dx",
              "vpx_img_alloc"):
        try:
            getattr(lib, f).restype = ctypes.c_void_p
        except AttributeError:
            return None
    lib.vpx_codec_get_cx_data.restype = ctypes.c_void_p
    lib.vpx_codec_get_frame.restype = ctypes.c_void_p
    lib.vpx_codec_err_to_string.restype = ctypes.c_char_p
    lib.vpx_codec_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_ulong, ctypes.c_long, ctypes.c_ulong]
    # self-check the assumed enc-cfg layout against documented
    # defaults (g_w=320, g_h=240, timebase 1/30)
    cfg = ctypes.create_string_buffer(8192)
    iface = ctypes.c_void_p(lib.vpx_codec_vp8_cx())
    if lib.vpx_codec_enc_config_default(iface, cfg, 0) != 0:
        return None
    g_w, = struct.unpack_from("<I", cfg, _CFG_G_W)
    g_h, = struct.unpack_from("<I", cfg, _CFG_G_H)
    num, den = struct.unpack_from("<II", cfg, _CFG_TB_NUM)
    if (g_w, g_h, num, den) != (320, 240, 1, 30):
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _get() is not None


def _iface(lib, codec: str, enc: bool) -> ctypes.c_void_p:
    name = f"vpx_codec_{codec}_{'cx' if enc else 'dx'}"
    return ctypes.c_void_p(getattr(lib, name)())


class VpxEncoder:
    """I420 frame encoder (VP8 or VP9), one packet per frame."""

    def __init__(self, codec: str, width: int, height: int,
                 fps: Tuple[int, int] = (30, 1),
                 bitrate_kbps: int = 256,
                 min_q: int = 4, max_q: int = 63):
        lib = _get()
        if lib is None:
            raise RuntimeError("vpx: system libvpx not available")
        if codec not in ("vp8", "vp9"):
            raise ValueError(f"vpx: unknown codec {codec!r}")
        self._lib = lib
        self.codec = codec
        self.width = width
        self.height = height
        self.fps = fps
        iface = _iface(lib, codec, True)
        cfg = ctypes.create_string_buffer(8192)
        if lib.vpx_codec_enc_config_default(iface, cfg, 0) != 0:
            raise RuntimeError("vpx: enc_config_default failed")
        for off, v in ((_CFG_G_W, width), (_CFG_G_H, height),
                       (_CFG_TB_NUM, fps[1]), (_CFG_TB_DEN, fps[0]),
                       (_CFG_LAG, 0),
                       (_CFG_RC_TARGET_BITRATE, bitrate_kbps),
                       (_CFG_RC_MIN_Q, min_q), (_CFG_RC_MAX_Q, max_q)):
            struct.pack_into("<I", cfg, off, v)
        self._ctx = ctypes.create_string_buffer(256)
        err = lib.vpx_codec_enc_init_ver(self._ctx, iface, cfg,
                                         ctypes.c_long(0), 0)
        if err != 0:
            raise RuntimeError(
                "vpx: encoder init failed: "
                + lib.vpx_codec_err_to_string(err).decode())
        self._img = ctypes.c_void_p(lib.vpx_img_alloc(
            None, _FMT_I420, width, height, 16))
        if not self._img.value:
            raise RuntimeError("vpx: image alloc failed")
        self._pts = 0

    def _fill_image(self, planes) -> None:
        mem = bytes((ctypes.c_char * 96).from_address(self._img.value))
        ptrs = struct.unpack_from("<4Q", mem, _IMG_PLANES)
        strides = struct.unpack_from("<4i", mem, _IMG_STRIDE)
        for ptr, arr, stride in zip(ptrs, planes, strides):
            arr = np.ascontiguousarray(arr, np.uint8)
            w = arr.shape[1]
            for r in range(arr.shape[0]):
                ctypes.memmove(ptr + r * stride,
                               arr.ctypes.data + r * w, w)

    def _drain(self) -> List[Tuple[bytes, bool]]:
        lib = self._lib
        out = []
        it = ctypes.c_void_p(None)
        while True:
            p = ctypes.c_void_p(
                lib.vpx_codec_get_cx_data(self._ctx, ctypes.byref(it)))
            if not p.value:
                break
            head = bytes((ctypes.c_char * 48).from_address(p.value))
            kind, = struct.unpack_from("<i", head)
            if kind != 0:                        # not a frame packet
                continue
            buf_ptr, sz, _pts, _dur, flags = struct.unpack_from(
                "<QQqQQ", head, 8)
            data = bytes((ctypes.c_char * sz).from_address(buf_ptr))
            key = bool(flags & 0x1)
            if self.codec == "vp8" and data:
                key = not (data[0] & 0x01)       # frame_type bit
            out.append((data, key))
        return out

    def encode(self, planes) -> List[Tuple[bytes, bool]]:
        """(Y, U, V) uint8 I420 planes -> [(packet, keyframe)]."""
        self._fill_image(planes)
        err = self._lib.vpx_codec_encode(
            self._ctx, self._img, self._pts, 1, 0, 1_000_000)
        if err != 0:
            raise RuntimeError(
                "vpx: encode failed: "
                + self._lib.vpx_codec_err_to_string(err).decode())
        self._pts += 1
        return self._drain()

    def flush(self) -> List[Tuple[bytes, bool]]:
        self._lib.vpx_codec_encode(self._ctx, None, -1, 1, 0,
                                   1_000_000)
        return self._drain()

    def __del__(self):
        try:
            self._lib.vpx_codec_destroy(self._ctx)
            self._lib.vpx_img_free(self._img)
        except Exception:
            pass


class VpxDecoder:
    """Packet decoder -> I420 (or I420-compatible 4:2:0) planes."""

    def __init__(self, codec: str):
        lib = _get()
        if lib is None:
            raise RuntimeError("vpx: system libvpx not available")
        if codec not in ("vp8", "vp9"):
            raise ValueError(f"vpx: unknown codec {codec!r}")
        self._lib = lib
        self.codec = codec
        self._ctx = ctypes.create_string_buffer(256)
        err = lib.vpx_codec_dec_init_ver(
            self._ctx, _iface(lib, codec, False), None,
            ctypes.c_long(0), 0)
        if err != 0:
            raise RuntimeError(
                "vpx: decoder init failed: "
                + lib.vpx_codec_err_to_string(err).decode())

    def decode(self, packet: bytes
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        lib = self._lib
        err = lib.vpx_codec_decode(self._ctx, packet, len(packet),
                                   None, 0)
        if err != 0:
            raise ValueError(
                "vpx: decode failed: "
                + lib.vpx_codec_err_to_string(err).decode())
        out = []
        it = ctypes.c_void_p(None)
        while True:
            p = ctypes.c_void_p(
                lib.vpx_codec_get_frame(self._ctx, ctypes.byref(it)))
            if not p.value:
                break
            mem = bytes((ctypes.c_char * 96).from_address(p.value))
            dw, dh = struct.unpack_from("<II", mem, _IMG_DW)
            xcs, ycs = struct.unpack_from("<II", mem, _IMG_XCS)
            ptrs = struct.unpack_from("<4Q", mem, _IMG_PLANES)
            strides = struct.unpack_from("<4i", mem, _IMG_STRIDE)
            planes = []
            for pli in range(3):
                w = dw if pli == 0 else (dw + xcs) >> xcs
                h = dh if pli == 0 else (dh + ycs) >> ycs
                arr = np.empty((h, w), np.uint8)
                for r in range(h):
                    ctypes.memmove(arr.ctypes.data + r * w,
                                   ptrs[pli] + r * strides[pli], w)
                planes.append(arr)
            out.append(tuple(planes))
        return out

    def __del__(self):
        try:
            self._lib.vpx_codec_destroy(self._ctx)
        except Exception:
            pass


# --------------------------------------------------------------- IVF

def ivf_header(codec: str, width: int, height: int,
               fps: Tuple[int, int], nframes: int) -> bytes:
    fourcc = b"VP80" if codec == "vp8" else b"VP90"
    return (b"DKIF" + struct.pack("<HH", 0, 32) + fourcc
            + struct.pack("<HHIIII", width, height, fps[0], fps[1],
                          nframes, 0))


def write_ivf(path: str, codec: str, width: int, height: int,
              fps: Tuple[int, int],
              packets: Iterable[bytes]) -> None:
    packets = list(packets)
    with open(path, "wb") as f:
        f.write(ivf_header(codec, width, height, fps, len(packets)))
        for i, pkt in enumerate(packets):
            f.write(struct.pack("<IQ", len(pkt), i) + pkt)


def parse_ivf(data: bytes
              ) -> Tuple[str, int, int, Tuple[int, int], List[bytes]]:
    """-> (codec, width, height, (fps_n, fps_d), packets)."""
    if data[:4] != b"DKIF" or len(data) < 32:
        raise ValueError("ivf: bad signature")
    hdr_size, = struct.unpack_from("<H", data, 6)
    fourcc = data[8:12]
    codec = {b"VP80": "vp8", b"VP90": "vp9"}.get(fourcc)
    if codec is None:
        raise ValueError(f"ivf: unsupported fourcc {fourcc!r}")
    w, h, den, num = struct.unpack_from("<HHII", data, 12)
    pos = hdr_size
    packets = []
    while pos + 12 <= len(data):
        sz, _pts = struct.unpack_from("<IQ", data, pos)
        pos += 12
        packets.append(data[pos:pos + sz])
        pos += sz
    return codec, w, h, (den, max(num, 1)), packets


def encode_frames(codec: str, frames, width: int, height: int,
                  fps: Tuple[int, int] = (30, 1),
                  bitrate_kbps: int = 256) -> List[Tuple[bytes, bool]]:
    enc = VpxEncoder(codec, width, height, fps, bitrate_kbps)
    out = []
    for planes in frames:
        out.extend(enc.encode(planes))
    out.extend(enc.flush())
    return out


def decode_packets(codec: str, packets: Iterable[bytes]
                   ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    dec = VpxDecoder(codec)
    frames = []
    for pkt in packets:
        frames.extend(dec.decode(pkt))
    return frames
