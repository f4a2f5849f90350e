"""Theora encoding via the system libtheoraenc.

The reference theoraenc (gst-plugins-base/ext/theora/gsttheoraenc.c:1)
wraps libtheora — analysis/rate control are not reimplemented there
either.  This module is the matching architecture: ctypes bindings
producing packets, paged into Ogg by our own page writer.  The DECODE
side is the clean-room implementation in codecs/theora.py.

A copy of the JAX package's ``codecs/theora_enc.py`` (ctypes to the
system libtheoraenc; ``available()`` is False without it).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

_libs = None
_tried = False


class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.POINTER(ctypes.c_ubyte)),
                ("bytes", ctypes.c_long),
                ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long),
                ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]

    def data(self) -> bytes:
        return ctypes.string_at(self.packet, self.bytes)


class _ThInfo(ctypes.Structure):
    _fields_ = [("version_major", ctypes.c_ubyte),
                ("version_minor", ctypes.c_ubyte),
                ("version_subminor", ctypes.c_ubyte),
                ("frame_width", ctypes.c_uint32),
                ("frame_height", ctypes.c_uint32),
                ("pic_width", ctypes.c_uint32),
                ("pic_height", ctypes.c_uint32),
                ("pic_x", ctypes.c_uint32),
                ("pic_y", ctypes.c_uint32),
                ("fps_numerator", ctypes.c_uint32),
                ("fps_denominator", ctypes.c_uint32),
                ("aspect_numerator", ctypes.c_uint32),
                ("aspect_denominator", ctypes.c_uint32),
                ("colorspace", ctypes.c_int),
                ("pixel_fmt", ctypes.c_int),
                ("target_bitrate", ctypes.c_int),
                ("quality", ctypes.c_int),
                ("keyframe_granule_shift", ctypes.c_int)]


class _ThComment(ctypes.Structure):
    _fields_ = [("user_comments", ctypes.POINTER(ctypes.c_char_p)),
                ("comment_lengths", ctypes.POINTER(ctypes.c_int)),
                ("comments", ctypes.c_int),
                ("vendor", ctypes.c_char_p)]


class _ThImgPlane(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int), ("height", ctypes.c_int),
                ("stride", ctypes.c_int),
                ("data", ctypes.POINTER(ctypes.c_ubyte))]


def _get():
    global _libs, _tried
    if _tried:
        return _libs
    _tried = True
    try:
        dec = ctypes.CDLL("libtheoradec.so.1", mode=ctypes.RTLD_GLOBAL)
        enc = ctypes.CDLL("libtheoraenc.so.1")
        enc.th_encode_alloc.restype = ctypes.c_void_p
        _libs = (enc, dec)
    except OSError:
        _libs = None
    return _libs


def available() -> bool:
    return _get() is not None


def encode_packets(frames, pic_w: int, pic_h: int, fps=(30, 1),
                   quality: int = 48, keyframe_shift: int = 6
                   ) -> Tuple[List[bytes], List[bytes]]:
    """(Y, Cb, Cr) 4:2:0 plane frames -> ([3 headers], [packets])."""
    libs = _get()
    if libs is None:
        raise RuntimeError("theoraenc: system libtheoraenc missing")
    enc_l, dec_l = libs
    fw, fh = (pic_w + 15) & ~15, (pic_h + 15) & ~15
    info = _ThInfo()
    dec_l.th_info_init(ctypes.byref(info))
    info.frame_width, info.frame_height = fw, fh
    info.pic_width, info.pic_height = pic_w, pic_h
    info.pic_x = info.pic_y = 0
    info.fps_numerator, info.fps_denominator = fps
    info.aspect_numerator = info.aspect_denominator = 1
    info.colorspace = 0
    info.pixel_fmt = 0
    info.target_bitrate = 0
    info.quality = quality
    info.keyframe_granule_shift = keyframe_shift
    ctx = ctypes.c_void_p(enc_l.th_encode_alloc(ctypes.byref(info)))
    if not ctx:
        raise RuntimeError("theoraenc: unsupported configuration")
    tc = _ThComment()
    dec_l.th_comment_init(ctypes.byref(tc))
    op = _OggPacket()
    headers = []
    while enc_l.th_encode_flushheader(ctx, ctypes.byref(tc),
                                      ctypes.byref(op)) > 0:
        headers.append(op.data())
    packets = []
    buf = (_ThImgPlane * 3)()
    for y, cb, cr in frames:
        y = np.ascontiguousarray(
            _pad_to(np.asarray(y, np.uint8), fh, fw))
        cb = np.ascontiguousarray(
            _pad_to(np.asarray(cb, np.uint8), fh // 2, fw // 2))
        cr = np.ascontiguousarray(
            _pad_to(np.asarray(cr, np.uint8), fh // 2, fw // 2))
        for i, arr in enumerate((y, cb, cr)):
            buf[i].width = arr.shape[1]
            buf[i].height = arr.shape[0]
            buf[i].stride = arr.shape[1]
            buf[i].data = arr.ctypes.data_as(
                ctypes.POINTER(ctypes.c_ubyte))
        if enc_l.th_encode_ycbcr_in(ctx, buf) != 0:
            enc_l.th_encode_free(ctx)
            raise RuntimeError("theoraenc: frame rejected")
        while enc_l.th_encode_packetout(ctx, 0, ctypes.byref(op)) > 0:
            packets.append(op.data())
    while enc_l.th_encode_packetout(ctx, 1, ctypes.byref(op)) > 0:
        packets.append(op.data())
    enc_l.th_encode_free(ctx)
    dec_l.th_comment_clear(ctypes.byref(tc))
    return headers, packets


def _pad_to(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    if arr.shape == (h, w):
        return arr
    return np.pad(arr, ((0, h - arr.shape[0]), (0, w - arr.shape[1])),
                  mode="edge")


def encode_ogg(frames, pic_w: int, pic_h: int, fps=(30, 1),
               quality: int = 48, keyframe_shift: int = 6,
               serial: int = 0x74686F72) -> bytes:
    """-> complete Ogg/Theora stream (granulepos =
    (last_key << kfgshift) + frames_since_key)."""
    from ..elements.ogg import ogg_page

    headers, packets = encode_packets(frames, pic_w, pic_h, fps,
                                      quality, keyframe_shift)
    pages = [ogg_page([headers[0]], serial, 0, 0, bos=True),
             ogg_page(headers[1:], serial, 1, 0)]
    seq = 2
    last_key = 0
    for i, pkt in enumerate(packets):
        if len(pkt) and not (pkt[0] & 0x40):      # keyframe
            last_key = i
        gran = (last_key << keyframe_shift) + (i - last_key)
        pages.append(ogg_page([pkt], serial, seq, gran,
                              eos=(i == len(packets) - 1)))
        seq += 1
    return b"".join(pages)
