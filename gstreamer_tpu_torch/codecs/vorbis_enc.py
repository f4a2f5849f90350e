"""Vorbis encoding via the system libvorbisenc.

The reference vorbisenc (gst-plugins-base/ext/vorbis/gstvorbisenc.c:1)
wraps libvorbisenc — psychoacoustic analysis is not reimplemented
there either.  This module is the matching architecture: ctypes
bindings producing packets, paged into Ogg by our own page writer
(elements/ogg.py).  The DECODE side is the clean-room implementation
in codecs/vorbis.py; only analysis/encode uses the system library.

Degrades gracefully: `available()` False when the libraries are absent.

A copy of the JAX package's ``codecs/vorbis_enc.py`` (ctypes to the
system libvorbisenc; ``available()`` is False without it).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

_libs: Optional[Tuple[ctypes.CDLL, ctypes.CDLL]] = None
_tried = False

c_float_p = ctypes.POINTER(ctypes.c_float)
c_float_pp = ctypes.POINTER(c_float_p)


class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.POINTER(ctypes.c_ubyte)),
                ("bytes", ctypes.c_long),
                ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long),
                ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]

    def data(self) -> bytes:
        return ctypes.string_at(self.packet, self.bytes)


def _get():
    global _libs, _tried
    if _tried:
        return _libs
    _tried = True
    try:
        v = ctypes.CDLL("libvorbis.so.0")
        ve = ctypes.CDLL("libvorbisenc.so.2")
        ve.vorbis_encode_init_vbr.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_float]
        v.vorbis_analysis_buffer.restype = c_float_pp
        _libs = (v, ve)
    except OSError:
        _libs = None
    return _libs


def available() -> bool:
    return _get() is not None


def encode_packets(pcm: np.ndarray, rate: int, quality: float = 0.4
                   ) -> Tuple[List[bytes], List[Tuple[bytes, int]]]:
    """float (n, ch) -> ([3 header pkts], [(audio pkt, granulepos)])."""
    libs = _get()
    if libs is None:
        raise RuntimeError("vorbisenc: system libvorbisenc not available")
    v, ve = libs
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    if pcm.shape[0] < pcm.shape[1]:
        pcm = pcm.T
    n, ch = pcm.shape

    vi = ctypes.create_string_buffer(512)
    vc = ctypes.create_string_buffer(512)
    vd = ctypes.create_string_buffer(4096)
    vb = ctypes.create_string_buffer(4096)
    v.vorbis_info_init(vi)
    if ve.vorbis_encode_init_vbr(vi, ch, rate,
                                 ctypes.c_float(quality)) != 0:
        v.vorbis_info_clear(vi)
        raise ValueError(
            f"vorbisenc: unsupported configuration {rate}Hz/{ch}ch")
    v.vorbis_comment_init(vc)
    v.vorbis_analysis_init(vd, vi)
    v.vorbis_block_init(vd, vb)

    h1, h2, h3 = _OggPacket(), _OggPacket(), _OggPacket()
    v.vorbis_analysis_headerout(vd, vc, ctypes.byref(h1),
                                ctypes.byref(h2), ctypes.byref(h3))
    headers = [h1.data(), h2.data(), h3.data()]

    audio: List[Tuple[bytes, int]] = []

    def drain():
        op = _OggPacket()
        while v.vorbis_analysis_blockout(vd, vb) == 1:
            v.vorbis_analysis(vb, None)
            v.vorbis_bitrate_addblock(vb)
            while v.vorbis_bitrate_flushpacket(vd, ctypes.byref(op)) == 1:
                audio.append((op.data(), int(op.granulepos)))

    step = 4096
    for lo in range(0, n, step):
        chunk = pcm[lo:lo + step]
        buf = v.vorbis_analysis_buffer(vd, len(chunk))
        for c in range(ch):
            col = np.ascontiguousarray(chunk[:, c])
            ctypes.memmove(buf[c], col.ctypes.data, col.nbytes)
        v.vorbis_analysis_wrote(vd, len(chunk))
        drain()
    v.vorbis_analysis_wrote(vd, 0)
    drain()

    v.vorbis_block_clear(vb)
    v.vorbis_dsp_clear(vd)
    v.vorbis_comment_clear(vc)
    v.vorbis_info_clear(vi)
    return headers, audio


def encode_ogg(pcm: np.ndarray, rate: int, quality: float = 0.4,
               serial: int = 0x766F7262) -> bytes:
    """float (n, ch) -> complete Ogg/Vorbis stream (Vorbis-over-Ogg
    header paging rules: BOS page with the ident packet alone, one page
    with comment+setup, then audio)."""
    from ..elements.ogg import ogg_page

    headers, audio = encode_packets(pcm, rate, quality)
    pages = [ogg_page([headers[0]], serial, 0, 0, bos=True),
             ogg_page(headers[1:], serial, 1, 0)]
    seq = 2
    for i, (pkt, gran) in enumerate(audio):
        pages.append(ogg_page([pkt], serial, seq, gran,
                              eos=(i == len(audio) - 1)))
        seq += 1
    return b"".join(pages)
