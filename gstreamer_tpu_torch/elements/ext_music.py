"""Game-music and tracker-module decoders over optional system libs.

References: gst-plugins-bad/ext/gme/gstgme.c (gmedec wraps
libgme: NSF/SPC/GBS/VGM and other console sound formats) and
gst-plugins-bad/ext/openmpt/gstopenmptdec.c (openmptdec wraps
libopenmpt for MOD/XM/IT/S3M tracker modules, on the
gstnonstreamaudiodecoder base).

Both are whole-file decoders (non-streamable formats): the element
buffers the complete input at EOS, opens it with the library and
emits PCM.  Degrades gracefully when the library is absent.

A port of the JAX package's ``elements/ext_music.py``: the decoders take
their source's host bytes (``HOST_INPUT``) and put the PCM on the element's
device (``device_array``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve

_gme = None
_gme_tried = False


def _get_gme():
    global _gme, _gme_tried
    if _gme_tried:
        return _gme
    _gme_tried = True
    for n in ("libgme.so.0", "libgme.so"):
        try:
            _gme = ctypes.CDLL(n)
            break
        except OSError:
            continue
    if _gme is not None:
        _gme.gme_open_data.restype = ctypes.c_char_p
        _gme.gme_open_data.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        _gme.gme_play.restype = ctypes.c_char_p
        _gme.gme_play.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]
        _gme.gme_start_track.restype = ctypes.c_char_p
        _gme.gme_start_track.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _gme.gme_track_ended.restype = ctypes.c_int
        _gme.gme_track_ended.argtypes = [ctypes.c_void_p]
        _gme.gme_delete.argtypes = [ctypes.c_void_p]
    return _gme


_mpt = None
_mpt_tried = False


def _get_mpt():
    global _mpt, _mpt_tried
    if _mpt_tried:
        return _mpt
    _mpt_tried = True
    for n in ("libopenmpt.so.0", "libopenmpt.so"):
        try:
            _mpt = ctypes.CDLL(n)
            break
        except OSError:
            continue
    if _mpt is not None:
        _mpt.openmpt_module_create_from_memory2.restype = \
            ctypes.c_void_p
        _mpt.openmpt_module_create_from_memory2.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
        _mpt.openmpt_module_read_interleaved_float_stereo.restype = \
            ctypes.c_size_t
        _mpt.openmpt_module_read_interleaved_float_stereo.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
            ctypes.c_void_p]
        _mpt.openmpt_module_destroy.argtypes = [ctypes.c_void_p]
    return _mpt


class _WholeFileAudioDec(TransformElement):
    """Accumulate the whole input; decode at EOS (the reference's
    nonstreamaudiodecoder base class behavior)."""
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    RATE = 48000

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._acc = b""
        self._decouple = True
        self._pending_buf = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = Caps.from_string(
                f"audio/x-raw, format=F32LE, layout=interleaved, "
                f"rate={self.RATE}, channels=2")
        else:
            res = Caps.from_string(self.SINK_CAPS)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._acc = b""
        self._pending_buf = True

    def _decode_all(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is not None:
            d = buf.data
            self._acc += (b"".join(host_array(x).tobytes()
                                   for x in d)
                          if isinstance(d, (tuple, list))
                          else (bytes(d) if isinstance(
                              d, (bytes, bytearray))
                              else host_array(d).tobytes()))
            return None
        self._pending_buf = None
        if not self._acc:
            return None
        pcm = self._decode_all()
        self._acc = b""
        if pcm is None or not len(pcm):
            return None
        return Buffer(data=device_array(pcm, resolve(self.device)),
                      batch=1, pts=0,
                      duration=len(pcm) * 1_000_000_000 // self.RATE)


@register_element
class GmeDec(_WholeFileAudioDec):
    """gmedec: game-music formats via libgme."""
    FACTORY = "gmedec"
    DESCRIPTION = "Uses libgme to emulate a gaming console sound " \
                  "processor"
    SINK_CAPS = ("audio/x-nsf; audio/x-spc; audio/x-gbs; "
                 "audio/x-vgm; audio/x-ay; audio/x-gym; audio/x-kss; "
                 "audio/x-sap")
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, SINK_CAPS),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=F32LE"),
    ]
    PROPERTIES = {"duration": (float, 10.0,
                               "seconds to render (emulated "
                               "formats loop forever)")}

    def _decode_all(self):
        lib = _get_gme()
        if lib is None:
            raise RuntimeError("gmedec: libgme not available")
        emu = ctypes.c_void_p()
        err = lib.gme_open_data(self._acc, len(self._acc),
                                ctypes.byref(emu), self.RATE)
        if err:
            raise ValueError(f"gmedec: {err.decode()}")
        try:
            err = lib.gme_start_track(emu, 0)
            if err:
                raise ValueError(f"gmedec: {err.decode()}")
            total = int(self.props["duration"] * self.RATE)
            out = np.empty(total * 2, np.int16)
            step = 4096
            got = 0
            while got < total * 2 and not lib.gme_track_ended(emu):
                n = min(step, total * 2 - got)
                lib.gme_play(emu, n, out[got:].ctypes.data)
                got += n
            return (out[:got].astype(np.float32) / 32768.0
                    ).reshape(-1, 2)
        finally:
            lib.gme_delete(emu)


@register_element
class OpenMptDec(_WholeFileAudioDec):
    """openmptdec: MOD/XM/IT/S3M tracker modules via libopenmpt."""
    FACTORY = "openmptdec"
    DESCRIPTION = "Decodes module files (MOD/S3M/XM/IT/...) with " \
                  "libopenmpt"
    SINK_CAPS = "audio/x-mod"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "audio/x-mod"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=F32LE"),
    ]

    def _decode_all(self):
        lib = _get_mpt()
        if lib is None:
            raise RuntimeError("openmptdec: libopenmpt not available")
        mod = lib.openmpt_module_create_from_memory2(
            self._acc, len(self._acc), None, None, None, None,
            None, None, None)
        if not mod:
            raise ValueError("openmptdec: cannot parse module")
        try:
            chunks = []
            buf = np.empty(4096 * 2, np.float32)
            while True:
                n = lib.openmpt_module_read_interleaved_float_stereo(
                    mod, self.RATE, 4096, buf.ctypes.data)
                if n == 0:
                    break
                chunks.append(buf[:n * 2].reshape(-1, 2).copy())
            if not chunks:
                return None
            return np.concatenate(chunks)
        finally:
            lib.openmpt_module_destroy(mod)
