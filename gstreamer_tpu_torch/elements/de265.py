"""libde265dec — HEVC decode via the system libde265.

Reference: gst-plugins-bad/ext/libde265/libde265-dec.c.  An
alternative HEVC decoder element alongside avdec_h265 (same caps),
wrapping libde265's push API: de265_push_data / de265_decode /
de265_get_next_picture.

A port of the JAX package's ``elements/de265.py``: it takes its source's
host bytes (``HOST_INPUT``), decodes on the host and puts each buffer's
planes on the element's device in one copy (``device_planes``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..core.buffer import Buffer, device_planes, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..device import resolve

_lib = None
_tried = False


def _get():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for n in ("libde265.so.0", "libde265.so"):
        try:
            _lib = ctypes.CDLL(n)
            break
        except OSError:
            continue
    if _lib is not None:
        _lib.de265_new_decoder.restype = ctypes.c_void_p
        _lib.de265_push_data.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p]
        _lib.de265_flush_data.argtypes = [ctypes.c_void_p]
        _lib.de265_decode.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
        _lib.de265_get_next_picture.restype = ctypes.c_void_p
        _lib.de265_get_next_picture.argtypes = [ctypes.c_void_p]
        _lib.de265_get_image_width.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int]
        _lib.de265_get_image_height.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int]
        _lib.de265_get_image_plane.restype = ctypes.c_void_p
        _lib.de265_get_image_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        _lib.de265_free_decoder.argtypes = [ctypes.c_void_p]
    return _lib


def available() -> bool:
    return _get() is not None


@register_element
class LibDe265Dec(TransformElement):
    """libde265dec: HEVC byte-stream -> I420."""
    FACTORY = "libde265dec"
    DESCRIPTION = "Decodes HEVC/H.265 video streams using libde265"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-h265, stream-format=byte-stream"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._ctx = None
        self._decouple = True
        self._pending_buf = None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            f = {"format": "I420"}
            if caps is not None and len(caps):
                for k in ("width", "height", "framerate"):
                    v = caps[0].get(k)
                    if v is not None:
                        f[k] = v
            from ..core.structure import Structure
            res = Caps([Structure("video/x-raw", f)])
        else:
            res = Caps.from_string(
                "video/x-h265, stream-format=byte-stream")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        lib = _get()
        if lib is None:
            raise RuntimeError("libde265dec: libde265 not available")
        self._ctx = ctypes.c_void_p(lib.de265_new_decoder())
        self._pending_buf = True

    def _drain_pics(self):
        lib = _get()
        frames = []
        more = ctypes.c_int(1)
        err = 0
        while more.value and err == 0:
            # DE265_OK == 0; anything else (e.g. "waiting for input
            # data") ends this drain round — pictures already queued
            # are still collected below
            err = lib.de265_decode(self._ctx, ctypes.byref(more))
            while True:
                img = lib.de265_get_next_picture(self._ctx)
                if not img:
                    break
                planes = []
                for c in range(3):
                    w = lib.de265_get_image_width(
                        ctypes.c_void_p(img), c)
                    h = lib.de265_get_image_height(
                        ctypes.c_void_p(img), c)
                    stride = ctypes.c_int()
                    ptr = lib.de265_get_image_plane(
                        ctypes.c_void_p(img), c,
                        ctypes.byref(stride))
                    raw = ctypes.string_at(ptr, stride.value * h)
                    planes.append(np.frombuffer(
                        raw, np.uint8).reshape(
                        h, stride.value)[:, :w].copy())
                frames.append(tuple(planes))
        return frames

    def _emit(self, frames) -> Optional[Buffer]:
        if not frames:
            return None
        data = device_planes([np.stack([f[c] for f in frames])
                              for c in range(3)], resolve(self.device))
        return Buffer(data=data, batch=len(frames))

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        lib = _get()
        if buf is None:
            self._pending_buf = None
            if self._ctx is None:
                return None
            lib.de265_flush_data(self._ctx)
            out = self._emit(self._drain_pics())
            lib.de265_free_decoder(self._ctx)
            self._ctx = None
            return out
        d = buf.data
        blobs = d if isinstance(d, (tuple, list)) else [d]
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            lib.de265_push_data(self._ctx, raw, len(raw), 0, None)
        return self._emit(self._drain_pics())
