"""ctypes bindings for the native JPEG entropy codec (native/gtpu_jpeg.cpp).

Mirrors the JAX package's ``native/jpeg.py``.  The library is built by
``native/_build.py`` at first use; without g++ ``available()`` is False and
``codecs/jpeg.py`` keeps its Python coder (bit-identical; the tests hold the
two paths to each other).  A failing build or load raises.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from . import _build


def get_lib():
    """The bound library, None without g++ (argument types are set on
    every call: idempotent, and the library itself is cached)."""
    lib = _build.load("gtpu_jpeg")
    if lib is None:
        return None
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.gtpu_jpeg_decode_scan.restype = ctypes.c_int
    lib.gtpu_jpeg_decode_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ip)]
    lib.gtpu_jpeg_encode_scan.restype = ctypes.c_long
    lib.gtpu_jpeg_encode_scan.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ip), ctypes.c_char_p, ctypes.c_long]
    return lib


def available() -> bool:
    return get_lib() is not None


def _int_arr(vals):
    return (ctypes.c_int * len(vals))(*vals)


def decode_scan(scan: bytes, mcux: int, mcuy: int, restart: int,
                comps: List[dict], luts) -> List[np.ndarray]:
    """comps: [{h, v, bw, bh, dc_idx, ac_idx}]; luts: (lut_val int16
    (ntab,65536), lut_len int8 (ntab,65536)).  Returns zigzag coeff arrays
    (nblocks, 64) int32 per component; raises on a corrupt scan."""
    lib = get_lib()
    lut_val, lut_len = luts
    lut_val = np.ascontiguousarray(lut_val, np.int16)
    lut_len = np.ascontiguousarray(lut_len, np.int8)
    outs = [np.zeros((c["bh"] * c["bw"] * 64,), np.int32) for c in comps]
    ptrs = (ctypes.POINTER(ctypes.c_int32) * len(comps))(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for o in outs])
    rc = lib.gtpu_jpeg_decode_scan(
        scan, len(scan), mcux, mcuy, restart, len(comps),
        _int_arr([c["h"] for c in comps]),
        _int_arr([c["v"] for c in comps]),
        _int_arr([c["bw"] for c in comps]),
        _int_arr([c["dc_idx"] for c in comps]),
        _int_arr([c["ac_idx"] for c in comps]),
        lut_val.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lut_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ptrs)
    if rc != 0:
        raise ValueError(f"jpeg: native scan decode failed ({rc})")
    return [o.reshape(-1, 64) for o in outs]


def encode_scan(mcux: int, mcuy: int, comps: List[dict],
                codes: np.ndarray, lens: np.ndarray,
                coef: List[np.ndarray]) -> bytes:
    """codes: uint16 (ntab,256); lens: uint8 (ntab,256); coef: zigzag
    int32 (nblocks,64) per component."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.uint16)
    lens = np.ascontiguousarray(lens, np.uint8)
    bufs = [np.ascontiguousarray(c, np.int32) for c in coef]
    ptrs = (ctypes.POINTER(ctypes.c_int32) * len(comps))(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for b in bufs])
    cap = sum(b.size for b in bufs) * 4 + 4096
    out = ctypes.create_string_buffer(cap)
    n = lib.gtpu_jpeg_encode_scan(
        mcux, mcuy, len(comps),
        _int_arr([c["h"] for c in comps]),
        _int_arr([c["v"] for c in comps]),
        _int_arr([c["bw"] for c in comps]),
        _int_arr([c["dc_idx"] for c in comps]),
        _int_arr([c["ac_idx"] for c in comps]),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ptrs, out, cap)
    if n < 0:
        raise ValueError(f"jpeg: native scan encode failed ({n})")
    return out.raw[:n]
