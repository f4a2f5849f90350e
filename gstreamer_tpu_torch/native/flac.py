"""ctypes bindings for the native FLAC codec (native/gtpu_flac.cpp).

Mirrors the JAX package's ``native/flac.py``.  The library is built by
``native/_build.py`` at first use; without g++ ``get_lib()`` is None and
``encode`` / ``decode`` return None, and the callers keep the pure-Python
codec in ``codecs/flac.py`` (the gold: the tests hold both paths to
bit-identical streams and sample-identical decodes).  A stream the C
decoder or encoder refuses also returns None, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Optional, Tuple

import numpy as np

from . import _build


def get_lib():
    """The bound library, None without g++ (argument types are set on
    every call: idempotent, and the library itself is cached)."""
    lib = _build.load("gtpu_flac")
    if lib is None:
        return None
    lib.gtpu_flac_decode.restype = ctypes.c_long
    lib.gtpu_flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.gtpu_flac_encode.restype = ctypes.c_long
    lib.gtpu_flac_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    return lib


def decode(data: bytes) -> Optional[Tuple[np.ndarray, int, int, int]]:
    """-> ((n, ch) int32, rate, channels, bps) or None (fallback)."""
    lib = get_lib()
    if lib is None:
        return None
    from ..codecs.flac import parse_stream_header
    si, _ = parse_stream_header(data)
    ch_n = max(si.channels, 1)
    cap = si.total_samples or (len(data) * 4 // ch_n + 65536)
    # total_samples is an untrusted 36-bit header field: bound it by the
    # best possible FLAC expansion (a ~6-byte constant frame encodes at
    # most 65535 samples) and a 256 MiB ceiling; the C decoder stops at
    # `cap`.
    max_expansion = (len(data) // 6 + 1) * 65535
    hard_cap = (256 << 20) // (4 * ch_n)
    cap = max(1, min(int(cap), max_expansion, hard_cap))
    out = np.zeros(int(cap) * si.channels, np.int32)
    ch = ctypes.c_int()
    rate = ctypes.c_int()
    bps = ctypes.c_int()
    n = lib.gtpu_flac_decode(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(cap), ctypes.byref(ch), ctypes.byref(rate),
        ctypes.byref(bps))
    if n < 0:
        return None
    return (out[:n * ch.value].reshape(-1, ch.value), rate.value,
            ch.value, bps.value)


def encode(samples: np.ndarray, sample_rate: int, bps: int = 16,
           blocksize: int = 4096) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, ch = samples.shape
    flat = np.ascontiguousarray(samples, np.int32).ravel()
    cap = 1024 + n * ch * ((bps + 7) // 8 + 2)
    out = np.zeros(cap, np.uint8)
    wrote = lib.gtpu_flac_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, ch, sample_rate, bps, blocksize,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if wrote < 0:
        return None
    blob = bytearray(out[:wrote].tobytes())
    # the MD5 the C side left zeroed (STREAMINFO bytes 26..42)
    from ..codecs.flac import _md5_raw_bytes
    md5 = hashlib.md5()
    md5.update(_md5_raw_bytes(samples, (bps + 7) // 8))
    blob[26:42] = md5.digest()
    return bytes(blob)
