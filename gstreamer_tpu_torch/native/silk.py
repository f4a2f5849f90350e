"""ctypes loader for the SILK synthesis hot-loop shim (native/gtpu_silk.cpp).

Mirrors the JAX package's ``native/silk.py``: ``codecs/silk.py`` uses the
library when present; the pure-Python fixed-point path is the
specification and the fallback (``GTPU_SILK_NATIVE=0`` forces it).  The
library is built by ``native/_build.py`` at first use into
``gstreamer_tpu_torch/_build/``; ``get_lib()`` is None without g++, and a
failing build or load raises (the JAX loader's silent None on a failed
build is not copied).
"""

from __future__ import annotations

import ctypes
import os

from . import _build


def get_lib():
    """The bound library; None when switched off or without g++."""
    if os.environ.get("GTPU_SILK_NATIVE", "1") == "0":
        return None
    lib = _build.load("gtpu_silk")
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.gtpu_silk_decode_core.restype = ctypes.c_int32
    lib.gtpu_silk_decode_core.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p, i32p, i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, i32p]
    lib.gtpu_silk_resample_iirfir.restype = ctypes.c_int
    lib.gtpu_silk_resample_iirfir.argtypes = [
        i32p, i32p, i16p, i32p, i32p, ctypes.c_int32,
        i32p, ctypes.c_int, i32p, i32p]
    lib.gtpu_silk_nlsf2a.restype = None
    lib.gtpu_silk_nlsf2a.argtypes = [i32p, ctypes.c_int, i32p, i32p,
                                     i32p]
    return lib
