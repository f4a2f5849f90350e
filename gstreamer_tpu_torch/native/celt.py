"""ctypes loader for the CELT hot-loop shim (native/gtpu_celt.cpp).

Mirrors the JAX package's ``native/celt.py``: ``codecs/celt.py`` uses the
library when present; the pure-Python path is the specification and the
fallback (``GTPU_CELT_NATIVE=0`` forces it).  The library is built by
``native/_build.py`` at first use into ``gstreamer_tpu_torch/_build/``;
``get_lib()`` is None without g++, and a failing build or load raises
(the JAX loader's silent None on a failed build is not copied).
"""

from __future__ import annotations

import ctypes
import os

from . import _build


def get_lib():
    """The bound library; None when switched off or without g++."""
    if os.environ.get("GTPU_CELT_NATIVE", "1") == "0":
        return None
    lib = _build.load("gtpu_celt")
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.gtpu_celt_pvq_v.restype = ctypes.c_uint64
    lib.gtpu_celt_pvq_v.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gtpu_celt_cwrsi.restype = None
    lib.gtpu_celt_cwrsi.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_uint64, i32p]
    lib.gtpu_celt_exp_rotation.restype = None
    lib.gtpu_celt_exp_rotation.argtypes = [
        f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.gtpu_celt_comb_filter.restype = None
    lib.gtpu_celt_comb_filter.argtypes = [
        f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, f64p, f64p, f64p,
        ctypes.c_int, ctypes.c_int]
    return lib
