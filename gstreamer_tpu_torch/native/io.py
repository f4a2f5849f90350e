"""ctypes bindings for the native frame loader (native/gtpu_io.cpp).

Mirrors the JAX package's ``native/io.py`` with one difference in use:
``NativeY4MReader.read`` copies frames from the mmap straight into the
caller's buffer (``gtpu_read_batch``), and ``seek`` moves the same reader
(``gtpu_seek``).  The reference's background-prefetch ring
(``gtpu_start_prefetch`` / ``gtpu_get_batch``, not bound here) costs a
zero-filled ring of slots at every start (and the reference restarts its
reader at every seek) and a second copy out of the slot; filesrc reads
into the page-locked buffer that goes to the card, and the pipeline's own
prefetch overlaps the read with the device's work (PERF.md section 6).  The
library is built by ``native/_build.py`` at first use; without g++
``available()`` is False and filesrc keeps its Python reader.  A failing
build or load raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build


class Y4MInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("fps_n", ctypes.c_int32),
        ("fps_d", ctypes.c_int32),
        ("frame_size", ctypes.c_int32),
        ("n_frames", ctypes.c_int64),
        ("chroma", ctypes.c_char * 16),
    ]


def get_lib():
    """The bound library, None without g++ (argument types are set on
    every call: idempotent, and the library itself is cached)."""
    lib = _build.load("gtpu_io", ("-lpthread",))
    if lib is None:
        return None
    lib.gtpu_open_y4m.restype = ctypes.c_void_p
    lib.gtpu_open_y4m.argtypes = [ctypes.c_char_p, ctypes.POINTER(Y4MInfo)]
    lib.gtpu_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gtpu_read_batch.restype = ctypes.c_int32
    lib.gtpu_read_batch.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_void_p]
    lib.gtpu_close.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return get_lib() is not None


class NativeY4MReader:
    """mmap-backed y4m reader: whole frames, from the current frame on."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native io unavailable: g++ not found")
        self._lib = lib
        self.info = Y4MInfo()
        self._h = lib.gtpu_open_y4m(path.encode(), ctypes.byref(self.info))
        if not self._h:
            raise IOError(f"cannot open y4m {path!r}")

    def seek(self, frame: int) -> None:
        """The next frame to read (clamped to the file)."""
        self._lib.gtpu_seek(self._h, frame)

    def read(self, out: np.ndarray) -> int:
        """Copy the next frames into `out` (n, frame_size) uint8,
        C-contiguous; returns how many (0 at the end)."""
        if (out.dtype != np.uint8 or not out.flags.c_contiguous
                or out.ndim != 2 or out.shape[1] != self.info.frame_size):
            raise ValueError(f"read: want a C-contiguous uint8 (n, "
                             f"{self.info.frame_size}) array, got "
                             f"{out.dtype} {out.shape}")
        return self._lib.gtpu_read_batch(self._h, out.shape[0],
                                         out.ctypes.data)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gtpu_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
