"""Build the repo's host C++ sources (``native/*.cpp``) with g++ at first use.

Each ``native/<name>.cpp`` becomes
``gstreamer_tpu_torch/_build/<name>-<hash>.so``; the hash covers the source
and the flags, so an edited source is rebuilt under a new name.  A build
writes a temporary file and ``os.replace``s it onto the final name, so
processes that build at the same time (test workers) never load a
half-written library.  Nothing is built when a module is imported.

``load`` returns None only when g++ is absent (the callers then keep their
pure-Python paths); a failing build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PKG_DIR.parent / "native"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}


def library_path(name: str, extra_flags=()) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + tuple(extra_flags)).encode())
    h.update((NATIVE_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, extra_flags=()) -> Optional[Path]:
    """Compile native/<name>.cpp unless its library exists.  Returns the
    library's path, None when g++ is absent; raises with g++'s output if
    the build fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = library_path(name, extra_flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / f"{name}.cpp"),
         *extra_flags], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building native/{name}.cpp failed "
                           f"(g++ exited {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, extra_flags=()) -> Optional[ctypes.CDLL]:
    """The loaded library of native/<name>.cpp, built first if needed;
    None when g++ is absent."""
    with _lock:
        if name not in _libs:
            path = build(name, extra_flags)
            _libs[name] = None if path is None else ctypes.CDLL(str(path))
        return _libs[name]
