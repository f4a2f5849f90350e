"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` (the hash
covers the source, the shared headers and the flags, the source's own
included, so an edited source or flag is rebuilt).  The libraries have a
plain C interface and include no PyTorch header, so a build takes seconds.
Nothing is built when a module is imported: only when a kernel is first
launched, or when ``build`` is called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("yscale", "chroma420", "deint", "scale2d", "hscale",
           "fused_ingest", "freeverb", "vad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source, after NVCC_FLAGS: freeverb must round every float
# product and sum on its own, as the scalar reference does
SOURCE_FLAGS = {"freeverb": ("-fmad=false",)}

_lock = threading.Lock()
_libs: dict = {}
_functions: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found on PATH or in {home}/bin: the CUDA kernels of "
            "gstreamer_tpu_torch are built from source at first use")
    return path


def flags(name: str) -> tuple:
    """nvcc's flags for csrc/<name>.cu."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for p in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source that is not built yet, one nvcc process
    each, all started together.  Returns {name: library path}; raises with
    nvcc's output if any build fails.  ``_build/<name>.log`` keeps nvcc's
    output (``-Xptxas -v``: registers and shared memory per kernel)."""
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {n: library_path(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags(n), "-o", str(tmp),
               str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{n}.cu: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            lib.gst_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gst_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


_C_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def function(name: str, symbol: str, signature: str):
    """(library, C function) of csrc/<name>.cu with its argument types set
    from `signature`: one letter per argument, "p" for a pointer or stream
    (passed whole, as c_void_p), "i" for an int and "f" for a float.
    Returns an int.  Set up once, then looked up."""
    key = (name, symbol, signature)
    got = _functions.get(key)
    if got is None:
        lib = load(name)
        fn = getattr(lib, symbol)
        fn.argtypes = [_C_TYPES[c] for c in signature]
        fn.restype = ctypes.c_int
        got = _functions[key] = (lib, fn)
    return got


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        msg = lib.gst_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
