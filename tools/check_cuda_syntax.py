#!/usr/bin/env python3
"""Syntax-check the port's CUDA sources with the host C++ compiler.

    python3 tools/check_cuda_syntax.py [NAME ...]

For machines without nvcc: each ``gstreamer_tpu_torch/csrc/<name>.cu``
(every source ``ops/_build.py`` builds, or the named ones) is compiled with
``g++ -std=c++17 -fsyntax-only`` against a stub ``cuda_runtime.h`` written
to a temporary directory (the CUDA qualifiers as empty macros, the few
types and intrinsics the sources use declared), with the ``<<<...>>>``
launches cut out.  This catches most of what a first nvcc build on the card
would: typos, undeclared names, wrong argument counts.  It checks nothing
of the device code's meaning.  Exits 1 if any source fails.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STUB = """#pragma once
#include <stddef.h>
#include <stdint.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__
#define __constant__
#define __launch_bounds__(...)
#define __align__(n)
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct float4 { float x, y, z, w; };
extern uint3 threadIdx, blockIdx, blockDim, gridDim;
const char* cudaGetErrorString(cudaError_t);
cudaError_t cudaGetLastError();
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int);
uint2 make_uint2(unsigned, unsigned);
uint4 make_uint4(unsigned, unsigned, unsigned, unsigned);
int2 make_int2(int, int);
int min(int, int);
int max(int, int);
size_t __cvta_generic_to_shared(const void*);
void __trap();
unsigned __funnelshift_r(unsigned, unsigned, unsigned);
unsigned __funnelshift_l(unsigned, unsigned, unsigned);
unsigned __vhaddu4(unsigned, unsigned);
unsigned __byte_perm(unsigned, unsigned, unsigned);
int __mul24(int, int);
template <class T> T __ldg(const T*);
template <class T> T __shfl_sync(unsigned, T, int);
template <class T> T __shfl_xor_sync(unsigned, T, int);
template <class T> T __shfl_up_sync(unsigned, T, unsigned);
template <class T> T __shfl_down_sync(unsigned, T, unsigned);
float fmaf(float, float, float);
int __reduce_min_sync(unsigned, int);
unsigned __usad(unsigned, unsigned, unsigned);
unsigned __vabsdiffu4(unsigned, unsigned);
int __popc(unsigned);
unsigned __ballot_sync(unsigned, int);
int __ffs(int);
int __float_as_int(float);
float __int_as_float(int);
float fminf(float, float);
float fmaxf(float, float);
unsigned __vavgu4(unsigned, unsigned);
int __dp4a(int, int, int);
int __dp4a(unsigned, unsigned, unsigned);
void __syncwarp(unsigned = 0xffffffffu);
void __syncthreads();
void __threadfence_block();
"""


def main(argv) -> int:
    from gstreamer_tpu_torch.ops import _build
    names = argv or list(_build.SOURCES)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "cuda_runtime.h").write_text(STUB)
        for h in _build.CSRC_DIR.glob("*.cuh"):     # their launches cut too
            (Path(tmp) / h.name).write_text(
                re.sub(r"<<<.*?>>>", "", h.read_text(), flags=re.S))
        for name in names:
            src = (_build.CSRC_DIR / f"{name}.cu").read_text()
            cut = Path(tmp) / f"{name}.cpp"
            cut.write_text(re.sub(r"<<<.*?>>>", "", src, flags=re.S))
            res = subprocess.run(
                ["g++", "-std=c++17", "-fsyntax-only", "-Wno-unknown-pragmas",
                 "-I", tmp, str(cut)],
                capture_output=True, text=True)
            print(f"{name}.cu: {'ok' if res.returncode == 0 else 'FAILED'}")
            if res.returncode != 0:
                print(res.stderr)
                failed.append(name)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
