// Both field-parity frames of a u8 plane: (NF, H, W) -> (NF, 2, H, W).
//
// Replaces gstreamer_tpu/ops/deint_kernel.py::deint_both_parities (its
// pallas_call, :85; body :54-76), the intra-frame deinterlace of
// elements/deinterlace.py.  For output row r of frame n, slot k keeps
// src[n, r] where r's parity is (parity0 + k) & 1; elsewhere it holds the
// interpolated row:
//   linear     (src[max(r-1,0)] + src[min(r+1,H-1)] + 1) >> 1
//   scalerbob  src[max(r-1,0)]
// The TPU kernel builds whole-frame row-shifted copies in VMEM with an iota
// mask; here each thread produces one run of one output row in both slots.
//
// Bound: bytes -- one u8 read and two u8 writes per pixel (597 MB for a
// 64-frame 1080p I420 batch), a few integer operations each.  A thread
// loads 16 bytes of rows r-1, r and r+1 (the neighbours are other threads'
// own rows, so device memory sees each row about once through L1/L2),
// averages them four bytes at a time with __vavgu4, which is exactly
// (a + b + 1) >> 1 per byte, and stores 16 bytes into each slot.  A width
// that is not a multiple of 16, or a pointer not 16-byte aligned, takes the
// same kernel one byte per thread.  Any H >= 1 and W >= 1.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "status.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ uint4 rounded_avg(uint4 a, uint4 b) {
  return make_uint4(__vavgu4(a.x, b.x), __vavgu4(a.y, b.y),
                    __vavgu4(a.z, b.z), __vavgu4(a.w, b.w));
}

__device__ __forceinline__ uint8_t rounded_avg(uint8_t a, uint8_t b) {
  return static_cast<uint8_t>((a + b + 1) >> 1);
}

// T is the unit one thread moves (uint4: 16 bytes, or uint8_t); `units` is
// the row width in those units.  blockIdx.x/threadIdx.x pick the unit,
// blockIdx.y walks the NF*H source rows with stride gridDim.y.
template <typename T, bool kLinear>
__global__ void __launch_bounds__(kMaxThreads)
deint_both_parities_kernel(const T* __restrict__ src, T* __restrict__ out,
                           int rows, int h, int units, int parity0) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= units) return;
  const size_t slot = static_cast<size_t>(h) * units;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int n = row / h;
    const int r = row - n * h;
    const T* frame = src + static_cast<size_t>(n) * slot + c;
    const T cur = __ldg(frame + static_cast<size_t>(r) * units);
    const T up = __ldg(frame + static_cast<size_t>(r > 0 ? r - 1 : 0) * units);
    T interp = up;
    if (kLinear) {
      const int rd = r + 1 < h ? r + 1 : h - 1;
      interp = rounded_avg(up, __ldg(frame + static_cast<size_t>(rd) * units));
    }
    // slot k keeps the rows of parity (parity0 + k) & 1
    const int keep = (r & 1) ^ parity0;
    T* o = out + 2 * static_cast<size_t>(n) * slot
           + static_cast<size_t>(r) * units + c;
    o[keep ? slot : 0] = cur;
    o[keep ? 0 : slot] = interp;
  }
}

template <typename T>
int launch(const void* src, void* out, int rows, int h, int units,
           int linear, int parity0, cudaStream_t stream) {
  int threads = (units + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid((units + threads - 1) / threads,
                  rows < kMaxGridY ? rows : kMaxGridY);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  if (linear) {
    deint_both_parities_kernel<T, true><<<grid, threads, 0, stream>>>(
        s, o, rows, h, units, parity0);
  } else {
    deint_both_parities_kernel<T, false><<<grid, threads, 0, stream>>>(
        s, o, rows, h, units, parity0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// method: 0 linear, 1 scalerbob (ops/deint_kernel.py METHODS).  The caller
// checks nf * h < 2^31, nf, h, w >= 1 and parity0 in {0, 1}.
extern "C" int gst_deint_both_parities_u8(const void* src, void* out, int nf,
                                          int h, int w, int method,
                                          int parity0, void* stream) {
  const int rows = nf * h;
  const bool vec = w % 16 == 0
                   && reinterpret_cast<uintptr_t>(src) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int linear = method == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<uint4>(src, out, rows, h, w / 16, linear, parity0, s)
             : launch<uint8_t>(src, out, rows, h, w, linear, parity0, s);
}
