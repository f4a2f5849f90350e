// removesilence's VAD power tracker: the Q16 recursion over a buffer of
// int16 samples, one thread a stream, from the carried power to the last.
//
// Replaces the jitted lax.scan of gstreamer_tpu/elements/removesilence.py
// (Vad._power_fn, :62-72, run at :76-77; Pallas has no counterpart).
// Reference: gst-plugins-bad gst/removesilence/vad_private.c:124-127:
//   u  = ((s * s) >> 14) & 0xFFFF
//   p' = 0x0800*u + 0xF7FF*(p >> 16) + ((0xF7FF*(p & 0xFFFF)) >> 16)
// in unsigned 64-bit integers; p stays below 2^33.
//
// Bound: latency.  Two bytes in a sample and a few integer operations; what
// limits it is the chain through p, a 64-bit shift, multiply and add a
// sample, inside one thread.  The loads are not on the chain: the loop is
// unrolled so that they are in flight ahead of it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "status.cuh"

namespace {

__global__ void vad_power_kernel(const int16_t* __restrict__ x,
                                 const int64_t* __restrict__ p0,
                                 int64_t* __restrict__ p_out, int streams,
                                 int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= streams) return;
  const int16_t* xs = x + static_cast<size_t>(s) * n;
  unsigned long long p = static_cast<unsigned long long>(p0[s]);
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const int v = xs[i];
    const unsigned long long u =
        static_cast<unsigned long long>((v * v) >> 14) & 0xFFFFull;
    p = 0x0800ull * u + 0xF7FFull * (p >> 16)
        + ((0xF7FFull * (p & 0xFFFFull)) >> 16);
  }
  p_out[s] = static_cast<int64_t>(p);
}

}  // namespace

// x: (streams, n) int16; p0, p_out: (streams,) int64 on the card.  The
// caller checks streams >= 1, n >= 1 and contiguity.
extern "C" int gst_vad_power(const void* x, const void* p0, void* p_out,
                             int streams, int n, void* stream) {
  const int threads = streams < 128 ? 32 * ((streams + 31) / 32) : 128;
  const int blocks = (streams + threads - 1) / threads;
  vad_power_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const int64_t*>(p0),
      static_cast<int64_t*>(p_out), streams, n);
  return static_cast<int>(cudaGetLastError());
}
