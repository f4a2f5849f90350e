// removesilence's VAD power tracker: the Q16 recursion over a buffer of
// int16 samples, from the carried power to the last, one warp a stream.
//
// Replaces the jitted lax.scan of gstreamer_tpu/elements/removesilence.py
// (Vad._power_fn, :62-72, run at :76-77; Pallas has no counterpart).
// Reference: gst-plugins-bad gst/removesilence/vad_private.c:124-127:
//   u  = ((s * s) >> 14) & 0xFFFF
//   p' = 0x0800*u + 0xF7FF*(p >> 16) + ((0xF7FF*(p & 0xFFFF)) >> 16)
// in unsigned 64-bit integers (exact here for 0 <= p < 2^63).
//
// Bound: latency.  Two bytes in a sample and a few integer operations; what
// limits it is the chain through p inside one thread.  Two identities
// shorten that chain to one instruction a sample.  With B = 0xF7FF and
// p = 2^16*h + l, B*p = 2^16*B*h + B*l, so while B*p < 2^64 (p < 2^48)
//   B*(p >> 16) + ((B*(p & 0xFFFF)) >> 16) = (B*p) >> 16,
// and once p < 2^32 it stays there (p' <= 0x0800*65535 +
// ((B*(2^32-1)) >> 16) = 4 294 899 711), where (B*p) >> 16 is the high
// word of p * (B << 16).  So the chain is
//   split form   while p >= 2^48 (no real state gets there),
//   (B*p) >> 16 in 64 bits while p >= 2^32,
//   p' = mulhi(p, 0xF7FF0000) + 0x0800*u   (one mad.hi.u32) after,
// each phase a prefix of the loop.  The reference starts at 0 and never
// leaves the 32-bit phase.  0x0800*u is taken off the chain: the warp
// computes it for a tile of samples into shared memory from 16-byte loads
// (8 samples a lane) before lane 0 runs the chain over the tile.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "status.cuh"

namespace {

constexpr int kTile = 4096;                      // samples a tile
constexpr unsigned long long kB = 0xF7FFull;

__device__ __forceinline__ uint32_t alpha_u(int v) {
  return ((static_cast<uint32_t>(v * v) >> 14) & 0xFFFFu) << 11;
}

// p after the tile's len samples, whose 0x0800*u are a[0 .. len)
__device__ unsigned long long chain(const uint32_t* a, int len,
                                   unsigned long long p) {
  int i = 0;
  for (; i < len && p >= (1ull << 48); ++i) {
    p = a[i] + kB * (p >> 16) + ((kB * (p & 0xFFFFull)) >> 16);
  }
  for (; i < len && (p >> 32) != 0; ++i) p = a[i] + ((kB * p) >> 16);
  if (i == len) return p;
  uint32_t q = static_cast<uint32_t>(p);
#pragma unroll 8
  for (; i < len; ++i) {
    asm("mad.hi.u32 %0, %1, %2, %3;"
        : "=r"(q)
        : "r"(q), "r"(static_cast<uint32_t>(kB << 16)), "r"(a[i]));
  }
  return q;
}

__global__ void __launch_bounds__(32)
vad_power_kernel(const int16_t* __restrict__ x,
                 const int64_t* __restrict__ p0, int64_t* __restrict__ p_out,
                 int n) {
  __shared__ __align__(16) uint32_t a[kTile];
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const int16_t* xs = x + static_cast<size_t>(s) * n;
  unsigned long long p = static_cast<unsigned long long>(p0[s]);
  const bool vec = (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    int done = 0;
    if (vec) {                             // t0 keeps the 16-byte alignment
      const int groups = len / 8;
      const int4* xv = reinterpret_cast<const int4*>(xs + t0);
      for (int k = lane; k < groups; k += 32) {
        const int4 v = __ldg(xv + k);
        const int w[4] = {v.x, v.y, v.z, v.w};
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[2 * j] = alpha_u(static_cast<int16_t>(w[j] & 0xFFFF));
          o[2 * j + 1] = alpha_u(w[j] >> 16);
        }
        uint4* dst = reinterpret_cast<uint4*>(a + 8 * k);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
      done = groups * 8;
    }
    for (int j = done + lane; j < len; j += 32) a[j] = alpha_u(xs[t0 + j]);
    __syncwarp();
    if (lane == 0) p = chain(a, len, p);
    __syncwarp();
  }
  if (lane == 0) p_out[s] = static_cast<int64_t>(p);
}

}  // namespace

// x: (streams, n) int16; p0, p_out: (streams,) int64 on the card.  The
// caller checks streams >= 1, n >= 1 and contiguity.
extern "C" int gst_vad_power(const void* x, const void* p0, void* p_out,
                             int streams, int n, void* stream) {
  vad_power_kernel<<<streams, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const int64_t*>(p0),
      static_cast<int64_t*>(p_out), n);
  return static_cast<int>(cudaGetLastError());
}
