// Two-pass separable S16-tap scale of an 8-bit plane, for Hopper (sm_90a).
//
// Shared by csrc/yscale.cu (luma, straight from the stored plane) and
// csrc/chroma420.cu (4:2:0 chroma, from virtual full-resolution samples).
// Per pass the result is the reference's fixed-point rounding
// (video-orc.orc resample_*_u8):  clamp((sum tap_s16 * px + 2^p - 1) >> p).
//
// One block owns one frame and one tile of output rows, and computes those
// outputs completely: no sum is carried between blocks.
//   1. flag the input rows the tile's vertical taps read, [v_off[r0],
//      v_off[r1-1] + tv), and keep only those (2-tap filters read fewer
//      than half of them);
//   2. stage those rows in shared memory a chunk at a time (Source::fetch)
//      and run the horizontal pass from there into a u8 row buffer, also in
//      shared memory;
//   3. run the vertical pass from that buffer and write the output once.
// Device memory sees each needed input row of the tile once and each output
// once; tiles overlap by the vertical filter's reach.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "status.cuh"

namespace scale2pass {

constexpr int kThreads = 256;
constexpr int kRowsPerChunk = 8;   // mirrored in ops/_scale2pass.py

struct Taps {
  const int32_t* h_off;    // [ow]      first source column of output column j
  const int16_t* h_taps;   // [th][ow]  tap-major, so neighbouring j are adjacent
  const int32_t* v_off;    // [oh]      first source row of output row r
  const int16_t* v_taps;   // [oh][tv]
  int in_w, ow, oh, th, tv, precision;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Dynamic shared memory: h taps | h-pass rows (u8) | staged source rows (u8)
// | needed-row list (int).  ops/_scale2pass.py computes the same total.
struct SmemLayout {
  size_t hbuf, rowbuf, rows, total;
  __host__ __device__ SmemLayout(const Taps& t, int span_max) {
    hbuf = align16(static_cast<size_t>(t.th) * t.ow * 2);
    rowbuf = hbuf + align16(static_cast<size_t>(span_max) * t.ow);
    rows = rowbuf + align16(static_cast<size_t>(kRowsPerChunk) * t.in_w);
    total = rows + static_cast<size_t>(span_max) * 4;
  }
};

__device__ __forceinline__ int round_u8(int acc, int precision) {
  const int v = (acc + ((1 << precision) - 1)) >> precision;  // arithmetic
  return min(max(v, 0), 255);
}

template <class Source, class OutT>
__global__ void __launch_bounds__(kThreads)
scale2pass_kernel(Source src, Taps t, OutT* __restrict__ out, int tile_rows,
                  int span_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lo, s_n;
  const SmemLayout L(t, span_max);
  int16_t* s_taps = reinterpret_cast<int16_t*>(smem);
  uint8_t* s_h = smem + L.hbuf;
  uint8_t* s_row = smem + L.rowbuf;
  int* s_rows = reinterpret_cast<int*>(smem + L.rows);

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile_rows;
  const int r1 = min(r0 + tile_rows, t.oh);
  const int tid = threadIdx.x;

  for (int i = tid; i < t.th * t.ow; i += blockDim.x) s_taps[i] = t.h_taps[i];
  if (tid == 0) {
    int lo = t.v_off[r0], hi = t.v_off[r0];
    for (int r = r0 + 1; r < r1; ++r) {
      lo = min(lo, t.v_off[r]);
      hi = max(hi, t.v_off[r]);
    }
    s_lo = lo;
    s_n = hi + t.tv - lo;
  }
  __syncthreads();
  const int lo = s_lo;
  const int span = s_n;

  // 1. which rows of [lo, lo + span) the tile's vertical taps read
  for (int i = tid; i < span; i += blockDim.x) {
    int need = 0;
    for (int r = r0; r < r1 && !need; ++r) {
      const int d = lo + i - t.v_off[r];
      need = d >= 0 && d < t.tv;
    }
    s_rows[i] = need;
  }
  __syncthreads();
  if (tid == 0) {  // compact in place: the write index never passes the read
    int n = 0;
    for (int i = 0; i < span; ++i)
      if (s_rows[i]) s_rows[n++] = i;
    s_n = n;
  }
  __syncthreads();
  const int n_rows = s_n;

  // 2. horizontal pass over the needed rows, a chunk of staged rows at a time
  for (int c0 = 0; c0 < n_rows; c0 += kRowsPerChunk) {
    const int nc = min(kRowsPerChunk, n_rows - c0);
    for (int i = tid; i < nc * t.in_w; i += blockDim.x) {
      const int k = i / t.in_w;
      s_row[i] = src.fetch(b, lo + s_rows[c0 + k], i - k * t.in_w);
    }
    __syncthreads();
    for (int i = tid; i < nc * t.ow; i += blockDim.x) {
      const int k = i / t.ow;
      const int j = i - k * t.ow;
      const uint8_t* px = s_row + k * t.in_w + t.h_off[j];
      int acc = 0;
      for (int q = 0; q < t.th; ++q)
        acc += static_cast<int>(s_taps[q * t.ow + j]) * px[q];
      s_h[s_rows[c0 + k] * t.ow + j] =
          static_cast<uint8_t>(round_u8(acc, t.precision));
    }
    __syncthreads();
  }

  // 3. vertical pass from shared memory; each output written once
  for (int i = tid; i < (r1 - r0) * t.ow; i += blockDim.x) {
    const int k = i / t.ow;
    const int j = i - k * t.ow;
    const int r = r0 + k;
    const uint8_t* col = s_h + (t.v_off[r] - lo) * t.ow + j;
    const int16_t* tap = t.v_taps + static_cast<size_t>(r) * t.tv;
    int acc = 0;
    for (int q = 0; q < t.tv; ++q)
      acc += static_cast<int>(__ldg(tap + q)) * col[q * t.ow];
    out[(static_cast<size_t>(b) * t.oh + r) * t.ow + j] =
        static_cast<OutT>(round_u8(acc, t.precision));
  }
}

// Launch on `stream`; returns the CUDA error code (0 on success).
template <class Source, class OutT>
int launch(const Source& src, const Taps& t, OutT* out, int batch,
           int tile_rows, int span_max, cudaStream_t stream) {
  const SmemLayout L(t, span_max);
  auto kern = scale2pass_kernel<Source, OutT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((t.oh + tile_rows - 1) / tile_rows, batch);
  kern<<<grid, kThreads, L.total, stream>>>(src, t, out, tile_rows, span_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scale2pass
