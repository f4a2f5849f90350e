// Two-pass separable S16-tap scale of an 8-bit plane, for Hopper (sm_90a).
//
// Shared by csrc/yscale.cu and csrc/scale2d.cu (a stored plane, int16 or
// int32 out) and csrc/chroma420.cu (4:2:0 chroma, from virtual
// full-resolution samples).  The horizontal-only helpers at the end
// (stage_span, hpass_rows, hscale_kernel) serve csrc/hscale.cu and
// csrc/fused_ingest.cu.
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

// A stored (B, h, w) u8 plane as the two-pass kernel's Source.
struct PlaneSource {
  const uint8_t* p;
  int h, w;
  __device__ __forceinline__ uint8_t fetch(int b, int y, int x) const {
    return __ldg(p + (static_cast<size_t>(b) * h + y) * w + x);
  }
};

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

// ---- horizontal pass only ---------------------------------------------------

struct HTaps {
  const int32_t* h_off;    // [ow]
  const int16_t* h_taps;   // [th][ow]  tap-major
  int in_w, ow, th, precision;
};

// Shared memory of the h tables: taps [th][ow] int16, then offsets [ow] int32.
__host__ __device__ inline size_t htable_bytes(int th, int ow) {
  return align16(static_cast<size_t>(th) * ow * 2) +
         align16(static_cast<size_t>(ow) * 4);
}

__device__ __forceinline__ void load_htables(const HTaps& t, int16_t* s_taps,
                                             int32_t* s_off) {
  for (int i = threadIdx.x; i < t.th * t.ow; i += blockDim.x)
    s_taps[i] = t.h_taps[i];
  for (int i = threadIdx.x; i < t.ow; i += blockDim.x) s_off[i] = t.h_off[i];
}

// Copy n contiguous bytes from device memory into shared memory, 16 bytes a
// thread where both sides allow it.  `s_base` is 16-byte aligned and has 16
// bytes of slack; the copy lands at s_base + (src & 15) so that source and
// destination share their alignment.  Returns where the first byte landed.
// The caller synchronises.
__device__ __forceinline__ uint8_t* stage_span(uint8_t* s_base,
                                               const uint8_t* src, int n) {
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  uint8_t* dst = s_base + skew;
  const int head = min(n, (16 - skew) & 15);
  const int nvec = (n - head) >> 4;
  const int tail0 = head + (nvec << 4);
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) vdst[i] = __ldg(vsrc + i);
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = __ldg(src + i);
  for (int i = tail0 + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = __ldg(src + i);
  return dst;
}

// Horizontal tap pass over n_rows rows of in_w samples held in shared memory
// (row k at s_rows + k * in_w).  store(k, j, value) takes each result.
template <class Store>
__device__ __forceinline__ void hpass_rows(const uint8_t* s_rows, int n_rows,
                                           const HTaps& t,
                                           const int16_t* s_taps,
                                           const int32_t* s_off,
                                           const Store& store) {
  for (int i = threadIdx.x; i < n_rows * t.ow; i += blockDim.x) {
    const int k = i / t.ow;
    const int j = i - k * t.ow;
    const uint8_t* px = s_rows + k * t.in_w + s_off[j];
    int acc = 0;
    for (int q = 0; q < t.th; ++q)
      acc += static_cast<int>(s_taps[q * t.ow + j]) * px[q];
    store(k, j, round_u8(acc, t.precision));
  }
}

template <class OutT>
struct RowStore {
  OutT* out;               // first row of the block
  int ow;
  __device__ __forceinline__ void operator()(int k, int j, int v) const {
    out[static_cast<size_t>(k) * ow + j] = static_cast<OutT>(v);
  }
};

// h-scale of total_rows rows (all frames' rows, back to back); a block owns
// rows_per_block consecutive rows: one contiguous span of device memory.
template <class OutT>
__global__ void __launch_bounds__(kThreads)
hscale_kernel(const uint8_t* __restrict__ src, HTaps t, OutT* __restrict__ out,
              int total_rows, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_taps = reinterpret_cast<int16_t*>(smem);
  int32_t* s_off = reinterpret_cast<int32_t*>(
      smem + align16(static_cast<size_t>(t.th) * t.ow * 2));
  uint8_t* s_base = smem + htable_bytes(t.th, t.ow);

  const int r0 = blockIdx.x * rows_per_block;
  const int n_rows = min(rows_per_block, total_rows - r0);
  load_htables(t, s_taps, s_off);
  const uint8_t* s_rows =
      stage_span(s_base, src + static_cast<size_t>(r0) * t.in_w,
                 n_rows * t.in_w);
  __syncthreads();
  hpass_rows(s_rows, n_rows, t, s_taps, s_off,
             RowStore<OutT>{out + static_cast<size_t>(r0) * t.ow, t.ow});
}

// Shared memory of hscale_kernel; ops/hscale_kernel.py computes the same.
__host__ __device__ inline size_t hscale_smem(int in_w, int ow, int th,
                                              int rows_per_block) {
  return htable_bytes(th, ow) +
         align16(static_cast<size_t>(rows_per_block) * in_w) + 16;
}

template <class OutT>
int launch_hscale(const uint8_t* src, const HTaps& t, OutT* out,
                  int total_rows, int rows_per_block, cudaStream_t stream) {
  const size_t smem = hscale_smem(t.in_w, t.ow, t.th, rows_per_block);
  auto kern = hscale_kernel<OutT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (total_rows + rows_per_block - 1) / rows_per_block;
  kern<<<blocks, kThreads, smem, stream>>>(
      src, t, out, total_rows, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scale2pass
