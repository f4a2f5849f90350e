// Separable S16-tap scale of an 8-bit plane, for Hopper (sm_90a).
//
// The two-pass kernel (scale2pass_kernel) is shared by csrc/yscale.cu and
// csrc/scale2d.cu (a stored plane, int16 or int32 out) and csrc/chroma420.cu
// (4:2:0 chroma: the full-resolution rows are built in shared memory from
// the half-resolution plane).  The horizontal-only part at the end (hrun,
// hpass_store, the row stores, hscale_kernel) serves csrc/hscale.cu and
// csrc/fused_ingest.cu with the same packed horizontal pass; the 4:2:0 up2
// filters on whole words (up2_columns, up2_row) serve csrc/chroma420.cu and
// csrc/fused_ingest.cu.
// Per pass the result is the reference's fixed-point rounding
// (video-orc.orc resample_*_u8):  clamp((sum tap_s16 * px + 2^p - 1) >> p),
// horizontal first, then vertical.
//
// One block owns one frame and one tile of output rows and computes those
// outputs completely: no sum is carried between blocks.  What bounds it on
// this card is, in turn, the staging of source rows (2 taps: nothing else
// happens) and shared-memory bandwidth in the horizontal pass (35 taps a
// column at 1080p -> 224 cubic).  The design, step by step:
//   1. The host lists, per tile, the input rows the tile's vertical taps
//      read (ops/_scale2pass.py row_table); no block scans or compacts.
//   2. Those rows are staged a chunk of 8 at a time into a ring of chunk
//      buffers: one bulk copy (TMA, 1-D) a row, completing on the slot's
//      mbarrier, when base and width are multiples of 16 (else word by word,
//      any alignment and width), so the next chunks load while chunk c is
//      computed and no thread spends instructions on the copy; one block
//      barrier a chunk.
//   3. The horizontal pass: a thread owns one output column over the 8 rows
//      of the chunk, so its taps are read once a chunk.  Pixels are read as
//      32-bit words and multiplied with dp4a: each S16 tap is split on the
//      host into byte limbs, tap = 256 * hi + lo (lo u8, hi s8), four taps
//      to a word, shifted so that every column starts on a source word;
//      acc = (dp4a(px, hi) << 8) + dp4a(px, lo) is the exact int32 sum.
//      The rounded u8 results go to a buffer in shared memory that is kept
//      column by column (entry = place in the tile's row list).
//      The host also orders the columns (ops/_scale2pass.py column_order) so
//      that the 32 lanes of a warp start on words in 32 different banks: in
//      natural order lanes lie 8.57 bytes apart and every load costs three
//      passes over the banks.
//   4. The vertical pass is the same dp4a dot product along a column's line
//      of that buffer, with the tile's vertical taps packed the same way, and
//      writes each output once.
// Device memory sees each needed input row of a tile once and each output
// once; tiles overlap by the vertical filter's reach.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "status.cuh"

namespace scale2pass {

constexpr int kThreads = 256;
constexpr int kRowsPerChunk = 8;   // mirrored in ops/_scale2pass.py
constexpr int kMaxStages = 4;

struct Taps {
  const int2* h_cols;      // [ow]      {first source word, output column} of
                           //           entry s, in the host's column order
  const int2* h_taps;      // [nw][ow]  {lo limbs u8x4, hi limbs s8x4} of entry s
  const int32_t* v_word;   // [oh]      first word of output row r's window in
                           //           a column of the h-pass buffer
  const int2* v_taps;      // [nwv][oh] {lo limbs, hi limbs}, as h_taps
  const int32_t* rows;     // [tiles][n_max]  input rows a tile reads, ascending
  const int32_t* count;    // [tiles]
  int in_w, ow, oh, nw, nwv, precision, tile_rows, n_max, stages;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Bytes between staged full-width rows: the h pass reads whole words and may
// run a few zero-tap bytes past the row.
__host__ __device__ inline int row_stride(int in_w) {
  return static_cast<int>(align16(in_w)) + 16;
}

// Bytes between the columns of the h-pass buffer.  It is kept column by
// column, so that the v pass reads along a line as the h pass does: room for
// whole chunks and the zero-tap words past the last row, and an odd number of
// words, so that neighbouring columns start in different banks.
__host__ __device__ inline int hbuf_pitch(int n_max) {
  const int pitch = ((n_max + 7) & ~7) + 8;
  return ((pitch >> 2) & 1) ? pitch : pitch + 4;
}

// Dynamic shared memory: packed h taps | the tile's packed v taps | h-pass
// result (u8, column by column) | the source's staging.
// ops/_scale2pass.py smem_bytes computes the same total.
struct Layout {
  size_t vtaps, hbuf, src, total;
  __host__ __device__ Layout(const Taps& t, size_t src_bytes) {
    vtaps = align16(static_cast<size_t>(t.nw) * t.ow * 8);
    hbuf = vtaps + align16(static_cast<size_t>(t.nwv) * t.tile_rows * 8);
    src = hbuf + align16(static_cast<size_t>(t.ow) * hbuf_pitch(t.n_max));
    total = src + src_bytes;
  }
};

__device__ __forceinline__ int round_u8(int acc, int precision) {
  const int v = (acc + ((1 << precision) - 1)) >> precision;  // arithmetic
  return min(max(v, 0), 255);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers that the bulk copies of a ring slot complete on
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `parity` has completed.  A wait that never ends
// (a lost copy) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1 << 24)) __trap();
  }
}

// One bulk copy (TMA, 1-D) of `bytes` from device to shared memory, both
// 16-byte aligned, bytes a multiple of 16; completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem_dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem_dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The `nbytes` (1..4) bytes at g, any alignment, as one little-endian word.
// Reads only aligned words that hold at least one of those bytes.
__device__ __forceinline__ uint32_t load_word_unaligned(const uint8_t* g,
                                                        int nbytes) {
  const int m = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 3);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(g - m);
  const uint32_t lo = __ldg(a);
  const uint32_t hi = (m + nbytes > 4) ? __ldg(a + 1) : 0u;
  return __funnelshift_r(lo, hi, 8 * m);
}

// Stage rows ids[0..n) (n <= 32) of a plane whose rows are `len` bytes, back
// to back, into dst + k * stride (16-byte aligned).  `aligned`: the plane's
// base and len are multiples of 16, so each row is one bulk copy, started by a
// lane of warp 0, and `bar` completes when all have landed; otherwise all
// threads copy word by word, synchronously, and `bar` is not used.
__device__ __forceinline__ void stage_rows(uint8_t* dst, int stride,
                                           const uint8_t* plane, int len,
                                           const int32_t* ids, int n,
                                           bool aligned, uint64_t* bar) {
  if (aligned) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) mbar_expect_tx(bar, static_cast<uint32_t>(n) * len);
      __syncwarp();
      if (threadIdx.x < n)
        bulk_copy(dst + threadIdx.x * stride,
                  plane + static_cast<size_t>(__ldg(ids + threadIdx.x)) * len,
                  len, bar);
    }
  } else {
    const int per = (len + 3) >> 2;
    for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
      const int k = i / per;
      const int x = (i - k * per) << 2;
      const uint8_t* g = plane + static_cast<size_t>(__ldg(ids + k)) * len + x;
      *reinterpret_cast<uint32_t*>(dst + k * stride + x) =
          load_word_unaligned(g, min(4, len - x));
    }
  }
}

__device__ __forceinline__ int dp4a_u8_u8(uint32_t a, int b, int c) {
  int d;
  asm("dp4a.u32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ int dp4a_u8_s8(uint32_t a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// A stored (B, h, w) u8 plane as the two-pass kernel's Source: the ring holds
// `stages` chunks of kRowsPerChunk rows.
struct PlaneSource {
  const uint8_t* p;
  int h, w, aligned;

  __host__ __device__ size_t smem_bytes(const Taps& t) const {
    return static_cast<size_t>(t.stages) * kRowsPerChunk * row_stride(w);
  }
  // start the loads of chunk c into ring slot `slot`
  __device__ __forceinline__ void fetch(uint8_t* s_src, const Taps& t, int b,
                                        int tile, int c, int slot, int n_rows,
                                        uint64_t* bar) const {
    const int rs = row_stride(w);
    stage_rows(s_src + static_cast<size_t>(slot) * kRowsPerChunk * rs, rs,
               p + static_cast<size_t>(b) * h * w, w,
               t.rows + static_cast<size_t>(tile) * t.n_max +
                   c * kRowsPerChunk,
               min(kRowsPerChunk, n_rows - c * kRowsPerChunk), aligned, bar);
  }
  // the chunk's rows, row_stride(w) apart, once its loads have landed
  __device__ __forceinline__ const uint8_t* prepare(uint8_t* s_src,
                                                    const Taps&, int, int,
                                                    int slot, int) const {
    return s_src + static_cast<size_t>(slot) * kRowsPerChunk * row_stride(w);
  }
};

// Rounded result of the two limb sums.
__device__ __forceinline__ uint32_t limb_round(int lo, int hi, int precision) {
  return static_cast<uint32_t>(round_u8(
      static_cast<int>(static_cast<uint32_t>(hi) << 8) + lo, precision));
}

// The exact limb sums of one output column over the 8 rows of a chunk: px is
// the column's first word in the chunk's first row, rows stride_w words
// apart; taps[q * ow] holds the {lo, hi} limb words that meet word q.
__device__ __forceinline__ void hdot8(const uint32_t* px, int stride_w, int nw,
                                      const int2* taps, int ow,
                                      int (&lo)[kRowsPerChunk],
                                      int (&hi)[kRowsPerChunk]) {
#pragma unroll
  for (int k = 0; k < kRowsPerChunk; ++k) lo[k] = hi[k] = 0;
  for (int q = 0; q < nw; ++q) {
    const int2 w = taps[q * ow];
#pragma unroll
    for (int k = 0; k < kRowsPerChunk; ++k) {
      const uint32_t v = px[k * stride_w + q];
      lo[k] = dp4a_u8_u8(v, w.x, lo[k]);
      hi[k] = dp4a_u8_s8(v, w.y, hi[k]);
    }
  }
}

// Horizontal pass over the 8 rows of chunk c: a thread owns one output
// column and leaves its 8 results as two words of that column's line in the
// h-pass buffer (rows past the tile's last are written too and never read
// with a tap that is not zero).  The host orders the columns so that the
// lanes of a warp start on words in different banks.
__device__ __forceinline__ void hpass_chunk(const uint8_t* rows8, int c,
                                            const Taps& t, const int2* s_taps,
                                            uint8_t* s_h) {
  const int stride_w = row_stride(t.in_w) >> 2;
  const int pitch = hbuf_pitch(t.n_max);
  for (int j = threadIdx.x; j < t.ow; j += blockDim.x) {
    const int2 col = __ldg(t.h_cols + j);
    int lo[kRowsPerChunk], hi[kRowsPerChunk];
    hdot8(reinterpret_cast<const uint32_t*>(rows8) + col.x, stride_w, t.nw,
          s_taps + j, t.ow, lo, hi);
    uint32_t* dst = reinterpret_cast<uint32_t*>(s_h + col.y * pitch +
                                                c * kRowsPerChunk);
#pragma unroll
    for (int k = 0; k < kRowsPerChunk; k += 4)
      dst[k >> 2] = limb_round(lo[k], hi[k], t.precision) |
                    limb_round(lo[k + 1], hi[k + 1], t.precision) << 8 |
                    limb_round(lo[k + 2], hi[k + 2], t.precision) << 16 |
                    limb_round(lo[k + 3], hi[k + 3], t.precision) << 24;
  }
}

// Vertical pass over the tile's output rows, four at a time: a thread owns
// one output column and reads along its line of the h-pass buffer.  Rows past
// the tile's last repeat its last row's work and store nothing.
template <class OutT>
__device__ __forceinline__ void vpass_tile(const uint8_t* s_h, const Taps& t,
                                           const int2* s_vt, int r0, int r1,
                                           OutT* out_frame) {
  constexpr int kRows = 4;
  const int pitch_w = hbuf_pitch(t.n_max) >> 2;
  for (int k0 = 0; k0 < r1 - r0; k0 += kRows) {
    int kk[kRows], first[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      kk[k] = min(k0 + k, r1 - r0 - 1);
      first[k] = __ldg(t.v_word + r0 + kk[k]);
    }
    for (int j = threadIdx.x; j < t.ow; j += blockDim.x) {
      const uint32_t* line = reinterpret_cast<const uint32_t*>(s_h) + j * pitch_w;
      int lo[kRows], hi[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) lo[k] = hi[k] = 0;
      for (int q = 0; q < t.nwv; ++q) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int2 w = s_vt[q * t.tile_rows + kk[k]];
          const uint32_t v = line[first[k] + q];
          lo[k] = dp4a_u8_u8(v, w.x, lo[k]);
          hi[k] = dp4a_u8_s8(v, w.y, hi[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (k0 + k < r1 - r0)
          out_frame[static_cast<size_t>(r0 + k0 + k) * t.ow + j] =
              static_cast<OutT>(limb_round(lo[k], hi[k], t.precision));
    }
  }
}

template <class Source, class OutT>
__global__ void __launch_bounds__(kThreads, 2)
scale2pass_kernel(Source src, Taps t, OutT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(t, 0);
  int2* s_taps = reinterpret_cast<int2*>(smem);
  int2* s_vt = reinterpret_cast<int2*>(smem + L.vtaps);
  uint8_t* s_h = smem + L.hbuf;
  uint8_t* s_src = smem + L.src;

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = tile * t.tile_rows;
  const int r1 = min(r0 + t.tile_rows, t.oh);
  const int tid = threadIdx.x;
  const int n_rows = __ldg(t.count + tile);
  const int n_chunks = (n_rows + kRowsPerChunk - 1) / kRowsPerChunk;

  __shared__ uint64_t s_bar[kMaxStages];   // one per ring slot
  if (src.aligned) {
    if (tid == 0) {
      for (int i = 0; i < t.stages; ++i) mbar_init(&s_bar[i], 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  // the first chunks are on their way while the tables load
  for (int c = 0; c < t.stages - 1; ++c)
    if (c < n_chunks) src.fetch(s_src, t, b, tile, c, c, n_rows, &s_bar[c]);
  for (int i = tid; i < t.nw * t.ow; i += blockDim.x) s_taps[i] = t.h_taps[i];
  for (int i = tid; i < t.nwv * t.tile_rows; i += blockDim.x) {
    const int q = i / t.tile_rows;
    const int r = r0 + i - q * t.tile_rows;
    s_vt[i] = r < r1 ? t.v_taps[static_cast<size_t>(q) * t.oh + r]
                     : make_int2(0, 0);
  }

  // horizontal pass, chunk by chunk; chunk c + stages - 1 loads meanwhile
  int slot = 0;
  uint32_t parity = 0;
  for (int c = 0; c < n_chunks; ++c) {
    if (src.aligned) mbar_wait(&s_bar[slot], parity);   // chunk c is in
    __syncthreads();               // for everyone; chunk c - 1 is done with
    const int nxt = c + t.stages - 1;
    const int nxt_slot = slot == 0 ? t.stages - 1 : slot - 1;
    if (nxt < n_chunks)
      src.fetch(s_src, t, b, tile, nxt, nxt_slot, n_rows, &s_bar[nxt_slot]);
    const uint8_t* rows8 = src.prepare(s_src, t, tile, c, slot, n_rows);
    hpass_chunk(rows8, c, t, s_taps, s_h);
    if (++slot == t.stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
  __syncthreads();

  // vertical pass from shared memory; each output written once
  vpass_tile(s_h, t, s_vt, r0, r1, out + static_cast<size_t>(b) * t.oh * t.ow);
}

// Launch on `stream`; returns the CUDA error code (0 on success).  `smem` is
// the host's own count of the block's shared memory and must equal Layout's.
template <class Source, class OutT>
int launch(const Source& src, const Taps& t, OutT* out, int batch, int smem,
           cudaStream_t stream) {
  const Layout L(t, src.smem_bytes(t));
  if (t.stages < 2 || t.stages > kMaxStages ||
      static_cast<size_t>(smem) != L.total)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = scale2pass_kernel<Source, OutT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((t.oh + t.tile_rows - 1) / t.tile_rows, batch);
  kern<<<grid, kThreads, L.total, stream>>>(src, t, out);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p, int len) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (len & 15) == 0;
}

// ---- 4:2:0 up2 filters on whole words ---------------------------------------
//
// video-chroma.c's 2x upsampling filters as exact byte arithmetic on 32-bit
// words, four samples an instruction; csrc/chroma420.cu and
// csrc/fused_ingest.cu build their full-resolution chroma rows with them.

// (3a + b + 2) >> 2 on each byte of a word: the rounded-up average of a and
// the rounded-down average of a and b (exact: the two roundings never meet)
__device__ __forceinline__ uint32_t filt31(uint32_t a, uint32_t b) {
  return __vavgu4(a, __vhaddu4(a, b));
}

// up2 columns of n staged half-resolution rows of cw samples (cs bytes
// apart, 16-byte aligned), interleaved to full width: row r goes to dst(r).
// Cosited: c[k], (c[k] + c[k+1] + 1) >> 1; interstitial: (c[k-1] + 3c[k] + 2)
// >> 2, (3c[k] + c[k+1] + 2) >> 2; edges clamped.  A word of four chroma
// samples makes two words; a thread takes four words.  All threads of the
// block call it; the caller synchronises.
template <class Dst>
__device__ __forceinline__ void up2_columns(const uint8_t* rows, int cs, int n,
                                            int cw, bool h_cosited,
                                            const Dst& dst) {
  const int cwords = (cw + 3) >> 2;
  const int groups = (cwords + 3) >> 2;
  for (int i = threadIdx.x; i < n * groups; i += blockDim.x) {
    const int r = i / groups;
    const int x0 = (i - r * groups) << 2;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(rows + r * cs);
    const uint4 v = *reinterpret_cast<const uint4*>(row + x0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const uint32_t prev = x0 ? row[x0 - 1] >> 24 : w[0] & 255u;
    const uint32_t after = x0 + 4 < cwords ? row[x0 + 4] & 255u : 0u;
    uint8_t* out = dst(r) + 8 * x0;
    // the four words are independent of each other: a word's left
    // neighbour is the word before it as loaded
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int valid = cw - 4 * (x0 + m);   // samples from this word on
      if (valid > 0) {
        uint32_t cur = w[m];
        const uint32_t before = m ? w[m - 1] >> 24 : prev;
        uint32_t next = m < 3 ? w[m + 1] & 255u : after;
        if (valid <= 4) {                    // the row's last word
          next = (cur >> (8 * (valid - 1))) & 255u;
          if (valid < 4) {                   // repeat the last sample
            const uint32_t keep = (1u << (8 * valid)) - 1u;
            cur = (cur & keep) | ((next * 0x01010101u) & ~keep);
          }
        }
        const uint32_t left = (cur << 8) | before;         // c[k-1] per byte
        const uint32_t right = (cur >> 8) | (next << 24);  // c[k+1] per byte
        uint32_t e, o;
        if (h_cosited) {
          e = cur;
          o = __vavgu4(cur, right);          // (a + b + 1) >> 1 per byte
        } else {
          e = filt31(cur, left);
          o = filt31(cur, right);
        }
        *reinterpret_cast<uint2*>(out + 8 * m) =
            make_uint2(__byte_perm(e, o, 0x5140), __byte_perm(e, o, 0x7362));
      }
    }
  }
}

// up2 rows: one full-resolution row of in_w samples from the column-filtered
// row a of its own chroma row and b of the neighbour (cosited: their rounded
// average; interstitial: (3a + b + 2) >> 2), sixteen samples a lane of the
// calling warp.  All three rows are 16-byte aligned.
__device__ __forceinline__ void up2_row(const uint8_t* a, const uint8_t* b,
                                        uint8_t* out, int in_w, bool cosited) {
  const uint4* ra = reinterpret_cast<const uint4*>(a);
  const uint4* rb = reinterpret_cast<const uint4*>(b);
  uint4* ro = reinterpret_cast<uint4*>(out);
  const int per = (in_w + 15) >> 4;
  // four loads of each row in flight before the first is used
  for (int x0 = threadIdx.x & 31; x0 < per; x0 += 128) {
    uint4 p[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (x0 + 32 * i < per) {
        p[i] = ra[x0 + 32 * i];
        q[i] = rb[x0 + 32 * i];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (x0 + 32 * i < per)
        ro[x0 + 32 * i] =
            cosited ? make_uint4(__vavgu4(p[i].x, q[i].x),
                                 __vavgu4(p[i].y, q[i].y),
                                 __vavgu4(p[i].z, q[i].z),
                                 __vavgu4(p[i].w, q[i].w))
                    : make_uint4(filt31(p[i].x, q[i].x), filt31(p[i].y, q[i].y),
                                 filt31(p[i].z, q[i].z),
                                 filt31(p[i].w, q[i].w));
  }
}

// ---- horizontal pass only ---------------------------------------------------
//
// hscale_u8 and fused_i420_up_hscale scale every row of their input
// horizontally and write every result to device memory: 1 byte read per
// source sample and 2 or 4 written per output, so bytes bound them on this
// card as long as the products cost little.  They do here: the pass is the
// two-pass kernel's packed dp4a pass (hdot8), over the same host tables
// (ops/_scale2pass.py pack_h).  What the design does to stay near the bytes:
//   1. A block owns a run of consecutive rows (the host sizes it,
//      ops/_scale2pass.py run_chunks) and walks it a chunk of 8 rows at a
//      time, so the packed taps (17.9 KB at 35 taps) come once a run.
//   2. The rows of a chunk are consecutive in device memory: one bulk copy
//      (TMA, 1-D) a chunk into a ring of chunk buffers, completing on the
//      slot's mbarrier, when base and width are multiples of 16; the next
//      chunks load while chunk c is computed.  Otherwise all threads copy
//      word by word, any alignment and width, rows row_stride apart.
//   3. A warp's 32 columns are scattered over the output row (the host's
//      bank-aware order), so storing them directly would touch a sector per
//      lane.  The 8 x ow results of a chunk wait in shared memory instead,
//      at the same 16-byte phase as their place in device memory, and leave
//      16 bytes a thread while the next chunk is computed: the rows of a
//      chunk are one contiguous span of the output (two for chroma, whose
//      even and odd rows go to two planes).  One block barrier a chunk.

constexpr int kChromaRowsPerChunk = kRowsPerChunk / 2;
// The h-only kernels keep their registers low enough for this many blocks
// an SM (ops/_scale2pass.py H_BLOCKS_PER_SM): their steps are short and
// separated by barriers, so what hides their latency is other blocks.
constexpr int kHBlocksPerSM = 3;

struct HTaps {
  const int2* h_cols;      // [ow]      as Taps::h_cols
  const int2* h_taps;      // [nw][ow]  as Taps::h_taps
  int in_w, ow, nw, precision, stages;
};

// Bytes of one of the two buffers a store keeps for `rows` x ow results of
// `elem` bytes: room to start at any 16-byte phase.
__host__ __device__ inline size_t out_span_bytes(int rows, int ow, int elem) {
  return align16(static_cast<size_t>(rows) * ow * elem) + 16;
}

// Dynamic shared memory of a block that h-scales stored rows: packed h taps
// | ring of `stages` chunks | two buffers of a chunk's results.
// ops/_scale2pass.py hsmem_bytes computes the same total.
struct HLayout {
  size_t ring, out, total;
  __host__ __device__ HLayout(const HTaps& t, int elem) {
    ring = align16(static_cast<size_t>(t.nw) * t.ow * 8);
    out = ring + static_cast<size_t>(t.stages) * kRowsPerChunk *
                     row_stride(t.in_w);
    total = out + 2 * out_span_bytes(kRowsPerChunk, t.ow, elem);
  }
};

// Stage n consecutive rows of len bytes, the first at g.  `aligned`: g and
// len are multiples of 16, so the rows are one bulk copy, land len apart and
// complete on `bar`; otherwise all threads copy word by word, synchronously,
// rows `stride` apart (a multiple of 4), and `bar` is not used.
__device__ __forceinline__ void stage_run(uint8_t* dst, int stride,
                                          const uint8_t* g, int len, int n,
                                          bool aligned, uint64_t* bar) {
  if (aligned) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, static_cast<uint32_t>(n) * len);
      bulk_copy(dst, g, static_cast<uint32_t>(n) * len, bar);
    }
  } else {
    const int per = (len + 3) >> 2;
    for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
      const int k = i / per;
      const int x = (i - k * per) << 2;
      *reinterpret_cast<uint32_t*>(dst + k * stride + x) = load_word_unaligned(
          g + static_cast<size_t>(k) * len + x, min(4, len - x));
    }
  }
}

// Copy nbytes from shared memory to device memory, 16 bytes a thread; s and
// dst lie at the same 16-byte phase.
__device__ __forceinline__ void copy_out(void* dst_, const void* s_,
                                         int nbytes) {
  uint8_t* dst = static_cast<uint8_t*>(dst_);
  const uint8_t* s = static_cast<const uint8_t*>(s_);
  const int head = min(
      nbytes, (16 - static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15)) &
                  15);
  const int nvec = (nbytes - head) >> 4;
  const int tail0 = head + (nvec << 4);
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  const uint4* vs = reinterpret_cast<const uint4*>(s + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) vd[i] = vs[i];
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = s[i];
  for (int i = tail0 + threadIdx.x; i < nbytes; i += blockDim.x) dst[i] = s[i];
}

// Where the buffer for a span that goes to g starts inside its 16 bytes of
// slack: at g's own 16-byte phase.
template <class T>
__device__ __forceinline__ T* same_phase(uint8_t* s_buf, const T* g) {
  return reinterpret_cast<T*>(s_buf + (reinterpret_cast<uintptr_t>(g) & 15));
}

// A store takes the results of chunk c of a block's run: at(c) says where
// they wait in shared memory, put() places the result of row k (of the
// chunk) and output column col, flush(c) writes the chunk's rows out.
// Consecutive chunks take turns on two buffers: chunk c - 1 leaves while
// chunk c is computed.

// Rows that are consecutive in the output: chunk c is one span.
template <class OutT>
struct RowStore {
  OutT* out;               // first output row of the run
  uint8_t* s_out;          // 2 x out_span_bytes(kRowsPerChunk, ow, elem)
  int ow, n_rows;          // rows of the run

  __device__ __forceinline__ OutT* span(int c) const {
    return out + static_cast<size_t>(c) * kRowsPerChunk * ow;
  }
  __device__ __forceinline__ OutT* at(int c) const {
    return same_phase(
        s_out + (c & 1) * out_span_bytes(kRowsPerChunk, ow, sizeof(OutT)),
        span(c));
  }
  __device__ __forceinline__ void put(OutT* s, int k, int col,
                                      uint32_t v) const {
    s[k * ow + col] = static_cast<OutT>(v);
  }
  __device__ __forceinline__ void flush(int c) const {
    const int n = min(kRowsPerChunk, n_rows - c * kRowsPerChunk);
    copy_out(span(c), at(c), n * ow * static_cast<int>(sizeof(OutT)));
  }
};

// Horizontal pass over the 8 rows of a chunk (stride_w words apart) into the
// store's buffer for chunk c: a thread owns one output column, as in
// hpass_chunk.  Rows past the run's last are computed from whatever the
// buffer holds and never leave.
template <class Store>
__device__ __forceinline__ void hpass_store(const uint8_t* rows8, int stride_w,
                                            const HTaps& t, const int2* s_taps,
                                            const Store& store, int c) {
  const auto s = store.at(c);
  for (int j = threadIdx.x; j < t.ow; j += blockDim.x) {
    const int2 col = __ldg(t.h_cols + j);
    int lo[kRowsPerChunk], hi[kRowsPerChunk];
    hdot8(reinterpret_cast<const uint32_t*>(rows8) + col.x, stride_w, t.nw,
          s_taps + j, t.ow, lo, hi);
#pragma unroll
    for (int k = 0; k < kRowsPerChunk; ++k)
      store.put(s, k, col.y, limb_round(lo[k], hi[k], t.precision));
  }
}

__device__ __forceinline__ void load_htaps(const HTaps& t, int2* s_taps) {
  for (int i = threadIdx.x; i < t.nw * t.ow; i += blockDim.x)
    s_taps[i] = t.h_taps[i];
}

// The mbarriers of a ring, one a slot; every thread of the block calls it.
__device__ __forceinline__ void ring_init(uint64_t* s_bar, int stages) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(&s_bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// h-scale of a run of n_rows consecutive stored rows, the first at src, a
// chunk at a time through the ring at s_ring; `smem` is laid out as HLayout.
// `aligned`: src and in_w are multiples of 16 (bulk copies).
template <class Store>
__device__ __forceinline__ void hrun(const uint8_t* src, int n_rows,
                                     bool aligned, const HTaps& t,
                                     unsigned char* smem, uint64_t* s_bar,
                                     const Store& store) {
  int2* s_taps = reinterpret_cast<int2*>(smem);
  uint8_t* s_ring = smem + HLayout(t, 0).ring;   // whatever the store's type
  const int stride = aligned ? t.in_w : row_stride(t.in_w);
  const size_t slot_bytes =
      static_cast<size_t>(kRowsPerChunk) * row_stride(t.in_w);
  const int n_chunks = (n_rows + kRowsPerChunk - 1) / kRowsPerChunk;
  auto fetch = [&](int c, int slot) {
    stage_run(s_ring + slot * slot_bytes, stride,
              src + static_cast<size_t>(c) * kRowsPerChunk * t.in_w, t.in_w,
              min(kRowsPerChunk, n_rows - c * kRowsPerChunk), aligned,
              &s_bar[slot]);
  };

  // the first chunks are on their way while the tables load
  for (int c = 0; c < t.stages - 1; ++c)
    if (c < n_chunks) fetch(c, c);
  load_htaps(t, s_taps);

  int slot = 0;
  uint32_t parity = 0;
  for (int c = 0; c < n_chunks; ++c) {
    if (aligned) mbar_wait(&s_bar[slot], parity);   // chunk c is in
    __syncthreads();               // for everyone; chunk c - 1 is done with
    const int nxt = c + t.stages - 1;
    if (nxt < n_chunks) fetch(nxt, slot == 0 ? t.stages - 1 : slot - 1);
    if (c > 0) store.flush(c - 1);
    hpass_store(s_ring + slot * slot_bytes, stride >> 2, t, s_taps, store, c);
    if (++slot == t.stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
  __syncthreads();
  store.flush(n_chunks - 1);
}

// h-scale of total_rows rows (all frames' rows, back to back); a block owns
// run_chunks consecutive chunks of them.
template <class OutT>
__global__ void __launch_bounds__(kThreads, kHBlocksPerSM)
hscale_kernel(const uint8_t* __restrict__ src, HTaps t, OutT* __restrict__ out,
              int total_rows, int run_chunks, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t s_bar[kMaxStages];
  const HLayout L(t, sizeof(OutT));
  const int run_rows = run_chunks * kRowsPerChunk;
  const size_t r0 = static_cast<size_t>(blockIdx.x) * run_rows;
  const int n_rows =
      static_cast<int>(min(static_cast<size_t>(run_rows), total_rows - r0));
  if (aligned) ring_init(s_bar, t.stages);
  hrun(src + r0 * t.in_w, n_rows, aligned != 0, t, smem, s_bar,
       RowStore<OutT>{out + r0 * t.ow, smem + L.out, t.ow, n_rows});
}

// Launch on `stream`; returns the CUDA error code (0 on success).  `smem` is
// the host's own count of the block's shared memory and must equal HLayout's.
template <class OutT>
int launch_hscale(const uint8_t* src, const HTaps& t, OutT* out,
                  int total_rows, int run_chunks, int smem,
                  cudaStream_t stream) {
  const HLayout L(t, sizeof(OutT));
  if (t.stages < 2 || t.stages > kMaxStages || run_chunks < 1 ||
      static_cast<size_t>(smem) != L.total)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = hscale_kernel<OutT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = (total_rows + kRowsPerChunk - 1) / kRowsPerChunk;
  const int blocks = (n_chunks + run_chunks - 1) / run_chunks;
  kern<<<blocks, kThreads, L.total, stream>>>(src, t, out, total_rows,
                                              run_chunks,
                                              aligned16(src, t.in_w) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scale2pass
