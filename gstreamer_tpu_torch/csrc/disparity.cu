// disparity's SAD cost volume and its left-to-right semi-global pass in one
// streaming kernel, from the two uint8 gray planes of a tick to each pixel's
// first minimal disparity: the volume is formed column by column in shared
// memory and never written to device memory unless asked for.
//
// Replaces the jitted expression and lax.scan of
// gstreamer_tpu/elements/opencv_analysis.py (Disparity.aggregate_fn: the
// volume :928-944, col_step :954, run at :964; Pallas has no counterpart),
// bit for bit.  For D = 32 disparities and 9x9 boxes the reference forms
//   ad    = |L - R shifted by d|  (zeros entering), edge-padded by 4
//   c     = cumsum(cumsum(ad, H), W), a zero row and column in front
//   cost  = ((c[y+9, x+9] - c[y, x+9]) - c[y+9, x]) + c[y, x]
// in float32, then the pass (col_step) and the first argmin.  Why this order
// can stream:
//   - ad is an integer from 0 to 255, so the sums down a padded column stay
//     under 2^24 (H + 8 <= 65 793) and are exact in any order: int32 here.
//   - Only the scan along W rounds.  jnp.cumsum on the CPU is XLA's blocked
//     reduce-window: blocks of 16 summed in order, the blocks' totals scanned
//     the same way, each block's exclusive prefix added to its entries
//     (ops/sgbm_kernel.py scan_cumsum).  Left to right that is one running
//     sum a level, restarted every 16 entries; when a block closes, its total
//     goes into the next level, and that level's inclusive sum (plus its own
//     base) becomes the base of the following block.  Four levels reach
//     16^4 padded columns.
//   - A box needs the integral image at rows y, y+9 and columns x, x+9 only.
//
// Schedule.  A block holds one (pair, strip of kRows output rows).  Its 32
// warps are the 32 disparities while the volume is formed: lane l holds
// padded row y0-1+l (lane 0: the sum of every padded row above the strip,
// from prefix_kernel; zero for the first strip, the zero row).  Each column
// a warp takes its lanes' |L - R| from a staged window in shared memory,
// prefixes them down the lanes with predicated shuffles (exact), advances
// each lane's W-scan, keeps the last 9 columns of the integral image in
// registers (a ring indexed by the column mod 9, known at compile time
// within a chunk of 18) and forms the boxes of rows y0..y0+22 from lanes l
// and l+9.  The boxes of a chunk of 18 columns go to a tile in shared
// memory; after the block's barrier, warps 0..22 become the strip's rows
// and run the pass over the tile's columns (lane d: prev[d], its
// neighbours + P1 and min + P2, redux.sync minima), 8 columns behind the
// scan.  Tiles and staged windows are
// double-buffered: one barrier a chunk.  The chunks wholly inside the image
// run in a loop of their own without clamps or tests, and the kernel is
// built for each of (pass or argmin) x (volumes out or not).
//
// prefix_kernel gives lane 0's sums: a block holds 32 columns and 8
// disparities, each warp sums one strip's rows (a row's 8 right bytes as
// three aligned words, their differences four at a time), and the strips'
// sums are scanned in order in shared memory.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "status.cuh"

namespace {

constexpr int kD = 32;                  // disparities
constexpr int kBlk = 9;                 // box side
constexpr int kHalf = kBlk / 2;         // edge padding
constexpr int kLanes = 32;              // padded rows a strip holds
constexpr int kRows = kLanes - kBlk;    // output rows a strip
constexpr int kChunk = 2 * kBlk;        // columns a chunk: two rings' worth
constexpr int kWarps = kD;              // a disparity a warp
constexpr int kThreads = kWarps * 32;
constexpr int kTileStride = kD + 1;     // a d-warp's lanes (rows) on 32 banks
constexpr int kTileFloats = kChunk * kRows * kTileStride;
constexpr int kGrSpan = kChunk + kD - 1;    // right-plane bytes a row a chunk
constexpr int kGlStride = 20;           // 5 words: 32 rows on 32 banks
constexpr int kGrStride = 52;           // 13 words: the same
constexpr int kStageBytes = kLanes * (kGlStride + kGrStride);
constexpr int kStageEntries = kLanes * (kChunk + kGrSpan);
constexpr int kSmemBytes = 2 * kTileFloats * 4 + 2 * kStageBytes;
constexpr int kPrefixCols = 32;        // columns a prefix block, a lane each
constexpr int kPrefixStrips = 32;      // strips a prefix block sums at once
constexpr int kPrefixD = 8;            // disparities a prefix thread
constexpr int kPrefixThreads = kPrefixStrips * 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kStagePer = (kStageEntries + kThreads - 1) / kThreads;
static_assert(kChunk % kBlk == 0, "a chunk starts on the ring's slot 0");
static_assert(kGlStride >= kChunk && kGrStride >= kGrSpan, "staged rows fit");
static_assert(kPrefixD == 8, "the packed prefix path holds 8 disparities");
static_assert(kRows * 255 < 65536, "a strip's sums fit 16 bits");

// a float's bits as an int that orders as the float does (-0 below +0):
// a negative float's magnitude bits flipped; the map is its own inverse
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

__device__ __forceinline__ float warp_min(float v) {
  return key_value(__reduce_min_sync(kFull, order_key(v)));
}

// a + the value of lane - o where that lane exists: a step of an
// inclusive scan, the shuffle's own in-range predicate guarding the add
__device__ __forceinline__ int scan_step(int a, int o) {
  int r;
  asm("{\n\t.reg .s32 t;\n\t.reg .pred p;\n\t"
      "shfl.sync.up.b32 t|p, %1, %2, 0, 0xffffffff;\n\t"
      "@p add.s32 t, t, %1;\n\t"
      "mov.s32 %0, t;\n\t}"
      : "=r"(r)
      : "r"(a), "r"(o));
  return r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// For each pair, strip s >= 1, disparity and padded column: the sum of
// |L - R| over the padded rows above the strip (0 .. s*kRows - 1), exact.
// prefix: (pairs, strips, kD, w + 8) int32; strip 0's slice is not written.
// A block holds kPrefixCols columns (a lane each) and kPrefixD disparities
// (a thread holds all of them, so a row's left byte is read once and its
// right bytes come from one L1 line), and kPrefixStrips strips at a time (a
// warp each sums its strip's kRows rows); then 256 of its threads scan the
// strips' sums in order, carrying the running sum to the next strips.
__global__ void __launch_bounds__(kPrefixThreads)
prefix_kernel(const uint8_t* __restrict__ gl, const uint8_t* __restrict__ gr,
              int* __restrict__ prefix, int h, int w, int strips) {
  __shared__ int sums[kPrefixStrips][kPrefixD][kPrefixCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wp = w + 2 * kHalf;
  const int c = blockIdx.x * kPrefixCols + lane;
  const int d0 = blockIdx.y * kPrefixD;
  const size_t pair = blockIdx.z;
  const bool col_on = c < wp;
  const int x = clampi(c - kHalf, 0, w - 1);
  const uint8_t* lp = gl + pair * h * w + x;
  const uint8_t* rp = gr + pair * h * w;
  const size_t plane = static_cast<size_t>(kD) * wp;
  // the scan's thread: disparity d0 + sj, column sc
  const int sj = threadIdx.x / kPrefixCols;
  const int sc = blockIdx.x * kPrefixCols + threadIdx.x % kPrefixCols;
  // The right bytes of disparities d0..d0+7 are the 8 bytes from
  // x - d0 - 7 up.  Where they and 3 bytes around them lie inside the row,
  // a row reads them as three aligned words, takes their absolute
  // differences from the left byte four at a time (vabsdiffu4) and sums
  // them in 16-bit halves (a strip's 23 rows x 255 < 2^16); elsewhere a
  // byte at a time.
  const bool packed = x - d0 >= kPrefixD + 2 && x - d0 + 4 <= w - 1;
  const uint8_t* rq = rp + (x - d0 - (kPrefixD - 1));
  int run = 0;
  for (int g = 0; g + 1 < strips; g += kPrefixStrips) {
    const int s = g + warp;                 // its rows: the top of strip s+1
    int acc[kPrefixD];
#pragma unroll
    for (int j = 0; j < kPrefixD; ++j) acc[j] = 0;
    // each path its own loop, so an unrolled loop issues the loads of
    // several rows before it waits for them
    if (s + 1 < strips && col_on && packed) {
      unsigned even_lo = 0, odd_lo = 0, even_hi = 0, odd_hi = 0;
#pragma unroll 4
      for (int k = 0; k < kRows; ++k) {
        const size_t row = static_cast<size_t>(
                               clampi(s * kRows + k - kHalf, 0, h - 1)) * w;
        const unsigned lv = lp[row] * 0x01010101u;
        const uintptr_t at = reinterpret_cast<uintptr_t>(rq + row);
        const unsigned* wd = reinterpret_cast<const unsigned*>(at & ~3ull);
        const unsigned sh = static_cast<unsigned>(at & 3) * 8;
        const unsigned w0 = wd[0], w1 = wd[1], w2 = wd[2];
        const unsigned lo = __vabsdiffu4(__funnelshift_r(w0, w1, sh), lv);
        const unsigned hi = __vabsdiffu4(__funnelshift_r(w1, w2, sh), lv);
        even_lo += lo & 0x00FF00FFu;
        odd_lo += (lo >> 8) & 0x00FF00FFu;
        even_hi += hi & 0x00FF00FFu;
        odd_hi += (hi >> 8) & 0x00FF00FFu;
      }
      // byte i of lo is disparity d0 + 7 - i, byte i of hi d0 + 3 - i
      acc[7] = even_lo & 0xFFFF;
      acc[5] = even_lo >> 16;
      acc[6] = odd_lo & 0xFFFF;
      acc[4] = odd_lo >> 16;
      acc[3] = even_hi & 0xFFFF;
      acc[1] = even_hi >> 16;
      acc[2] = odd_hi & 0xFFFF;
      acc[0] = odd_hi >> 16;
    } else if (s + 1 < strips && col_on) {
#pragma unroll 4
      for (int k = 0; k < kRows; ++k) {
        const size_t row = static_cast<size_t>(
                               clampi(s * kRows + k - kHalf, 0, h - 1)) * w;
        const unsigned lv = lp[row];
#pragma unroll
        for (int j = 0; j < kPrefixD; ++j) {
          const int xr = x - d0 - j;
          const unsigned rv = xr >= 0 ? rp[row + xr] : 0u;
          acc[j] = __usad(lv, rv, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPrefixD; ++j) sums[warp][j][lane] = acc[j];
    __syncthreads();
    if (threadIdx.x < kPrefixD * kPrefixCols && sc < wp) {
      for (int t = 0; t < kPrefixStrips && g + t + 1 < strips; ++t) {
        run += sums[t][sj][threadIdx.x % kPrefixCols];
        prefix[(pair * strips + g + t + 1) * plane +
               static_cast<size_t>(d0 + sj) * wp + sc] = run;
      }
    }
    __syncthreads();
  }
}

template <bool B>
struct Inner {
  static constexpr bool value = B;
};

// The block's state while it walks the columns: a lane's W-scan (a running
// sum and a base a level) at disparity `warp`, the ring of its padded row's
// last kBlk columns of the integral image, and the pass's carry of row
// `warp`.
struct Walk {
  float s0, s1, s2, s3, e1, e2, e3;
  float ring[kBlk];
  float prev, m;
};

// Phase A of one chunk: column c0 + k of every padded row at the warp's
// disparity, into the tile (t: this lane's row and the warp's disparity in
// the chunk's first column).  kInner: every column of the chunk lies inside
// the image, past the first 8 (its boxes exist), and its staged bytes sit
// at offset k: no clamps and no tests.
template <bool kInner>
__device__ __forceinline__ void volume_chunk(Walk& st, int c0, int wp, int w,
                                             int xs, const uint8_t* lrow,
                                             const uint8_t* rrow, int pv,
                                             int lane, float* t) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int c = c0 + k;
    if (kInner || c < wp) {                       // the same for the block
      const int ix = kInner ? k : clampi(c - kHalf, 0, w - 1) - xs;
      int a = static_cast<int>(__usad(lrow[ix], rrow[ix], 0u));
      const int above = __shfl_sync(kFull, pv, k);
      if (lane == 0) a = above;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) a = scan_step(a, o);  // exact
      const float v = static_cast<float>(a);
      st.s0 = (c & 15) ? st.s0 + v : v;
      const float cur = st.s0 + st.e1;
      if ((c & 15) == 15) {                       // a block of 16 closes
        int q = c >> 4;
        st.s1 = (q & 15) ? st.s1 + st.s0 : st.s0;
        st.e1 = st.s1 + st.e2;
        if ((q & 15) == 15) {
          q >>= 4;
          st.s2 = (q & 15) ? st.s2 + st.s1 : st.s1;
          st.e2 = st.s2 + st.e3;
          if ((q & 15) == 15) {
            q >>= 4;
            st.s3 = (q & 15) ? st.s3 + st.s2 : st.s2;
            st.e3 = st.s3;
          }
        }
      }
      const float old = st.ring[k % kBlk];        // column c - 9
      st.ring[k % kBlk] = cur;
      const float hi = __shfl_down_sync(kFull, cur, kBlk);
      const float hi9 = __shfl_down_sync(kFull, old, kBlk);
      if ((kInner || c >= 2 * kHalf) && lane < kRows) {
        t[k * kRows * kTileStride] = ((hi - cur) - hi9) + old;
      }
    }
  }
}

// Phase B of one chunk for row `warp` (lane d): the pass, or the argmin of
// the volume, over the tile's columns; the chunk's disparities leave in one
// store from lanes 0..8.
template <bool kSgbm, bool kWant, bool kInner>
__device__ __forceinline__ void pass_chunk(Walk& st, int c0, int w,
                                           size_t row_px, int lane, int warp,
                                           const float* t, float p1, float p2,
                                           uint8_t* __restrict__ disp,
                                           float* __restrict__ cost,
                                           float* __restrict__ agg) {
  int out = 0;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int x = c0 + k - 2 * kHalf;
    if (kInner || (x >= 0 && x < w)) {            // the same for the warp
      const float cur = t[(k * kRows + warp) * kTileStride + lane];
      float val = cur;
      if (kSgbm) {
        if (!kInner && x == 0) {
          st.prev = cur;
        } else {
          // lane 0's left and lane 31's right are the lane's own prev,
          // and prev + p1 >= prev never lowers the minimum
          const float left = __shfl_up_sync(kFull, st.prev, 1);
          const float right = __shfl_down_sync(kFull, st.prev, 1);
          const float tr = fminf(fminf(st.prev, st.m + p2),
                                 fminf(left + p1, right + p1));
          st.prev = (cur + tr) - st.m;
        }
        val = st.prev;
      }
      st.m = warp_min(val);                       // the next column's too
      const int best = __ffs(__ballot_sync(kFull, val == st.m)) - 1;
      if (lane == k) out = best;
      if (kWant) {
        cost[(row_px + x) * kD + lane] = cur;
        if (kSgbm) agg[(row_px + x) * kD + lane] = st.prev;
      }
    }
  }
  const int x = c0 + lane - 2 * kHalf;
  if (lane < kChunk && (kInner || (x >= 0 && x < w))) {
    disp[row_px + x] = static_cast<uint8_t>(out);
  }
}

template <bool kSgbm, bool kWant>
__global__ void __launch_bounds__(kThreads, 1)
disparity_kernel(const uint8_t* __restrict__ gl,
                 const uint8_t* __restrict__ gr,
                 const int* __restrict__ prefix, uint8_t* __restrict__ disp,
                 float* __restrict__ cost, float* __restrict__ agg, int h,
                 int w, int strips, float p1, float p2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  uint8_t* sgl = smem + 2 * kTileFloats * 4;
  uint8_t* sgr = sgl + 2 * kLanes * kGlStride;

  // the warp's index through a shuffle: the compiler then knows it is the
  // same across the warp, so the shuffles and redux.sync under branches on
  // it need no divergence handling
  const int warp = __shfl_sync(kFull, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  const int strip = blockIdx.x;
  const size_t pair = blockIdx.y;
  const int y0 = strip * kRows;
  const int wp = w + 2 * kHalf;
  const int chunks = (wp + kChunk - 1) / kChunk;
  const uint8_t* lpl = gl + pair * h * w;
  const uint8_t* rpl = gr + pair * h * w;

  // the staged bytes this thread copies each chunk: a left byte (the
  // chunk's 9 columns, edge-clamped) or a right byte (31 more to the left,
  // zeros entering), of the lanes' rows
  int st_off[kStagePer], st_i[kStagePer];
  size_t st_row[kStagePer];
  bool st_left[kStagePer], st_on[kStagePer];
#pragma unroll
  for (int j = 0; j < kStagePer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    st_on[j] = e < kStageEntries;
    st_left[j] = e < kLanes * kChunk;
    const int l = st_left[j] ? e / kChunk : (e - kLanes * kChunk) / kGrSpan;
    st_i[j] = st_left[j] ? e - l * kChunk : e - kLanes * kChunk - l * kGrSpan;
    st_off[j] = st_left[j] ? l * kGlStride + st_i[j]
                           : l * kGrStride + st_i[j];
    st_row[j] =
        static_cast<size_t>(clampi(y0 - 1 + l - kHalf, 0, h - 1)) * w;
  }
  auto stage = [&](int c0, int buf) {
    const int xs = clampi(c0 - kHalf, 0, w - 1);
#pragma unroll
    for (int j = 0; j < kStagePer; ++j) {
      if (!st_on[j]) continue;
      if (st_left[j]) {
        sgl[buf * kLanes * kGlStride + st_off[j]] =
            lpl[st_row[j] + min(xs + st_i[j], w - 1)];
      } else {
        const int xi = xs - (kD - 1) + st_i[j];
        sgr[buf * kLanes * kGrStride + st_off[j]] =
            (xi >= 0 && xi < w) ? rpl[st_row[j] + xi] : 0;
      }
    }
  };

  // lane k < kChunk of warp d loads the above-strip sum of column c0 + k
  const int* pre = prefix + ((pair * strips + strip) * kD + warp) * wp;
  auto load_prefix = [&](int c0) {
    const int c = c0 + lane;
    return (strip > 0 && lane < kChunk && c < wp) ? pre[c] : 0;
  };

  Walk st;
  st.s0 = st.s1 = st.s2 = st.s3 = st.e1 = st.e2 = st.e3 = 0.0f;
#pragma unroll
  for (int k = 0; k < kBlk; ++k) st.ring[k] = 0.0f;    // column -1: zeros
  st.prev = st.m = 0.0f;
  const int y = y0 + warp;
  const bool row_on = warp < kRows && y < h;
  const size_t row_px = (pair * h + (row_on ? y : 0)) * w;

  stage(0, 0);
  int pv = load_prefix(0);
  __syncthreads();
  // one chunk: the volume's columns into the tile, the next chunk staged,
  // the barrier, the pass over the tile (Inner: see volume_chunk)
  auto chunk = [&](int i, auto inner) {
    constexpr bool kInner = decltype(inner)::value;
    const int buf = i & 1;
    const int c0 = i * kChunk;
    const int pv_next = load_prefix(c0 + kChunk);
    const int xs = clampi(c0 - kHalf, 0, w - 1);
    const uint8_t* lrow = sgl + buf * kLanes * kGlStride + lane * kGlStride;
    const uint8_t* rrow = sgr + buf * kLanes * kGrStride + lane * kGrStride +
                          (kD - 1) - warp;
    float* t = tile + buf * kTileFloats;
    volume_chunk<kInner>(st, c0, wp, w, xs, lrow, rrow, pv, lane,
                         t + lane * kTileStride + warp);
    if (i + 1 < chunks) stage(c0 + kChunk, buf ^ 1);
    __syncthreads();
    if (row_on) {
      pass_chunk<kSgbm, kWant, kInner>(st, c0, w, row_px, lane, warp, t, p1,
                                       p2, disp, cost, agg);
    }
    pv = pv_next;
  };
  // chunks 1..last hold only columns whose boxes exist (x >= 1) and whose
  // bytes need no clamp: c0 > 8 and c0 + 8 <= w + 3.  Each kind runs in a
  // loop of its own, so no loop body joins two register layouts.
  const int last = min((w - 1 + kHalf - (kChunk - 1)) / kChunk, chunks - 1);
  int i = 0;
  if (last >= 1) {
    chunk(0, Inner<false>());
    for (i = 1; i <= last; ++i) chunk(i, Inner<true>());
  }
  for (; i < chunks; ++i) chunk(i, Inner<false>());
}

template <bool kSgbm, bool kWant>
int launch(const void* gl, const void* gr, void* prefix, void* disp,
           void* cost, void* agg, int pairs, int h, int w, int strips,
           float p1, float p2, cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        disparity_kernel<kSgbm, kWant>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  disparity_kernel<kSgbm, kWant>
      <<<dim3(strips, pairs), kThreads, kSmemBytes, s>>>(
          static_cast<const uint8_t*>(gl), static_cast<const uint8_t*>(gr),
          static_cast<const int*>(prefix), static_cast<uint8_t*>(disp),
          static_cast<float*>(cost), static_cast<float*>(agg), h, w, strips,
          p1, p2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gl, gr: (pairs, h, w) uint8 gray planes; prefix: (pairs, strips, 32, w + 8)
// int32 scratch, strips = ceil(h / 23); disp: (pairs, h, w) uint8; cost, agg:
// (pairs, h, w, 32) float32 or null (agg only with sgbm), all on the card.
// sgbm: 1 for the pass, 0 for the volume's argmin.  The caller checks
// pairs >= 1, h >= 1, w >= 1, h + 8 <= 65 793, w + 8 <= 65 536 and
// contiguity.
extern "C" int gst_disparity(const void* gl, const void* gr, void* prefix,
                             void* disp, void* cost, void* agg, int pairs,
                             int h, int w, int sgbm, float p1, float p2,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int strips = (h + kRows - 1) / kRows;
  const int wp = w + 2 * kHalf;
  if (strips > 1) {
    prefix_kernel<<<dim3((wp + kPrefixCols - 1) / kPrefixCols,
                         kD / kPrefixD, pairs),
                    kPrefixThreads, 0, s>>>(
        static_cast<const uint8_t*>(gl), static_cast<const uint8_t*>(gr),
        static_cast<int*>(prefix), h, w, strips);
  }
  const bool want = cost != nullptr;
  if (sgbm) {
    return want ? launch<true, true>(gl, gr, prefix, disp, cost, agg, pairs,
                                     h, w, strips, p1, p2, s)
                : launch<true, false>(gl, gr, prefix, disp, cost, agg, pairs,
                                      h, w, strips, p1, p2, s);
  }
  return want ? launch<false, true>(gl, gr, prefix, disp, cost, agg, pairs, h,
                                    w, strips, p1, p2, s)
              : launch<false, false>(gl, gr, prefix, disp, cost, agg, pairs,
                                     h, w, strips, p1, p2, s);
}
