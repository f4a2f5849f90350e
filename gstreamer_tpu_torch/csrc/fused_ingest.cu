// Fused I420 ingest: unpack + 4:2:0 chroma upsample + horizontal scale.
//
//   y (B, H, W), u, v (B, H/2, W/2) u8  ->  Y (B, H, ow) int16 and
//   U_even, U_odd, V_even, V_odd, each (B, H/2, ow) int16: the h-scaled
//   full-resolution chroma rows 2k and 2k+1.
//
// Replaces gstreamer_tpu/ops/convert_kernel.py::fused_i420_up_hscale (its
// pallas_call, :185).  Same integer result, filter by filter, each with its
// own shift:
//   up2 H   cosited:       c[k], (c[k] + c[k+1] + 1) >> 1
//           interstitial:  (c[k-1] + 3c[k] + 2) >> 2, (3c[k] + c[k+1] + 2) >> 2
//   up2 V   interstitial, over the h-filtered rows k-1, k, k+1
//   h-scale clamp((sum tap_s16 * px + 4095) >> 12, 0, 255)
// with columns and rows clamped at the plane's edges.  The TPU kernel keeps
// even and odd columns as half-width operands of dense bf16 limb matrices,
// takes the row halo from three shifted copies of the chroma planes, and pads
// height and width to its tiles.  None of that carries over.
//
// Bound: bytes (1.5 per source pixel read; 2 * ow * 2H per frame written);
// the products (4 dp4a operations per tap and output, three planes' worth)
// and the two up2 filters over the full-resolution chroma come second.  One
// launch holds two kinds of block, the long chroma blocks first and the short
// luma blocks after them, where they fill the card's last round (spreading
// them among the chroma blocks measured slower):
//   luma    a block owns a run of consecutive luma rows (all frames' rows back
//           to back) and is csrc/hscale.cu's loop with an int16 store
//           (scale2pass.cuh hrun).
//   chroma  a block owns one frame, one plane and a long run of chroma rows
//           (the host lists the runs with their clamped halo rows,
//           ops/_scale2pass.py chroma_runs), so the halo costs a few percent.
//           The rows arrive four at a time through a ring of bulk copies; each
//           is column-filtered once, on whole words, into a full-width row of
//           a rolling window (up2_columns); the row filter (up2_row) builds a
//           chunk of 8 full-resolution rows, the even and odd children of 4
//           chroma rows, from window rows k-1, k, k+1; the chunk goes through
//           the same packed dp4a pass as luma (hpass_store), and its even and
//           odd rows leave for their two planes 16 bytes a thread while the
//           next chunk is built.  Two block barriers a chunk.
// The full-width chroma rows never reach device memory, and nothing is
// padded: edges are clamped by index.

#include "scale2pass.cuh"

namespace {

using scale2pass::align16;
using scale2pass::HLayout;
using scale2pass::HTaps;
using scale2pass::kChromaRowsPerChunk;
using scale2pass::kRowsPerChunk;
using scale2pass::kThreads;
using scale2pass::out_span_bytes;
using scale2pass::row_stride;

// Column-filtered rows a chroma block keeps: the row filter of chunk m reads
// staged rows 4m - 1 .. 4m + 5 while rows up to 4m + 7 are already there.
// ops/_scale2pass.py WINDOW_ROWS mirrors it.
constexpr int kWindowRows = 12;

struct Planes {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  int16_t* oy;
  int16_t* oue;
  int16_t* ouo;
  int16_t* ove;
  int16_t* ovo;
  int hc, wc, h_cosited;
};

// How the work is cut into blocks (ops/convert_kernel.py sizes the runs).
struct Split {
  const int4* cruns;       // [c_runs] {k0, k1, lo, hi}: chroma rows k0 .. k1-1
                           //          of a plane, built from rows lo .. hi
  int c_runs;              // runs a chroma plane of one frame is cut into
  int c_blocks;            // batch * 2 * c_runs; the luma blocks follow
  int y_run;               // chunks of luma rows a luma block owns
  int y_rows;              // batch * H
  int y_aligned, c_aligned;
};

// Dynamic shared memory of a chroma block: packed h taps | ring of `stages`
// groups of 4 half-resolution rows | window of column-filtered full-width
// rows | the chunk's 8 finished rows | two buffers of a chunk's results, even
// and odd rows apart.  ops/_scale2pass.py fused_smem_bytes computes the
// larger of this and the luma block's HLayout.
struct CLayout {
  size_t ring, window, rows, out, total;
  __host__ __device__ CLayout(const HTaps& t, int wc) {
    ring = align16(static_cast<size_t>(t.nw) * t.ow * 8);
    window = ring + static_cast<size_t>(t.stages) * kChromaRowsPerChunk *
                        align16(wc);
    rows = window + static_cast<size_t>(kWindowRows) * row_stride(t.in_w);
    out = rows + static_cast<size_t>(kRowsPerChunk) * row_stride(t.in_w);
    total = out + 4 * out_span_bytes(kChromaRowsPerChunk, t.ow, 2);
  }
};

size_t smem_total(const HTaps& t, int wc) {
  const size_t luma = HLayout(t, sizeof(int16_t)).total;
  const size_t chroma = CLayout(t, wc).total;
  return luma > chroma ? luma : chroma;
}

// Rows 2k (even) and 2k+1 (odd) of a chunk go to two planes: chunk c is one
// span of 4 rows in each.
struct ParityStore {
  int16_t* even;           // first row of the run in each plane
  int16_t* odd;
  uint8_t* s_out;          // 2 x 2 x out_span_bytes(kChromaRowsPerChunk, ow, 2)
  int ow, n_rows;          // chroma rows of the run
  struct At {
    int16_t* e;
    int16_t* o;
  };

  __device__ __forceinline__ size_t first(int c) const {
    return static_cast<size_t>(c) * kChromaRowsPerChunk * ow;
  }
  __device__ __forceinline__ At at(int c) const {
    const size_t span = out_span_bytes(kChromaRowsPerChunk, ow, 2);
    uint8_t* buf = s_out + (c & 1) * 2 * span;
    return At{scale2pass::same_phase(buf, even + first(c)),
              scale2pass::same_phase(buf + span, odd + first(c))};
  }
  __device__ __forceinline__ void put(const At& s, int k, int col,
                                      uint32_t v) const {
    ((k & 1) ? s.o : s.e)[(k >> 1) * ow + col] = static_cast<int16_t>(v);
  }
  __device__ __forceinline__ void flush(int c) const {
    const int n = min(kChromaRowsPerChunk, n_rows - c * kChromaRowsPerChunk);
    const At s = at(c);
    scale2pass::copy_out(even + first(c), s.e, n * ow * 2);
    scale2pass::copy_out(odd + first(c), s.o, n * ow * 2);
  }
};

// One frame's plane (u or v), run `run` of its chroma rows.
__device__ __forceinline__ void chroma_run(const Planes& p, const HTaps& t,
                                           const Split& sp, int b, int plane,
                                           int run, unsigned char* smem,
                                           uint64_t* s_bar) {
  const CLayout L(t, p.wc);
  int2* s_taps = reinterpret_cast<int2*>(smem);
  uint8_t* s_ring = smem + L.ring;
  uint8_t* s_win = smem + L.window;
  uint8_t* s_rows = smem + L.rows;
  const int4 r = __ldg(sp.cruns + run);
  const int k0 = r.x, k1 = r.y, lo = r.z, hi = r.w;
  const int cs = static_cast<int>(align16(p.wc));
  const int rs = row_stride(t.in_w);
  const bool aligned = sp.c_aligned != 0;
  const bool h_cosited = p.h_cosited != 0;
  const uint8_t* src =
      (plane ? p.v : p.u) + (static_cast<size_t>(b) * p.hc + lo) * p.wc;
  const int n_staged = hi - lo + 1;
  const int n_groups =
      (n_staged + kChromaRowsPerChunk - 1) / kChromaRowsPerChunk;
  const int n_out = (k1 - k0 + kChromaRowsPerChunk - 1) / kChromaRowsPerChunk;
  const size_t slot_bytes = static_cast<size_t>(kChromaRowsPerChunk) * cs;

  // staged rows 4g .. 4g+3 -> ring slot g % stages
  auto fetch = [&](int g) {
    const int slot = g % t.stages;
    scale2pass::stage_run(
        s_ring + slot * slot_bytes, cs,
        src + static_cast<size_t>(g) * kChromaRowsPerChunk * p.wc, p.wc,
        min(kChromaRowsPerChunk, n_staged - g * kChromaRowsPerChunk), aligned,
        &s_bar[slot]);
  };
  // where column-filtered staged row i waits
  auto win = [&](int i) { return s_win + (i % kWindowRows) * rs; };
  // up2 columns of group g, once it is in, into the window
  auto columns = [&](int g) {
    const int slot = g % t.stages;
    if (aligned) scale2pass::mbar_wait(&s_bar[slot], (g / t.stages) & 1);
    scale2pass::up2_columns(
        s_ring + slot * slot_bytes, cs,
        min(kChromaRowsPerChunk, n_staged - g * kChromaRowsPerChunk), p.wc,
        h_cosited,
        [=](int i) {
          return s_win + ((g * kChromaRowsPerChunk + i) % kWindowRows) * rs;
        });
  };

  for (int g = 0; g < t.stages; ++g)
    if (g < n_groups) fetch(g);
  scale2pass::load_htaps(t, s_taps);
  __syncthreads();                 // word-by-word staging: group 0 is in
  columns(0);

  const size_t out0 = (static_cast<size_t>(b) * p.hc + k0) * t.ow;
  const ParityStore store{(plane ? p.ove : p.oue) + out0,
                          (plane ? p.ovo : p.ouo) + out0, smem + L.out, t.ow,
                          k1 - k0};
  for (int m = 0; m < n_out; ++m) {
    if (m + 1 < n_groups) columns(m + 1);
    __syncthreads();     // the window holds groups <= m + 1; chunk m - 1 is
                         // done with: its rows, its results, group m's slot
    if (m + t.stages < n_groups) fetch(m + t.stages);
    if (m > 0) store.flush(m - 1);

    // up2 rows, a warp a row: children 2k (above: k-1) and 2k+1 (below: k+1)
    const int kc0 = k0 + m * kChromaRowsPerChunk;
    const int n_full = 2 * min(kChromaRowsPerChunk, k1 - kc0);
    for (int k = threadIdx.x >> 5; k < n_full; k += blockDim.x >> 5) {
      const int kc = kc0 + (k >> 1);
      const int nb = (k & 1) ? min(kc + 1, p.hc - 1) : max(kc - 1, 0);
      scale2pass::up2_row(win(kc - lo), win(nb - lo), s_rows + k * rs, t.in_w,
                          false);
    }
    __syncthreads();
    scale2pass::hpass_store(s_rows, rs >> 2, t, s_taps, store, m);
  }
  __syncthreads();
  store.flush(n_out - 1);
}

__global__ void __launch_bounds__(kThreads, scale2pass::kHBlocksPerSM)
fused_ingest_kernel(Planes p, HTaps t, Split sp) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t s_bar[scale2pass::kMaxStages];
  const int blk = blockIdx.x;
  if (blk < sp.c_blocks) {
    if (sp.c_aligned) scale2pass::ring_init(s_bar, t.stages);
    const int b = blk / (2 * sp.c_runs);
    const int rem = blk - b * 2 * sp.c_runs;
    chroma_run(p, t, sp, b, rem / sp.c_runs, rem % sp.c_runs, smem, s_bar);
  } else {
    if (sp.y_aligned) scale2pass::ring_init(s_bar, t.stages);
    const int run_rows = sp.y_run * kRowsPerChunk;
    const size_t r0 = static_cast<size_t>(blk - sp.c_blocks) * run_rows;
    const int n_rows =
        static_cast<int>(min(static_cast<size_t>(run_rows), sp.y_rows - r0));
    const HLayout L(t, sizeof(int16_t));
    scale2pass::hrun(p.y + r0 * t.in_w, n_rows, sp.y_aligned != 0, t, smem,
                     s_bar,
                     scale2pass::RowStore<int16_t>{p.oy + r0 * t.ow,
                                                   smem + L.out, t.ow, n_rows});
  }
}

}  // namespace

extern "C" int gst_fused_i420_up_hscale(
    const void* y, const void* u, const void* v, void* oy, void* oue,
    void* ouo, void* ove, void* ovo, const void* h_cols, const void* h_taps,
    const void* cruns, int batch, int in_h, int in_w, int ow, int nw,
    int precision, int h_cosited, int y_run, int c_runs, int stages, int smem,
    void* stream) {
  const HTaps t{static_cast<const int2*>(h_cols),
                static_cast<const int2*>(h_taps), in_w, ow, nw, precision,
                stages};
  const Planes p{static_cast<const uint8_t*>(y),
                 static_cast<const uint8_t*>(u),
                 static_cast<const uint8_t*>(v),
                 static_cast<int16_t*>(oy),
                 static_cast<int16_t*>(oue),
                 static_cast<int16_t*>(ouo),
                 static_cast<int16_t*>(ove),
                 static_cast<int16_t*>(ovo),
                 in_h / 2, in_w / 2, h_cosited};
  const size_t total = smem_total(t, p.wc);
  if (stages < 2 || stages > scale2pass::kMaxStages || y_run < 1 ||
      c_runs < 1 || static_cast<size_t>(smem) != total)
    return static_cast<int>(cudaErrorInvalidValue);
  const Split sp{static_cast<const int4*>(cruns), c_runs, batch * 2 * c_runs,
                 y_run, batch * in_h,
                 scale2pass::aligned16(y, in_w) ? 1 : 0,
                 scale2pass::aligned16(u, p.wc) &&
                         scale2pass::aligned16(v, p.wc) ? 1 : 0};
  cudaError_t e = cudaFuncSetAttribute(
      fused_ingest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(total));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int y_chunks = (sp.y_rows + kRowsPerChunk - 1) / kRowsPerChunk;
  const int y_blocks = (y_chunks + y_run - 1) / y_run;
  fused_ingest_kernel<<<sp.c_blocks + y_blocks, kThreads, total,
                        static_cast<cudaStream_t>(stream)>>>(p, t, sp);
  return static_cast<int>(cudaGetLastError());
}
