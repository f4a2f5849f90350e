// Fused 4:2:0 chroma upsample + h+v scale: (B, ch, cw) u8 -> (B, OH, OW)
// int32 in 0..255.
//
// Replaces gstreamer_tpu/ops/chroma420_kernel.py::chroma420_scale (its
// pallas_call, :159).  Same integer result as up2_phases -> split-tap h
// scale -> split-tap v scale: the TPU kernel's parity split (ce/co, re/ro)
// and bf16 limb matrices are a layout for the MXU, and the split happens
// before any rounding, so the sums are those of scaling the interleaved
// full-resolution plane.  The up2 filters are video-chroma.c's, cosited or
// interstitial, edges clamped, the column filter first, each rounded to u8
// before the scale.  No sum is carried between blocks: a block computes its
// outputs from every row they need (the TPU kernel instead sums v across
// sequential row tiles).
//
// Bound: operations.  About 0.52 MB is read per 1080p chroma plane; the tap
// products over the full-resolution virtual plane (35x20 taps at cubic) and
// the two up2 filters over it are the larger side.  What the design does:
// per chunk of 8 needed full-resolution rows a block stages only the
// half-resolution rows they are built from (the host lists them,
// ops/_scale2pass.py chroma_table; one bulk copy a row, ahead of use), runs
// the column filter once per staged row into a full-width row in shared
// memory, then the row filter into the chunk buffer, both as byte arithmetic
// on whole 32-bit words (scale2pass.cuh up2_columns, up2_row), and hands the
// chunk to the two-pass kernel's dp4a horizontal pass.  Each chroma byte comes from device
// memory once per chunk that needs it; the up2 samples never reach device
// memory.  The two filter passes cost about as much as the horizontal pass.

#include "scale2pass.cuh"

namespace {

using scale2pass::align16;
using scale2pass::kRowsPerChunk;
using scale2pass::row_stride;
using scale2pass::Taps;

// Shared memory: ring of `stages` x cr_max half-resolution rows | cr_max
// column-filtered full-width rows | the chunk's kRowsPerChunk finished rows.
struct Chroma420Source {
  const uint8_t* p;
  const int32_t* crows;    // [tiles][chunks][cr_max] rows a chunk stages
  const int32_t* cn;       // [tiles][chunks]
  const int32_t* slots;    // [tiles][n_max]  staged row of y >> 1 | its
                           //                 neighbour's << 8
  int ch, cw, in_w, h_cosited, v_cosited, cr_max, chunks, aligned;

  __host__ __device__ size_t smem_bytes(const Taps& t) const {
    return static_cast<size_t>(t.stages) * cr_max * align16(cw) +
           static_cast<size_t>(cr_max + kRowsPerChunk) * row_stride(in_w);
  }

  __device__ __forceinline__ void fetch(uint8_t* s_src, const Taps&, int b,
                                        int tile, int c, int slot, int,
                                        uint64_t* bar) const {
    const int cs = static_cast<int>(align16(cw));
    const int idx = tile * chunks + c;
    scale2pass::stage_rows(s_src + static_cast<size_t>(slot) * cr_max * cs, cs,
                           p + static_cast<size_t>(b) * ch * cw, cw,
                           crows + static_cast<size_t>(idx) * cr_max,
                           __ldg(cn + idx), aligned, bar);
  }

  __device__ __forceinline__ const uint8_t* prepare(uint8_t* s_src,
                                                    const Taps& t, int tile,
                                                    int c, int slot,
                                                    int n_rows) const {
    const int cs = static_cast<int>(align16(cw));
    const int rs = row_stride(in_w);
    const uint8_t* ring = s_src + static_cast<size_t>(slot) * cr_max * cs;
    uint8_t* s_hc = s_src + static_cast<size_t>(t.stages) * cr_max * cs;
    uint8_t* s_row = s_hc + static_cast<size_t>(cr_max) * rs;
    const int tid = threadIdx.x;

    // up2 columns of every staged row, interleaved to full width
    const int n = __ldg(cn + tile * chunks + c);
    scale2pass::up2_columns(ring, cs, n, cw, h_cosited != 0,
                            [=](int r) { return s_hc + r * rs; });
    __syncthreads();

    // up2 rows: each needed full-resolution row from its two staged rows,
    // a warp a row
    const int nc = min(kRowsPerChunk, n_rows - c * kRowsPerChunk);
    const int32_t* sl =
        slots + static_cast<size_t>(tile) * t.n_max + c * kRowsPerChunk;
    for (int k = tid >> 5; k < nc; k += blockDim.x >> 5) {
      const int s = __ldg(sl + k);
      scale2pass::up2_row(s_hc + (s & 255) * rs, s_hc + (s >> 8) * rs,
                          s_row + k * rs, in_w, v_cosited != 0);
    }
    __syncthreads();
    return s_row;
  }
};

}  // namespace

extern "C" int gst_chroma420_scale_u8(
    const void* src, void* out, const void* h_cols, const void* h_taps,
    const void* v_word, const void* v_taps, const void* rows,
    const void* count, const void* crows, const void* cn, const void* slots,
    int batch, int ch, int cw, int in_w, int oh, int ow, int nw, int nwv,
    int precision, int tile_rows, int n_max, int stages, int smem,
    int h_cosited, int v_cosited, int cr_max, int chunks, void* stream) {
  const Taps t{static_cast<const int2*>(h_cols),
               static_cast<const int2*>(h_taps),
               static_cast<const int32_t*>(v_word),
               static_cast<const int2*>(v_taps),
               static_cast<const int32_t*>(rows),
               static_cast<const int32_t*>(count),
               in_w, ow, oh, nw, nwv, precision, tile_rows, n_max, stages};
  const Chroma420Source s{static_cast<const uint8_t*>(src),
                          static_cast<const int32_t*>(crows),
                          static_cast<const int32_t*>(cn),
                          static_cast<const int32_t*>(slots),
                          ch, cw, in_w, h_cosited, v_cosited, cr_max, chunks,
                          scale2pass::aligned16(src, cw)};
  return scale2pass::launch(s, t, static_cast<int32_t*>(out), batch, smem,
                            static_cast<cudaStream_t>(stream));
}
