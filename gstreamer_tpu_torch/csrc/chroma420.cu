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
// on whole 32-bit words, and hands the chunk to the two-pass kernel's dp4a
// horizontal pass (scale2pass.cuh).  Each chroma byte comes from device
// memory once per chunk that needs it; the up2 samples never reach device
// memory.  The two filter passes cost about as much as the horizontal pass.

#include "scale2pass.cuh"

namespace {

using scale2pass::align16;
using scale2pass::kRowsPerChunk;
using scale2pass::row_stride;
using scale2pass::Taps;

// (3a + b + 2) >> 2 on each byte of a word: the rounded-up average of a and
// the rounded-down average of a and b (exact: the two roundings never meet)
__device__ __forceinline__ uint32_t filt31(uint32_t a, uint32_t b) {
  return __vavgu4(a, __vhaddu4(a, b));
}

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

    // up2 columns of every staged row, interleaved to full width: a word of
    // four chroma samples makes two words; a thread takes four words
    const int n = __ldg(cn + tile * chunks + c);
    const int cwords = (cw + 3) >> 2;
    const int groups = (cwords + 3) >> 2;
    for (int i = tid; i < n * groups; i += blockDim.x) {
      const int r = i / groups;
      const int x0 = (i - r * groups) << 2;
      const uint32_t* row = reinterpret_cast<const uint32_t*>(ring + r * cs);
      const uint4 v = *reinterpret_cast<const uint4*>(row + x0);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t prev = x0 ? row[x0 - 1] >> 24 : w[0] & 255u;
      const uint32_t after = x0 + 4 < cwords ? row[x0 + 4] & 255u : 0u;
      uint8_t* dst = s_hc + r * rs + 8 * x0;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int valid = cw - 4 * (x0 + m);   // samples from this word on
        if (valid <= 0) break;
        uint32_t cur = w[m];
        uint32_t next;
        if (valid <= 4) {                      // the row's last word
          next = (cur >> (8 * (valid - 1))) & 255u;
          if (valid < 4) {                     // repeat the last sample
            const uint32_t keep = (1u << (8 * valid)) - 1u;
            cur = (cur & keep) | ((next * 0x01010101u) & ~keep);
          }
        } else {
          next = m < 3 ? w[m + 1] & 255u : after;
        }
        const uint32_t left = (cur << 8) | prev;           // c[k-1] per byte
        const uint32_t right = (cur >> 8) | (next << 24);  // c[k+1] per byte
        uint32_t e, o;
        if (h_cosited) {
          e = cur;
          o = __vavgu4(cur, right);            // (a + b + 1) >> 1 per byte
        } else {
          e = filt31(cur, left);
          o = filt31(cur, right);
        }
        *reinterpret_cast<uint2*>(dst + 8 * m) =
            make_uint2(__byte_perm(e, o, 0x5140), __byte_perm(e, o, 0x7362));
        prev = cur >> 24;
      }
    }
    __syncthreads();

    // up2 rows: each needed full-resolution row from its two staged rows,
    // sixteen samples a thread
    const int nc = min(kRowsPerChunk, n_rows - c * kRowsPerChunk);
    const int per = (in_w + 15) >> 4;
    const int32_t* sl =
        slots + static_cast<size_t>(tile) * t.n_max + c * kRowsPerChunk;
    for (int k = tid >> 5; k < nc; k += blockDim.x >> 5) {   // a warp a row
      const int s = __ldg(sl + k);
      const uint4* ra = reinterpret_cast<const uint4*>(s_hc + (s & 255) * rs);
      const uint4* rb = reinterpret_cast<const uint4*>(s_hc + (s >> 8) * rs);
      uint4* ro = reinterpret_cast<uint4*>(s_row + k * rs);
      for (int x = tid & 31; x < per; x += 32) {
        const uint4 a = ra[x];
        const uint4 nb = rb[x];
        ro[x] = v_cosited
                    ? make_uint4(__vavgu4(a.x, nb.x), __vavgu4(a.y, nb.y),
                                 __vavgu4(a.z, nb.z), __vavgu4(a.w, nb.w))
                    : make_uint4(filt31(a.x, nb.x), filt31(a.y, nb.y),
                                 filt31(a.z, nb.z), filt31(a.w, nb.w));
      }
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
