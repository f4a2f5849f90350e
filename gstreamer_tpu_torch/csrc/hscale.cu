// Horizontal tap scale of a u8 plane: (B, H, W) u8 -> (B, H, out_w) int32.
//
// Replaces gstreamer_tpu/ops/hscale_kernel.py::hscale_u8 (its pallas_call,
// :73).  Same integer result: clamp((sum tap_s16 * px + 4095) >> 12, 0, 255).
// The TPU kernel contracts 256-row tiles against a dense bf16 hi/lo limb tap
// matrix on the MXU; here the taps stay as the resampler's (offset, S16
// taps) tables, split on the host into byte limbs packed four to a word, and
// every product runs on dp4a (scale2pass.cuh hdot8, the two-pass kernel's
// horizontal pass).
//
// Bound: bytes (1 per source pixel read, 4 per output written); at 35 taps
// the products come second (4 dp4a operations per tap and output).  Every
// row is needed and rows are independent, so the frames' rows are taken back
// to back.  A block owns a run of them, so the packed taps are read once a
// run and not once per 8 rows; it walks the run a chunk of 8 rows at a time
// through a ring of bulk copies, one a chunk, that load while the chunk
// before is computed; the chunk's results wait in shared memory and leave 16
// bytes a thread (scale2pass.cuh, the horizontal-only part).  Many short
// runs, three blocks an SM, measured faster than one long run a block.

#include "scale2pass.cuh"

extern "C" int gst_hscale_u8(const void* src, void* out, const void* h_cols,
                             const void* h_taps, int total_rows, int in_w,
                             int ow, int nw, int precision, int run_chunks,
                             int stages, int smem, void* stream) {
  const scale2pass::HTaps t{static_cast<const int2*>(h_cols),
                            static_cast<const int2*>(h_taps), in_w, ow, nw,
                            precision, stages};
  return scale2pass::launch_hscale(static_cast<const uint8_t*>(src), t,
                                   static_cast<int32_t*>(out), total_rows,
                                   run_chunks, smem,
                                   static_cast<cudaStream_t>(stream));
}
