// Fused h+v scale of a u8 plane: (B, H, W) u8 -> (B, OH, OW) int32.
//
// Replaces gstreamer_tpu/ops/scale2d_kernel.py::scale_hv_u8 (its pallas_call,
// :88).  Same integer result: the h pass rounded and clamped to 0..255
// ((sum tap_s16 * px + 4095) >> 12), then the v pass likewise.  The TPU
// kernel sums the v pass across sequential row tiles into an output block
// that stays in VMEM, over a height padded with zero rows; here blocks run in
// any order, so a block computes its tile of output rows from every input row
// they need (scale2pass.cuh), and nothing is padded.  It is csrc/yscale.cu's
// kernel with an int32 output.
//
// Bound: bytes (the u8 source rows the taps read, plus 4 bytes per output);
// see csrc/yscale.cu for what the design does about it.

#include "scale2pass.cuh"

extern "C" int gst_scale_hv_u8(
    const void* src, void* out, const void* h_cols, const void* h_taps,
    const void* v_word, const void* v_taps, const void* rows,
    const void* count, int batch, int in_h, int in_w, int oh, int ow, int nw,
    int nwv, int precision, int tile_rows, int n_max, int stages, int smem,
    void* stream) {
  const scale2pass::Taps t{static_cast<const int2*>(h_cols),
                           static_cast<const int2*>(h_taps),
                           static_cast<const int32_t*>(v_word),
                           static_cast<const int2*>(v_taps),
                           static_cast<const int32_t*>(rows),
                           static_cast<const int32_t*>(count),
                           in_w, ow, oh, nw, nwv, precision, tile_rows, n_max,
                           stages};
  const scale2pass::PlaneSource s{static_cast<const uint8_t*>(src), in_h, in_w,
                                  scale2pass::aligned16(src, in_w)};
  return scale2pass::launch(s, t, static_cast<int32_t*>(out), batch, smem,
                            static_cast<cudaStream_t>(stream));
}
