// Fused luma h+v scale: (B, H, W) u8 -> (B, oh, ow) int16.
//
// Replaces gstreamer_tpu/ops/yscale_kernel.py::yscale_hv (its pallas_call,
// :109).  Same integer result per pass: clamp((sum tap_s16 * px + 4095)
// >> 12, 0, 255), h first, then v.  The TPU kernel turns the taps into dense
// bf16 hi/lo limb matrices for the MXU and carries the v sum across grid
// steps; here a block owns one frame and one tile of output rows, the taps
// stay the resampler's (offset, S16 taps) tables, and each S16 tap is split
// into two byte limbs so that four products go through one dp4a.
//
// Bound: bytes (the u8 source rows the vertical taps read, about 2.07 MB per
// 1080p frame when every row is needed; 2 taps read 448 of 1080 rows).  What
// the design does about it (scale2pass.cuh): the host lists the rows a tile
// needs, they arrive by bulk copies (TMA) into a ring while earlier chunks
// are computed, the h pass result never leaves shared memory, and each
// output is written once.  At 35 x 20 taps the dp4a passes take as long as
// the copies; at 2 taps the kernel is copies only.

#include "scale2pass.cuh"

extern "C" int gst_yscale_hv_u8(
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
  return scale2pass::launch(s, t, static_cast<int16_t*>(out), batch, smem,
                            static_cast<cudaStream_t>(stream));
}
