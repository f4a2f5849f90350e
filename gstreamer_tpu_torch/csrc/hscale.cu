// Horizontal tap scale of a u8 plane: (B, H, W) u8 -> (B, H, out_w) int32.
//
// Replaces gstreamer_tpu/ops/hscale_kernel.py::hscale_u8 (its pallas_call,
// :73).  Same integer result: clamp((sum tap_s16 * px + 4095) >> 12, 0, 255).
// The TPU kernel contracts 256-row tiles against a dense bf16 hi/lo limb tap
// matrix on the MXU; here the taps stay as the resampler's (offset, S16
// taps) tables and every product is an int32 multiply-add.  Every row is
// needed and rows are independent, so the frames' rows are taken back to
// back: a block stages a few consecutive rows (one contiguous span, 16 bytes
// a thread) in shared memory and writes their outputs once.
//
// Bound: bytes (1 per source pixel read, 4 per output written).

#include "scale2pass.cuh"

extern "C" int gst_hscale_u8(const void* src, void* out, const void* h_off,
                             const void* h_taps, int total_rows,
                             int in_w, int ow, int th, int precision,
                             int rows_per_block, void* stream) {
  const scale2pass::HTaps t{static_cast<const int32_t*>(h_off),
                            static_cast<const int16_t*>(h_taps), in_w, ow, th,
                            precision};
  return scale2pass::launch_hscale(static_cast<const uint8_t*>(src), t,
                                   static_cast<int32_t*>(out), total_rows,
                                   rows_per_block,
                                   static_cast<cudaStream_t>(stream));
}
