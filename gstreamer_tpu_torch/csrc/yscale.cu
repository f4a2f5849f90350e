// Fused luma h+v scale: (B, H, W) u8 -> (B, oh, ow) int16.
//
// Replaces gstreamer_tpu/ops/yscale_kernel.py::yscale_hv (its pallas_call,
// :109).  Same integer result per pass: clamp((sum tap_s16 * px + 4095)
// >> 12, 0, 255), h first, then v.  The TPU kernel turns the taps into dense
// bf16 hi/lo limb matrices for the MXU; here the taps stay as the
// resampler's (offset, S16 taps) tables and every product is an int32
// multiply-add.  See scale2pass.cuh for the tiling.
//
// Bound: bytes (the u8 source read; about 2.07 MB per 1080p frame when every
// row is needed).  The design reads each needed source row of a tile once,
// keeps the h-pass result in shared memory and writes each output once.

#include "scale2pass.cuh"

extern "C" int gst_yscale_hv_u8(const void* src, void* out, const void* h_off,
                                const void* h_taps, const void* v_off,
                                const void* v_taps, int batch, int in_h,
                                int in_w, int oh, int ow, int th, int tv,
                                int precision, int tile_rows, int span_max,
                                void* stream) {
  const scale2pass::Taps t{static_cast<const int32_t*>(h_off),
                           static_cast<const int16_t*>(h_taps),
                           static_cast<const int32_t*>(v_off),
                           static_cast<const int16_t*>(v_taps),
                           in_w, ow, oh, th, tv, precision};
  const scale2pass::PlaneSource s{static_cast<const uint8_t*>(src), in_h, in_w};
  return scale2pass::launch(s, t, static_cast<int16_t*>(out), batch,
                            tile_rows, span_max,
                            static_cast<cudaStream_t>(stream));
}
