// Fused 4:2:0 chroma upsample + h+v scale: (B, ch, cw) u8 -> (B, OH, OW)
// int32 in 0..255.
//
// Replaces gstreamer_tpu/ops/chroma420_kernel.py::chroma420_scale (its
// pallas_call, :159).  Same integer result as up2_phases -> split-tap h
// scale -> split-tap v scale: the TPU kernel's parity split (ce/co, re/ro)
// and bf16 limb matrices are a layout for the MXU, and the split happens
// before any rounding, so the sums are those of scaling the interleaved
// full-resolution plane.  Here each full-resolution sample the taps touch is
// computed where it is needed, straight from the half-resolution u8 plane:
// column x uses the even or odd up2 phase of chroma column x >> 1
// (video-chroma.c filters, cosited or interstitial, edges clamped), and rows
// likewise, column filter first as in the reference chain.  No sum is carried
// between blocks: a block computes its outputs from every row they need
// (the TPU kernel instead sums v across sequential row tiles).
//
// Bound: about 0.52 MB read per 1080p chroma plane against the tap
// multiply-adds over the full-resolution virtual plane; at cubic (35x20
// taps) the operations bound is the larger.  The up2 samples never reach
// device memory; they are built in shared memory per tile.

#include "scale2pass.cuh"

namespace {

struct Chroma420Source {
  const uint8_t* p;
  int ch, cw, h_cosited, v_cosited;

  // up2 column phase at full-resolution column x of one chroma row
  __device__ __forceinline__ int col(const uint8_t* row, int x) const {
    const int k = x >> 1;
    const int c = __ldg(row + k);
    if (h_cosited) {
      if (!(x & 1)) return c;
      return (c + __ldg(row + min(k + 1, cw - 1)) + 1) >> 1;
    }
    if (!(x & 1)) return (__ldg(row + max(k - 1, 0)) + 3 * c + 2) >> 2;
    return (3 * c + __ldg(row + min(k + 1, cw - 1)) + 2) >> 2;
  }

  __device__ __forceinline__ uint8_t fetch(int b, int y, int x) const {
    const uint8_t* frame = p + static_cast<size_t>(b) * ch * cw;
    const int k = y >> 1;
    const int c = col(frame + static_cast<size_t>(k) * cw, x);
    int v;
    if (v_cosited) {
      v = (y & 1)
              ? (c + col(frame + static_cast<size_t>(min(k + 1, ch - 1)) * cw,
                         x) + 1) >> 1
              : c;
    } else if (!(y & 1)) {
      v = (col(frame + static_cast<size_t>(max(k - 1, 0)) * cw, x) + 3 * c +
           2) >> 2;
    } else {
      v = (3 * c + col(frame + static_cast<size_t>(min(k + 1, ch - 1)) * cw,
                       x) + 2) >> 2;
    }
    return static_cast<uint8_t>(v);
  }
};

}  // namespace

extern "C" int gst_chroma420_scale_u8(const void* src, void* out,
                                      const void* h_off, const void* h_taps,
                                      const void* v_off, const void* v_taps,
                                      int batch, int ch, int cw, int in_w,
                                      int oh, int ow, int th, int tv,
                                      int precision, int h_cosited,
                                      int v_cosited, int tile_rows,
                                      int span_max, void* stream) {
  const scale2pass::Taps t{static_cast<const int32_t*>(h_off),
                           static_cast<const int16_t*>(h_taps),
                           static_cast<const int32_t*>(v_off),
                           static_cast<const int16_t*>(v_taps),
                           in_w, ow, oh, th, tv, precision};
  const Chroma420Source s{static_cast<const uint8_t*>(src), ch, cw, h_cosited,
                          v_cosited};
  return scale2pass::launch(s, t, static_cast<int32_t*>(out), batch,
                            tile_rows, span_max,
                            static_cast<cudaStream_t>(stream));
}
