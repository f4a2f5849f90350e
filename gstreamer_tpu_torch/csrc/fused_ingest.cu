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
// height and width to its tiles.  None of that carries over: a block owns one
// frame and a run of chroma rows, stages them (with one halo row each side)
// in shared memory, builds the interleaved full-width up2 rows there, and
// runs the same table-driven h pass over them that it runs over the luma rows
// (scale2pass.cuh hpass_rows).  The full-width chroma rows never reach device
// memory, and nothing is padded: edges are clamped by index.
//
// Bound: bytes (1.5 per source pixel read; 2 * ow * 2H per frame written).

#include "scale2pass.cuh"

namespace {

using scale2pass::align16;
using scale2pass::HTaps;
using scale2pass::kThreads;

struct Planes {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  int16_t* oy;
  int16_t* oue;
  int16_t* ouo;
  int16_t* ove;
  int16_t* ovo;
  int h, hc, wc, h_cosited;
};

// Dynamic shared memory: h tables | chroma rows (u8, + halo) | h-filtered
// full-width rows (u8) | luma rows, then v-filtered full-width rows (u8).
// ops/convert_kernel.py computes the same total.
struct SmemLayout {
  size_t chroma, hrows, rows, total;
  __host__ __device__ SmemLayout(const HTaps& t, int wc, int kc) {
    chroma = scale2pass::htable_bytes(t.th, t.ow);
    hrows = chroma + align16(static_cast<size_t>(kc + 2) * wc) + 16;
    rows = hrows + align16(static_cast<size_t>(kc + 2) * t.in_w);
    total = rows + align16(static_cast<size_t>(2 * kc) * t.in_w) + 16;
  }
};

// rows 2k (even) and 2k+1 (odd) of a block go to two planes
struct ParityStore {
  int16_t* even;
  int16_t* odd;
  int ow;
  __device__ __forceinline__ void operator()(int k, int j, int v) const {
    ((k & 1) ? odd : even)[static_cast<size_t>(k >> 1) * ow + j] =
        static_cast<int16_t>(v);
  }
};

__global__ void __launch_bounds__(kThreads)
fused_ingest_kernel(Planes p, HTaps t, int kc, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemLayout L(t, p.wc, kc);
  int16_t* s_taps = reinterpret_cast<int16_t*>(smem);
  int32_t* s_off = reinterpret_cast<int32_t*>(
      smem + align16(static_cast<size_t>(t.th) * t.ow * 2));
  uint8_t* s_cbase = smem + L.chroma;
  uint8_t* s_h = smem + L.hrows;
  uint8_t* s_v = smem + L.rows;

  const int b = blockIdx.x / tiles;
  const int k0 = (blockIdx.x - b * tiles) * kc;
  const int nk = min(kc, p.hc - k0);
  const int w = t.in_w;
  const int tid = threadIdx.x;

  scale2pass::load_htables(t, s_taps, s_off);

  // luma rows 2*k0 .. 2*(k0+nk)-1: one contiguous span, the plain h pass
  {
    const size_t row0 = static_cast<size_t>(b) * p.h + 2 * k0;
    const uint8_t* s_y = scale2pass::stage_span(s_v, p.y + row0 * w,
                                                2 * nk * w);
    __syncthreads();
    scale2pass::hpass_rows(s_y, 2 * nk, t, s_taps, s_off,
                           scale2pass::RowStore<int16_t>{p.oy + row0 * t.ow,
                                                         t.ow});
  }

  const int lo = max(k0 - 1, 0);
  const int hi = min(k0 + nk, p.hc - 1);
  const int n_c = hi - lo + 1;
  for (int plane = 0; plane < 2; ++plane) {
    const uint8_t* src = plane ? p.v : p.u;
    __syncthreads();               // the h pass before this is done with s_v
    const uint8_t* s_c = scale2pass::stage_span(
        s_cbase, src + (static_cast<size_t>(b) * p.hc + lo) * p.wc,
        n_c * p.wc);
    __syncthreads();

    // up2 H of every staged row, interleaved to full width
    for (int i = tid; i < n_c * p.wc; i += blockDim.x) {
      const int r = i / p.wc;
      const int x = i - r * p.wc;
      const uint8_t* row = s_c + r * p.wc;
      const int c = row[x];
      const int cn = row[min(x + 1, p.wc - 1)];
      int e, o;
      if (p.h_cosited) {
        e = c;
        o = (c + cn + 1) >> 1;
      } else {
        e = (row[max(x - 1, 0)] + 3 * c + 2) >> 2;
        o = (3 * c + cn + 2) >> 2;
      }
      s_h[r * w + 2 * x] = static_cast<uint8_t>(e);
      s_h[r * w + 2 * x + 1] = static_cast<uint8_t>(o);
    }
    __syncthreads();

    // up2 V (interstitial) into full-resolution rows 2k and 2k+1
    for (int i = tid; i < nk * w; i += blockDim.x) {
      const int kk = i / w;
      const int x = i - kk * w;
      const int k = k0 + kk;
      const int c = s_h[(k - lo) * w + x];
      const int up = s_h[(max(k - 1, 0) - lo) * w + x];
      const int dn = s_h[(min(k + 1, p.hc - 1) - lo) * w + x];
      s_v[(2 * kk) * w + x] = static_cast<uint8_t>((up + 3 * c + 2) >> 2);
      s_v[(2 * kk + 1) * w + x] = static_cast<uint8_t>((3 * c + dn + 2) >> 2);
    }
    __syncthreads();

    const size_t out0 = (static_cast<size_t>(b) * p.hc + k0) * t.ow;
    scale2pass::hpass_rows(
        s_v, 2 * nk, t, s_taps, s_off,
        ParityStore{(plane ? p.ove : p.oue) + out0,
                    (plane ? p.ovo : p.ouo) + out0, t.ow});
  }
}

}  // namespace

extern "C" int gst_fused_i420_up_hscale(
    const void* y, const void* u, const void* v, void* oy, void* oue,
    void* ouo, void* ove, void* ovo, const void* h_off, const void* h_taps,
    int batch, int in_h, int in_w, int ow, int th, int precision,
    int h_cosited, int chroma_rows_per_block, void* stream) {
  const HTaps t{static_cast<const int32_t*>(h_off),
                static_cast<const int16_t*>(h_taps), in_w, ow, th, precision};
  const Planes p{static_cast<const uint8_t*>(y),
                 static_cast<const uint8_t*>(u),
                 static_cast<const uint8_t*>(v),
                 static_cast<int16_t*>(oy),
                 static_cast<int16_t*>(oue),
                 static_cast<int16_t*>(ouo),
                 static_cast<int16_t*>(ove),
                 static_cast<int16_t*>(ovo),
                 in_h, in_h / 2, in_w / 2, h_cosited};
  const int kc = chroma_rows_per_block;
  const SmemLayout L(t, p.wc, kc);
  cudaError_t e = cudaFuncSetAttribute(
      fused_ingest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (p.hc + kc - 1) / kc;
  fused_ingest_kernel<<<batch * tiles, kThreads, L.total,
                        static_cast<cudaStream_t>(stream)>>>(p, t, kc, tiles);
  return static_cast<int>(cudaGetLastError());
}
