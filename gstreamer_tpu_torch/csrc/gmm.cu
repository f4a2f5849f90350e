// segmentation's per-pixel Gaussian mixture (Zivkovic's MOG2, 5 modes)
// over the frames of a tick, one thread a pixel.
//
// Replaces the jitted lax.scan of gstreamer_tpu/elements/opencv_analysis.py
// (Segmentation.make_scan_fn, :313-350; its step _gmm_step, :161-252;
// Pallas has no counterpart).  Every float32 operation is the reference's,
// in its order; the five that XLA contracts on the CPU are fmaf here and the
// source is built with -fmad=false, so nothing else fuses:
//   dist2 = fma(d2, d2, fma(d1, d1, d0 * d0))                        (:171)
//   w'    = fma(alpha, o - w, w) - alpha * ct                        (:181)
//   mean' = fma(rho, d, mean)                                        (:185)
//   var'  = fma(alpha / max(w', 1e-6), dist2 - var, var)        (:187-190)
//   the shadow test's dot products as dist2, x - ratio * mean as
//   fma(-ratio, mean, x)                                        (:232-236)
// The weights' total is summed left to right, and so is the sorted weights'
// cumsum (jnp.cumsum is XLA's reduce-window, in order for five).  The stable
// argsort of -w (zeros equal) is an odd-even transposition network of ten
// adjacent exchanges that carries each mode's bit, so the background modes
// come out as a bitmask; the weakest-slot argmin takes the first index.
//
// Built to issue few instructions a frame: one pass over the modes finds
// the owned mode and updates it in place (a branch: in a warp most lanes
// own the same mode), the modes' tests are bitmasks, a pixel whose heaviest
// mode holds at least kSoleBg of the weight skips the sort, the shadow test
// runs only for background modes, and the next frame's pixel is loaded a
// frame ahead.
//
// The carry is the reference's layout: weight (P, 5), mean (P, 5, 3),
// var (P, 5) float32 and nmodes (P,) int32 for P pixels; it is read once
// and written once a tick, the modes live in registers (every loop over
// the modes is unrolled, so no array is indexed at run time).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "status.cuh"

namespace {

constexpr int kK = 5;
constexpr float kTb = 16.0f;        // varThreshold
constexpr float kTg = 9.0f;         // varThresholdGen
constexpr float kBgRatio = 0.9f;    // backgroundRatio
// a heaviest weight from which it is the only background mode: above
// backgroundRatio by more than the 2^-23 the running sums can lose
constexpr float kSoleBg = 0.9001f;
constexpr float kVarInit = 15.0f;
constexpr float kVarMin = 4.0f;
constexpr float kVarMax = 75.0f;
constexpr float kEps = 1e-6f;
constexpr float kShadowTau = 0.5f;
constexpr int kThreads = 256;

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return fmaf(a[2], b[2], fmaf(a[1], b[1], a[0] * b[0]));
}

// one adjacent exchange of the descending sort: only a strictly heavier
// weight on the right moves left, so equal weights (0.0 and -0.0 among
// them) keep their order and the network is stable
__device__ __forceinline__ void exchange(float& wa, float& wb, unsigned& pa,
                                         unsigned& pb) {
  const bool s = wb > wa;
  const float w0 = s ? wb : wa, w1 = s ? wa : wb;
  const unsigned p0 = s ? pb : pa, p1 = s ? pa : pb;
  wa = w0;
  wb = w1;
  pa = p0;
  pb = p1;
}

__global__ void __launch_bounds__(kThreads)
gmm_kernel(const uint8_t* __restrict__ rp, const uint8_t* __restrict__ gp,
           const uint8_t* __restrict__ bp, const float* __restrict__ w_in,
           const float* __restrict__ m_in, const float* __restrict__ v_in,
           const int* __restrict__ n_in, float* __restrict__ w_out,
           float* __restrict__ m_out, float* __restrict__ v_out,
           int* __restrict__ n_out, uint8_t* __restrict__ mask, int frames,
           long long pixels, float alpha, float act, int with_shadow) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (p >= pixels) return;
  float w[kK], m[kK][3], v[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    w[k] = w_in[p * kK + k];
    v[k] = v_in[p * kK + k];
#pragma unroll
    for (int c = 0; c < 3; ++c) m[k][c] = m_in[(p * kK + k) * 3 + c];
  }
  int n = n_in[p];

  // the next frame's pixel is loaded a frame ahead
  unsigned nr = rp[p], ng = gp[p], nb = bp[p];
  for (int f = 0; f < frames; ++f) {
    const size_t off = static_cast<size_t>(f) * pixels + p;
    const float x[3] = {static_cast<float>(nr), static_cast<float>(ng),
                        static_cast<float>(nb)};
    if (f + 1 < frames) {
      nr = rp[off + pixels];
      ng = gp[off + pixels];
      nb = bp[off + pixels];
    }
    // one pass over the modes: the distance, the match within Tb of the
    // old variance (near, a bitmask), the weight (the reference's o - w with
    // o = 0 is -w), and the first active mode within Tg takes the owned
    // update in place: its weight with o = 1, its mean and variance
    unsigned near = 0, live = 0;
    int first = -1;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = x[c] - m[k][c];
      const float dist2 = dot3(d, d);
      if (dist2 < v[k] * kTb) near |= 1u << k;
      const float w0 = w[k];
      w[k] = fmaf(alpha, -w0, w0) - act;
      if (first < 0 && k < n && dist2 < v[k] * kTg) {
        first = k;
        w[k] = fmaf(alpha, 1.0f - w0, w0) - act;
        // var's rate is the reference's second alpha / max(w', eps): the
        // same value as rho
        const float rho = alpha / fmaxf(w[k], kEps);
#pragma unroll
        for (int c = 0; c < 3; ++c) m[k][c] = fmaf(rho, d[c], m[k][c]);
        v[k] = fminf(fmaxf(fmaf(rho, dist2 - v[k], v[k]), kVarMin), kVarMax);
      }
      const bool alive = k < n && w[k] > 0.0f;
      if (!alive) w[k] = 0.0f;
      live |= alive ? 1u << k : 0u;
    }
    int nn = __popc(live);
    if (first < 0) {                         // spawn in the weakest slot
      int slot = nn;
      if (nn >= kK) {                        // every mode alive here
        slot = 0;
        float best = w[0];
#pragma unroll
        for (int k = 1; k < kK; ++k) {
          if (w[k] < best) {
            best = w[k];
            slot = k;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (k == slot) {
          w[k] = alpha;
#pragma unroll
          for (int c = 0; c < 3; ++c) m[k][c] = x[c];
          v[k] = kVarInit;
        }
      }
      nn = min(nn + 1, kK);
    }
    const float tot = fmaxf((((w[0] + w[1]) + w[2]) + w[3]) + w[4], kEps);
#pragma unroll
    for (int k = 0; k < kK; ++k) w[k] = (k < nn) ? w[k] / tot : 0.0f;

    // the background modes as a bitmask.  Where the heaviest weight is at
    // least kSoleBg, it alone is background: it sorts first (no other
    // weight can equal it), and every later place's running sum less its
    // own weight stays at or above the heaviest less 2^-23, so above
    // backgroundRatio.  Elsewhere, the stable descending sort of (weight,
    // mode bit): odd-even transposition, five rounds of adjacent
    // exchanges; then the running sum in sorted order.
    float wmax = w[0];
    int kmax = 0;
#pragma unroll
    for (int k = 1; k < kK; ++k) {
      if (w[k] > wmax) {
        wmax = w[k];
        kmax = k;
      }
    }
    unsigned bg = 1u << kmax;
    if (wmax < kSoleBg) {
      float ws[kK];
      unsigned pm[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        ws[k] = w[k];
        pm[k] = 1u << k;
      }
#pragma unroll
      for (int r = 0; r < kK; ++r) {
#pragma unroll
        for (int i = r & 1; i + 1 < kK; i += 2) {
          exchange(ws[i], ws[i + 1], pm[i], pm[i + 1]);
        }
      }
      bg = 0;
      float csum = 0.0f;
#pragma unroll
      for (int q = 0; q < kK; ++q) {
        csum = q ? csum + ws[q] : ws[0];
        if ((csum - ws[q]) < kBgRatio) bg |= pm[q];
      }
    }
    bg &= (1u << nn) - 1u;                   // the modes below nn
    const bool matches_bg = (bg & near) != 0;

    uint8_t out = matches_bg ? 0 : 255;
    if (!matches_bg && with_shadow) {        // only background modes count
      bool shadow = false;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (bg & (1u << k)) {
          const float num = dot3(x, m[k]);
          const float den = fmaxf(dot3(m[k], m[k]), kEps);
          const float ratio = num / den;
          float ds[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) ds[c] = fmaf(-ratio, m[k][c], x[c]);
          const float dist2s = dot3(ds, ds);
          if (ratio >= kShadowTau && ratio <= 1.0f &&
              dist2s < (v[k] * kTb) * (ratio * ratio)) {
            shadow = true;
          }
        }
      }
      if (shadow) out = 127;
    }
    mask[off] = out;
    n = nn;
  }

#pragma unroll
  for (int k = 0; k < kK; ++k) {
    w_out[p * kK + k] = w[k];
    v_out[p * kK + k] = v[k];
#pragma unroll
    for (int c = 0; c < 3; ++c) m_out[(p * kK + k) * 3 + c] = m[k][c];
  }
  n_out[p] = n;
}

}  // namespace

// r, g, b: (frames, pixels) uint8; the carry in (weight, mean, var, nmodes)
// and out as above; mask: (frames, pixels) uint8, all on the card.  The
// caller checks frames >= 1, pixels >= 1 and contiguity.
extern "C" int gst_gmm(const void* r, const void* g, const void* b,
                       const void* w_in, const void* m_in, const void* v_in,
                       const void* n_in, void* w_out, void* m_out,
                       void* v_out, void* n_out, void* mask, int frames,
                       int pixels, float alpha, float act, int with_shadow,
                       void* stream) {
  const int blocks = (pixels + kThreads - 1) / kThreads;
  gmm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r), static_cast<const uint8_t*>(g),
      static_cast<const uint8_t*>(b), static_cast<const float*>(w_in),
      static_cast<const float*>(m_in), static_cast<const float*>(v_in),
      static_cast<const int*>(n_in), static_cast<float*>(w_out),
      static_cast<float*>(m_out), static_cast<float*>(v_out),
      static_cast<int*>(n_out), static_cast<uint8_t*>(mask), frames, pixels,
      alpha, act, with_shadow);
  return static_cast<int>(cudaGetLastError());
}
