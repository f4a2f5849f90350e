// Freeverb's per-sample recursion: 8 + 8 damped combs and 4 + 4 series
// allpasses of one stereo engine, over n frames, state carried in place.
//
// Replaces the jitted lax.scan of gstreamer_tpu/elements/freeverb.py
// (:131-198; Pallas has no counterpart).  Reference: gst-plugins-bad
// gst/freeverb/gstfreeverb.c (Jezar's Freeverb): per sample
//   comb:    tmp = buf[i]; fs = tmp*damp2 + fs*damp1; buf[i] = in + fs*feedback
//   allpass: bo = buf[i]; out = bo - in; buf[i] = in + bo*0.5
//   out_l = ((0 + c0) + c1) + ... + c7 through the 4 allpasses, - DC, then
//   L = out_l*wet1 + out_r*wet2 + in_l*dry (and mirrored for R).
// Built with -fmad=false: every product and sum is rounded on its own, as
// the scalar reference rounds it, so the output equals it bit for bit.
//
// Bound: latency.  The work is ~140 float operations and 8 bytes in, 8 out
// a frame; what limits it is the chain each filterstore carries from one
// sample to the next (a multiply and an add), and the sum and allpass chain
// inside a sample.  One warp runs one stream: lanes 0-15 run the 16 combs
// side by side; lane 0 gathers their outputs by shuffles, sums each
// channel's in the reference's order and runs both channels' 4 allpasses in
// series, the two chains interleaved, then the wet/dry mix.  A sample's ring
// reads all go first (each ring is read at its index before it is
// written there, and no two stages share one) and the next sample's input
// is loaded ahead, so the chain a sample waits on is the comb read, the
// shuffles, the 8 sums, the 4 allpasses and the mix.  The rings (~111 KB
// a 48 kHz stream, ~222 KB at 96 kHz) are staged into dynamic shared memory
// for the call and written back at its end; above the opt-in limit
// (192 kHz) they stay in device memory.

#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

#include "status.cuh"

namespace {

constexpr int kCombs = 16;      // 8 a channel: rings 0-7 left, 8-15 right
constexpr int kRings = 24;      // then 4 allpasses left (16-19), right (20-23)
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  int off[kRings];              // each ring's first float in a stream's rings
  int size[kRings];
  int total;                    // floats of rings a stream
};

struct Params {
  float feedback, damp1, damp2, wet1, wet2, dry, gain, dc;
};

// x: (streams, n, kIn) float32; out: (streams, n, 2); rings: (streams,
// total); idx: (streams, 24) int32; fs: (streams, 16).  One block of 32
// threads a stream.
template <bool kShared, int kIn>
__global__ void __launch_bounds__(32)
freeverb_kernel(const float* __restrict__ x, float* __restrict__ out,
                float* rings, int* idx, float* fss, int n, Layout lay,
                Params p) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  float* g = rings + static_cast<size_t>(s) * lay.total;
  float* r = g;
  if (kShared) {
    for (int i = lane; i < lay.total; i += 32) smem[i] = g[i];
    __syncwarp();
    r = smem;
  }
  int* si = idx + s * kRings;
  const bool comb = lane < kCombs;
  const int c = comb ? lane : 0;
  float* cbuf = r + lay.off[c];
  const int csize = lay.size[c];
  int ci = si[c];
  float fs = fss[s * kCombs + c];
  // lane 0 runs both channels' allpasses: [0..3] left, [4..7] right
  const bool ap = lane == 0;
  float* abuf[8];
  int asize[8], ai[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    abuf[k] = r + lay.off[kCombs + k];
    asize[k] = lay.size[kCombs + k];
    ai[k] = si[kCombs + k];
  }
  const float* xs = x + static_cast<size_t>(s) * n * kIn;
  float* os = out + static_cast<size_t>(s) * n * 2;
  float nl = __ldg(xs);
  float nr = kIn == 2 ? __ldg(xs + 1) : nl;
  for (int t = 0; t < n; ++t) {
    // every ring is read at its index before it is written there, and no
    // two stages share a ring: all this sample's reads go first
    const float tmp = comb ? cbuf[ci] : 0.0f;
    float bo[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) bo[k] = ap ? abuf[k][ai[k]] : 0.0f;
    const float in2l = nl, in2r = nr;
    if (t + 1 < n) {
      nl = __ldg(xs + static_cast<size_t>(t + 1) * kIn);
      nr = kIn == 2 ? __ldg(xs + static_cast<size_t>(t + 1) * kIn + 1) : nl;
    }
    float in1l, in1r;
    if (kIn == 2) {
      in1l = (in2l + p.dc) * p.gain;
      in1r = (in2r + p.dc) * p.gain;
    } else {
      in1l = (2.0f * in2l + p.dc) * p.gain;
      in1r = in1l;
    }
    if (comb) {
      fs = tmp * p.damp2 + fs * p.damp1;
      cbuf[ci] = (lane < 8 ? in1l : in1r) + fs * p.feedback;
      ci = ci + 1 >= csize ? 0 : ci + 1;
    }
    // the comb outputs summed in the reference's order ((0 + c0) + c1) +
    // ..., left and right side by side
    float vl = 0.0f, vr = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      vl = vl + __shfl_sync(kFull, tmp, k);
      vr = vr + __shfl_sync(kFull, tmp, 8 + k);
    }
    if (ap) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float ol = bo[k] - vl;
        const float orr = bo[4 + k] - vr;
        abuf[k][ai[k]] = vl + bo[k] * 0.5f;
        abuf[4 + k][ai[4 + k]] = vr + bo[4 + k] * 0.5f;
        vl = ol;
        vr = orr;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        ai[k] = ai[k] + 1 >= asize[k] ? 0 : ai[k] + 1;
      }
      vl = vl - p.dc;
      vr = vr - p.dc;
      float* o = os + static_cast<size_t>(t) * 2;
      o[0] = vl * p.wet1 + vr * p.wet2 + in2l * p.dry;
      o[1] = vr * p.wet1 + vl * p.wet2 + in2r * p.dry;
    }
  }
  if (comb) {
    si[c] = ci;
    fss[s * kCombs + c] = fs;
  }
  if (ap) {
#pragma unroll
    for (int k = 0; k < 8; ++k) si[kCombs + k] = ai[k];
  }
  if (kShared) {
    __syncwarp();
    for (int i = lane; i < lay.total; i += 32) g[i] = smem[i];
  }
}

template <bool kShared, int kIn>
int launch(const float* x, float* out, float* rings, int* idx, float* fs,
           int streams, int n, const Layout& lay, const Params& p,
           cudaStream_t stream) {
  size_t smem = 0;
  if (kShared) {
    smem = static_cast<size_t>(lay.total) * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        freeverb_kernel<kShared, kIn>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  freeverb_kernel<kShared, kIn><<<streams, 32, smem, stream>>>(
      x, out, rings, idx, fs, n, lay, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// layout: 49 host ints, the 24 ring offsets, the 24 sizes and the total;
// shared: stage the rings in shared memory (the caller checks they fit).
// The caller checks streams >= 1, n >= 1, channels in {1, 2}, the shapes
// and that every tensor is contiguous on the card.
extern "C" int gst_freeverb(const void* x, void* out, void* rings, void* idx,
                            void* fs, int streams, int n, int channels,
                            const void* layout, int shared, float feedback,
                            float damp1, float damp2, float wet1, float wet2,
                            float dry, float gain, float dc, void* stream) {
  Layout lay;
  memcpy(lay.off, layout, sizeof(lay.off));
  memcpy(lay.size, static_cast<const int*>(layout) + kRings,
         sizeof(lay.size));
  lay.total = static_cast<const int*>(layout)[2 * kRings];
  const Params p{feedback, damp1, damp2, wet1, wet2, dry, gain, dc};
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  float* rg = static_cast<float*>(rings);
  int* ix = static_cast<int*>(idx);
  float* f = static_cast<float*>(fs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    return channels == 2
               ? launch<true, 2>(xs, o, rg, ix, f, streams, n, lay, p, st)
               : launch<true, 1>(xs, o, rg, ix, f, streams, n, lay, p, st);
  }
  return channels == 2
             ? launch<false, 2>(xs, o, rg, ix, f, streams, n, lay, p, st)
             : launch<false, 1>(xs, o, rg, ix, f, streams, n, lay, p, st);
}
