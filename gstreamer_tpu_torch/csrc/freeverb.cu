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
// a frame; the one chain that carries from frame to frame is each comb's
// filterstore, a multiply and an add (4 cycles each).  Everything else can
// be taken out of it, because every ring is a delay at least as long as
// itself: comb k at frame t reads what it wrote at frame t - size_k.
//   - In a block of B <= min(comb ring) frames no comb reads a value
//     written in the same block, so a block's comb reads (its "window", a
//     span of each ring wrapping at most once) are known before it starts;
//     so are the comb sums, which use only the values read.
//   - In a chunk of C <= min(allpass ring) frames no allpass reads a value
//     written in the same chunk, so one thread a frame runs all 8 stages of
//     its frame, the chunk's frames side by side.
// One block of 8 warps a stream.  Warp 0 (lanes 0-15, one comb each) runs
// only the comb recursions: for each frame of a block it reads the window
// value, updates fs and writes the comb's new ring value back over it, 4
// frames a 16-byte load and store, loaded two steps ahead and stored one
// step late, with no index, wrap or branch in the loop.  Warps 1-7 (the
// consumers) stay one block behind it and one or two ahead: they stage the
// window of block b + lag from the comb rings into a slot of shared memory
// with the comb inputs, the samples and the sums of each channel in the
// reference's order; write block b's new values back to the rings; and run
// block b's allpasses in chunks (a named barrier over the consumers
// between chunks), DC and the mix.  Two slots double-buffer the hand-off;
// FULL / READY named barriers (bar.arrive on one side, bar.sync on the
// other) order it.  lag = 2 when B <= half the shortest comb ring (block
// b + 2's window then holds only writes of blocks <= b, written back
// before it is staged), else 1 (B = 1 at rates whose shortest comb ring is
// 1 float: the schedule runs frame by frame).  The rings sit in shared
// memory for the call where they fit beside the slots (all 24 to 48 kHz,
// the allpasses to 384 kHz), else in device memory (kShared); at 48 kHz
// all 24 there take 2.9% less time than the allpasses alone, none 48%
// more (tools/freeverb_variants.py).  B, C, lag and the placement come
// from the layout (schedule(); ops/freeverb_kernel.py::schedule mirrors
// it, gst_freeverb_schedule reports it, and a launch whose placement
// differs from it is refused).  The schedule only reorders operations
// that are independent, so every rounded value is the reference's.
//
// On the H100 the consumers set the pace: alone they take ~13 cycles a
// frame (staging, write-back and the allpasses ~3.6 each), the comb warp
// alone ~12.2, where the bare multiply-add chain takes 8.5 (its loads and
// stores wait in its in-order issue): tools/freeverb_variants.py.

#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

#include <algorithm>

#include "status.cuh"

namespace {

constexpr int kCombs = 16;       // 8 a channel: rings 0-7 left, 8-15 right
constexpr int kAllpasses = 8;    // then 4 left (16-19), 4 right (20-23)
constexpr int kRings = 24;
constexpr int kMaxBlock = 512;   // frames a block at most
constexpr int kConsumers = 224;  // warps 1-7
constexpr int kThreads = 32 + kConsumers;
// a slot of block buffers, in rows of `pitch` floats: the 16 comb windows
// (the comb warp overwrites each value read with the one it writes), the
// two channels' comb inputs, comb sums and samples
constexpr int kRowIn = kCombs;
constexpr int kRowSum = kCombs + 2;
constexpr int kRowX = kCombs + 4;
constexpr int kSlotRows = kCombs + 6;
// named barriers (0 is __syncthreads): FULL + slot, READY + slot, the
// consumers' own, and the start (the first slots and the allpass rings
// staged)
constexpr int kFull = 1;
constexpr int kReady = 3;
constexpr int kConsumerBar = 5;
constexpr int kStart = 6;
// the H100's opt-in shared memory a block, in bytes
constexpr size_t kSharedLimit = 227 * 1024;

struct Layout {
  int off[kRings];              // each ring's first float in a stream's rings
  int size[kRings];
  int total;                    // floats of rings a stream
};

struct Params {
  float feedback, damp1, damp2, wet1, wet2, dry, gain, dc;
};

struct Schedule {
  int block;                    // B frames a block
  int lag;                      // blocks staged ahead of the comb warp
  int chunk;                    // C frames an allpass chunk
  int pitch;                    // floats a row of a slot
  int shared;                   // rings kept in shared memory for the call:
};                              // 2 all 24, 1 the allpasses, 0 none

Schedule schedule(const Layout& lay) {
  using std::min;
  int cmin = lay.size[0], amin = lay.size[kCombs];
  for (int k = 1; k < kCombs; ++k) cmin = min(cmin, lay.size[k]);
  for (int k = kCombs + 1; k < kRings; ++k) amin = min(amin, lay.size[k]);
  Schedule sc;
  sc.block = cmin >= 2 ? min(cmin / 2, kMaxBlock) : 1;
  sc.lag = 2 * sc.block <= cmin ? 2 : 1;
  sc.chunk = amin;
  // a multiple of 4 (16-byte rows) that is 4 more than a multiple of 32, so
  // the comb lanes' vector loads fall in distinct banks
  sc.pitch = (sc.block + 31) / 32 * 32 + 4;
  // the most rings that fit in shared memory beside the two slots
  const size_t slots = static_cast<size_t>(2) * kSlotRows * sc.pitch;
  const size_t all = lay.total, allpasses = lay.total - lay.off[kCombs];
  sc.shared = (slots + all) * sizeof(float) <= kSharedLimit         ? 2
              : (slots + allpasses) * sizeof(float) <= kSharedLimit ? 1
                                                                    : 0;
  return sc;
}

// both called by whole warps
__device__ __forceinline__ void bar_sync(int id, int count) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  __syncwarp();
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// one frame of a comb: v is the value read, then the value written
__device__ __forceinline__ void comb1(float& v, float in, float& fs,
                                      const Params& p) {
  fs = v * p.damp2 + fs * p.damp1;
  v = in + fs * p.feedback;
}

// 4 frames of a comb: the values written, from the values read v
__device__ __forceinline__ float4 comb_step(float4 v, const float4& a,
                                            float& fs, const Params& p) {
  comb1(v.x, a.x, fs, p);
  comb1(v.y, a.y, fs, p);
  comb1(v.z, a.z, fs, p);
  comb1(v.w, a.w, fs, p);
  return v;
}

// x: (streams, n, kIn) float32; out: (streams, n, 2); rings: (streams,
// total); idx: (streams, 24) int32; fs: (streams, 16).  One block of
// kThreads a stream; dynamic shared memory: two slots, then the rings
// kept there for the call (kShared: 2 all 24, 1 the allpasses, 0 none).
template <int kIn, int kShared>
__global__ void __launch_bounds__(kThreads)
freeverb_kernel(const float* __restrict__ x, float* __restrict__ out,
                float* rings, int* idx, float* fss, int n, Layout lay,
                Schedule sc, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int B = sc.block, P = sc.pitch;
  const int nblocks = (n + B - 1) / B;
  float* g = rings + static_cast<size_t>(s) * lay.total;
  int* si = idx + s * kRings;
  const float* xs = x + static_cast<size_t>(s) * n * kIn;
  // the rings kept in shared memory: all, or the allpasses' span at the
  // end of a stream's rings; comb ring k at cbase + off[k], allpass ring a
  // at abase + off[16 + a] - abeg
  const int abeg = lay.off[kCombs];
  const int first = kShared == 2 ? 0 : abeg;
  const int span = kShared ? lay.total - first : 0;
  float* sr = smem + 2 * kSlotRows * P;
  for (int i = tid; i < span; i += kThreads) sr[i] = g[first + i];
  __syncthreads();                         // before any thread reads them
  float* cbase = kShared == 2 ? sr : g;
  float* abase = kShared == 2 ? sr + abeg : kShared ? sr : g + abeg;

  if (tid < 32) {
    // -- the comb warp: the 16 filterstore chains ------------------------
    const bool comb = tid < kCombs;
    float fs = comb ? fss[s * kCombs + tid] : 0.0f;
    bar_sync(kStart, kThreads);            // slots 0 .. lag-1 staged
    for (int b = 0; b < nblocks; ++b) {
      const int nb = min(B, n - b * B);
      float* slot = smem + (b & 1) * kSlotRows * P;
      if (b >= sc.lag) bar_sync(kReady + (b & 1), kThreads);
      if (comb) {
        float4* w = reinterpret_cast<float4*>(slot + tid * P);
        const float4* in =
            reinterpret_cast<const float4*>(slot + (kRowIn + (tid >= 8)) * P);
        // 4 frames a step.  Each step's window and inputs are loaded two
        // steps ahead and its results stored one step late, from registers
        // of their own, with no branch in the loop, so no load or store
        // waits in the chain.  A load past the block's steps reads floats
        // of the slot's next rows and is never used.
        const int steps = nb / 4;
        if (steps > 0) {
          float4 v0 = w[0], a0 = in[0], v1 = w[1], a1 = in[1];
          float4 r0 = comb_step(v0, a0, fs, p), r1;
          v0 = w[2];
          a0 = in[2];
          int k = 1;
          for (; k + 2 <= steps; k += 2) {
            r1 = comb_step(v1, a1, fs, p);
            w[k - 1] = r0;
            v1 = w[k + 2];
            a1 = in[k + 2];
            r0 = comb_step(v0, a0, fs, p);
            w[k] = r1;
            v0 = w[k + 3];
            a0 = in[k + 3];
          }
          if (k < steps) {
            r1 = comb_step(v1, a1, fs, p);
            w[k] = r1;
          }
          w[k - 1] = r0;
        }
        float* wt = slot + tid * P;
        const float* it = slot + (kRowIn + (tid >= 8)) * P;
        for (int f = 4 * steps; f < nb; ++f) comb1(wt[f], it[f], fs, p);
      }
      bar_arrive(kFull + (b & 1), kThreads);
    }
    if (comb) fss[s * kCombs + tid] = fs;
  } else {
    // -- the consumers ----------------------------------------------------
    const int q = tid - 32;
    float* os = out + static_cast<size_t>(s) * n * 2;
    int sb[kCombs], wb[kCombs], ab[kAllpasses];   // ring positions of the
#pragma unroll                                    // next block staged, the
    for (int k = 0; k < kCombs; ++k) {            // next written back, the
      sb[k] = si[k];                              // next allpass chunk
      wb[k] = sb[k];
    }
#pragma unroll
    for (int a = 0; a < kAllpasses; ++a) ab[a] = si[kCombs + a];

    // block b's window, comb inputs, comb sums and samples into slot b & 1
    auto stage = [&](int b) {
      const int nb = min(B, n - b * B);
      float* slot = smem + (b & 1) * kSlotRows * P;
      for (int f = q; f < nb; f += kConsumers) {
        const size_t t = static_cast<size_t>(b) * B + f;
        const float l = __ldg(xs + kIn * t);
        const float r = kIn == 2 ? __ldg(xs + 2 * t + 1) : l;
        slot[kRowX * P + f] = l;
        slot[(kRowX + 1) * P + f] = r;
        if (kIn == 2) {
          slot[kRowIn * P + f] = (l + p.dc) * p.gain;
          slot[(kRowIn + 1) * P + f] = (r + p.dc) * p.gain;
        } else {
          const float in1 = (2.0f * l + p.dc) * p.gain;
          slot[kRowIn * P + f] = in1;
          slot[(kRowIn + 1) * P + f] = in1;
        }
        float v[kCombs];
#pragma unroll
        for (int k = 0; k < kCombs; ++k) {
          int pos = sb[k] + f;
          if (pos >= lay.size[k]) pos -= lay.size[k];
          v[k] = cbase[lay.off[k] + pos];
        }
        float vl = 0.0f, vr = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          slot[k * P + f] = v[k];
          slot[(8 + k) * P + f] = v[8 + k];
          vl = vl + v[k];
          vr = vr + v[8 + k];
        }
        slot[kRowSum * P + f] = vl;
        slot[(kRowSum + 1) * P + f] = vr;
      }
#pragma unroll
      for (int k = 0; k < kCombs; ++k) {
        sb[k] += nb;
        if (sb[k] >= lay.size[k]) sb[k] -= lay.size[k];
      }
    };
    // the comb warp's new values of block b back into the rings
    auto write_back = [&](int b) {
      const int nb = min(B, n - b * B);
      const float* slot = smem + (b & 1) * kSlotRows * P;
      for (int f = q; f < nb; f += kConsumers) {
#pragma unroll
        for (int k = 0; k < kCombs; ++k) {
          int pos = wb[k] + f;
          if (pos >= lay.size[k]) pos -= lay.size[k];
          cbase[lay.off[k] + pos] = slot[k * P + f];
        }
      }
#pragma unroll
      for (int k = 0; k < kCombs; ++k) {
        wb[k] += nb;
        if (wb[k] >= lay.size[k]) wb[k] -= lay.size[k];
      }
    };
    // block b's allpasses, DC and mix, chunk by chunk
    auto finish = [&](int b) {
      const int nb = min(B, n - b * B);
      const float* slot = smem + (b & 1) * kSlotRows * P;
      for (int f0 = 0; f0 < nb; f0 += sc.chunk) {
        const int len = min(sc.chunk, nb - f0);
        for (int j = q; j < len; j += kConsumers) {
          const int f = f0 + j;
          // every allpass ring is read before any is written
          int pos[kAllpasses];
          float bo[kAllpasses];
#pragma unroll
          for (int a = 0; a < kAllpasses; ++a) {
            const int sz = lay.size[kCombs + a];
            pos[a] = ab[a] + j;
            if (pos[a] >= sz) pos[a] -= sz;
            pos[a] += lay.off[kCombs + a] - abeg;
            bo[a] = abase[pos[a]];
          }
          float vl = slot[kRowSum * P + f];
          float vr = slot[(kRowSum + 1) * P + f];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float ol = bo[a] - vl;
            const float orr = bo[4 + a] - vr;
            abase[pos[a]] = vl + bo[a] * 0.5f;
            abase[pos[4 + a]] = vr + bo[4 + a] * 0.5f;
            vl = ol;
            vr = orr;
          }
          vl = vl - p.dc;
          vr = vr - p.dc;
          const float l = slot[kRowX * P + f];
          const float r = slot[(kRowX + 1) * P + f];
          const size_t t = static_cast<size_t>(b) * B + f;
          os[2 * t] = vl * p.wet1 + vr * p.wet2 + l * p.dry;
          os[2 * t + 1] = vr * p.wet1 + vl * p.wet2 + r * p.dry;
        }
#pragma unroll
        for (int a = 0; a < kAllpasses; ++a) {
          const int sz = lay.size[kCombs + a];
          ab[a] += len;
          if (ab[a] >= sz) ab[a] -= sz;
        }
        bar_sync(kConsumerBar, kConsumers);
      }
    };

    for (int b = 0; b < sc.lag && b < nblocks; ++b) stage(b);
    bar_sync(kStart, kThreads);
    for (int b = 0; b < nblocks; ++b) {
      bar_sync(kFull + (b & 1), kThreads);
      write_back(b);
      bar_sync(kConsumerBar, kConsumers);
      if (sc.lag == 1 && b + 1 < nblocks) {
        stage(b + 1);
        bar_arrive(kReady + ((b + 1) & 1), kThreads);
      }
      finish(b);                           // ends on a consumer barrier
      if (sc.lag == 2 && b + 2 < nblocks) {
        stage(b + 2);
        bar_arrive(kReady + (b & 1), kThreads);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < span; i += kThreads) g[first + i] = sr[i];
  if (tid < kRings) {
    si[tid] = static_cast<int>(
        (static_cast<long long>(si[tid]) + n) % lay.size[tid]);
  }
}

template <int kIn, int kShared>
int launch(const float* x, float* out, float* rings, int* idx, float* fs,
           int streams, int n, const Layout& lay, const Schedule& sc,
           const Params& p, cudaStream_t stream) {
  size_t floats = static_cast<size_t>(2) * kSlotRows * sc.pitch;
  if (kShared) floats += lay.total - (kShared == 2 ? 0 : lay.off[kCombs]);
  const size_t smem = floats * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      freeverb_kernel<kIn, kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  freeverb_kernel<kIn, kShared><<<streams, kThreads, smem, stream>>>(
      x, out, rings, idx, fs, n, lay, sc, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kIn>
int launch_in(const float* x, float* out, float* rings, int* idx, float* fs,
              int streams, int n, const Layout& lay, const Schedule& sc,
              const Params& p, cudaStream_t stream) {
  if (sc.shared == 2) {
    return launch<kIn, 2>(x, out, rings, idx, fs, streams, n, lay, sc, p,
                          stream);
  }
  if (sc.shared == 1) {
    return launch<kIn, 1>(x, out, rings, idx, fs, streams, n, lay, sc, p,
                          stream);
  }
  return launch<kIn, 0>(x, out, rings, idx, fs, streams, n, lay, sc, p,
                        stream);
}

Layout read_layout(const void* layout) {
  Layout lay;
  memcpy(lay.off, layout, sizeof(lay.off));
  memcpy(lay.size, static_cast<const int*>(layout) + kRings,
         sizeof(lay.size));
  lay.total = static_cast<const int*>(layout)[2 * kRings];
  return lay;
}

}  // namespace

// The schedule the kernel runs for a layout (49 host ints, the 24 ring
// offsets, the 24 sizes and the total), into 5 host ints: frames a block,
// the lag, frames an allpass chunk, floats a slot row and the rings kept in
// shared memory (2 all, 1 the allpasses, 0 none).  freeverb_kernel.py's
// schedule mirrors it; chip_smoke.py holds the two equal.
extern "C" int gst_freeverb_schedule(const void* layout, void* out) {
  const Schedule sc = schedule(read_layout(layout));
  const int v[5] = {sc.block, sc.lag, sc.chunk, sc.pitch, sc.shared};
  memcpy(out, v, sizeof(v));
  return 0;
}

// layout: as gst_freeverb_schedule's; shared: the caller's copy of the
// schedule's placement, which must equal the kernel's own (else
// cudaErrorInvalidValue, before any launch).  The caller checks
// streams >= 1, n >= 1, channels in {1, 2}, the shapes and that every
// tensor is contiguous on the card.
extern "C" int gst_freeverb(const void* x, void* out, void* rings, void* idx,
                            void* fs, int streams, int n, int channels,
                            const void* layout, int shared, float feedback,
                            float damp1, float damp2, float wet1, float wet2,
                            float dry, float gain, float dc, void* stream) {
  const Layout lay = read_layout(layout);
  const Schedule sc = schedule(lay);
  if (shared != sc.shared) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{feedback, damp1, damp2, wet1, wet2, dry, gain, dc};
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  float* rg = static_cast<float*>(rings);
  int* ix = static_cast<int*>(idx);
  float* f = static_cast<float*>(fs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return channels == 2
             ? launch_in<2>(xs, o, rg, ix, f, streams, n, lay, sc, p, st)
             : launch_in<1>(xs, o, rg, ix, f, streams, n, lay, sc, p, st);
}
