#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gstreamer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--batch N]

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel), holds each kernel against its plain PyTorch version on the card
at the main paths' shapes (bit for bit; the two-pass and the
horizontal-only scale kernels also at batch 64, at a width that is no
multiple of 16 and on views that start off a 16-byte boundary), times kernel, plain version, a library call or
yardstick and the byte/operation bound (the operations at the rate of the
unit that does them; a time under its bound fails the run), then drives the
port's main paths at full width, each with the launch counts zeroed just
before it and read just after:

1. the VideoConverter -- a batch of 1920x1080 I420 frames, made from the
   seed, to RGB 224x224 -- in four configurations:

  linear2      method=linear, 2 taps (videoscale's default): yscale kernel
               + 2-tap gather chroma
  cubic        the converter's default cubic: yscale kernel + chroma420
               kernel
  add_borders  linear/2 with the 16:9 -> 1:1 dest rect (dest-y=49,
               dest-height=126): phase-split path + rect embed, no kernel
  fused_ingest linear/2 with GTPU_PALLAS=1 set for this phase only: the
               fused-ingest kernel (unpack + chroma up2 + h-scale), then the
               plain v-scale; the same bytes as linear2

2. the two standalone scale ops, hscale_u8 and scale_hv_u8, called as a user
   would on the batch's luma plane (the package has no other caller);

3. launch strings through the port's parse_launch on CUDA, 1920x1080 I420
   frames pushed into appsrc as CUDA tensors and read from appsink:

  deint_chain                deinterlace method=linear ! videobalance
                             (BASELINE config 4 as bench_all.py drives it):
                             deint kernel, 3 launches per tick
  deint_rate_chain           deinterlace method=scalerbob ! videorate !
                             30/1 ! videobalance: deint kernel
  headline_launch            videoconvertscale ! RGB 224x224 (add-borders
                             route: no kernel)
  headline_launch_noborders  the same with add-borders=false: yscale kernel
  quickstart                 the README quick-start string at 1080p:
                             videotestsrc pattern=snow ! I420 1920x1080 !
                             videoconvertscale add-borders=false ! RGB
                             224x224 ! appsink (snow generated on the card)
  quickstart_fused           the same with GTPU_PALLAS=1: fused-ingest kernel

4. generic_routes: the converter's other routes at full width (GENERIC
   below): NV12 ingest with and without the fused-ingest kernel, an SD -> HD
   upscale, a same-size I420 -> BGRA, RGB -> I420 for an encoder, 10-bit
   P010 -> 8-bit RGB, RGB16 out with the default bayer dither and with a
   serial one (floyd-steinberg: the scale kernels still launch), gamma remap
   with a primaries change, interlaced scaling, and the launched
   videoconvertscale with element defaults over an NV12 videotestsrc.  The
   card's bytes must equal the numpy gold and the port's CPU path on the
   first 2 frames;

5. the switches: linear2 and cubic again at batch 64 under
   GTPU_PALLAS_YSCALE=0 and GTPU_PALLAS_CHROMA=0: the same bytes, and no
   launch of the kernel switched off;

6. the audio front-end (BASELINE config 2; no kernel of the port on its
   path, every launch count must stay 0), each with a rate line and its
   device idle share:

  asr_resample_f32  bench_all.py's config: AudioResampler("kaiser", 48000,
                    16000).resample_fn("f32", 131072, 2) over 128 seeded
                    chunks / 32768, channel mean after; per sample within 1
                    ULP of the port's CPU path and the float64 gold, also
                    with TF32 allowed process-wide
  asr_resample_s16  the same shape on the s16 path: bit for bit against the
                    CPU path and resample_ref
  asr_launch        appsrc (48 kHz stereo S16, 10 s a tick as CUDA tensors)
                    ! audioconvert ! mono ! audioresample ! 16 kHz !
                    audioconvert ! F32 ! appsink: bytes equal a numpy gold of
                    the chain on the first 2 ticks
  asr_quickstart    tests/test_audio.py's string with audiotestsrc (host
                    samples) at samplesperbuffer=48000
  volume_s16/_f32   volume volume=0.5, bit for bit against numpy.

7. N-to-1 aggregators through parse_launch, several appsrcs fed CUDA tensors
   (AGGREGATORS), each with an e2e line and its device idle share:

  compositor_4k     BASELINE config 3 as bench_all.py:90-132 builds it: four
                    1920x1080 I420 pads placed 2x2 into a 3840x2160 mosaic,
                    batch 32, 4 ticks; every quadrant must equal its input,
                    no kernel; its byte bound printed beside it
  compositor_wall   a monitoring wall: four 1080p I420 pads scaled to
                    960x540 by their own converters (4 yscale and 8 chroma420
                    launches a tick), OVER a checker in BGRA 1080p, one at
                    alpha 0.5 and a picture-in-picture at alpha 0.6 on top;
                    held to a numpy gold of the converters and the blend
  audiomixer_s16/_f32  two 48 kHz stereo inputs, 10 s a tick, one near full
                    scale: the int64 sum saturated / the float64 sum cast.

8. stateful and controlled elements (stateful_phase), each with an e2e line,
   its device idle share and peak memory:

  deint_<method>    BASELINE config 4 with each of the nine methods that have
                    no kernel (tomsmocomp, greedyh, greedyl, vfir,
                    linearblend, weave, weave-tff, weave-bff, yadif) at
                    1920x1080 I420, batch 64, 3 ticks: output frames per tick
                    (latency held back on the first), and the card's bytes
                    equal the port's CPU path over ticks of 2, 1 and 2 frames
  deint_chain_controlled  deint_chain with contrast and brightness keyframed
                    (a new value every tick): 3 deint launches a tick, each
                    tick equal to the plain deinterlace and videobalance's
                    float32 tables at that tick's values
  effectv_chain     bench_all.py:177-209's edgetv ! vertigotv scan at 640x480
                    RGB, batch 128, 3 ticks; it and each of the twelve effects
                    alone equal the port's CPU path over two ticks of 4 frames
  volume_controlled_s16/_f32  a volume ramp, 10 s of 48 kHz stereo a tick,
                    equal to the port's CPU path on every tick.

9. ingest from disk (ingest_phase; the files are written under a temporary
   directory and removed):

  ingest_y4m        bench_e2e.py's path: 96 seeded random 1080p I420 frames
                    in a y4m (about 300 MB) through filesrc !
                    videoconvertscale add-borders=false ! RGB 224x224 !
                    appsink at batch 16 and 64, prefetch off and on, three
                    passes with seek(0) between them: bytes equal the
                    port's VideoConverter on the frames read with numpy,
                    prefetch equal to no prefetch, duration and position
                    queries, the native reader and yscale_hv once a tick;
                    frames/s per pass, the H2D ceiling (pinned and pageable
                    probes around each pass) and its fraction, busy ms and
                    idle share, peak memory; then once under GTPU_PALLAS=1
                    (fused_i420_up_hscale once a tick, same bytes)
  ingest_jpeg       BASELINE config 5: 64 1080p 4:2:0 JPEGs at quality 85
                    (videotestsrc pattern=smpte plus seeded noise, written
                    by the port's jpegenc) and 8 each of 500x375 4:4:4 and
                    gray through multifilesrc ! jpegdec ! videoconvertscale
                    add-borders=false ! RGB 224x224: the card's planes equal
                    the port's CPU decode, the RGB the converter on them,
                    every scan decoded natively; frames/s, host entropy ms
                    and device IDCT ms an image against its byte bound
  ml_ingest         examples/ml_ingest_torch.py's train loop: a finite loss.

10. the common filters and fittings (fittings_phase, FITTINGS), each with
   an e2e line, its device idle share and peak memory:

  filters_tee       seeded 1080p I420 frames, batch 64, 4 ticks, through
                    videocrop top=60 bottom=60 ! videoflip method=clockwise
                    ! videomedian ! gamma ! tee into two RGB 224x224
                    branches (bilinear and catrom: the plan scales v before
                    h, the generic route, no kernel), a portrait RGB 112x224
                    branch (catrom: yscale once and chroma420 twice a tick
                    on the 960x1920 plane, each also held to its plain
                    version there) and a closed valve whose fakesink must
                    get nothing; run again under GTPU_TRACERS="stats;latency"
                    and GTPU_DEBUG_DUMP_DOT_DIR: the same bytes, a dot file,
                    every buffer counted
  selector_box      two 1080p I420 appsrcs, batch 32, 3 ticks, through
                    input-selector active-pad=sink_1 ! videobox left=-64
                    right=-64 ! alpha method=green ! AYUV: the active pad's
                    luma inside black borders.

11. overlays and the device video effects (overlays_phase, OVERLAY_PATHS),
   each with an e2e line, its device idle share and peak memory:

  burnin            seeded 1080p I420, batch 64, 3 ticks, through
                    timeoverlay ! qroverlay pixel-size=4 ! gdkpixbufoverlay
                    (a seeded PNG written by the port's PNG encoder) !
                    videoconvertscale method=catrom add-borders=false ! RGB
                    224x224: yscale once and chroma420 twice a tick; the
                    overlays are host elements, so the graph runs per
                    element
  camera_raw_rggb / _rggb16le  a seeded 1080p Bayer mosaic at 8 and 16
                    bits, batch 64, 3 ticks, through bayer2rgb !
                    videoconvertscale add-borders=false ! RGB 224x224 (the
                    generic route, no kernel); the 8-bit mosaic also through
                    bayer2rgb ! ARGB ! rgb2bayer, equal to itself
  augment           seeded 1080p I420, batch 32, 3 ticks, through
                    videoconvertscale ! AYUV ! rotate angle=0.3 !
                    gaussianblur sigma=1.2 ! coloreffects preset=sepia !
                    videoconvertscale method=catrom add-borders=false ! RGB
                    224x224 (no kernel)

   Each tick's first 2 frames equal the port's CPU path.  Then each of the
   27 effect and 13 overlay factories alone (OVL_FACTORIES) over two ticks
   of 4 1080p frames (texts, a PNG and an SVG for the renderers and
   decoders): the card's samples equal the CPU path's, no kernel launched.

12. the audio DSP family (dsp_phase, DSP_PATHS): freeverb's and the VAD's
   kernels (two per-sample recursions; the JAX package ran each as a jitted
   lax.scan) against their plain versions bit for bit (freeverb at 1 Hz to
   768 kHz, mono and stereo, two pushes with the state carried, every
   block schedule the layout derives, every ring in shared memory to 48
   kHz, the allpasses to 384 kHz, none at 768 kHz; the main path's push in
   one launch against 100 launches and on its first frames against the plain
   version; the VAD from six carried powers, 2^62 among them, at four
   lengths), timed beside their roofline and latency bounds and the
   previous kernels' times, then:

  music_master      a mastering chain before encoding: 48 kHz stereo F32,
                    3 pushes of 10 s, through equalizer-10bands !
                    audiodynamic ! freeverb ! audiopanorama ! rgvolume !
                    rglimiter ! spectrum ! level: freeverb once a push
  voice_chain       a call-centre or ASR ingest: 48 kHz mono S16, 250
                    pushes of 20 ms (1 s of speech-band tones, 1 s near
                    silence in turns), through removesilence remove=true
                    squash=true ! audioamplify ! audiowsincband ! 8 kHz !
                    mulawenc ! mulawdec: the VAD once a push

   each with frames/s, busy ms, idle share, top device items and peak
   memory, and again on short pushes on the card and the CPU (samples and
   bus messages equal); then each of the 31 factories alone over two
   pushes, the card equal to the CPU.

Outputs are checked against the port's own CPU path (first frames), the
converter's numpy gold and videobalance's float64 tables.  Any failure
raises.  The last line of standard output is one JSON object {"ok": true,
"device": ...}; the line before it holds the kernels' JSON, and the line
before that the card's name and power limit.  Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# H100 SXM int32: 64 of an SM's 128 lanes per clock take int32 (half the
# 67e12 non-tensor fp32 rate), a multiply-add counted as 2 operations
INT32_OPS_PER_S = 33.5e12
# dp4a: one int32-lane instruction makes four 8-bit products and adds them,
# so the same lanes do four times the operations.  The two-pass scale
# kernels run every product there, an S16 tap as two 8-bit limbs: 2
# multiply-adds, 4 operations, per tap and sample.
DP4A_OPS_PER_S = 4 * INT32_OPS_PER_S
W, H, OW, OH = 1920, 1080, 224, 224
CONFIGS = {
    "linear2": {"resampler-method": "linear", "resampler-taps": 2},
    "cubic": None,
    "add_borders": {"resampler-method": "linear", "resampler-taps": 2,
                    "dest-x": 0, "dest-y": 49, "dest-width": 224,
                    "dest-height": 126},
    # linear2's plan; convert() runs under opt_in() (FUSED_CONFIGS)
    "fused_ingest": {"resampler-method": "linear", "resampler-taps": 2},
}
FUSED_CONFIGS = ("fused_ingest",)
SMALL = (3, 46, 70, 20, 33)     # B, H, W, OH, OW: an awkward small shape


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


@contextlib.contextmanager
def switches(**env):
    """The converter's GTPU_PALLAS* switches set inside the block only (a
    value of None unsets one); they are read at every convert()."""
    old = {k: os.environ.pop(k, None) for k in env}
    os.environ.update({k: v for k, v in env.items() if v is not None})
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def opt_in(on: bool = True):
    """GTPU_PALLAS=1 (the converter's fused-ingest route) inside the block
    only."""
    return switches(GTPU_PALLAS="1" if on else None)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device ms a call of fn: `iters` calls captured in one CUDA graph and
    replayed, so no host time falls between the launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def touched(res, limit: int) -> int:
    """Distinct source samples a resampler's taps read."""
    import numpy as np
    idx = res.offset[:, None] + np.arange(res.max_taps)[None, :]
    return int(np.unique(np.clip(idx, 0, limit - 1)).size)


def bound(bytes_moved: float, ops: float, dp4a_ops: float = 0.0):
    """(ms, "bytes" or "operations", unit): the larger of the bytes over the
    card's memory rate and the operations over the peak rate of the unit
    that does them: `ops` on the int32 lanes, `dp4a_ops` at dp4a's rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / INT32_OPS_PER_S + dp4a_ops / DP4A_OPS_PER_S) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s"
    unit = (f"dp4a {DP4A_OPS_PER_S / 1e12:.0f} T 8-bit ops/s" if dp4a_ops
            else f"int32 {INT32_OPS_PER_S / 1e12:.1f} T ops/s")
    return t_ops, "operations", unit


def two_pass_ops(b, rows, h_res, v_res):
    """dp4a operations of a two-pass scale: 4 per tap and sample (two 8-bit
    limb multiply-adds), over the `rows` source rows the vertical taps read
    and over every output."""
    return 4.0 * b * (rows * h_res.out_size * h_res.max_taps
                      + v_res.out_size * h_res.out_size * v_res.max_taps)


def dense_pair(x_f32, h_res, v_res):
    """The library yardstick: two dense fp32 tap-matrix products (no TF32)."""
    import torch
    from gstreamer_tpu_torch.video.scaler import tap_matrix
    mh = torch.as_tensor(tap_matrix(h_res).T.astype("float32"),
                         device=x_f32.device)
    mv = torch.as_tensor(tap_matrix(v_res).astype("float32"),
                         device=x_f32.device)
    return lambda: torch.matmul(mv, torch.matmul(x_f32, mh))


def dense_h(x_f32, h_res):
    """The library yardstick of an h-only scale: one dense fp32 product."""
    import torch
    from gstreamer_tpu_torch.video.scaler import tap_matrix
    mh = torch.as_tensor(tap_matrix(h_res).T.astype("float32"),
                         device=x_f32.device)
    return lambda: torch.matmul(x_f32, mh)


# -- the h-only, int32 and fused-ingest kernels: kernel vs plain, timings -----

def max_err(ks, ps, what):
    """Largest difference between a kernel's outputs and its plain
    version's; dtypes and shapes must agree."""
    err = 0
    for k, p in zip(ks, ps):
        require(k.dtype == p.dtype and k.shape == p.shape,
                f"{what}: kernel gives {k.dtype} {tuple(k.shape)}, plain "
                f"{p.dtype} {tuple(p.shape)}")
        err = max(err, int((k.int() - p.int()).abs().max()))
    return err


ODD_WIDTH = (2, 270, 484, 112, 112)   # B, H, W, OH, OW: W % 16 == 4
SKEWED = 2                            # 1080p frames of the misaligned view


def check_two_pass(planes, plans, rng):
    """yscale_hv, scale_hv_u8 and chroma420_scale (all four sitings)
    against their plain versions, bit for bit, where the staging differs:
    the launch paths' batch of 64 at the main path's shape (bulk copies),
    a width that is no multiple of 16, the awkward small shape on a view
    that starts off a 16-byte boundary, and full-width frames on a view
    that starts one byte in (word-by-word staging).  Returns {kernel:
    largest difference (0)}."""
    import torch
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    from gstreamer_tpu_torch.video.scaler import make_resampler
    dev = planes[0].device

    def view(n, h, w, skip):
        """(n, h, w) random bytes starting `skip` bytes into a tensor."""
        flat = torch.as_tensor(rng.integers(0, 256, skip + n * h * w + 16,
                                            dtype="uint8")).to(dev)
        return flat[skip:skip + n * h * w].view(n, h, w)

    cases = [(planes[0][:DEINT_BATCH], planes[1][:DEINT_BATCH], p["h_res"],
              p["v_res"]) for p in plans]
    ob, oh_, ow_, ooh, oow = ODD_WIDTH
    cases.append((view(ob, oh_, ow_, 0), view(ob, oh_ // 2, ow_ // 2, 0),
                  make_resampler("linear", ow_, oow, 0, max_taps_opt=2),
                  make_resampler("linear", oh_, ooh, 0, max_taps_opt=2)))
    sb, sh, sw, soh, sow = SMALL
    cases.append((view(sb, sh, sw, sh * sw), view(sb, sh // 2, sw // 2,
                                                  (sh // 2) * (sw // 2)),
                  make_resampler("lanczos", sw, sow),
                  make_resampler("lanczos", sh, soh)))
    cases.append((view(SKEWED, H, W, 1), view(SKEWED, H // 2, W // 2, 1),
                  plans[1]["h_res"], plans[1]["v_res"]))
    err = {"yscale_hv": 0, "scale_hv_u8": 0, "chroma420_scale": 0}
    for y, c, hr, vr in cases:
        w, h = hr.in_size, vr.in_size
        err["yscale_hv"] = max(err["yscale_hv"], max_err(
            [ysk.yscale_hv(y, hr, vr)], [ysk.yscale_hv_plain(y, hr, vr)],
            "yscale_hv"))
        err["scale_hv_u8"] = max(err["scale_hv_u8"], max_err(
            [s2k.scale_hv_u8(y, hr, vr)], [s2k.scale_hv_u8_plain(y, hr, vr)],
            "scale_hv_u8"))
        for h_cos in (False, True):
            for v_cos in (False, True):
                err["chroma420_scale"] = max(err["chroma420_scale"], max_err(
                    [ck.chroma420_scale(c, hr, vr, h_cos, v_cos, w, h)],
                    [ck.chroma420_scale_plain(c, hr, vr, h_cos, v_cos)],
                    "chroma420_scale"))
        torch.cuda.synchronize()
    for kname, e in err.items():
        require(e == 0, f"{kname}: kernel differs from its plain version "
                f"by up to {e}")
    return err


def check_new_kernels(planes, plans, rng):
    """hscale_u8, scale_hv_u8 and fused_i420_up_hscale against their plain
    versions, bit for bit, at the main path's shape under both plans
    (linear/2 and cubic taps) and at one awkward small shape (lanczos; a
    view that starts off a 16-byte boundary included).  Returns
    {kernel: largest difference (0)}."""
    import torch
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    from gstreamer_tpu_torch.video.scaler import make_resampler
    sb, sh, sw, soh, sow = SMALL
    small = tuple(torch.as_tensor(rng.integers(0, 256, shp, dtype="uint8")
                                  ).to(planes[0].device)[1:]
                  for shp in ((sb + 1, sh, sw), (sb + 1, sh // 2, sw // 2),
                              (sb + 1, sh // 2, sw // 2)))
    cases = [(planes, p["h_res"], p["v_res"]) for p in plans]
    cases.append((small, make_resampler("lanczos", sw, sow),
                  make_resampler("lanczos", sh, soh)))
    err = {"hscale_u8": 0, "scale_hv_u8": 0, "fused_i420_up_hscale": 0}
    for (y, u, v), hr, vr in cases:
        err["hscale_u8"] = max(err["hscale_u8"], max_err(
            [hk.hscale_u8(y, hr)], [hk.hscale_u8_plain(y, hr)], "hscale_u8"))
        err["scale_hv_u8"] = max(err["scale_hv_u8"], max_err(
            [s2k.scale_hv_u8(y, hr, vr)], [s2k.scale_hv_u8_plain(y, hr, vr)],
            "scale_hv_u8"))
        for cosited in (False, True):
            err["fused_i420_up_hscale"] = max(
                err["fused_i420_up_hscale"], max_err(
                    fk.fused_i420_up_hscale(y, u, v, hr, cosited),
                    fk.fused_i420_up_hscale_plain(y, u, v, hr, cosited),
                    "fused_i420_up_hscale"))
        torch.cuda.synchronize()
    for kname, e in err.items():
        require(e == 0, f"{kname}: kernel differs from its plain version "
                f"by up to {e}")
    return err


def check_h_only(planes, plans, rng):
    """hscale_u8 and fused_i420_up_hscale (both sitings) against their plain
    versions, bit for bit, where the staging or the partition into blocks
    differs from the batch's: the launch paths' batch of 64 at the main
    path's shape under both plans (bulk copies, shorter runs), a width that
    is no multiple of 16, the awkward small shape (23 chroma rows, lanczos)
    on a view that starts off a 16-byte boundary, and full-width frames on
    a view that starts one byte in (word-by-word staging).  Returns
    {kernel: largest difference (0)}."""
    import torch
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.video.scaler import make_resampler
    dev = planes[0].device

    def i420(n, h, w, skip):
        """(y, u, v) of random bytes, each starting `skip` bytes into a
        tensor."""
        out = []
        for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
            flat = torch.as_tensor(rng.integers(
                0, 256, skip + n * hh * ww + 16, dtype="uint8")).to(dev)
            out.append(flat[skip:skip + n * hh * ww].view(n, hh, ww))
        return tuple(out)

    cases = [(tuple(p[:DEINT_BATCH] for p in planes), plan["h_res"])
             for plan in plans]
    ob, oh_, ow_, _, oow = ODD_WIDTH
    cases.append((i420(ob, oh_, ow_, 0),
                  make_resampler("linear", ow_, oow, 0, max_taps_opt=2)))
    sb, sh, sw, _, sow = SMALL
    cases.append((i420(sb, sh, sw, 3), make_resampler("lanczos", sw, sow)))
    cases += [(i420(SKEWED, H, W, 1), plan["h_res"]) for plan in plans]
    err = {"hscale_u8": 0, "fused_i420_up_hscale": 0}
    for (y, u, v), hr in cases:
        err["hscale_u8"] = max(err["hscale_u8"], max_err(
            [hk.hscale_u8(y, hr)], [hk.hscale_u8_plain(y, hr)], "hscale_u8"))
        for cosited in (False, True):
            err["fused_i420_up_hscale"] = max(
                err["fused_i420_up_hscale"], max_err(
                    fk.fused_i420_up_hscale(y, u, v, hr, cosited),
                    fk.fused_i420_up_hscale_plain(y, u, v, hr, cosited),
                    "fused_i420_up_hscale"))
        torch.cuda.synchronize()
    for kname, e in err.items():
        require(e == 0, f"{kname}: kernel differs from its plain version "
                f"by up to {e}")
    return err


def time_new_kernels(planes, plans):
    """{(kernel, tag): times and bound} at the batch's shape.  Bytes: each
    input read once, each output written once (scale_hv_u8: the rows its
    vertical taps read, as for yscale_hv).  Operations: every product runs
    on dp4a, 4 operations per tap and sample at that rate (scale_hv_u8:
    two_pass_ops), plus the up2 filters of the fused kernel (about 4 per
    sample they produce, on packed words, four samples to an int32 lane)."""
    import torch
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    y, u, v = planes
    b = y.shape[0]
    y_f32 = y.float()
    up_f32 = torch.repeat_interleave(torch.repeat_interleave(u, 2, -1),
                                     2, -2).float()
    out = {}
    for tag, plan in plans.items():
        hr, vr = plan["h_res"], plan["v_res"]
        th, tv = hr.max_taps, vr.max_taps
        cos = plan["up_h_cosited"]
        lib_h = dense_h(y_f32, hr)
        lib_c = dense_h(up_f32, hr)
        out[("hscale_u8", tag)] = dict(
            ms=cuda_ms(lambda: hk.hscale_u8(y, hr), 20),
            plain_ms=cuda_ms(lambda: hk.hscale_u8_plain(y, hr), 3, 1),
            library_ms=cuda_ms(lib_h, 5, 1), library="1 dense fp32 matmul",
            bound=bound(b * H * W + b * H * OW * 4, 0.0,
                        4.0 * b * H * OW * th),
            taps=(th,))
        rows = touched(vr, H)
        out[("scale_hv_u8", tag)] = dict(
            ms=cuda_ms(lambda: s2k.scale_hv_u8(y, hr, vr), 20),
            plain_ms=cuda_ms(lambda: s2k.scale_hv_u8_plain(y, hr, vr), 3, 1),
            library_ms=cuda_ms(dense_pair(y_f32, hr, vr), 5, 1),
            library="2 dense fp32 matmuls",
            bound=bound(b * rows * W + b * OH * OW * 4, 0.0,
                        two_pass_ops(b, rows, hr, vr)),
            taps=(th, tv))
        out[("fused_i420_up_hscale", tag)] = dict(
            ms=cuda_ms(lambda: fk.fused_i420_up_hscale(y, u, v, hr, cos), 20),
            plain_ms=cuda_ms(
                lambda: fk.fused_i420_up_hscale_plain(y, u, v, hr, cos),
                3, 1),
            library_ms=None,
            # no single call computes it; three dense h products (Y and two
            # nearest-upsampled chroma planes) move comparable data
            yardstick_ms=cuda_ms(lambda: (lib_h(), lib_c(), lib_c()), 5, 1),
            bound=bound(b * H * W * 3 // 2 + b * 3 * H * OW * 2, 0.0,
                        4.0 * b * 3 * H * OW * th
                        + b * 2 * 4.0 * (W * H // 2 + W * H)),
            taps=(th,))
    return out


def standalone_ops(planes, host, plan):
    """The two standalone scale ops as a user calls them, at full width on
    the batch's luma plane; outputs checked for shape and type, and against
    the port's CPU path on the first frames."""
    import torch
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    hr, vr = plan["h_res"], plan["v_res"]
    y = planes[0]
    require(hk.applicable(hr, y.shape) and s2k.applicable(hr, vr, y.shape),
            "standalone ops: the headline shape fails their own gates")
    out_h = hk.hscale_u8(y, hr)
    out_hv = s2k.scale_hv_u8(y, hr, vr)
    torch.cuda.synchronize()
    b = y.shape[0]
    require(out_h.dtype == out_hv.dtype == torch.int32
            and tuple(out_h.shape) == (b, H, OW)
            and tuple(out_hv.shape) == (b, OH, OW),
            "standalone ops: bad output")
    cpu = torch.as_tensor(host[0][:CPU_FRAMES])
    require(torch.equal(out_h[:CPU_FRAMES].cpu(), hk.hscale_u8(cpu, hr))
            and torch.equal(out_hv[:CPU_FRAMES].cpu(),
                            s2k.scale_hv_u8(cpu, hr, vr)),
            "standalone ops: CUDA output differs from the port's CPU path")
    require(int(out_h.min()) >= 0 and int(out_h.max()) <= 255
            and int(out_hv.min()) >= 0 and int(out_hv.max()) <= 255,
            "standalone ops: output outside 0..255")


# -- deinterlace: kernel vs plain, timings ----------------------------------

DEINT_BATCH = 64                # bench_all.py's batch per tick at 1080i
DEINT_ODD = (3, 45, 301)        # odd height and width: the byte path


def check_deint(planes, rng):
    """deint_both_parities against its plain version, bit for bit, at the
    chain's Y and U/V shapes and one odd shape, both methods, both
    parities.  Returns the largest difference (0)."""
    import torch
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    odd = torch.as_tensor(rng.integers(0, 256, DEINT_ODD, dtype="uint8")
                          ).to(planes[0].device)
    err = 0
    for plane in (planes[0][:DEINT_BATCH], planes[1][:DEINT_BATCH], odd):
        for method in dk.METHODS:
            for parity0 in (0, 1):
                k = dk.deint_both_parities(plane, method, parity0)
                p = dk.deint_both_parities_plain(plane, method, parity0)
                torch.cuda.synchronize()
                require(k.dtype == torch.uint8 and k.shape == p.shape,
                        f"deint {tuple(plane.shape)}: bad output")
                err = max(err, int((k.int() - p.int()).abs().max()))
    require(err == 0, f"deint_both_parities: kernel differs from its plain "
            f"version by up to {err}")
    return err


def time_deint(planes):
    """Per tick of the chain (Y + U + V at batch 64, method linear): the
    kernel, the plain version, the byte bound and a copy_ yardstick that
    moves the same bytes (one read, two writes; the port never calls
    it)."""
    import torch
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    t = dict(ms=0.0, plain_ms=0.0, copy_ms=0.0, bytes=0, ops=0)
    for i, reps in ((0, 1), (1, 2)):                # Y once, U and V alike
        plane = planes[i][:DEINT_BATCH]
        nf, h, w = plane.shape
        dst = torch.empty((nf, 2, h, w), dtype=torch.uint8,
                          device=plane.device)
        both = plane.unsqueeze(1).expand(nf, 2, h, w)
        t["ms"] += reps * cuda_ms(
            lambda: dk.deint_both_parities(plane, "linear", 0), 20)
        t["plain_ms"] += reps * cuda_ms(
            lambda: dk.deint_both_parities_plain(plane, "linear", 0), 3, 1)
        t["copy_ms"] += reps * cuda_ms(lambda: dst.copy_(both), 20)
        t["bytes"] += reps * 3 * plane.numel()
        t["ops"] += reps * 3 * plane.numel()       # (a + b + 1) >> 1
        del dst
    t["bound"] = bound(t["bytes"], t["ops"])
    return t


# -- launch strings through parse_launch -------------------------------------

SRC = ("appsrc name=in caps=video/x-raw,format=I420,width={w},height={h},"
       "framerate=30/1 ! ")
# the README quick-start string, with the source pinned to 1080p I420 and n
# frames (videotestsrc has no appsrc to feed: it makes its frames on the card)
QUICKSTART = ("videotestsrc pattern=snow num-buffers={n} ! video/x-raw,"
              "format=I420,width={w},height={h},framerate=30/1 ! "
              "videoconvertscale add-borders=false ! video/x-raw,format=RGB,"
              "width=224,height=224 ! appsink name=out")
LAUNCH = {       # name: (launch string, batch, ticks, GTPU_PALLAS=1)
    "deint_chain": (SRC + "deinterlace method=linear ! videobalance "
                    "contrast=1.1 brightness=0.05 ! appsink name=out",
                    DEINT_BATCH, 3, False),
    "deint_rate_chain": (SRC + "deinterlace method=scalerbob ! videorate ! "
                         "video/x-raw,framerate=30/1 ! videobalance "
                         "saturation=1.2 ! appsink name=out", 16, 2, False),
    "headline_launch": (SRC + "videoconvertscale ! video/x-raw,format=RGB,"
                        "width=224,height=224 ! appsink name=out", 64, 3,
                        False),
    "headline_launch_noborders": (
        SRC + "videoconvertscale add-borders=false ! video/x-raw,format=RGB,"
        "width=224,height=224 ! appsink name=out", 64, 3, False),
    "quickstart": (QUICKSTART, 64, 3, False),
    "quickstart_fused": (QUICKSTART, 64, 3, True),
}
DUR = 33333333                  # ns per input frame at 30/1
CPU_FRAMES = 2                  # input frames the CPU reference runs


def drive(desc, batch, ticks, planes, device=None):
    """Push `ticks` buffers of `planes` (the same frames each tick) into
    appsrc, where the string has one (a videotestsrc makes batch * ticks
    frames itself), and tick the pipeline to EOS, each tick timed on the
    host clock between two synchronises.  Returns (pipeline, first sample,
    output frames per tick, seconds per tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    cuda = device is None
    pipe = parse_launch(desc.format(w=W, h=H, n=batch * ticks), batch=batch,
                        device=device)
    src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
    if src is not None:
        for t in range(ticks):
            src.push_buffer(Buffer(data=planes, pts=t * batch * DUR,
                                   duration=DUR, batch=batch))
        src.end_of_stream()
    pipe.set_state(State.PLAYING)
    first, frames, secs = None, [], []
    while True:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = pipe.tick()
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not more:
            break
        n = 0
        while (s := sink.pull_sample()) is not None:
            if first is None:
                first = s
            n += s.buffer.batch
        frames.append(n)
        secs.append(dt)
    pipe.set_state(State.NULL)
    return pipe, first, frames, secs


def balance_gold(pipe, deinterlaced):
    """videobalance's float64 tables looked up on the host."""
    import numpy as np
    bal = next(e for e in pipe.iterate_elements()
               if e.FACTORY == "videobalance")
    ty, tu, tv = bal._tables()
    y, u, v = (np.asarray(p, np.int64) for p in deinterlaced)
    return ty[y], tu[u, v], tv[u, v]


def launch_paths(planes, host, counters, table=None):
    """Drive every launch path on the card with the counts zeroed just
    before it and read just after; check its outputs against the same
    launch string run by the port on the CPU over the first input frames,
    and the deint chain against the plain deinterlace and videobalance's
    float64 tables.  Returns {name: dict of counts, frames/s, ...}."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    res = {}
    for name, (desc, batch, ticks, fused) in (table or LAUNCH).items():
        ins = tuple(p[:batch] for p in planes)
        with opt_in(fused):
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            pipe, first, frames, secs = drive(desc, batch, ticks, ins)
            counts = {k: c.launches for k, c in counters.items()}
            peak = torch.cuda.max_memory_allocated()
            require(len(frames) == ticks and all(frames),
                    f"{name}: {frames} output frames per tick")
            _, ref, _, _ = drive(desc, CPU_FRAMES, 1,
                                 tuple(p[:CPU_FRAMES] for p in host), "cpu")
        n = ref.buffer.batch
        require(first.buffer.pts == ref.buffer.pts
                and str(first.caps) == str(ref.caps),
                f"{name}: first sample's pts/caps differ from the CPU run")
        for o, r in zip(first.buffer.data, ref.buffer.data):
            require(o.device.type == "cuda", f"{name}: output on {o.device}")
            require(torch.equal(o[:n].cpu(), r),
                    f"{name}: CUDA output differs from the port's CPU path")
        if name == "deint_chain":
            fields = tuple(dk.deint_both_parities_plain(
                torch.as_tensor(p[:CPU_FRAMES]), "linear", 0).flatten(0, 1)
                for p in host)
            for o, g in zip(first.buffer.data, balance_gold(pipe, fields)):
                require(np.array_equal(
                    o[:2 * CPU_FRAMES].cpu().numpy().astype(np.int64), g),
                    "deint_chain: output differs from deint plain + "
                    "videobalance float64 tables")
            require(counts["deint_both_parities"] == 3 * ticks,
                    f"deint_chain: {counts} launches, want 3 deint per tick")
        elif name == "deint_rate_chain":
            require(counts["deint_both_parities"] >= 1,
                    f"deint_rate_chain: deint kernel not launched {counts}")
        elif name in ("headline_launch_noborders", "quickstart"):
            require(counts["yscale_hv"] >= 1
                    and counts["fused_i420_up_hscale"] == 0,
                    f"{name}: want the yscale kernel and no fused-ingest "
                    f"launch, got {counts}")
        elif name == "launch_small_default":
            require(not any(counts.values()) and pipe._fused,
                    f"{name}: want the phase-split route in one fused "
                    f"program and no kernel, got {counts}")
        elif name == "quickstart_fused":
            require(counts["fused_i420_up_hscale"] == ticks
                    and counts["yscale_hv"] == 0,
                    f"{name}: want one fused-ingest launch per tick and no "
                    f"yscale launch, got {counts}")
        timed_f, timed_s = sum(frames[1:]), sum(secs[1:])
        res[name] = dict(counts=counts, batch=batch, ticks=ticks,
                         frames=frames, secs=secs, fused=pipe._fused,
                         fps=timed_f / timed_s, ref_frames=n, peak=peak)
        del first
        print(f"path {name}: batch {batch}, {ticks} ticks, "
              f"{'fused' if pipe._fused else 'per-element'}; launches "
              f"{counts}; output frames per tick {frames}; peak device "
              f"memory {peak / 2**30:.2f} GiB; CUDA == port CPU ({n} "
              f"frames)")
    return res


# -- the converter's other routes, at full width --------------------------------

BT709 = ("16-235", "bt709", "bt709", "bt709")
LINEAR2 = {"resampler-method": "linear", "resampler-taps": 2}
# name: input (format, size, VideoInfo arguments), output, batch, config,
# whether GTPU_PALLAS=1 is set, and the plan entries the route must show
GENERIC = {
    "nv12_ingest": dict(
        src=("NV12", (W, H), {}), dst=("RGB", (OW, OH), {}), batch=256,
        cfg=LINEAR2, want={"scale_order": "hv", "scale_before_matrix": True},
        launches={}),
    "nv12_fused": dict(
        src=("NV12", (W, H), {}), dst=("RGB", (OW, OH), {}), batch=256,
        cfg=LINEAR2, fused=True, want={"pallas_ok": True},
        launches={"fused_i420_up_hscale": 1}),
    "upscale": dict(
        src=("I420", (640, 360), {}), dst=("RGB", (W, H), {}), batch=32,
        cfg=None, want={"scale_before_matrix": False, "upsample": True},
        launches={}),
    "same_size": dict(
        src=("I420", (W, H), {}), dst=("BGRA", (W, H), {}), batch=32,
        cfg=None, want={"h_res": None, "v_res": None, "upsample": True},
        launches={}),
    "encode_side": dict(
        src=("RGB", (W, H), {}), dst=("I420", (1280, 720), {}), batch=32,
        cfg=None, want={"scale_before_matrix": True, "upsample": False,
                        "downsample": True}, launches={}),
    "hdr_ingest": dict(
        src=("P010_10LE", (W, H), {}), dst=("RGB", (OW, OH), {}), batch=64,
        cfg=LINEAR2, want={"unpack_bits": 16, "pack_bits": 8, "dither": None},
        launches={}),
    "rgb16_out": dict(
        src=("I420", (W, H), {}), dst=("RGB16", (640, 360), {}), batch=32,
        cfg=None, want={"pack_bits": 8},
        launches={"yscale_hv": 1, "chroma420_scale": 2}),
    # a serial dither: only the planes at the dither step visit the host, so
    # the route's kernels launch as they do for rgb16_out (timed once: the
    # dither is a Python loop over pixels)
    "rgb16_serial": dict(
        src=("I420", (W, H), {}), dst=("RGB16", (640, 360), {}),
        batch=CPU_FRAMES, cfg={"dither-method": "floyd-steinberg"},
        want={"pack_bits": 8}, timing=(1, 0),
        launches={"yscale_hv": 1, "chroma420_scale": 2}),
    "gamma_remap": dict(
        src=("I420", (W, H), {"colorimetry": BT709}),
        dst=("RGB", (640, 360),
             {"colorimetry": ("0-255", "rgb", "srgb", "bt2020")}),
        batch=16, cfg={"gamma-mode": "remap", "primaries-mode": "fast"},
        want={"do_gamma": True}, launches={}),
    "interlaced": dict(
        src=("I420", (W, H), {"interlace_mode": "interleaved"}),
        dst=("I420", (1280, 720), {"interlace_mode": "interleaved"}),
        batch=16, cfg=None, want={"interlaced": True, "downsample": True},
        launches={}),
}
GENERIC_LAUNCH = {
    "launch_small_default": (
        "videotestsrc num-buffers={n} ! video/x-raw,format=NV12,width={w},"
        "height={h},framerate=30/1 ! videoconvertscale ! video/x-raw,"
        "format=RGB,width=224,height=224 ! appsink name=out", 64, 3, False),
}


def generic_converter(name, device=None):
    from gstreamer_tpu_torch import VideoConverter, VideoInfo
    from gstreamer_tpu_torch.video.info import Colorimetry
    g = GENERIC[name]

    def info(fmt, size, kw):
        kw = dict(kw)
        if "colorimetry" in kw:
            kw["colorimetry"] = Colorimetry(*kw["colorimetry"])
        return VideoInfo(format=fmt, width=size[0], height=size[1], **kw)
    return VideoConverter(info(*g["src"]), info(*g["dst"]), g["cfg"],
                          device=device)


def generic_inputs(name, host, batch):
    """Host planes of `batch` input frames of a GENERIC configuration, cut
    from the seeded 1080p I420 batch `host`: NV12's component planes are
    I420's; a smaller I420 frame is the top-left corner; RGB takes three
    runs of luma frames; P010 builds 10-bit samples from two frames' bytes,
    left-justified in their 16-bit words."""
    import numpy as np
    fmt, (w, h), _ = GENERIC[name]["src"]
    y, u, v = host
    if fmt in ("I420", "NV12"):
        cw, ch = (w + 1) // 2, (h + 1) // 2
        out = (y[:batch, :h, :w], u[:batch, :ch, :cw], v[:batch, :ch, :cw])
    elif fmt == "RGB":
        out = tuple(y[i * batch:(i + 1) * batch] for i in range(3))
    elif fmt == "P010_10LE":
        out = tuple(((p[:batch].astype(np.uint16) << 2
                      | (p[batch:2 * batch] & 3)) << 6) for p in host)
    else:
        raise ValueError(fmt)
    require(all(len(p) == batch for p in out),
            f"{name}: the seeded batch is too small for {batch} frames")
    return tuple(np.ascontiguousarray(p) for p in out)


def generic_routes(host, counters):
    """Drive every GENERIC configuration on the card through
    VideoConverter.convert, with the launch counts zeroed just before and
    read just after; require the route the plan must take, the launches it
    must make, and the card's bytes equal to the numpy gold and to the
    port's CPU path on the first frames; then time it.  A batch that does
    not fit the card's memory is halved, and the printed line says so.
    Returns {name: launch counts}."""
    import numpy as np
    import torch
    res, outs = {}, {}
    for name, g in GENERIC.items():
        conv = generic_converter(name)
        for key, val in g["want"].items():
            require(conv.plan[key] == val if val is not None
                    else conv.plan[key] is None,
                    f"{name}: plan[{key!r}] is {conv.plan[key]!r}")
        batch, note = g["batch"], ""
        while True:
            ins = generic_inputs(name, host, batch)
            dev = tuple(torch.as_tensor(p).to(conv.device) for p in ins)
            try:
                with opt_in(g.get("fused", False)):
                    for c in counters.values():
                        c.launches = 0
                    out = conv.convert(dev)
                    torch.cuda.synchronize()
                    counts = {k: c.launches for k, c in counters.items()
                              if c.launches}
                    ms = cuda_ms(lambda: conv.convert(dev),
                                 *g.get("timing", (3, 1)))
                break
            except torch.cuda.OutOfMemoryError:
                require(batch > CPU_FRAMES, f"{name}: out of device memory "
                        f"at batch {batch}")
                del dev
                torch.cuda.empty_cache()
                batch //= 2
                note = f" (batch halved from {g['batch']}: out of memory)"
        require(counts == g["launches"],
                f"{name}: launches {counts}, want {g['launches']}")
        first = tuple(p[:CPU_FRAMES] for p in ins)
        with opt_in(g.get("fused", False)):
            cpu = generic_converter(name, "cpu").convert(first)
        gold = conv.convert_ref(first)
        shapes = conv.out_info.plane_shapes()
        want = torch.uint16 if conv.out_info.finfo.bits == 16 else torch.uint8
        require(len(out) == len(shapes), f"{name}: {len(out)} planes")
        for o, c, gd, shape in zip(out, cpu, gold, shapes):
            require(o.device.type == "cuda" and o.dtype == want
                    and tuple(o.shape) == (batch,) + shape,
                    f"{name}: bad output {o.dtype} {tuple(o.shape)}")
            require(torch.equal(o[:CPU_FRAMES].cpu(), c),
                    f"{name}: CUDA output differs from the port's CPU path")
            require(np.array_equal(o[:CPU_FRAMES].cpu().numpy(), gd),
                    f"{name}: CUDA output differs from the numpy gold")
        if name == "same_size":
            require(int(out[3].min()) == 255, "same_size: alpha not opaque")
        if name == "rgb16_out":
            require(conv.plan["dither"].method == "bayer"
                    and all(int(o.max()) <= m
                            for o, m in zip(out, (31, 63, 31))),
                    "rgb16_out: not dithered and stored at 5/6/5 bits")
        if name == "rgb16_serial":
            require(conv.plan["dither"].method == "floyd-steinberg"
                    and any(not torch.equal(o, b[:batch]) for o, b
                            in zip(outs["rgb16_out"], out)),
                    "rgb16_serial: the bytes of the bayer dither")
        outs[name] = tuple(o[:CPU_FRAMES].clone() for o in out)
        res[name] = counts
        print(f"generic {name}: {g['src'][0]} {g['src'][1]} -> {g['dst'][0]} "
              f"{g['dst'][1]}, launches {counts}; CUDA == port CPU path == "
              f"numpy gold ({CPU_FRAMES} frames)")
        print(f"e2e {name}: {ms:.3f} ms per batch of {batch}{note}, "
              f"{batch / ms * 1e3:.1f} frames/s")
        del out, dev
        torch.cuda.empty_cache()
    for a, b in zip(outs["nv12_fused"], outs["nv12_ingest"]):
        require(torch.equal(a, b),
                "nv12_fused: output differs from nv12_ingest's bytes")
    return res


def switched_off(convs, planes, counters):
    """linear2 and cubic at the launch paths' batch under
    GTPU_PALLAS_YSCALE=0 and under GTPU_PALLAS_CHROMA=0: the bytes of the
    run with no switch set, and no launch of the kernel switched off.
    Returns the launch counts summed over the runs."""
    import torch
    ins = tuple(p[:DEINT_BATCH] for p in planes)
    total = {k: 0 for k in counters}
    for cfg in ("linear2", "cubic"):
        base = convs[cfg].convert(ins)
        for var, off in (("GTPU_PALLAS_YSCALE", "yscale_hv"),
                         ("GTPU_PALLAS_CHROMA", "chroma420_scale")):
            with switches(**{var: "0"}):
                for c in counters.values():
                    c.launches = 0
                out = convs[cfg].convert(ins)
                torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters.items()}
            require(counts[off] == 0,
                    f"{cfg} under {var}=0: {off} launched {counts[off]} times")
            for o, r in zip(out, base):
                require(torch.equal(o, r),
                        f"{cfg} under {var}=0: bytes differ from the run "
                        f"with no switch set")
            for k, n in counts.items():
                total[k] += n
            print(f"switch {var}=0, {cfg}, batch {DEINT_BATCH}: launches "
                  f"{ {k: n for k, n in counts.items() if n} }; the same "
                  f"bytes as with no switch set")
    return total


# -- the audio front-end (BASELINE config 2) ------------------------------------

ASR_CHUNKS, ASR_FRAMES = 128, 1 << 17     # bench_all.py:47-69: 128 x 2.7 s
AUDIO_CHECK = 2                           # chunks / ticks held to the gold
F32_ULPS = 1.0      # card vs the port's CPU path and the float64 gold
ASR_SRC = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
           "channels=2,layout=interleaved ! ")
ASR_CHAIN = ("audioconvert ! audio/x-raw,channels=1 ! audioresample ! "
             "audio/x-raw,rate=16000 ! audioconvert ! "
             "audio/x-raw,format=F32LE ! appsink name=out")
# name: (launch string, input frames a tick, ticks); tests/test_audio.py:180
# launches the ASR front-end; asr_launch feeds it 10 s a tick through
# appsrc, asr_quickstart keeps its audiotestsrc (samples made on the host)
AUDIO_LAUNCH = {
    "asr_launch": (ASR_SRC + ASR_CHAIN, 480000, 4),
    "asr_quickstart": ("audiotestsrc num-buffers={n} samplesperbuffer=48000 "
                       "! audio/x-raw,format=S16LE,rate=48000,channels=2 ! "
                       + ASR_CHAIN, 48000, 4),
    "volume_s16": (ASR_SRC + "volume volume=0.5 ! appsink name=out",
                   480000, 4),
    "volume_f32": (ASR_SRC.replace("S16LE", "F32LE")
                   + "volume volume=0.5 ! appsink name=out", 480000, 4),
}


def device_time(step, iters: int):
    """Run `step` twice, then `iters` times under torch.profiler; returns
    (wall ms, device busy ms, device idle share, profiler) per step; busy
    is the union of the kernels' device intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy = busy_us / iters / 1e3
    return wall, busy, max(0.0, 1.0 - busy / wall), prof


def asr_inputs(seed: int):
    """bench_all.py's input: 128 chunks of 2^17 frames of 48 kHz stereo
    S16, seeded."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32767, (ASR_CHUNKS, ASR_FRAMES, 2),
                        dtype=np.int16)


def ulps32(a, b):
    """|a - b| in ULPs of float32 at b (a float32, b float64)."""
    import numpy as np
    a = np.asarray(a, np.float64)
    return np.abs(a - b) / np.spacing(np.abs(b).astype(np.float32))


def audio_resample(host, dev):
    """asr_resample_f32 and asr_resample_s16: bench_all.py's config through
    the port's AudioResampler("kaiser", 48000, 16000) on the card.  f32: the
    chunks / 32768, resampled, the channel mean after; the first chunks are
    held per output sample to the port's CPU path and to the float64 gold
    (resample_ref from the same float32 inputs) within F32_ULPS, once with
    TF32 allowed process-wide (the route sums in float64, so TF32, whose
    10-bit mantissa is 2^13 ULPs of float32, cannot reach it).  s16: bit for
    bit against the CPU path on the first chunks and resample_ref on a
    prefix.  Returns {name: ms per call, ...}."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import AudioResampler
    res = AudioResampler("kaiser", 48000, 16000, device=dev)
    cpu_res = AudioResampler("kaiser", 48000, 16000, device="cpu")
    x = torch.as_tensor(host).to(dev)
    n_out = res.out_frames_for(ASR_FRAMES)
    out = {}
    rf = res.resample_fn("f32", ASR_FRAMES, 2)
    xf = x.float() / 32768.0
    first = xf[:AUDIO_CHECK].cpu()
    want = cpu_res.resample_fn("f32", ASR_FRAMES, 2)(first).numpy()
    for tf32 in (False, True):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            got = rf(xf[:AUDIO_CHECK])
            torch.cuda.synchronize()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        require(got.dtype == torch.float32 and tuple(got.shape) == (
            AUDIO_CHECK, n_out, 2), f"asr_resample_f32: bad output "
            f"{got.dtype} {tuple(got.shape)}")
        d = ulps32(got.cpu().numpy(), want.astype(np.float64)).max()
        require(d <= F32_ULPS, f"asr_resample_f32 (TF32 allowed: {tf32}): "
                f"{d} ULPs from the port's CPU path")
    gold_ulps = 0.0
    for c in range(AUDIO_CHECK):
        gold = cpu_res.resample_ref(first[c].numpy().astype(np.float64),
                                    "f32")
        gold_ulps = max(gold_ulps, float(ulps32(got[c].cpu().numpy(),
                                                gold).max()))
    require(gold_ulps <= F32_ULPS, f"asr_resample_f32: {gold_ulps} ULPs "
            f"from the float64 gold")
    mean = rf(xf).mean(dim=-1)
    require(tuple(mean.shape) == (ASR_CHUNKS, n_out)
            and bool(torch.isfinite(mean).all()), "asr_resample_f32: output")
    out["asr_resample_f32"] = dict(
        ms=cuda_ms(lambda: rf(x.float() / 32768.0).mean(dim=-1), 10),
        check=f"CUDA vs port CPU path and vs float64 gold <= {F32_ULPS} ULP "
              f"(gold: {gold_ulps:.3f}), also with TF32 allowed",
        step=lambda: rf(x.float() / 32768.0).mean(dim=-1))
    rs = res.resample_fn("s16", ASR_FRAMES, 2)
    got = rs(x)
    torch.cuda.synchronize()
    require(got.dtype == torch.int16 and tuple(got.shape) == (
        ASR_CHUNKS, n_out, 2), "asr_resample_s16: bad output")
    cpu = cpu_res.resample_fn("s16", ASR_FRAMES, 2)(
        torch.as_tensor(host[:AUDIO_CHECK]))
    require(torch.equal(got[:AUDIO_CHECK].cpu(), cpu),
            "asr_resample_s16: CUDA output differs from the port's CPU path")
    prefix = 30000
    gold = cpu_res.resample_ref(host[0, :prefix].astype(np.int64), "s16")
    require(np.array_equal(got[0, :len(gold)].cpu().numpy(), gold),
            "asr_resample_s16: CUDA output differs from resample_ref")
    out["asr_resample_s16"] = dict(
        ms=cuda_ms(lambda: rs(x), 10),
        check=f"CUDA == port CPU path ({AUDIO_CHECK} chunks) == resample_ref "
              f"({len(gold)} outputs), bit for bit", step=lambda: rs(x))
    return out


def asr_gold(ticks, res):
    """A numpy gold of the ASR chain over S16 stereo ticks: unpack, the Q10
    mix to mono with rounding, the quantizer (dither none) and pack to S16,
    resample_ref carried across ticks as audioresample carries its history
    and phase, then S16 -> F32 by the replicated S32 canon."""
    import numpy as np
    from gstreamer_tpu_torch.audio.channel_mixer import build_matrix, matrix_int

    def canon(s):
        w = s.astype(np.int64) & 0xFFFF
        v = (w << 16) | (w ^ 0x8000)
        return np.where(v >= 1 << 31, v - (1 << 32), v)

    mint = matrix_int(build_matrix(("front-left", "front-right"),
                                   ("mono",))).astype(np.int64)
    hist, ph, outs = None, 0, []
    up, down = res.out_red, res.in_red
    for x in ticks:
        m = np.clip((canon(x) @ mint + 512) >> 10, -(1 << 31), (1 << 31) - 1)
        q = np.clip(m + (1 << 15), -(1 << 31), (1 << 31) - 1) & ~0xFFFF
        s16 = (q >> 16).astype(np.int16)
        x = s16 if hist is None else np.concatenate([hist, s16])
        n_out = ((len(x) - res.n_taps) * up - (up - 1)) // down + 1
        r = res.resample_ref(x.astype(np.int64), "s16", samp_phase=ph,
                             n_out=n_out)
        total = ph + n_out * down
        hist, ph = x[total // up:], total % up
        outs.append((canon(r) / 2147483648.0).astype(np.float32))
    return outs


def audio_drive(desc, frames, ticks, pushes, device):
    """Push `pushes` (one array a tick) into appsrc where the string has one,
    tick to EOS on `device`, each tick timed on the host clock between two
    synchronises.  Returns (output arrays per tick, seconds per tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    cuda = torch.device(device).type == "cuda"
    pipe = parse_launch(desc.format(n=ticks), device=device)
    src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
    if src is not None:
        for t, x in enumerate(pushes[:ticks]):
            src.push_buffer(Buffer(data=x, pts=t * frames * 10**9 // 48000,
                                   duration=frames * 10**9 // 48000))
        src.end_of_stream()
    pipe.set_state(State.PLAYING)
    outs, secs = [], []
    while True:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = pipe.tick()
        if cuda:
            torch.cuda.synchronize()
        if not more:
            break
        secs.append(time.perf_counter() - t0)
        got = []
        while (s := sink.pull_sample()) is not None:
            got.append(s.buffer.data)
        outs.append(torch.cat(got) if got else None)
    pipe.set_state(State.NULL)
    return outs, secs


def audio_launch(seed, dev):
    """Drive every AUDIO_LAUNCH path on the card; hold its outputs to a
    numpy gold (asr_launch: asr_gold; volume: the Q27 product and the
    float32 product) and to the same string on the port's CPU path on the
    first AUDIO_CHECK ticks.  Returns {name: rates, ...}."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import AudioResampler
    rng = np.random.default_rng(seed + 1)
    res = {}
    for name, (desc, frames, ticks) in AUDIO_LAUNCH.items():
        host = [rng.integers(-32768, 32767, (frames, 2), dtype=np.int16)
                for _ in range(ticks)]
        if name == "volume_f32":
            host = [(h / 32768.0).astype(np.float32) for h in host]
        pushes = [torch.as_tensor(h).to(dev) for h in host]
        outs, secs = audio_drive(desc, frames, ticks, pushes, dev)
        require(len(outs) == ticks and all(o is not None for o in outs),
                f"{name}: {len(outs)} ticks of output, want {ticks}")
        cpu, _ = audio_drive(desc, frames, AUDIO_CHECK,
                                host[:AUDIO_CHECK], "cpu")
        for o, c in zip(outs, cpu):
            require(o.device.type == dev.type and torch.equal(o.cpu(), c),
                    f"{name}: CUDA output differs from the port's CPU path")
        if name == "asr_launch":
            gold = asr_gold(host[:AUDIO_CHECK], AudioResampler(
                "kaiser", 48000, 16000, device="cpu"))
        elif name == "volume_s16":
            gold = [np.clip((h.astype(np.int64) * (1 << 26)) >> 27,
                            -32768, 32767).astype(np.int16)
                    for h in host[:AUDIO_CHECK]]
        elif name == "volume_f32":
            gold = [h * np.float32(0.5) for h in host[:AUDIO_CHECK]]
        else:
            gold = None
        if gold is not None:
            for o, g in zip(outs, gold):
                o = o.cpu().numpy()
                require(o.dtype == g.dtype and o.shape == g.shape
                        and np.array_equal(o.view(np.uint8),
                                           g.view(np.uint8)),
                        f"{name}: output differs from the numpy gold")
        timed = sum(secs[1:])
        res[name] = dict(
            frames=frames, ticks=ticks, secs=secs,
            msps=frames * (ticks - 1) / timed / 1e6,
            out_frames=[len(o) for o in outs],
            check=f"CUDA == port CPU path ({AUDIO_CHECK} ticks)"
                  + (" == numpy gold" if gold is not None else ""))
    return res


def audio_phase(seed, counters, dev):
    """The audio front-end on the card with the launch counts zeroed just
    before each configuration and read just after (no kernel of the
    port's runs on this path: every count must stay 0); a rate line and
    the device idle share for each."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    host = asr_inputs(seed)
    for c in counters.values():
        c.launches = 0
    rs = audio_resample(host, dev)
    counts = {k: c.launches for k, c in counters.items() if c.launches}
    require(not counts, f"audio resample: kernels launched {counts}")
    for name, r in rs.items():
        _, busy, idle, _ = device_time(r["step"], 3)
        print(f"audio {name}: {r['check']}; launches {counts}")
        print(f"e2e {name}: {r['ms']:.3f} ms per call of {ASR_CHUNKS} x "
              f"{ASR_FRAMES} frames, {ASR_CHUNKS * ASR_FRAMES / r['ms'] / 1e3:.1f}"
              f" Msamples/s (input frames, as bench_all.py counts); device "
              f"busy {busy:.3f} ms a call, idle share {idle:.3f}")
    for c in counters.values():
        c.launches = 0
    paths = audio_launch(seed, dev)
    counts = {k: c.launches for k, c in counters.items() if c.launches}
    require(not counts, f"audio launch paths: kernels launched {counts}")
    for name, r in paths.items():
        desc, frames, _ = AUDIO_LAUNCH[name]
        print(f"audio {name}: {r['check']}; output frames per tick "
              f"{r['out_frames']}; launches {counts}")
        prof_pipe = parse_launch(desc.format(n=10 ** 6), device=dev)
        src = prof_pipe.get_by_name("in")
        sink = prof_pipe.get_by_name("out")
        x = torch.zeros((frames, 2), device=dev,
                        dtype=torch.float32 if "f32" in name else torch.int16)
        prof_pipe.set_state(State.PLAYING)

        def tick():
            if src is not None:
                src.push_buffer(Buffer(data=x))
            prof_pipe.tick()
            while sink.pull_sample() is not None:
                pass
        _, busy, idle, _ = device_time(tick, 3)
        prof_pipe.set_state(State.NULL)
        print(f"e2e {name}: {r['msps']:.3f} Msamples/s of 48 kHz stereo "
              f"input frames over ticks 2..{r['ticks']} ({r['frames']} a "
              f"tick; {[round(s * 1e3, 3) for s in r['secs']]} ms per tick, "
              f"host clock between synchronises); device busy {busy:.3f} ms "
              f"a tick, idle share {idle:.3f}")


# -- BASELINE config 3 and the audio mixer: N-to-1 aggregators -----------------

def comp_src(k, w, h):
    return (f"appsrc name=in{k} caps=video/x-raw,format=I420,width={w},"
            f"height={h},framerate=30/1 ! c.sink_{k}")


def mosaic_desc(w, h):
    """bench_all.py:90-132's compositor string (BASELINE config 3), appsink
    in place of fakesink: four I420 w x h pads placed 2x2 into a mosaic of
    twice their size."""
    return (f"compositor name=c sink_1::xpos={w} sink_2::ypos={h} "
            f"sink_3::xpos={w} sink_3::ypos={h} ! video/x-raw,width={2 * w},"
            f"height={2 * h} ! appsink name=out "
            + " ".join(comp_src(k, w, h) for k in range(4)))


def wall_pads(w, h):
    """The monitoring wall's pads: (xpos, ypos, alpha, zorder), each an
    I420 w x h stream scaled to w/2 x h/2; the fourth is a
    picture-in-picture over the middle of the other three."""
    return [(0, 0, 1.0, 0), (w // 2, 0, 0.5, 0), (0, h // 2, 1.0, 0),
            (w // 4, h // 4, 0.6, 1)]


def wall_desc(w, h):
    props = " ".join(
        f"sink_{k}::xpos={x} sink_{k}::ypos={y} sink_{k}::width={w // 2} "
        f"sink_{k}::height={h // 2} sink_{k}::alpha={a} sink_{k}::zorder={z}"
        for k, (x, y, a, z) in enumerate(wall_pads(w, h)))
    return (f"compositor name=c background=checker {props} ! video/x-raw,"
            f"format=BGRA,width={w},height={h} ! appsink name=out "
            + " ".join(comp_src(k, w, h) for k in range(4)))


def mixer_desc(fmt):
    return ("audiomixer name=c ! appsink name=out "
            + " ".join(f"appsrc name=in{k} caps=audio/x-raw,format={fmt},"
                       f"rate=48000,channels=2,layout=interleaved ! c.sink_{k}"
                       for k in range(2)))


AGG_FRAMES = 480000           # audio frames a tick: 10 s of 48 kHz stereo
# name: (launch string of (w, h), batch or audio frames a tick, ticks,
# kernel launches per tick: tests/test_torch_compositor.py's CPU spy sees
# one yscale and two chroma420 calls per scaled pad and tick)
AGGREGATORS = {
    "compositor_4k": (mosaic_desc, 32, 4, {}),
    "compositor_wall": (wall_desc, 16, 4,
                        {"yscale_hv": 4, "chroma420_scale": 8}),
    "audiomixer_s16": (lambda w, h: mixer_desc("S16LE"), AGG_FRAMES, 4, {}),
    "audiomixer_f32": (lambda w, h: mixer_desc("F32LE"), AGG_FRAMES, 4, {}),
}


def drive_multi(desc, batch, ticks, ins, device):
    """Push `ticks` buffers into every appsrc of `ins` ({name: data}, the
    same data each tick: a tuple of planes of `batch` frames, or one
    (frames, 2) audio tensor at 48 kHz) and tick the pipeline to EOS, each
    tick timed on the host clock between two synchronises.  Returns
    (pipeline, samples per tick, seconds per tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    cuda = torch.device(device).type == "cuda"
    pipe = parse_launch(desc, batch=batch, device=device)
    for name, data in ins.items():
        src = pipe.get_by_name(name)
        for t in range(ticks):
            if isinstance(data, tuple):
                src.push_buffer(Buffer(data=data, pts=t * batch * DUR,
                                       duration=DUR, batch=batch))
            else:
                n = data.shape[0]
                src.push_buffer(Buffer(data=data, pts=t * n * 10**9 // 48000,
                                       duration=n * 10**9 // 48000))
        src.end_of_stream()
    sink = pipe.get_by_name("out")
    pipe.set_state(State.PLAYING)
    outs, secs = [], []
    while True:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = pipe.tick()
        if cuda:
            torch.cuda.synchronize()
        if not more:
            break
        secs.append(time.perf_counter() - t0)
        got = []
        while (s := sink.pull_sample()) is not None:
            got.append(s)
        outs.append(got)
    pipe.set_state(State.NULL)
    return pipe, outs, secs


def over_gold(dst, src, alpha_u8):
    """compositor_orc_overlay_argb in numpy int64 on canonical (..., 4)
    (A, c0, c1, c2) arrays: an independent gold of the OVER blend."""
    import numpy as np
    a_s = (((src[..., 0] * alpha_u8) & 0xFFFF) * 0x8081) >> 23
    a_d = (((dst[..., 0] * (255 - a_s)) & 0xFFFF) * 0x8081) >> 23
    a_out = (a_s + a_d) & 0xFF
    acc = (src * a_s[..., None] + dst * a_d[..., None]) & 0xFFFF
    out = np.where(a_out[..., None] == 0, 255, np.clip(
        acc // np.maximum(a_out, 1)[..., None], 0, 255))
    out[..., 0] = a_out
    return out


def wall_gold(pipe, host_ins, w, h):
    """The wall's first frames in numpy: each pad through its converter's
    numpy gold (convert_ref), OVER the checker in zorder, then pack."""
    import numpy as np
    from gstreamer_tpu_torch.video.format import format_info, pack, unpack
    f = format_info("BGRA")
    yy, xx = np.mgrid[0:h, 0:w]
    val = np.array([80, 160, 80, 160])[((yy & 8) >> 3) + ((xx & 8) >> 3)]
    n = len(next(iter(host_ins.values()))[0])
    out = np.broadcast_to(np.stack([np.full_like(val, 255), val, val, val],
                                   -1), (n, h, w, 4)).astype(np.int64)
    comp = pipe.get_by_name("c")
    pads = sorted(enumerate(wall_pads(w, h)), key=lambda kp: kp[1][3])
    for k, (x0, y0, alpha, _z) in pads:
        conv = comp._converters[f"sink_{k}"]
        pw, ph = w // 2, h // 2
        src = unpack(np, f, conv.convert_ref(host_ins[f"in{k}"]), pw, ph)
        x1, y1 = min(x0 + pw, w), min(y0 + ph, h)
        out[:, y0:y1, x0:x1] = over_gold(
            out[:, y0:y1, x0:x1], src[:, :y1 - y0, :x1 - x0].astype(np.int64),
            max(0, min(255, int(alpha * 255))))
    return pack(np, f, out, w, h)


def aggregator_inputs(name, host, rng, w, h, batch):
    """{appsrc name: host data}: video pads take frames k*batch.. of the
    seeded 1080p batch (cut to w x h); the mixers' first input is near full
    scale so that S16 saturates, the second spans the range."""
    import numpy as np
    if name.startswith("audiomixer"):
        lo = rng.integers(20000, 32767, (batch, 2), dtype=np.int16)
        full = rng.integers(-32768, 32767, (batch, 2), dtype=np.int16)
        if name.endswith("f32"):
            return {"in0": (lo / 32768.0).astype(np.float32),
                    "in1": (full / 40000.0).astype(np.float32)}
        return {"in0": lo, "in1": full}
    cw, ch = (w + 1) // 2, (h + 1) // 2
    out = {}
    for k in range(4):
        sl = slice(k * batch, (k + 1) * batch)
        if len(host[0][sl]) < batch:          # a small batch: reuse frames
            sl = slice(0, batch)
        out[f"in{k}"] = tuple(np.ascontiguousarray(p[sl, :hh, :ww]) for p, hh, ww
                              in zip(host, (h, ch, ch), (w, cw, cw)))
    return out


def mixer_gold(ins):
    """int64 sum clipped to S16, or the float64 sum in pad order cast."""
    import numpy as np
    a, b = ins["in0"], ins["in1"]
    if a.dtype == np.float32:
        return (a.astype(np.float64) + b).astype(np.float32)
    return np.clip(a.astype(np.int64) + b, -32768, 32767).astype(np.int16)


def aggregator_phase(seed, counters, dev, host, w=W, h=H):
    """BASELINE config 3 (compositor_4k: bench_all.py's 4 x 1080p I420 -> 4K
    mosaic), a monitoring wall whose scaled pads run the yscale and
    chroma420 kernels, and the audio mixer at S16 and F32, each through the
    port's parse_launch on the card with the launch counts zeroed just
    before it and read just after.  Outputs equal the port's CPU path on
    the first frames (ticks) and a numpy gold; launches per tick equal the
    table's; the wall's converter holds yscale_hv and chroma420_scale to
    their plain versions at its shapes.  Returns ({kernel: launches} summed
    over the four, {kernel: largest difference from its plain version})."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    rng = np.random.default_rng(seed + 2)
    total = {k: 0 for k in counters}
    err = {}
    for name, (make, batch, ticks, per_tick) in AGGREGATORS.items():
        desc = make(w, h)
        audio = name.startswith("audiomixer")
        host_ins = aggregator_inputs(name, host, rng, w, h, batch)
        ins = {k: (torch.as_tensor(v).to(dev) if audio else
                   tuple(torch.as_tensor(p).to(dev) for p in v))
               for k, v in host_ins.items()}
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        pipe, outs, secs = drive_multi(desc, batch, ticks, ins, dev)
        counts = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        want = {k: per_tick.get(k, 0) * ticks for k in counters}
        require(counts == want, f"{name}: launches {counts}, want {want}")
        for k, n in counts.items():
            total[k] += n
        require(len(outs) == ticks and all(len(o) == 1 for o in outs),
                f"{name}: {[len(o) for o in outs]} samples per tick")
        if audio:
            _, cpu, _ = drive_multi(desc, batch, AUDIO_CHECK, host_ins, "cpu")
            gold = mixer_gold(host_ins)
            for t, o in enumerate(outs):
                o = o[0].buffer.data
                require(o.device.type == dev.type and o.dtype == torch.as_tensor(
                    gold).dtype and tuple(o.shape) == gold.shape,
                    f"{name}: bad output {o.dtype} {tuple(o.shape)}")
                require(np.array_equal(o.cpu().numpy(), gold),
                        f"{name}: tick {t} differs from the numpy gold")
                if t < AUDIO_CHECK:
                    require(torch.equal(o.cpu(), cpu[t][0].buffer.data),
                            f"{name}: CUDA output differs from the port's "
                            f"CPU path")
            if name.endswith("s16"):
                require(int(outs[0][0].buffer.data.max()) == 32767,
                        f"{name}: the near-full-scale input did not saturate")
            check = (f"CUDA == port CPU path ({AUDIO_CHECK} ticks) == numpy "
                     f"gold ({ticks} ticks)")
        else:
            first = outs[0][0]
            n = CPU_FRAMES
            cpu_ins = {k: tuple(p[:n] for p in v)
                       for k, v in host_ins.items()}
            _, cpu, _ = drive_multi(desc, n, 1, cpu_ins, "cpu")
            ref = cpu[0][0]
            require(first.buffer.pts == ref.buffer.pts
                    and str(first.caps) == str(ref.caps),
                    f"{name}: first sample's pts/caps differ from the CPU run")
            for o, r in zip(first.buffer.data, ref.buffer.data):
                require(o.device.type == dev.type and o.dtype == torch.uint8,
                        f"{name}: output {o.dtype} on {o.device}")
                require(torch.equal(o[:n].cpu(), r),
                        f"{name}: CUDA output differs from the port's CPU path")
            if name == "compositor_4k":
                # every quadrant of every plane is its input plane, on the
                # whole first tick: no background shows
                for ci, o in enumerate(first.buffer.data):
                    ph, pw = o.shape[-2] // 2, o.shape[-1] // 2
                    for k, (qy, qx) in enumerate([(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]):
                        require(torch.equal(
                            o[:, qy * ph:(qy + 1) * ph, qx * pw:(qx + 1) * pw],
                            ins[f"in{k}"][ci]),
                            f"{name}: plane {ci} quadrant {k} is not its input")
                gold_what = "every quadrant == its input (whole tick)"
            else:
                # the kernels at the wall's shapes: a pad's batch of 1080p
                # scaled to 960x540 under the converter's cubic plan
                plan = pipe.get_by_name("c")._converters["sink_0"].plan
                y, u, v = ins["in0"]
                hr, vr = plan["h_res"], plan["v_res"]
                err["yscale_hv"] = max_err([ysk.yscale_hv(y, hr, vr)],
                                           [ysk.yscale_hv_plain(y, hr, vr)],
                                           "yscale_hv")
                cargs = (hr, vr, plan["up_h_cosited"], plan["up_v_cosited"])
                err["chroma420_scale"] = max_err(
                    [ck.chroma420_scale(c, *cargs, w, h) for c in (u, v)],
                    [ck.chroma420_scale_plain(c, *cargs) for c in (u, v)],
                    "chroma420_scale")
                for kname, e in err.items():
                    require(e == 0, f"{name}: {kname} differs from its plain "
                            f"version by up to {e} at the wall's shapes")
                gold = wall_gold(pipe, cpu_ins, w, h)
                for o, g in zip(first.buffer.data, gold):
                    require(np.array_equal(o[:n].cpu().numpy(), g),
                            f"{name}: CUDA output differs from the numpy gold")
                gold_what = (f"numpy gold ({n} frames); yscale_hv and "
                             f"chroma420_scale == plain at {tuple(y.shape)} "
                             f"-> {(vr.out_size, hr.out_size)}")
            check = f"CUDA == port CPU path ({n} frames), {gold_what}"
        print(f"aggregate {name}: batch {batch}, {ticks} ticks, "
              f"{'fused' if pipe._fused else 'per-element'}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; {check}; peak "
              f"device memory {peak / 2**30:.2f} GiB")
        del outs

        prof = parse_launch(desc, batch=batch, device=dev)
        sink = prof.get_by_name("out")
        prof.set_state(State.PLAYING)

        def tick():
            for k, v in ins.items():
                prof.get_by_name(k).push_buffer(
                    Buffer(data=v, batch=1 if audio else batch))
            prof.tick()
            while sink.pull_sample() is not None:
                pass
        _, busy, idle, _ = device_time(tick, 3)
        prof.set_state(State.NULL)
        timed = sum(secs[1:])
        tick_ms = [round(s * 1e3, 3) for s in secs]
        if audio:
            rate = (f"{batch * (ticks - 1) / timed / 1e6:.3f} Msamples/s of "
                    f"48 kHz stereo input frames")
        else:
            rate = f"{batch * (ticks - 1) / timed:.1f} output frames/s"
        extra = ""
        if name == "compositor_4k":
            # compulsory traffic: each input plane read once, each output
            # plane written once
            nbytes = sum(p.numel() for p in next(iter(ins.values()))) * 4 * 2
            bms, by, unit = bound(nbytes, 0.0)
            extra = (f"; bound {bms:.4f} ms a tick ({by}, {unit}, "
                     f"{nbytes / batch / 1e6:.1f} MB an output frame), "
                     f"{batch / bms * 1e3:.0f} frames/s")
        print(f"e2e {name}: {rate} over ticks 2..{ticks} ({tick_ms} ms per "
              f"tick, host clock between synchronises); device busy "
              f"{busy:.3f} ms a tick, idle share {idle:.3f}{extra}")
        del ins, prof
        torch.cuda.empty_cache()
    return total, err


# -- stateful and controlled elements: BASELINE config 4 in full, effectv ---

# the deinterlace methods with no kernel (plain torch); the fields each
# holds back at the stream's start (gstdeinterlacemethod.h latency)
DEINT_NEW = ("tomsmocomp", "greedyh", "greedyl", "vfir", "linearblend",
             "weave", "weave-tff", "weave-bff", "yadif")
DEINT_HELD = {"greedyh": 1, "greedyl": 1, "yadif": 2}
DEINT_TICKS = 3
DEINT_CHECK = (2, 1, 2)     # input frames a tick of the CPU check
BALANCE = "videobalance contrast=1.1 brightness=0.05 ! appsink name=out"
# a fade: contrast and brightness keyframed, a new value every tick
FADE = {"vb": {"contrast": [(0, 1.3), (DEINT_TICKS * DEINT_BATCH * DUR,
                                       0.7)],
               "brightness": [(0, -0.1), (DEINT_TICKS * DEINT_BATCH * DUR,
                                          0.2)]}}
EW, EH = 640, 480           # bench_all.py:177-209's 480p camera feed
ESRC = (f"appsrc name=in caps=video/x-raw,format=RGB,width={EW},"
        f"height={EH},framerate=30/1 ! ")
EFFECT_CHAIN = ("edgetv ! vertigotv", 128, 3)      # string, batch, ticks
EFFECTS = ("edgetv", "streaktv", "shagadelictv", "vertigotv", "quarktv",
           "revtv", "dicetv", "warptv", "rippletv", "agingtv", "optv",
           "radioactv")
EFFECT_CHECK = (4, 4)       # frames a tick, card and CPU
VOLUME_RAMP = {"v": {"volume": [(0, 0.2), (4 * 10**10, 1.4)]}}


def controlled(desc, device, batch, controls=None):
    """parse_launch(desc) with `controls` ({element: {prop: [(ts, value),
    ...]}}) bound as linear InterpolationControlSources."""
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.controller import \
        InterpolationControlSource
    pipe = parse_launch(desc, batch=batch, device=device)
    for name, props in (controls or {}).items():
        for prop, points in props.items():
            cs = InterpolationControlSource("linear")
            for ts, v in points:
                cs.set(ts, v)
            pipe.get_by_name(name).set_control_source(prop, cs)
    return pipe


def push_tick(src, data, pts):
    """Push one tick's data (a tuple of planes, or one (frames, 2) audio
    tensor at 48 kHz) at `pts`; returns the next tick's pts."""
    from gstreamer_tpu_torch.core.buffer import Buffer
    if isinstance(data, tuple):
        n = data[0].shape[0]
        src.push_buffer(Buffer(data=data, pts=pts, duration=DUR, batch=n))
        return pts + n * DUR
    n = data.shape[0] * 10**9 // 48000
    src.push_buffer(Buffer(data=data, pts=pts, duration=n))
    return pts + n


def drive_seq(desc, pushes, device, batch, controls=None):
    """Push `pushes` into appsrc ``in``, one a tick (push_tick), under
    `controls` (controlled), and tick the pipeline to EOS, each tick timed
    on the host clock between two synchronises.  Returns (pipeline,
    samples per tick, seconds per tick)."""
    import torch
    from gstreamer_tpu_torch.core.pipeline import State
    cuda = torch.device(device).type == "cuda"
    pipe = controlled(desc, device, batch, controls)
    src = pipe.get_by_name("in")
    pts = 0
    for data in pushes:
        pts = push_tick(src, data, pts)
    src.end_of_stream()
    sink = pipe.get_by_name("out")
    pipe.set_state(State.PLAYING)
    outs, secs = [], []
    while True:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = pipe.tick()
        if cuda:
            torch.cuda.synchronize()
        if not more:
            break
        secs.append(time.perf_counter() - t0)
        got = []
        while (s := sink.pull_sample()) is not None:
            got.append(s)
        outs.append(got)
    pipe.set_state(State.NULL)
    return pipe, outs, secs


def same_samples(a, b, what, dev):
    """Samples per tick of a run on `dev` equal a CPU run's: data bytes,
    pts, batch, caps."""
    import torch
    require(len(a) == len(b) and all(len(x) == len(y) for x, y in
                                     zip(a, b)),
            f"{what}: {[len(x) for x in a]} samples per tick on the card, "
            f"{[len(y) for y in b]} on the CPU")
    for x, y in zip(a, b):
        for s, r in zip(x, y):
            require((s.buffer.pts, s.buffer.batch, str(s.caps))
                    == (r.buffer.pts, r.buffer.batch, str(r.caps)),
                    f"{what}: sample metadata differs from the CPU run")
            sd, rd = s.buffer.data, r.buffer.data
            sd = sd if isinstance(sd, (tuple, list)) else (sd,)
            rd = rd if isinstance(rd, (tuple, list)) else (rd,)
            for o, c in zip(sd, rd):
                require(o.device.type == dev.type and torch.equal(o.cpu(), c),
                        f"{what}: CUDA output differs from the port's CPU "
                        f"path")


def profile_ticks(desc, push, dev, batch, controls=None):
    """Device busy ms and idle share a tick (device_time: 3 ticks traced
    after 2), the pipeline fed `push` every tick."""
    from gstreamer_tpu_torch.core.pipeline import State
    pipe = controlled(desc, dev, batch, controls)
    src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
    pipe.set_state(State.PLAYING)
    pts = [0]

    def tick():
        pts[0] = push_tick(src, push, pts[0])
        pipe.tick()
        while sink.pull_sample() is not None:
            pass
    _, busy, idle, _ = device_time(tick, 3)
    pipe.set_state(State.NULL)
    return busy, idle


def fade_gold(host, ticks):
    """deint_chain_controlled's gold: the plain linear deinterlace of the
    first CPU_FRAMES frames, then videobalance's float32 tables (one
    rounding a step, cos / sin correctly rounded) at each tick's values."""
    import math
    import numpy as np
    import torch
    from gstreamer_tpu_torch.core.controller import \
        InterpolationControlSource
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    fields = [dk.deint_both_parities_plain(torch.as_tensor(p[:CPU_FRAMES]),
                                           "linear", 0).flatten(0, 1).numpy()
              for p in host]
    f32 = np.float32
    golds = []
    for t in range(ticks):
        vals = {}
        for prop, points in FADE["vb"].items():
            cs = InterpolationControlSource("linear")
            for ts, v in points:
                cs.set(ts, v)
            vals[prop] = f32(cs.value_at(t * DEINT_BATCH * DUR))
        c, b = vals["contrast"], vals["brightness"]
        i = np.arange(256, dtype=np.float32)
        ty = np.clip(np.rint(f32(16) + (i - f32(16)) * c + b * f32(255)),
                     0, 255).astype(np.int64)
        arg = f32(np.pi) * f32(0.0)
        hc, hs = f32(math.cos(float(arg))), f32(math.sin(float(arg)))
        ii, jj = (i - f32(128))[:, None], (i - f32(128))[None, :]
        tu = np.clip(np.rint(f32(128) + (ii * hc + jj * hs) * f32(1.0)),
                     0, 255).astype(np.int64)
        tv = np.clip(np.rint(f32(128) + (-ii * hs + jj * hc) * f32(1.0)),
                     0, 255).astype(np.int64)
        y, u, v = (f.astype(np.int64) for f in fields)
        golds.append((ty[y], tu[u, v], tv[u, v], (float(c), float(b))))
    return golds


def stateful_phase(seed, counters, dev, host):
    """The stateful and controlled paths on the card, each with the
    launch counts zeroed just before it and read just after: every
    deinterlace method of BASELINE config 4 (deint_<method>), the linear
    chain under a keyframed fade (deint_chain_controlled, 3 deint launches
    a tick), bench_all.py's edgetv ! vertigotv scan chain and each effectv
    effect alone, and a volume ramp.  Outputs equal the port's CPU path
    across tick boundaries (and the fade a host gold).  Returns
    {kernel: launches}."""
    import numpy as np
    import torch
    total = {k: 0 for k in counters}
    b = DEINT_BATCH
    ins = tuple(torch.as_tensor(p[:b]).to(dev) for p in host)
    src = SRC.format(w=W, h=H)
    chk = []
    off = 0
    for n in DEINT_CHECK:
        chk.append(tuple(p[off:off + n] for p in host))
        off += n

    def counted(fn):
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        res = fn()
        counts = {k: c.launches for k, c in counters.items()}
        for k, v in counts.items():
            total[k] += v
        return res, counts, torch.cuda.max_memory_allocated()

    # -- every other deinterlace method, BASELINE config 4's chain -------
    for m in DEINT_NEW:
        name = f"deint_{m}"
        desc = src + f"deinterlace method={m} ! " + BALANCE
        (pipe, outs, secs), counts, peak = counted(
            lambda: drive_seq(desc, [ins] * DEINT_TICKS, dev, b))
        require(not any(counts.values()),
                f"{name}: kernels launched {counts} (no kernel on its path)")
        frames = [sum(s.buffer.batch for s in o) for o in outs]
        want = [2 * b - DEINT_HELD.get(m, 0)] + [2 * b] * (DEINT_TICKS - 1)
        require(frames == want, f"{name}: output frames per tick {frames}, "
                f"want {want}")
        del outs
        _, on_card, _ = drive_seq(desc, [tuple(torch.as_tensor(x).to(dev)
                                               for x in c) for c in chk],
                                  dev, max(DEINT_CHECK))
        _, on_cpu, _ = drive_seq(desc, [tuple(torch.as_tensor(x) for x in c)
                                        for c in chk], "cpu",
                                 max(DEINT_CHECK))
        same_samples(on_card, on_cpu, name, dev)
        busy, idle = profile_ticks(desc, ins, dev, b)
        fps = sum(frames[1:]) / sum(secs[1:])
        print(f"path {name}: batch {b}, {DEINT_TICKS} ticks, per-element; "
              f"launches none; output frames per tick {frames}; CUDA == "
              f"port CPU path over ticks of {DEINT_CHECK} frames; peak "
              f"device memory {peak / 2**30:.2f} GiB")
        print(f"e2e {name}: {fps:.1f} output frames/s over ticks 2.."
              f"{DEINT_TICKS} ({[round(s * 1e3, 3) for s in secs]} ms per "
              f"tick, host clock between synchronises); device busy "
              f"{busy:.3f} ms a tick, idle share {idle:.3f}; peak "
              f"{peak / 2**30:.2f} GiB")
        del on_card, on_cpu
        torch.cuda.empty_cache()

    # -- the linear chain under a keyframed fade ---------------------------
    name = "deint_chain_controlled"
    desc = src + "deinterlace method=linear ! videobalance name=vb ! " \
        "appsink name=out"
    (pipe, outs, secs), counts, peak = counted(
        lambda: drive_seq(desc, [ins] * DEINT_TICKS, dev, b, FADE))
    require(counts["deint_both_parities"] == 3 * DEINT_TICKS
            and sum(counts.values()) == 3 * DEINT_TICKS,
            f"{name}: launches {counts}, want 3 deint_both_parities a tick")
    golds = fade_gold(host, DEINT_TICKS)
    for t, (o, g) in enumerate(zip(outs, golds)):
        require(len(o) == 1 and o[0].buffer.batch == 2 * b,
                f"{name}: tick {t} gave {[s.buffer.batch for s in o]}")
        for p, gp in zip(o[0].buffer.data, g[:3]):
            require(np.array_equal(p[:2 * CPU_FRAMES].cpu().numpy()
                                   .astype(np.int64), gp),
                    f"{name}: tick {t} differs from the plain deinterlace "
                    f"and the float32 tables at {g[3]}")
    require(not torch.equal(outs[0][0].buffer.data[0],
                            outs[-1][0].buffer.data[0]),
            f"{name}: the fade did not change the output")
    busy, idle = profile_ticks(desc, ins, dev, b, FADE)
    fps = 2 * b * (DEINT_TICKS - 1) / sum(secs[1:])
    print(f"path {name}: batch {b}, {DEINT_TICKS} ticks, per-element; "
          f"launches { {k: v for k, v in counts.items() if v} }; each tick "
          f"== plain deinterlace + float32 tables at its values "
          f"{[g[3] for g in golds]} ({CPU_FRAMES} frames); peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"e2e {name}: {fps:.1f} output frames/s over ticks 2.."
          f"{DEINT_TICKS} ({[round(s * 1e3, 3) for s in secs]} ms per tick, "
          f"host clock between synchronises); device busy {busy:.3f} ms a "
          f"tick, idle share {idle:.3f}")
    del outs, ins
    torch.cuda.empty_cache()

    # -- effectv: bench_all.py's scan chain, then every effect alone -------
    rng = np.random.default_rng(seed + 3)
    chain, eb, eticks = EFFECT_CHAIN
    rgb = tuple(rng.integers(0, 256, (eb, EH, EW), dtype=np.uint8)
                for _ in range(3))
    rgb_dev = tuple(torch.as_tensor(p).to(dev) for p in rgb)
    name = "effectv_chain"
    desc = ESRC + chain + " ! appsink name=out"
    (pipe, outs, secs), counts, peak = counted(
        lambda: drive_seq(desc, [rgb_dev] * eticks, dev, eb))
    require(not any(counts.values()) and pipe._fused,
            f"{name}: want one fused step and no kernel, got {counts}")
    require([sum(s.buffer.batch for s in o) for o in outs] == [eb] * eticks,
            f"{name}: output frames per tick")
    del outs
    busy, idle = profile_ticks(desc, rgb_dev, dev, eb)
    fps = eb * (eticks - 1) / sum(secs[1:])
    checked = []
    for effect in (chain,) + EFFECTS:
        d = ESRC + effect + " ! appsink name=out"
        pushes = []
        off = 0
        for n in EFFECT_CHECK:
            pushes.append(tuple(p[off:off + n] for p in rgb))
            off += n
        (_, on_card, _), counts, _ = counted(lambda: drive_seq(
            d, [tuple(torch.as_tensor(x).to(dev) for x in c)
                for c in pushes], dev, EFFECT_CHECK[0]))
        require(not any(counts.values()), f"{effect}: kernels {counts}")
        _, on_cpu, _ = drive_seq(d, [tuple(torch.as_tensor(x) for x in c)
                                     for c in pushes], "cpu",
                                 EFFECT_CHECK[0])
        same_samples(on_card, on_cpu, effect, dev)
        checked.append(effect.split()[0] if effect in EFFECTS else "chain")
    print(f"path {name}: batch {eb}, {eticks} ticks, fused scan; launches "
          f"none; CUDA == port CPU path over ticks of {EFFECT_CHECK} frames "
          f"at {EW}x{EH} for {checked}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"e2e {name}: {fps:.1f} output frames/s over ticks 2..{eticks} "
          f"({[round(s * 1e3, 3) for s in secs]} ms per tick, host clock "
          f"between synchronises; {2 * eb} scan steps a tick); device busy "
          f"{busy:.3f} ms a tick, idle share {idle:.3f}")
    del rgb_dev
    torch.cuda.empty_cache()

    # -- a volume ramp, S16 and F32, 10 s a tick ---------------------------
    arng = np.random.default_rng(seed + 4)
    for fmt in ("S16LE", "F32LE"):
        name = f"volume_controlled_{fmt[:3].lower()}"
        desc = (ASR_SRC.replace("S16LE", fmt)
                + "volume name=v ! appsink name=out")
        host_a = [arng.integers(-32768, 32767, (AGG_FRAMES, 2),
                                dtype=np.int16) for _ in range(4)]
        if fmt == "F32LE":
            host_a = [(h / 32768.0).astype(np.float32) for h in host_a]
        (_, outs, secs), counts, _ = counted(lambda: drive_seq(
            desc, [torch.as_tensor(h).to(dev) for h in host_a], dev, 1,
            VOLUME_RAMP))
        require(not any(counts.values()), f"{name}: kernels {counts}")
        _, cpu, _ = drive_seq(desc, [torch.as_tensor(h) for h in host_a],
                              "cpu", 1, VOLUME_RAMP)
        same_samples(outs, cpu, name, dev)
        busy, idle = profile_ticks(desc, torch.as_tensor(host_a[0]).to(dev),
                                   dev, 1, VOLUME_RAMP)
        msps = AGG_FRAMES * (len(secs) - 1) / sum(secs[1:]) / 1e6
        print(f"audio {name}: CUDA == port CPU path on every tick "
              f"({len(outs)} ticks of {AGG_FRAMES} frames, a new gain each "
              f"tick); launches none")
        print(f"e2e {name}: {msps:.3f} Msamples/s of 48 kHz stereo input "
              f"frames over ticks 2..{len(secs)} "
              f"({[round(s * 1e3, 3) for s in secs]} ms per tick); device "
              f"busy {busy:.3f} ms a tick, idle share {idle:.3f}")
    return total


# -- ingest from disk: BASELINE config 5 and bench_e2e.py's path -------------
INGEST_FRAMES = 96                # bench_e2e.py:23-31's clip, about 300 MB
INGEST_BATCHES = (16, 64)
INGEST_PASSES = 3
INGEST = ("filesrc name=src location={path} ! videoconvertscale name=conv "
          "add-borders=false ! video/x-raw,format=RGB,width=224,height=224 "
          "! appsink name=out")
FRAME_BYTES = W * H * 3 // 2      # one 1080p I420 frame
JPEG_FILES, JPEG_BATCH, JPEG_QUALITY = 64, 16, 85
JPEG_SMALL = (500, 375, 8)        # width, height, files of 4:4:4 and of gray
JPEG_DECODE = ("multifilesrc location={pat} ! jpegdec name=dec ! "
               "videoconvertscale name=conv add-borders=false ! "
               "video/x-raw,format=RGB,width=224,height=224 ! appsink "
               "name=out")
ML_FRAMES, ML_BATCH = 64, 16


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def write_y4m(path, frames, seed):
    """bench_e2e.py:23-31's input: seeded random 1080p I420 frames; returns
    the frames as one (frames, FRAME_BYTES) uint8 array."""
    import numpy as np
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (frames, FRAME_BYTES), dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F30:1 Ip A1:1 C420mpeg2\n".encode())
        for k in range(frames):
            f.write(b"FRAME\n")
            f.write(raw[k].tobytes())
    return raw


def h2d_ceiling(dev):
    """Host-to-device rate of 16 1080p luma planes (bench_e2e.py:141-167's
    probe), page-locked and pageable: (pinned GB/s, pageable GB/s), median
    of 5 warm copies on the host clock between synchronises; None off the
    card."""
    import numpy as np
    import torch
    if dev.type != "cuda":
        return None
    x = np.random.default_rng(1).integers(0, 256, (16, H, W),
                                          dtype=np.uint8)
    pinned = torch.from_numpy(x).pin_memory()
    rates = []
    for src, kw in ((pinned, {"non_blocking": True}),
                    (torch.from_numpy(x), {})):
        src.to(dev, **kw)
        torch.cuda.synchronize()
        r = []
        for _ in range(5):
            t0 = time.perf_counter()
            src.to(dev, **kw)
            torch.cuda.synchronize()
            r.append(x.nbytes / (time.perf_counter() - t0) / 1e9)
        rates.append(float(np.median(r)))
    return tuple(rates)


def traced(step, dev):
    """(wall ms, device busy ms, idle share) of ONE call of `step` under
    torch.profiler, no warm-up call (a pass ends at EOS): the union of the
    device's kernel and copy intervals, as device_time counts them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        t0 = time.perf_counter()
        step()
        return (time.perf_counter() - t0) * 1e3, 0.0, 1.0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy = busy_us / 1e3
    return wall, busy, max(0.0, 1.0 - busy / wall)


def drain(sink):
    out = []
    while (s := sink.pull_sample()) is not None:
        out.append(s)
    return out


def ingest_pass(pipe, sink, dev):
    """Tick `pipe` to EOS; (samples, ticks, seconds on the host clock, the
    last sync included)."""
    samples, ticks = [], 0
    sync(dev)
    t0 = time.perf_counter()
    while pipe.tick():
        ticks += 1
        samples += drain(sink)
    sync(dev)
    return samples, ticks, time.perf_counter() - t0


def same_rgb(samples, gold, what):
    """The samples' RGB planes, in order, equal `gold` (three (n, 224, 224)
    tensors); returns (pts list, batch list)."""
    import torch
    got = [torch.cat([s.buffer.data[c] for s in samples]) for c in range(3)]
    require(all(tuple(g.shape) == tuple(r.shape) and torch.equal(g, r)
                for g, r in zip(got, gold)),
            f"{what}: RGB differs from the converter on the same frames")
    return ([s.buffer.pts for s in samples],
            [s.buffer.batch for s in samples])


def ingest_y4m(seed, counters, dev, tmp):
    """filesrc ! videoconvertscale add-borders=false ! RGB 224 ! appsink over
    bench_e2e.py's clip at batch 16 and 64, prefetch off and on, three passes
    with seek(0) between them; then once under GTPU_PALLAS=1.  Returns the
    kernels' launches."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import VideoConverter, parse_launch
    from gstreamer_tpu_torch.core.pipeline import State
    path = os.path.join(tmp, "ingest.y4m")
    raw = write_y4m(path, INGEST_FRAMES, seed)
    ys = W * H
    host = (raw[:, :ys].reshape(-1, H, W),
            raw[:, ys:ys + ys // 4].reshape(-1, H // 2, W // 2),
            raw[:, ys + ys // 4:].reshape(-1, H // 2, W // 2))
    del raw
    dur_ns = INGEST_FRAMES * 10**9 // 30
    launches = {k: 0 for k in counters}
    runs, gold = {}, None
    for batch in INGEST_BATCHES:
        for prefetch in (False, True):
            tag = f"batch {batch}, prefetch {'on' if prefetch else 'off'}"
            pipe = parse_launch(INGEST.format(path=path), device=dev)
            pipe.compile(batch=batch, donate_inputs=True, prefetch=prefetch)
            src, sink = pipe.get_by_name("src"), pipe.get_by_name("out")
            pipe.set_state(State.PLAYING)
            if gold is None:
                # the port's VideoConverter, built from the element's
                # config, on the same frames read with numpy
                conv = pipe.get_by_name("conv")._converter
                ref = VideoConverter(conv.in_info, conv.out_info, conv.config,
                                     device=dev)
                gold = ref.convert(tuple(torch.as_tensor(p).to(dev)
                                         for p in host))
                del ref
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            fps, ceil, frac, meta = [], [], [], None
            for k in range(INGEST_PASSES):
                if k:
                    require(pipe.seek(0), f"ingest_y4m [{tag}]: seek(0) "
                            "refused")
                pre = h2d_ceiling(dev)
                for c in counters.values():
                    c.launches = 0
                before = src.native_batches
                samples, ticks, secs = ingest_pass(pipe, sink, dev)
                counts = {n: c.launches for n, c in counters.items()}
                post = h2d_ceiling(dev)
                for n, v in counts.items():
                    launches[n] += v
                want = -(-INGEST_FRAMES // batch)
                require(ticks == want, f"ingest_y4m [{tag}]: {ticks} ticks, "
                        f"want {want}")
                require(counts["yscale_hv"] == ticks
                        and sum(counts.values()) == ticks,
                        f"ingest_y4m [{tag}]: launches {counts}, want "
                        f"yscale_hv once a tick ({ticks})")
                require(src.native_batches - before == ticks,
                        f"ingest_y4m [{tag}]: the native reader delivered "
                        f"{src.native_batches - before} of {ticks} ticks")
                m = same_rgb(samples, gold, f"ingest_y4m [{tag}] pass {k}")
                require(m[0] == [i * batch * 10**9 // 30
                                 for i in range(ticks)],
                        f"ingest_y4m [{tag}]: pts {m[0]}")
                require(meta in (None, m), f"ingest_y4m [{tag}]: pass {k} "
                        "timestamps differ from pass 0")
                meta = m
                require(pipe.query_duration() == dur_ns,
                        f"ingest_y4m [{tag}]: duration "
                        f"{pipe.query_duration()}, want {dur_ns}")
                last = (ticks - 1) * batch      # the last tick's first frame
                want_pos = (last * 10**9 // 30
                            + (INGEST_FRAMES - last) * (10**9 // 30))
                require(pipe.query_position() == want_pos,
                        f"ingest_y4m [{tag}]: position "
                        f"{pipe.query_position()}, want {want_pos} (the "
                        "last buffer's pts + its frames' durations)")
                fps.append(INGEST_FRAMES / secs)
                if pre is not None:
                    ceil.append((pre, post))
                    frac.append(fps[-1] / float(
                        np.median([pre[0], post[0]]) * 1e9 / FRAME_BYTES))
            require(pipe.seek(0), f"ingest_y4m [{tag}]: seek(0) refused")
            wall, busy, idle = traced(lambda: ingest_pass(pipe, sink, dev),
                                      dev)
            peak = (torch.cuda.max_memory_allocated() / 2**30
                    if dev.type == "cuda" else 0.0)
            pipe.set_state(State.NULL)
            runs[(batch, prefetch)] = meta
            ticks = -(-INGEST_FRAMES // batch)
            probes = [[round(v, 2) for v in pair] for pc in ceil
                      for pair in pc]
            as_fps = [[round(pc[0][k] * 1e9 / FRAME_BYTES, 1) for pc in ceil]
                      for k in (0, 1)]
            print(f"e2e ingest_y4m [{tag}]: "
                  f"{[round(f, 1) for f in fps]} frames/s per pass; H2D "
                  f"ceiling (pinned, pageable) GB/s before / after each "
                  f"pass {probes} = pinned {as_fps[0]}, pageable "
                  f"{as_fps[1]} 1080p-frames/s (before each pass); fraction "
                  f"of the pinned ceiling {[round(f, 4) for f in frac]}; "
                  f"traced pass: {wall:.2f} ms wall, {busy:.3f} busy ms = "
                  f"{busy / ticks:.3f} a tick, idle {idle:.1%}; peak device "
                  f"memory {peak:.2f} GiB")
        require(runs[(batch, True)] == runs[(batch, False)],
                f"ingest_y4m [batch {batch}]: prefetch changed the ticks or "
                "pts")
    # the fused-ingest route: same bytes, its kernel once a tick
    with opt_in():
        pipe = parse_launch(INGEST.format(path=path), device=dev)
        pipe.compile(batch=64, prefetch=True)
        pipe.set_state(State.PLAYING)
        for c in counters.values():
            c.launches = 0
        samples, ticks, secs = ingest_pass(pipe, pipe.get_by_name("out"), dev)
        counts = {n: c.launches for n, c in counters.items()}
        pipe.set_state(State.NULL)
    for n, v in counts.items():
        launches[n] += v
    require(counts["fused_i420_up_hscale"] == ticks
            and sum(counts.values()) == ticks,
            f"ingest_y4m [GTPU_PALLAS=1]: launches {counts}")
    same_rgb(samples, gold, "ingest_y4m [GTPU_PALLAS=1]")
    print(f"e2e ingest_y4m [batch 64, prefetch on, GTPU_PALLAS=1]: "
          f"{INGEST_FRAMES / secs:.1f} frames/s, same bytes, "
          f"fused_i420_up_hscale once a tick")
    return launches


def jpeg_set(dev, pattern, fmt, w, h, files, batch, seed):
    """`files` JPEGs at quality JPEG_QUALITY written by the port's jpegenc
    from videotestsrc pattern=smpte plus seeded noise (drawn on `dev`), at
    `pattern` % index."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    caps = f"video/x-raw,format={fmt},width={w},height={h},framerate=30/1"
    bars = parse_launch(f"videotestsrc pattern=smpte num-buffers=1 ! {caps} "
                        "! appsink name=out", device=dev)
    bars.set_state("playing")
    bars.tick()
    frame = bars.get_by_name("out").pull_sample().buffer.data
    bars.set_state("null")
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc = parse_launch(f"appsrc name=in caps={caps} ! jpegenc quality="
                       f"{JPEG_QUALITY} ! multifilesink location={pattern}",
                       batch=batch, device=dev)
    src = enc.get_by_name("in")
    for k in range(0, files, batch):
        n = min(batch, files - k)
        planes = tuple(
            (p.expand((n,) + tuple(p.shape[1:])).to(torch.int16)
             + torch.randint(-12, 13, (n,) + tuple(p.shape[1:]),
                             generator=gen, device=dev, dtype=torch.int16)
             ).clamp_(0, 255).to(torch.uint8) for p in frame)
        src.push_buffer(Buffer(data=planes, pts=k * DUR, duration=DUR,
                               batch=n))
    src.end_of_stream()
    enc.run()


def decode_planes(pattern, files, batch, dev):
    """multifilesrc ! jpegdec ! appsink on `dev`: the decoded planes of every
    file, one tuple a file."""
    from gstreamer_tpu_torch import parse_launch
    pipe = parse_launch(f"multifilesrc location={pattern} ! jpegdec ! "
                        "appsink name=out", batch=batch, device=dev)
    pipe.set_state("playing")
    out = []
    while pipe.tick():
        for s in drain(pipe.get_by_name("out")):
            out += [tuple(p[k] for p in s.buffer.data)
                    for k in range(s.buffer.batch)]
    pipe.set_state("null")
    require(len(out) == files, f"jpegdec: {len(out)} images of {files}")
    return out


def ingest_jpeg(seed, counters, dev, tmp):
    """BASELINE config 5: multifilesrc ! jpegdec ! videoconvertscale
    add-borders=false ! RGB 224 ! appsink over 64 1080p 4:2:0 JPEGs, and 16
    small 4:4:4 / gray ones.  Returns the kernels' launches."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import VideoConverter, parse_launch
    from gstreamer_tpu_torch.codecs import jpeg as cj
    from gstreamer_tpu_torch.native import jpeg as njpeg
    require(njpeg.available(), "ingest_jpeg: the native entropy coder did "
            "not build")
    sets = {"1080p_420": ("I420", W, H, JPEG_FILES, JPEG_BATCH),
            "small_444": ("Y444",) + JPEG_SMALL[:2] + (JPEG_SMALL[2],) * 2,
            "small_gray": ("GRAY8",) + JPEG_SMALL[:2] + (JPEG_SMALL[2],) * 2}
    launches = {k: 0 for k in counters}
    for i, (sname, (fmt, w, h, files, batch)) in enumerate(sets.items()):
        pattern = os.path.join(tmp, f"{sname}_%05d.jpg")
        t0 = time.perf_counter()
        jpeg_set(dev, pattern, fmt, w, h, files, batch, seed + i)
        enc_s = time.perf_counter() - t0
        blobs = []
        for k in range(files):
            with open(pattern % k, "rb") as f:
                blobs.append(f.read())
        # the card's decoded planes against the port's CPU decode
        card = decode_planes(pattern, files, batch, dev)
        for k, (planes, blob) in enumerate(zip(card, blobs)):
            cpu, _, _, _ = cj.jpeg_decode(blob, device="cpu")
            if fmt == "I420":
                cw, ch = -(-w // 2), -(-h // 2)
                cpu = (cpu[0],) + tuple(p[:ch, :cw] for p in cpu[1:])
            require(len(planes) == len(cpu) and all(
                p.device.type == dev.type and torch.equal(p.cpu(), c)
                for p, c in zip(planes, cpu)),
                f"ingest_jpeg [{sname}]: file {k}: the card's planes differ "
                "from the CPU decode")
        # the launched string: counts zeroed just before, read just after
        pipe = parse_launch(JPEG_DECODE.format(pat=pattern), batch=batch,
                            device=dev)
        pipe.set_state("playing")
        dec, sink = pipe.get_by_name("dec"), pipe.get_by_name("out")
        for c in counters.values():
            c.launches = 0
        samples, ticks, secs = ingest_pass(pipe, sink, dev)
        counts = {n: c.launches for n, c in counters.items()}
        for n, v in counts.items():
            launches[n] += v
        require(dec.native_decodes == files,
                f"ingest_jpeg [{sname}]: {dec.native_decodes} of {files} "
                "scans decoded natively")
        if fmt == "I420":
            require(counts["yscale_hv"] == ticks
                    and sum(counts.values()) == ticks,
                    f"ingest_jpeg [{sname}]: launches {counts}, want "
                    f"yscale_hv once a tick ({ticks})")
        conv = pipe.get_by_name("conv")._converter
        ref = VideoConverter(conv.in_info, conv.out_info, conv.config,
                             device=dev)
        gold = ref.convert(tuple(torch.stack([p[c] for p in card])
                                 for c in range(len(card[0]))))
        same_rgb(samples, gold, f"ingest_jpeg [{sname}]")
        pipe.set_state("null")
        # where the time goes: host entropy decode, device IDCT, idle share
        t0 = time.perf_counter()
        coded = [cj.decode_entropy(b) for b in blobs[:batch]]
        entropy_ms = (time.perf_counter() - t0) * 1e3 / len(coded)
        zz = torch.as_tensor(np.concatenate(
            [c["coef"] for img in coded for c in img.comps]), device=dev)
        zz = zz[:, torch.as_tensor(cj.UNZIGZAG, device=dev)].reshape(
            -1, 8, 8).contiguous()
        counts_ = [c["coef"].shape[0] for img in coded for c in img.comps]
        q = torch.as_tensor(np.stack(
            [img.qtabs[c["tq"]] for img in coded for c in img.comps]
        ).astype(np.float32), device=dev)
        qb = q[torch.repeat_interleave(
            torch.arange(len(counts_), device=dev),
            torch.as_tensor(counts_, device=dev))].contiguous()
        nblk = zz.shape[0]
        idct_ms = (cuda_ms(lambda: cj._idct(zz, qb), 5, 1)
                   if dev.type == "cuda" else 0.0) / len(coded)
        bound_ms = (nblk * 64 * (4 + 1) / HBM_BYTES_PER_S * 1e3
                    / len(coded))
        transform_ms = (cuda_ms(lambda: cj.decode_transform(coded, dev), 3, 1)
                        if dev.type == "cuda" else 0.0) / len(coded)
        del zz, qb
        pipe = parse_launch(JPEG_DECODE.format(pat=pattern), batch=batch,
                            device=dev)
        pipe.set_state("playing")
        wall, busy, idle = traced(
            lambda: ingest_pass(pipe, pipe.get_by_name("out"), dev), dev)
        pipe.set_state("null")
        print(f"e2e ingest_jpeg [{sname}: {files} {w}x{h} {fmt} JPEGs, "
              f"quality {JPEG_QUALITY}, batch {batch}]: "
              f"{files / secs:.1f} frames/s ({ticks} ticks); written by "
              f"jpegenc in {enc_s:.2f} s; host entropy decode "
              f"{entropy_ms:.3f} ms an image; IDCT on the device "
              f"{idct_ms:.4f} ms an image against a byte bound of "
              f"{bound_ms:.4f} ms (int32 coefficients in, uint8 out), the "
              f"device half with its copies {transform_ms:.4f} ms an image; "
              f"traced pass {wall:.1f} ms wall, {busy:.3f} busy ms, idle "
              f"{idle:.1%}; kernel launches {counts}")
    return launches


def ml_ingest(dev, tmp):
    """examples/ml_ingest_torch.py's loop on `dev`: a finite loss."""
    import importlib.util
    import math
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "ml_ingest_torch", os.path.join(here, "examples",
                                        "ml_ingest_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    clip = os.path.join(tmp, "train.y4m")
    ex.make_dataset(clip, ML_FRAMES, dev)
    t0 = time.perf_counter()
    frames, steps, loss = ex.train(clip, ML_BATCH, dev, seed=0)
    sync(dev)
    secs = time.perf_counter() - t0
    require(frames == ML_FRAMES and steps == ML_FRAMES // ML_BATCH
            and math.isfinite(loss),
            f"ml_ingest: {frames} frames, {steps} steps, loss {loss}")
    print(f"e2e ml_ingest: {frames} frames in {steps} train steps, "
          f"{frames / secs:.1f} frames/s including the steps (first calls "
          f"included), final loss {loss:.6f}")


def ingest_phase(seed, counters, dev):
    """ingest_y4m, ingest_jpeg and ml_ingest in one temporary directory;
    returns the kernels' launches."""
    import tempfile
    launches = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory() as tmp:
        for part in (ingest_y4m, ingest_jpeg):
            for k, n in part(seed, counters, dev, tmp).items():
                launches[k] += n
        ml_ingest(dev, tmp)
    return launches


# -- the common filters and fittings ------------------------------------------

FIT_CROP = 60                    # videocrop top and bottom: 1080 -> 960 rows
FIT_BOX = 64                     # videobox's border left and right
FIT_SQUARE = (224, 224)          # the tee's two square branches
FIT_PORTRAIT = (112, 224)        # its portrait branch: the input's aspect
FIT_TEE = (SRC + "videocrop top={c} bottom={c} ! videoflip method=clockwise "
           "! videomedian ! gamma gamma=1.2 ! tee name=t "
           "t. ! queue ! videoconvertscale add-borders=false ! video/x-raw,"
           "format=RGB,width={sw},height={sh} ! appsink name=out "
           "t. ! queue2 ! videoconvertscale method=catrom add-borders=false ! "
           "video/x-raw,format=RGB,width={sw},height={sh} ! appsink "
           "name=out_cubic "
           "t. ! queue ! videoconvertscale method=catrom add-borders=false ! "
           "video/x-raw,format=RGB,width={pw},height={ph} ! appsink "
           "name=out_portrait "
           "t. ! queue ! valve drop=true ! fakesink name=drop")
FIT_SELECTOR = ("input-selector name=s active-pad=sink_1 ! videobox "
                "left=-{b} right=-{b} ! alpha method=green ! "
                "video/x-raw,format=AYUV ! appsink name=out "
                + " ".join(SRC.replace("name=in", f"name=in{k}")[:-2]
                           + f"! s.sink_{k}" for k in range(2)))
# name: (launch string, appsrc names, appsinks, batch, ticks, the route each
# converter branch takes (the plan's scale_order), launches a tick)
FITTINGS = {
    "filters_tee": (FIT_TEE, ("in",), ("out", "out_cubic", "out_portrait"),
                    64, 4, {"out": "vh", "out_cubic": "vh",
                            "out_portrait": "hv"},
                    {"yscale_hv": 1, "chroma420_scale": 2}),
    "selector_box": (FIT_SELECTOR, ("in0", "in1"), ("out",), 32, 3, {}, {}),
}


def fit_desc(name, w, h):
    c, b = FIT_CROP, FIT_BOX
    return FITTINGS[name][0].format(
        w=w, h=h, c=c, b=b, sw=FIT_SQUARE[0], sh=FIT_SQUARE[1],
        pw=FIT_PORTRAIT[0], ph=FIT_PORTRAIT[1])


def drive_sinks(desc, batch, ticks, ins, sinks, device):
    """Push `ticks` buffers of the same data into every appsrc of `ins`
    ({name: tuple of planes}) and tick the pipeline to EOS, each tick timed
    on the host clock between two synchronises.  The EOS tick flushes the
    queues that a host element (here the closed valve) makes one-tick
    double buffers, so its samples are the last entry.  Returns (pipeline,
    {sink: [samples of each tick and of the EOS tick]}, seconds per tick
    before the EOS tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    dev = torch.device(device)
    pipe = parse_launch(desc, batch=batch, device=dev)
    for name, data in ins.items():
        src = pipe.get_by_name(name)
        for t in range(ticks):
            src.push_buffer(Buffer(data=data, pts=t * batch * DUR,
                                   duration=DUR, batch=batch))
        src.end_of_stream()
    pipe.set_state(State.PLAYING)
    outs, secs = {s: [] for s in sinks}, []
    while True:
        sync(dev)
        t0 = time.perf_counter()
        more = pipe.tick()
        sync(dev)
        if more:
            secs.append(time.perf_counter() - t0)
        for s in sinks:
            outs[s].append(drain(pipe.get_by_name(s)))
        if not more:
            break
    pipe.set_state(State.NULL)
    return pipe, outs, secs


def converter_of(pipe, sink):
    """The videoconvertscale feeding `sink` through its capsfilter."""
    up = pipe.get_by_name(sink).sink_pads()[0].peer.element
    return up.sink_pads()[0].peer.element._converter


def fittings_inputs(name, host, rng, batch):
    """{appsrc: host planes}: the tee takes the seed's 1080p frames, the
    selector two sets of seeded frames (sink_1's the active one)."""
    import numpy as np
    if name == "filters_tee":
        return {"in": tuple(p[:batch] for p in host)}
    return {f"in{k}": tuple(rng.integers(0, 256, p[:batch].shape,
                                         dtype=np.uint8) for p in host)
            for k in range(2)}


def smi_line():
    """nvidia-smi's name and power limit of the card as one line, or None
    when it prints nothing."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return out[0] if out else None


def fittings_phase(seed, counters, dev, host, w=W, h=H):
    """The slice's path at full width, through the port's parse_launch on
    the card with the launch counts zeroed just before each path and read
    just after (FITTINGS): filters_tee (videocrop, videoflip, videomedian,
    gamma and a four-way tee at batch 64; its portrait branch runs yscale
    and chroma420 on the cropped, rotated plane, each also held to its plain
    version at that shape; the closed valve's sink gets nothing) and
    selector_box (input-selector, videobox's borders and alpha's green key
    into AYUV at batch 32).  Every branch's first frames equal the port's
    CPU path; the tee runs once more under GTPU_TRACERS="stats;latency" and
    GTPU_DEBUG_DUMP_DOT_DIR with the same bytes, the dot file written and
    every buffer counted.  Prints frames/s, device busy ms and idle share
    and peak memory beside the card's name and power limit; returns
    ({kernel: launches}, {kernel: largest difference from its plain
    version})."""
    import tempfile

    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    from gstreamer_tpu_torch.core.tracer import hooks
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    rng = np.random.default_rng(seed + 5)
    total = {k: 0 for k in counters}
    err = {}
    card = (smi_line() or "nvidia-smi printed nothing") \
        if dev.type == "cuda" else "CPU rehearsal"
    for name, (_, srcs, sinks, batch, ticks, order, per_tick) in \
            FITTINGS.items():
        desc = fit_desc(name, w, h)
        host_ins = fittings_inputs(name, host, rng, batch)
        ins = {k: tuple(torch.as_tensor(p).to(dev) for p in v)
               for k, v in host_ins.items()}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        pipe, outs, secs = drive_sinks(desc, batch, ticks, ins, sinks, dev)
        counts = {k: c.launches for k, c in counters.items()}
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else 0)
        want = {k: per_tick.get(k, 0) * ticks for k in counters}
        require(counts == want, f"{name}: launches {counts}, want {want}")
        for k, n in counts.items():
            total[k] += n
        got_order = {s: converter_of(pipe, s).plan["scale_order"]
                     for s in order}
        require(got_order == order, f"{name}: routes {got_order}, want "
                f"{order}")
        for s in sinks:
            frames = sum(x.buffer.batch for tick in outs[s] for x in tick)
            require(frames == batch * ticks,
                    f"{name}: {s} got {frames} frames, want {batch * ticks}")
        if name == "filters_tee":
            require(pipe.get_by_name("drop").n_rendered == 0,
                    "filters_tee: the closed valve let buffers through")
        firsts = {s: next(x for tick in outs[s] for x in tick)
                  for s in sinks}
        n = CPU_FRAMES
        cpu_ins = {k: tuple(p[:n] for p in v) for k, v in host_ins.items()}
        _, cpu, _ = drive_sinks(desc, n, 1, cpu_ins, sinks, "cpu")
        for s in sinks:
            ref = next(x for tick in cpu[s] for x in tick)
            first = firsts[s]
            require(first.buffer.pts == ref.buffer.pts
                    and str(first.caps) == str(ref.caps),
                    f"{name}: {s}'s first sample's pts/caps differ from the "
                    f"CPU run")
            for o, r in zip(first.buffer.data, ref.buffer.data):
                require(o.device.type == dev.type and o.dtype == torch.uint8,
                        f"{name}: {s} output {o.dtype} on {o.device}")
                require(torch.equal(o[:n].cpu(), r),
                        f"{name}: {s} differs from the port's CPU path")
        if name == "filters_tee":
            # the kernels at the portrait branch's shapes, on the cropped
            # and rotated input planes
            plan = converter_of(pipe, "out_portrait").plan
            hr, vr = plan["h_res"], plan["v_res"]
            crops = (FIT_CROP, FIT_CROP // 2, FIT_CROP // 2)
            y, u, v = (p[:, c:p.shape[1] - c].flip(-2).transpose(-1, -2)
                       .contiguous() for c, p in zip(crops, ins["in"]))
            err["yscale_hv"] = max_err([ysk.yscale_hv(y, hr, vr)],
                                       [ysk.yscale_hv_plain(y, hr, vr)],
                                       "yscale_hv")
            cargs = (hr, vr, plan["up_h_cosited"], plan["up_v_cosited"])
            err["chroma420_scale"] = max_err(
                [ck.chroma420_scale(c, *cargs, y.shape[-1], y.shape[-2])
                 for c in (u, v)],
                [ck.chroma420_scale_plain(c, *cargs) for c in (u, v)],
                "chroma420_scale")
            for kname, e in err.items():
                require(e == 0, f"{name}: {kname} differs from its plain "
                        f"version by up to {e} at the portrait shape")
            check = (f"yscale_hv and chroma420_scale == plain at "
                     f"{tuple(y.shape)} -> {(vr.out_size, hr.out_size)}")
            del y, u, v
            # once more with two tracers and the dot dump: the same bytes
            with tempfile.TemporaryDirectory() as tmp, switches(
                    GTPU_TRACERS="stats;latency",
                    GTPU_DEBUG_DUMP_DOT_DIR=tmp):
                hooks.reset()
                try:
                    tpipe, touts, tsecs = drive_sinks(desc, batch, ticks,
                                                      ins, sinks, dev)
                    rep = hooks.reports()
                finally:
                    hooks.reset()
                dot = os.path.join(tmp, f"{tpipe.name}.dot")
                require(os.path.exists(dot) and "valve" in open(dot).read(),
                        f"{name}: no dot file {dot}")
            stats = rep.get("stats", {})
            require(stats.get("ticks") == ticks and all(
                stats["frames"].get(s) == batch * ticks for s in sinks)
                and "drop" not in stats["frames"]
                and set(rep.get("latency", {})) == set(sinks),
                f"{name}: tracer reports {rep}")
            for s in sinks:
                again = next(x for tick in touts[s] for x in tick)
                require(all(torch.equal(a, b) for a, b in zip(
                    again.buffer.data, firsts[s].buffer.data)),
                    f"{name}: {s} changed under the tracers")
            del touts
            check += (f"; traced run: same bytes, dot written, stats "
                      f"frames { {s: stats['frames'][s] for s in sinks} }, "
                      f"{[round(t * 1e3, 3) for t in tsecs]} ms per tick "
                      f"(untraced {[round(t * 1e3, 3) for t in secs]})")
        else:
            # the active pad's frames inside videobox's borders
            b = FIT_BOX
            y = firsts["out"].buffer.data[0]
            require(torch.equal(y[:, :, b:-b], ins["in1"][0])
                    and bool((y[:, :, :b] == 16).all()),
                    f"{name}: luma is not sink_1's frames in black borders")
            check = "luma == sink_1's frames inside the borders"
        print(f"fittings {name}: batch {batch}, {ticks} ticks, "
              f"{'fused' if pipe._fused else 'per-element'}; routes "
              f"{got_order}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; CUDA == port "
              f"CPU path ({n} frames) on {list(sinks)}; {check}")
        pipe_order = pipe._order
        del outs, firsts, pipe

        prof = parse_launch(desc, batch=batch, device=dev)
        prof.set_state(State.PLAYING)

        def tick():
            for k, v in ins.items():
                prof.get_by_name(k).push_buffer(Buffer(data=v, batch=batch))
            prof.tick()
            for s in sinks:
                drain(prof.get_by_name(s))
        if dev.type == "cuda":
            _, busy, idle, _ = device_time(tick, 3)
        else:
            busy, idle = 0.0, 1.0
        prof.set_state(State.NULL)
        # the first tick makes first calls; where a host element turns the
        # queues into one-tick double buffers, the elements after them make
        # theirs in the second
        warm = 2 if any(getattr(e, "_decouple", False)
                        for e in pipe_order) else 1
        timed = sum(secs[warm:])
        print(f"e2e {name}: {batch * (ticks - warm) / timed:.1f} input "
              f"frames/s over ticks {warm + 1}..{ticks} "
              f"({[round(s * 1e3, 3) for s in secs]} ms per tick, host "
              f"clock between synchronises); device busy {busy:.3f} ms a "
              f"tick, idle share {idle:.3f}; peak device memory "
              f"{peak / 2**30:.2f} GiB; {card}")
        del ins, prof
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return total, err


# -- overlays and the device video effects ------------------------------------

OVL_QR = "tpu-media burn-in 0001"      # qroverlay's payload
OVL_LOGO = (96, 160)                     # the logo PNG: height, width (RGBA)
OVL_SVG = ("<svg width='320' height='120'><rect x='8' y='8' width='150' "
           "height='60' fill='#ff0000' stroke='blue' stroke-width='4'/>"
           "<circle cx='240' cy='60' r='40' fill='#00ff00'/>"
           "<text x='20' y='100' fill='white'>tpu-media</text></svg>")
BURNIN = (SRC + "timeoverlay name=stamp ! qroverlay data=\"{qr}\" pixel-size=4 ! "
          "gdkpixbufoverlay location={png} offset-x=-32 offset-y=-32 ! "
          "videoconvertscale method=catrom add-borders=false ! video/x-raw,"
          "format=RGB,width={ow},height={oh} ! appsink name=out")
RAW = ("appsrc name=in caps=video/x-bayer,format={fmt},width={w},height={h},"
       "framerate=30/1 ! bayer2rgb ! videoconvertscale add-borders=false ! "
       "video/x-raw,format=RGB,width={ow},height={oh} ! appsink name=out")
RAW_ROUND = ("appsrc name=in caps=video/x-bayer,format={fmt},width={w},"
             "height={h},framerate=30/1 ! bayer2rgb ! video/x-raw,format=ARGB "
             "! rgb2bayer ! video/x-bayer,format={fmt} ! appsink name=out")
AUGMENT = (SRC + "videoconvertscale ! video/x-raw,format=AYUV ! rotate "
           "angle=0.3 ! gaussianblur sigma=1.2 ! coloreffects preset=sepia ! "
           "videoconvertscale method=catrom add-borders=false ! video/x-raw,"
           "format=RGB,width={ow},height={oh} ! appsink name=out")
# name: (launch string, bayer format or None, batch, ticks, launches a tick)
OVERLAY_PATHS = {
    "burnin": (BURNIN, None, 64, 3, {"yscale_hv": 1, "chroma420_scale": 2}),
    "camera_raw_rggb": (RAW, "rggb", 64, 3, {}),
    "camera_raw_rggb16le": (RAW, "rggb16le", 64, 3, {}),
    "augment": (AUGMENT, None, 32, 3, {}),
}
OVL_ALONE = (2, 4)               # ticks and frames a tick of each factory
GEOMETRIC = ("bulge", "circle", "diffuse", "fisheye", "kaleidoscope",
             "marble", "mirror", "perspective", "pinch", "rotate", "sphere",
             "square", "stretch", "tunnel", "twirl", "waterripple")
# each factory alone: (its string, the input: a video format, "bayer",
# "text", "png" or "svg")
OVL_FACTORIES = (
    [("coloreffects preset=xpro", "AYUV"), ("chromahold", "AYUV"),
     ("burn", "RGBx"), ("chromium", "BGRA"), ("dilate", "BGRx"),
     ("dodge", "RGBA"), ("exclusion", "RGBx"), ("gaussianblur", "AYUV"),
     ("solarize", "RGBx")]
    + [(f"{g} off-edge-pixels={('ignore', 'clamp', 'wrap')[k % 3]}",
        ("AYUV", "ARGB", "BGRA", "ABGR", "RGBA")[k % 5])
       for k, g in enumerate(GEOMETRIC)]
    + [("bayer2rgb", "bayer"), ("rgb2bayer", "ARGB")]
    + [("overlaycomposition name=e", "I420"),
       ("textoverlay text=\"tpu-media\" shaded-background=true", "NV12"),
       ("timeoverlay halignment=right", "I420"),
       ("clockoverlay", "AYUV"), ("textrender", "text"),
       ("gdkpixbufdec", "png"),
       ("gdkpixbufoverlay location={png} alpha=0.7", "RGBA"),
       ("cairooverlay name=e", "RGB"),
       ("qroverlay data=\"{qr}\" x=10 y=90", "Y444"),
       ("debugqroverlay name=e span-buffer=3", "I420"),
       ("gdkpixbufsink name=out", "RGB"), ("rsvgdec", "svg"),
       ("rsvgoverlay location={svg} fit-to-frame=true", "BGRx")])


def drive_bufs(desc, bufs, device, batch, setup=None):
    """parse_launch(desc) on `device`, `setup(pipeline)` where given, push
    `bufs` (Buffer keyword dicts) into appsrc "in" and tick to EOS, each
    tick timed on the host clock between two synchronises.  Returns
    (pipeline, the samples of each tick from appsink "out", seconds per
    tick)."""
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    dev = torch.device(device)
    pipe = parse_launch(desc, batch=batch, device=dev)
    if setup is not None:
        setup(pipe)
    src = pipe.get_by_name("in")
    for b in bufs:
        src.push_buffer(Buffer(**b))
    src.end_of_stream()
    sink = pipe.get_by_name("out")
    pipe.set_state(State.PLAYING)
    outs, secs = [], []
    while True:
        sync(dev)
        t0 = time.perf_counter()
        more = pipe.tick()
        sync(dev)
        if not more:
            break
        secs.append(time.perf_counter() - t0)
        outs.append(drain(sink) if hasattr(sink, "pull_sample") else [])
    pipe.set_state(State.NULL)
    return pipe, outs, secs


@contextlib.contextmanager
def fixed_localtime():
    """time.localtime pinned inside the block, so that clockoverlay draws
    the same text on the card and on the CPU."""
    real = time.localtime
    stamp = real(1_700_000_000)
    time.localtime = lambda *a: stamp
    try:
        yield
    finally:
        time.localtime = real


def overlay_setup(factory):
    """The callbacks overlaycomposition and cairooverlay take from an
    application, or None: a composition a buffer (a scaled, clipped,
    translucent rectangle, a premultiplied one every other buffer) and a
    drawing a frame."""
    import numpy as np
    from gstreamer_tpu_torch.video.overlay import (VideoOverlayComposition,
                                                   VideoOverlayRectangle)
    px = np.random.default_rng(7).integers(0, 256, (120, 200, 4),
                                           dtype=np.uint8)
    if factory == "overlaycomposition":
        def setup(pipe):
            e = pipe.get_by_name("e")
            e.composition = VideoOverlayComposition([VideoOverlayRectangle(
                px, render_x=-50, render_y=900, render_width=400,
                render_height=240, global_alpha=0.7)])
            e.draw = lambda buf: (VideoOverlayComposition([
                VideoOverlayRectangle(px, render_x=1800, render_y=20,
                                      premultiplied=True)])
                if buf.pts % 2 else None)
        return setup
    if factory == "cairooverlay":
        def draw(surface, pts, dur):
            k = pts // DUR
            surface[100 + 10 * k:300, 200:600 + 20 * k] = (255, 40, 0, 160)
        return lambda pipe: setattr(pipe.get_by_name("e"), "draw", draw)
    return None


def alone_inputs(kind, rng, w, h, frame_png):
    """Host buffers for one factory alone: OVL_ALONE's ticks of frames of a
    video format (seeded), of a bayer mosaic, or of texts / encoded w x h
    images (each a frame)."""
    import numpy as np
    from gstreamer_tpu_torch.video.info import VideoInfo
    ticks, n = OVL_ALONE
    if kind in ("text", "png", "svg"):
        blob = {"png": lambda: frame_png,
                "svg": lambda: OVL_SVG.replace(
                    "width='320' height='120'",
                    f"width='{w}' height='{h}'").encode(),
                "text": lambda: None}[kind]()
        return [dict(data=[blob or f"frame {t * n + k}".encode()
                           for k in range(n)], pts=t * n * DUR,
                     duration=DUR, batch=n) for t in range(ticks)]
    if kind == "bayer":
        data = [rng.integers(0, 256, (n, h, w), dtype=np.uint8)
                for _ in range(ticks)]
    else:
        info = VideoInfo(format=kind, width=w, height=h)
        data = [tuple(rng.integers(0, 256, (n,) + s, dtype=np.uint8)
                      for s in info.plane_shapes()) for _ in range(ticks)]
    return [dict(data=d, pts=t * n * DUR, duration=DUR, batch=n)
            for t, d in enumerate(data)]


def alone_desc(factory, kind, w, h, png, svg):
    if kind == "bayer":
        head = (f"appsrc name=in caps=video/x-bayer,format=rggb,width={w},"
                f"height={h},framerate=30/1 ! ")
    elif kind == "text":
        head = "appsrc name=in ! text/x-raw,format=utf8 ! "
    elif kind == "png":
        head = "appsrc name=in ! image/png ! "
    elif kind == "svg":
        head = "appsrc name=in ! image/svg+xml ! "
    else:
        head = (f"appsrc name=in caps=video/x-raw,format={kind},width={w},"
                f"height={h},framerate=30/1 ! ")
    tail = {"textrender": f" ! video/x-raw,format=ARGB,width={w},"
                          f"height={h} ! appsink name=out",
            "gdkpixbufsink": ""}.get(factory.split()[0],
                                     " ! appsink name=out")
    return head + factory.format(png=png, svg=svg, qr=OVL_QR) + tail


def on_device(bufs, dev):
    import torch

    def put(x):
        return torch.as_tensor(x).to(dev) if hasattr(x, "dtype") else x
    out = []
    for b in bufs:
        d = b["data"]
        d = tuple(put(x) for x in d) if isinstance(d, tuple) else (
            d if isinstance(d, list) else put(d))
        out.append(dict(b, data=d))
    return out


def write_logo(tmp, rng):
    """The burn-in logo: a seeded RGBA PNG of OVL_LOGO's size in `tmp`,
    written by the port's PNG encoder; returns its path."""
    import numpy as np
    from gstreamer_tpu_torch.codecs.png import png_encode
    png = os.path.join(tmp, "logo.png")
    with open(png, "wb") as f:
        f.write(png_encode(rng.integers(0, 256, OVL_LOGO + (4,),
                                        dtype=np.uint8)))
    return png


def overlay_path(name, png, host, rng, w=W, h=H):
    """OVERLAY_PATHS' `name` at w x h: (launch string, host data of one
    tick: I420 planes or a Bayer mosaic)."""
    import numpy as np
    tmpl, fmt, batch, _, _ = OVERLAY_PATHS[name]
    desc = tmpl.format(w=w, h=h, ow=OW, oh=OH, png=png, qr=OVL_QR, fmt=fmt)
    if fmt is None:
        return desc, tuple(p[:batch] for p in host)
    top = 256 if fmt == "rggb" else 65536
    return desc, rng.integers(0, top, (batch, h, w)).astype(
        np.uint8 if top == 256 else np.uint16)


def overlays_phase(seed, counters, dev, host, w=W, h=H):
    """The overlays and the device video effects at full width, each path
    with the launch counts zeroed just before it and read just after
    (OVERLAY_PATHS): burnin (timeoverlay ! qroverlay ! gdkpixbufoverlay
    on 1080p I420, then the catrom converter to RGB 224x224: yscale once
    and chroma420 twice a tick), camera_raw (bayer2rgb at 8 and 16 bits,
    then the converter's generic route; the 8-bit mosaic also through
    bayer2rgb ! ARGB ! rgb2bayer, equal to itself at every site) and
    augment (rotate ! gaussianblur ! coloreffects on AYUV between two
    converters).  Each tick's first frames equal the port's CPU path (for
    burnin with the buffer's duration scaled, so each frame's stamp is the
    same).  Then each of the 27 effect and 13 overlay factories alone on
    OVL_ALONE's ticks of 1080p frames (texts, a PNG, an SVG for the
    renderers and decoders): the card's samples equal the CPU path's, no
    kernel launched.  Prints frames/s, device busy ms and idle share and
    peak memory beside the card's name and power limit; returns {kernel:
    launches}."""
    import tempfile

    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.codecs.png import png_encode
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    rng = np.random.default_rng(seed + 6)
    total = {k: 0 for k in counters}
    card = (smi_line() or "nvidia-smi printed nothing") \
        if dev.type == "cuda" else "CPU rehearsal"
    n = CPU_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        png = write_logo(tmp, rng)
        svg = os.path.join(tmp, "logo.svg")
        with open(svg, "w") as f:
            f.write(OVL_SVG)
        # the decoders' w x h image: seeded colour stripes, one a column,
        # which the PNG "Up" filter makes cheap to decode on the host
        frame_png = png_encode(np.broadcast_to(
            rng.integers(0, 256, (1, w, 3), dtype=np.uint8), (h, w, 3)))
        for name, (_, fmt, batch, ticks, per_tick) in OVERLAY_PATHS.items():
            desc, data = overlay_path(name, png, host, rng, w, h)
            ins = on_device([dict(data=data)], dev)[0]["data"]
            bufs = [dict(data=ins, pts=t * batch * DUR, duration=DUR,
                         batch=batch) for t in range(ticks)]
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            pipe, outs, secs = drive_bufs(desc, bufs, dev, batch)
            counts = {k: c.launches for k, c in counters.items()}
            peak = (torch.cuda.max_memory_allocated()
                    if dev.type == "cuda" else 0)
            want = {k: per_tick.get(k, 0) * ticks for k in counters}
            require(counts == want, f"{name}: launches {counts}, want {want}")
            for k, v in counts.items():
                total[k] += v
            require([[s.buffer.batch for s in o] for o in outs]
                     == [[batch]] * ticks, f"{name}: samples per tick")
            # the CPU path on each tick's first frames, at the same pts;
            # timeoverlay stamps frame k at pts + k * duration // batch
            cut = (tuple(p[:n] for p in data) if fmt is None
                   else data[:n])
            dur = n * (DUR // batch) if "timeoverlay" in desc else DUR
            _, cpu, _ = drive_bufs(desc, [dict(b, data=cut, duration=dur,
                                               batch=n) for b in bufs],
                                   "cpu", n)
            for t, (o, c) in enumerate(zip(outs, cpu)):
                require(o[0].buffer.pts == c[0].buffer.pts
                        and str(o[0].caps) == str(c[0].caps),
                        f"{name}: tick {t} pts/caps differ from the CPU run")
                for x, y in zip(o[0].buffer.data, c[0].buffer.data):
                    require(x.device.type == dev.type
                            and torch.equal(x[:n].cpu(), y),
                            f"{name}: tick {t} differs from the port's CPU "
                            f"path")
            check = f"CUDA == port CPU path ({n} frames of each tick)"
            if name == "burnin":
                first = Buffer(**bufs[0])
                stamps = {pipe.get_by_name("stamp")._text_for_frame(first, k)
                          for k in range(batch)}
                check += f"; {len(stamps)} distinct time stamps a tick"
            if fmt == "rggb":
                rdesc = RAW_ROUND.format(w=w, h=h, fmt=fmt)
                _, rt, _ = drive_bufs(rdesc, bufs[:1], dev, batch)
                require(torch.equal(rt[0][0].buffer.data, ins),
                        f"{name}: rgb2bayer(bayer2rgb(x)) != x")
                check += "; bayer2rgb ! ARGB ! rgb2bayer == the mosaic"
                del rt
            print(f"overlays {name}: batch {batch}, {ticks} ticks, "
                  f"{'fused' if pipe._fused else 'per-element'}; launches "
                  f"{ {k: v for k, v in counts.items() if v} or 'none'}; "
                  f"{check}")
            del outs, cpu, pipe

            prof = parse_launch(desc, batch=batch, device=dev)
            prof.set_state(State.PLAYING)
            tick_no = [0]

            def tick():
                prof.get_by_name("in").push_buffer(Buffer(
                    data=ins, pts=tick_no[0] * batch * DUR, duration=DUR,
                    batch=batch))
                tick_no[0] += 1
                prof.tick()
                drain(prof.get_by_name("out"))
            if dev.type == "cuda":
                _, busy, idle, _ = device_time(tick, 3)
            else:
                busy, idle = 0.0, 1.0
            prof.set_state(State.NULL)
            print(f"e2e {name}: {batch * (ticks - 1) / sum(secs[1:]):.1f} "
                  f"input frames/s over ticks 2..{ticks} "
                  f"({[round(s * 1e3, 3) for s in secs]} ms per tick, host "
                  f"clock between synchronises); device busy {busy:.3f} ms "
                  f"a tick, idle share {idle:.3f}; peak device memory "
                  f"{peak / 2**30:.2f} GiB; {card}")
            del ins, bufs, prof
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        # -- each factory alone: the card's samples equal the CPU path's ---
        checked = []
        for factory, kind in OVL_FACTORIES:
            fname = factory.split()[0]
            desc = alone_desc(factory, kind, w, h, png, svg)
            host_bufs = alone_inputs(kind, rng, w, h, frame_png)
            setup = overlay_setup(fname)
            for c in counters.values():
                c.launches = 0
            with fixed_localtime():
                pipe, on_card, _ = drive_bufs(desc, on_device(host_bufs, dev),
                                              dev, OVL_ALONE[1], setup)
                counts = {k: c.launches for k, c in counters.items()}
                cpipe, on_cpu, _ = drive_bufs(desc, host_bufs, "cpu",
                                              OVL_ALONE[1], setup)
            require(not any(counts.values()), f"{fname}: kernels {counts}")
            if fname == "gdkpixbufsink":
                got = [m.data["pixbuf"] for p in (pipe, cpipe)
                       for m in iter(p.bus.pop, None)
                       if m.type == "element"
                       and m.data.get("name") == "pixbuf"]
                half = len(got) // 2
                require(half == OVL_ALONE[0] * OVL_ALONE[1] and all(
                    np.array_equal(a, b) for a, b in zip(got[:half],
                                                         got[half:])),
                        f"{fname}: pixbuf messages differ from the CPU run")
            else:
                require(sum(len(o) for o in on_card) == OVL_ALONE[0],
                        f"{fname}: samples per tick "
                        f"{[len(o) for o in on_card]}")
                same_samples(on_card, on_cpu, fname, dev)
            checked.append(fname)
            del pipe, cpipe, on_card, on_cpu
        require(len(checked) == 40, f"{len(checked)} factories checked")
        print(f"overlays each factory alone: CUDA == port CPU path over "
              f"{OVL_ALONE[0]} ticks of {OVL_ALONE[1]} frames at {w}x{h} "
              f"(texts, a PNG and an SVG for the renderers and decoders), no "
              f"kernel launched, for {checked}")
    return total


# -- 12. the audio DSP family ---------------------------------------------------

FP32_OPS_PER_S = 67e12          # H100 SXM data sheet, float32 outside the
#                                 tensor cores
# the latency of one dependent float32 or 32-bit integer operation on
# Hopper, in cycles (published microbenchmarks): the unit of the two
# recursions' latency bounds
DEP_CYCLES = 4
# float32 operations a frame of freeverb: 16 combs x 5, 16 sums, 8
# allpasses x 3, 4 for the input, 2 for DC, 2 x 5 for the mix
FV_FLOPS = 136
# int32-lane operations a sample of the VAD: 11 integer operations, 64-bit
# ones as two
VAD_OPS = 22
# dependent operations a sample on the VAD's chain: one multiply-high-add
VAD_CHAIN = 1
DSP_SRC = ("appsrc name=in caps=audio/x-raw,format={fmt},rate=48000,"
           "channels={ch},layout=interleaved ! ")
MUSIC_CHAIN = ("equalizer-10bands band0=3.0 band9=-3.0 ! audiodynamic "
               "ratio=0.5 threshold=0.3 ! freeverb room-size=0.6 ! "
               "audiopanorama panorama=0.3 ! rgvolume fallback-gain=-3.0 ! "
               "rglimiter ! spectrum ! level")
VOICE_CHAIN = ("removesilence remove=true squash=true ! audioamplify "
               "amplification=1.5 ! audiowsincband lower-frequency=300 "
               "upper-frequency=3400 ! audioresample ! audio/x-raw,rate=8000 "
               "! mulawenc ! mulawdec")
DSP_PATHS = {
    # name: (format, channels, chain, frames a push, pushes, its kernel,
    #        frames a push and pushes of the card-against-CPU check)
    "music_master": ("F32LE", 2, MUSIC_CHAIN, 480000, 3, "freeverb", 4800, 3),
    "voice_chain": ("S16LE", 1, VOICE_CHAIN, 960, 250, "vad_power", 960,
                    100),
}
FV_RATES = (1, 1000, 8000, 44100, 48000, 96000, 192000, 384000, 768000)
FV_CHECK = 4800                 # frames of freeverb's check's first push
FV_ODD = 777                    # and of its second: no multiple of a block
VAD_CHECK = (4, 24000)          # streams, samples a push of the VAD's, 2
VAD_P0 = (0, 5, 2**32, 2**33 - 1, 2**40, 2**62)   # carried powers
VAD_LENGTHS = (1, 7, 960, 24000)
# the times of the kernels these versions replace (freeverb one warp a
# stream, the VAD one thread a stream; a call back to back on an H100 80GB
# HBM3, 700 W): {(kernel, frames a push): ms}
PREVIOUS_MS = {("freeverb", "4800"): 0.9478,
               ("freeverb", "480000"): 92.9153, ("vad_power", "960"): 0.0337}
DSP_ALONE = 4800                # frames a push of each factory alone, 2
DSP_FACTORIES = (               # (chain, format, channels)
    ("mulawenc", "S16LE", 2), ("mulawdec", "mulaw", 2),
    ("alawenc", "S16LE", 2), ("alawdec", "alaw", 2),
    ("audioamplify amplification=1.5 clipping-method=none", "S16LE", 2),
    ("audioinvert degree=0.3", "S16LE", 2),
    ("audiokaraoke level=0.7", "F32LE", 2),
    ("audioecho delay=5000000 intensity=0.5 feedback=0.3", "F32LE", 2),
    ("audiodynamic ratio=0.5 threshold=0.3", "S16LE", 2),
    ("spectrum bands=64 interval=20000000", "F32LE", 2),
    ("level interval=20000000", "S16LE", 2),
    ("equalizer-3bands band0=6.0", "F32LE", 2),
    ("equalizer-10bands band0=3.0 band9=-3.0", "S16LE", 2),
    ("equalizer-nbands num-bands=5", "F32LE", 2),
    ("audiopanorama panorama=-0.4", "S16LE", 1),
    ("audiowsinclimit cutoff=4000", "F32LE", 2),
    ("audiowsincband lower-frequency=300 upper-frequency=3400", "S16LE", 1),
    ("audiofirfilter", "F32LE", 2), ("audioiirfilter", "F32LE", 2),
    ("audiocheblimit cutoff=4000", "F32LE", 2),
    ("audiochebband lower-frequency=500 upper-frequency=3000", "F32LE", 2),
    ("stereo stereo=0.5", "S16LE", 2), ("rganalysis", "S16LE", 2),
    ("rgvolume fallback-gain=-3.0", "F32LE", 2), ("rglimiter", "F32LE", 2),
    ("removesilence remove=true silent=false", "S16LE", 1),
    ("freeverb", "F32LE", 2), ("cutter", "S16LE", 2),
    ("scaletempo rate=1.5", "F32LE", 2), ("pitch pitch=1.2", "F32LE", 2),
    ("bs2b", "F32LE", 2))


def dsp_signal(fmt, ch, frames, pushes, rng):
    """A path's pushes, seeded: F32 two detuned tones under noise (peaks
    above -6 dBFS, so the limiter works); S16 mono one second of
    speech-band tones and noise and one second near silence in turns, so
    the VAD drops and squashes buffers; a coded format random bytes."""
    import numpy as np
    n = frames * pushes
    t = np.arange(n) / 48000.0
    if fmt in ("mulaw", "alaw"):
        x = rng.integers(0, 256, (n, ch), dtype=np.uint8)
    elif fmt == "F32LE":
        x = (0.25 * rng.standard_normal((n, ch)) + 0.3 * np.sin(
            2 * np.pi * np.array([220.0, 331.0])[:ch] * t[:, None])
             ).astype(np.float32)
    else:
        speech = sum(np.sin(2 * np.pi * f * t) for f in (310, 870, 2400)) \
            * 5000 + rng.standard_normal(n) * 800
        quiet = rng.standard_normal(n) * 3
        x = np.where((np.arange(n) // 48000) % 2 == 0, speech, quiet)
        x = np.repeat(x[:, None], ch, axis=1).astype(np.int16)
    return np.split(x, pushes)


def dsp_desc(fmt, ch, chain):
    src = (DSP_SRC.format(fmt=fmt, ch=ch) if fmt not in ("mulaw", "alaw")
           else f"appsrc name=in caps=audio/x-{fmt},rate=48000,"
                f"channels={ch} ! ")
    return src + chain + " ! appsink name=out"


def dsp_bufs(arrays, frames):
    dur = frames * 10**9 // 48000
    return [dict(data=a, pts=t * dur, duration=dur)
            for t, a in enumerate(arrays)]


def bus_messages(pipe):
    """The element and tag messages a run posted: (type, data)."""
    return [(m.type, m.data) for m in iter(pipe.bus.pop, None)
            if m.type in ("element", "tag")]


def sm_clock_hz():
    """The card's maximum SM clock from nvidia-smi, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    require(bool(out), "nvidia-smi printed no SM clock")
    return float(out[0]) * 1e6


def check_dsp_kernels(rng, dev):
    """Each recursion's kernel against its plain version on the same inputs
    (the plain version on CPU copies), bit for bit: freeverb at FV_RATES,
    mono and stereo, a push of FV_CHECK frames and one of FV_ODD with the
    state carried (outputs and the final rings, indices and filterstores;
    every schedule the layout derives: blocks of 1 frame at lag 1 and 2,
    blocks of 12 to 512, all rings in shared memory to 48 kHz, the
    allpasses to 384 kHz, none at 768 kHz); the main path's push (480 000
    frames of 48 kHz stereo) in one launch against 100 launches of 4800
    frames with the state carried (outputs and state), and on its first
    FV_CHECK frames against the plain version; the kernel's own schedule
    (gst_freeverb_schedule) equal to its Python mirror at every rate; the
    VAD from VAD_P0 at VAD_LENGTHS, and on VAD_CHECK's streams over two
    pushes.  Returns {kernel: max abs error}."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import freeverb_kernel as fvk
    from gstreamer_tpu_torch.ops import vad_kernel as vk
    prm = fvk.params(0.6, 0.2, 1.0, 0.5)
    err = {"freeverb": 0.0, "vad_power": 0}

    def same(k, p, what):
        require(k.shape == p.shape and torch.equal(
            k.view(torch.int32), p.view(torch.int32)),
                f"freeverb: {what}: the kernel differs from its plain version")
        err["freeverb"] = max(err["freeverb"], float((k - p).abs().max()))

    paths = {}
    for rate in FV_RATES:
        sizes = fvk.ring_sizes(rate)
        for ch in (1, 2):
            kst = fvk.fresh_state(1, sizes, dev)
            pst = fvk.fresh_state(1, sizes, "cpu")
            for frames in (FV_CHECK, FV_ODD):
                x = torch.from_numpy((rng.standard_normal((1, frames, ch))
                                      * 0.3).astype(np.float32))
                same(fvk.freeverb(x.to(dev), kst, sizes, prm).cpu(),
                     fvk.freeverb_plain(x, pst, sizes, prm),
                     f"{rate} Hz, {ch} ch, {frames} frames")
            for key in ("rings", "idx", "fs"):
                require(torch.equal(kst[key].cpu(), pst[key]),
                        f"freeverb at {rate} Hz: state {key} differs")
        sc = fvk.schedule(sizes)
        require(fvk.kernel_schedule(sizes) == sc,
                f"freeverb at {rate} Hz: the kernel's schedule "
                f"{fvk.kernel_schedule(sizes)} differs from its mirror {sc}")
        paths[rate] = (f"block {sc['block']} lag {sc['lag']} chunk "
                       f"{sc['chunk']}, rings in shared memory: "
                       + ("all", "the allpasses", "none")[2 - sc["shared"]])
    sizes = fvk.ring_sizes(48000)
    x = torch.from_numpy((rng.standard_normal((1, 480000, 2)) * 0.3)
                         .astype(np.float32)).to(dev)
    one = fvk.fresh_state(1, sizes, dev)
    k = fvk.freeverb(x, one, sizes, prm)
    many = fvk.fresh_state(1, sizes, dev)
    parts = [fvk.freeverb(c.contiguous(), many, sizes, prm)
             for c in x.split(4800, dim=1)]
    bits = {"rings": torch.int32, "idx": torch.int32, "fs": torch.int32}
    require(len(parts) == 100 and torch.equal(
        k.view(torch.int32), torch.cat(parts, dim=1).view(torch.int32))
            and all(torch.equal(one[key].view(t), many[key].view(t))
                    for key, t in bits.items()),
            "freeverb: the main path's push in one launch differs from 100 "
            "launches of 4800 frames")
    p = fvk.freeverb_plain(x[:, :FV_CHECK].cpu(),
                           fvk.fresh_state(1, sizes, "cpu"), sizes, prm)
    same(k[:, :FV_CHECK].cpu(), p, "the main path's push")
    del x, k, parts
    for n in VAD_LENGTHS:
        xv = torch.from_numpy((rng.standard_normal((len(VAD_P0), n)) * 12000)
                              .astype(np.int16))
        xv[0, :3] = -32768
        p0 = torch.tensor(VAD_P0, dtype=torch.int64)
        pk = vk.vad_power(xv.to(dev), p0.to(dev)).cpu()
        err["vad_power"] = max(err["vad_power"], int(
            (pk - vk.vad_power_plain(xv, p0)).abs().max()))
    s, n = VAD_CHECK
    p0 = torch.tensor([0, 7, 123456789, 2**32], dtype=torch.int64)[:s]
    pk, pp = p0.to(dev), p0
    for _ in range(2):
        xv = torch.from_numpy((rng.standard_normal((s, n)) * 9000)
                              .astype(np.int16))
        pk = vk.vad_power(xv.to(dev), pk)
        pp = vk.vad_power_plain(xv, pp)
        torch.cuda.synchronize()
        err["vad_power"] = max(err["vad_power"],
                               int((pk.cpu() - pp).abs().max()))
    require(err["vad_power"] == 0, "vad_power: the kernel differs from its "
            "plain version")
    print(f"dsp kernel vs plain (bit for bit): {err}; freeverb at {FV_RATES} "
          f"Hz, mono and stereo, pushes of {FV_CHECK} and {FV_ODD} frames "
          f"(schedules: {paths}); the main path's 480000-frame push in one "
          f"launch == 100 launches of 4800 (outputs and state), == plain on "
          f"its first {FV_CHECK} frames; vad_power from {VAD_P0} at "
          f"{VAD_LENGTHS} samples, and on {s} streams, 2 pushes of {n} "
          f"samples")
    return err


def time_dsp_kernels(rng, dev):
    """Kernel, plain version (on the card) and bounds: a call's time back
    to back (``ms``: CUDA events, as every other kernel and the previous
    kernels are timed; the wrapper's host cost where it is longer) and the
    kernel's device time (``device_ms``: graph_ms); freeverb on one
    FV_CHECK-frame push of 48 kHz stereo (the check's shape; the plain
    version's loop makes the main path's push too long to time it) and on
    the main path's 480 000-frame push; the VAD on the voice path's
    960-sample push.  The roofline bound counts the samples in and out and
    the state read and written once; the latency bound the recursion's
    dependent chain at the card's maximum SM clock."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import freeverb_kernel as fvk
    from gstreamer_tpu_torch.ops import vad_kernel as vk
    clock = sm_clock_hz()
    prm = fvk.params(0.6, 0.2, 1.0, 0.5)
    sizes = fvk.ring_sizes(48000)
    state_bytes = (sum(sizes) + fvk.N_RINGS + fvk.N_COMBS) * 4
    out = {}
    for tag, frames, iters in (("4800", FV_CHECK, 20),
                               ("480000", 480000, 3)):
        x = torch.from_numpy((rng.standard_normal((1, frames, 2)) * 0.3)
                             .astype(np.float32)).to(dev)
        st = fvk.fresh_state(1, sizes, dev)
        ms = cuda_ms(lambda: fvk.freeverb(x, st, sizes, prm), iters, 1)
        device = graph_ms(lambda: fvk.freeverb(x, st, sizes, prm), iters)
        plain = None
        if frames == FV_CHECK:
            pst = fvk.fresh_state(1, sizes, dev)
            plain = cuda_ms(lambda: fvk.freeverb_plain(x, pst, sizes, prm),
                            1, 0)
        nbytes = frames * 2 * 4 * 2 + 2 * state_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = frames * FV_FLOPS / FP32_OPS_PER_S * 1e3
        out[("freeverb", tag)] = dict(
            ms=ms, device_ms=device, plain_ms=plain, library_ms=None,
            bound=((t_bytes, "bytes", f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
                   if t_bytes >= t_ops else
                   (t_ops, "operations", "fp32 67 T ops/s")),
            latency_ms=frames * 2 * DEP_CYCLES / clock * 1e3)
    xv = torch.from_numpy((rng.standard_normal((1, 960)) * 9000)
                          .astype(np.int16)).to(dev)
    p0 = torch.zeros(1, dtype=torch.int64, device=dev)
    t_bytes = (960 * 2 + 16) / HBM_BYTES_PER_S * 1e3
    t_ops = 960 * VAD_OPS / INT32_OPS_PER_S * 1e3
    out[("vad_power", "960")] = dict(
        ms=cuda_ms(lambda: vk.vad_power(xv, p0), 50),
        device_ms=graph_ms(lambda: vk.vad_power(xv, p0), 50),
        plain_ms=cuda_ms(lambda: vk.vad_power_plain(xv, p0), 3, 1),
        library_ms=None,
        bound=((t_bytes, "bytes", f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
               if t_bytes >= t_ops else
               (t_ops, "operations", "int32 33.5 T ops/s")),
        latency_ms=960 * VAD_CHAIN * DEP_CYCLES / clock * 1e3)
    for (kname, tag), t in out.items():
        plain = ("plain not timed at this shape" if t["plain_ms"] is None
                 else f"plain {t['plain_ms']:.4f} ms")
        print(f"time {kname} [{tag} frames a push]: kernel {t['ms']:.4f} ms "
              f"a call back to back (CUDA events; the previous kernel, so "
              f"timed: {PREVIOUS_MS[(kname, tag)]:.4f} ms), "
              f"{t['device_ms']:.4f} ms on the device (a CUDA graph of the "
              f"calls), {plain}, "
              f"bound {t['bound'][0]:.6f} ms ({t['bound'][1]}, "
              f"{t['bound'][2]}), latency bound {t['latency_ms']:.4f} ms (the "
              f"dependent chain, {DEP_CYCLES} cycles an operation at "
              f"{clock / 1e6:.0f} MHz; binds: "
              f"{'latency' if t['latency_ms'] > t['bound'][0] else 'roofline'}"
              f"); library: none (no single PyTorch call)")
        require(t["device_ms"] >= max(t["bound"][0], t["latency_ms"]),
                f"{kname}: {t['device_ms']:.4f} ms reads under its bound")
    return out


def top_device_items(prof, iters, n=6):
    """The n kernels with the most device time a step: (name, ms, calls a
    step)."""
    import torch
    per: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, c = per.get(e.name, (0.0, 0))
            per[e.name] = (us + e.time_range.elapsed_us(), c + 1)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])[:n]
    return [(k[:60], round(us / iters / 1e3, 4), round(c / iters, 2))
            for k, (us, c) in ranked]


def dsp_phase(seed, counters, dev):
    """The audio DSP family on the card.  Checks each recursion's kernel
    against its plain version (check_dsp_kernels) and times both
    (time_dsp_kernels); drives each of DSP_PATHS at full width with the
    launch counts zeroed just before it and read just after (music_master:
    48 kHz stereo F32, 3 pushes of 10 s, freeverb once a push; voice_chain:
    48 kHz mono S16, 250 pushes of 20 ms, the VAD once a push), printing
    frames/s on the host clock, device busy ms and idle share with the top
    device items, and peak memory; runs each path again with its check's
    short pushes on the card and the CPU (samples and bus messages equal);
    then each of the 31 factories alone over two pushes of DSP_ALONE frames
    (card equal to the CPU, freeverb's and the VAD's kernels launched once
    a push where they run, none elsewhere).  Returns ({kernel: launches},
    {kernel: max abs error}, {(kernel, shape): timings})."""
    import numpy as np
    import torch
    from gstreamer_tpu_torch import parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    rng = np.random.default_rng(seed + 7)
    cuda = dev.type == "cuda"
    card = (smi_line() or "nvidia-smi printed nothing") if cuda \
        else "CPU rehearsal"
    err = check_dsp_kernels(rng, dev) if cuda else {}
    timings = time_dsp_kernels(rng, dev) if cuda else {}
    total = {k: 0 for k in counters}
    for name, (fmt, ch, chain, frames, pushes, kname, cframes,
               cpushes) in DSP_PATHS.items():
        desc = dsp_desc(fmt, ch, chain)
        arrays = dsp_signal(fmt, ch, frames, pushes, rng)
        bufs = on_device(dsp_bufs(arrays, frames), dev)
        base = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        pipe, outs, secs = drive_bufs(desc, bufs, dev, 1)
        counts = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() - base if cuda else 0
        want = {k: pushes if k == kname else 0 for k in counters}
        require(counts == want, f"{name}: launches {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
        got = [s for o in outs for s in o]
        require(all(torch.isfinite(s.buffer.data.float()).all()
                    for s in got), f"{name}: non-finite output")
        out_frames = sum(int(s.buffer.data.shape[0]) for s in got)
        msgs = bus_messages(pipe)
        del outs, got, bufs, pipe
        # the card against the port's CPU path on short pushes
        short = dsp_bufs(dsp_signal(fmt, ch, cframes, cpushes, rng), cframes)
        cpipe, on_card, _ = drive_bufs(desc, on_device(short, dev), dev, 1)
        hpipe, on_cpu, _ = drive_bufs(desc, short, "cpu", 1)
        same_samples(on_card, on_cpu, name, dev)
        cmsgs, hmsgs = bus_messages(cpipe), bus_messages(hpipe)
        require(cmsgs == hmsgs, f"{name}: bus messages differ from the CPU "
                f"run")
        kept = sum(len(o) for o in on_card)
        print(f"dsp {name}: {pushes} pushes of {frames} frames, "
              f"{'fused' if cpipe._fused else 'per-element'}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; {out_frames} "
              f"output frames, {len(msgs)} bus messages; CUDA == port CPU "
              f"path over {cpushes} pushes of {cframes} frames ({kept} "
              f"buffers kept, {len(cmsgs)} bus messages equal)")
        del on_card, on_cpu, cpipe, hpipe

        prof = parse_launch(desc, device=dev)
        prof.set_state(State.PLAYING)
        x = on_device(dsp_bufs(arrays[:1], frames), dev)[0]["data"]
        tick_no = [0]

        def tick():
            dur = frames * 10**9 // 48000
            prof.get_by_name("in").push_buffer(Buffer(
                data=x, pts=tick_no[0] * dur, duration=dur))
            tick_no[0] += 1
            prof.tick()
            drain(prof.get_by_name("out"))
        iters = 2 if frames > 10000 else 20
        if cuda:
            _, busy, idle, tr = device_time(tick, iters)
            top = top_device_items(tr, iters)
        else:
            busy, idle, top = 0.0, 1.0, []
        prof.set_state(State.NULL)
        timed = sum(secs[1:])
        print(f"e2e {name}: {frames * (pushes - 1) / timed:.1f} input "
              f"frames/s over pushes 2..{pushes} ({frames} frames a push, "
              f"{timed / (pushes - 1) * 1e3:.3f} ms a push on average, host "
              f"clock between synchronises); device busy {busy:.3f} ms a "
              f"push, idle share {idle:.3f}; top device items {top}; peak "
              f"device memory {peak / 2**20:.1f} MiB above the path's start "
              f"(its inputs included); {card}")
        del x, prof
        if cuda:
            torch.cuda.empty_cache()

    # -- each factory alone: the card's samples equal the CPU path's -------
    checked = []
    for chain, fmt, ch in DSP_FACTORIES:
        fname = chain.split()[0]
        desc = dsp_desc(fmt, ch, chain)
        arrays = dsp_signal(fmt, ch, DSP_ALONE, 2, rng)
        if fname == "rglimiter":
            arrays = [a * np.float32(2.0) for a in arrays]
        bufs = dsp_bufs(arrays, DSP_ALONE)
        for c in counters.values():
            c.launches = 0
        pipe, on_card, _ = drive_bufs(desc, on_device(bufs, dev), dev, 1)
        counts = {k: c.launches for k, c in counters.items() if c.launches}
        want = ({"freeverb": 2} if fname == "freeverb" else
                {"vad_power": 2} if fname == "removesilence" else {})
        require(counts == want or not cuda,
                f"{fname}: launches {counts}, want {want}")
        cpipe, on_cpu, _ = drive_bufs(desc, bufs, "cpu", 1)
        same_samples(on_card, on_cpu, fname, dev)
        require(bus_messages(pipe) == bus_messages(cpipe),
                f"{fname}: bus messages differ from the CPU run")
        checked.append(fname)
        del pipe, cpipe, on_card, on_cpu
    require(len(set(checked)) == 31, f"{len(set(checked))} factories checked")
    print(f"dsp each factory alone: CUDA == port CPU path (samples and bus "
          f"messages) over 2 pushes of {DSP_ALONE} frames, freeverb and "
          f"removesilence 2 launches of their kernel, none elsewhere, for "
          f"{checked}")
    return total, err, timings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    if args.batch < DEINT_BATCH:
        ap.error(f"--batch must be at least {DEINT_BATCH}: the launch paths "
                 "take their frames from the converter's batch")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    from gstreamer_tpu_torch import VideoConverter, VideoInfo
    from gstreamer_tpu_torch.device import resolve
    from gstreamer_tpu_torch.ops import _build
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import deint_kernel as dk
    from gstreamer_tpu_torch.ops import freeverb_kernel as fvk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    from gstreamer_tpu_torch.ops import vad_kernel as vk
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk

    torch.set_float32_matmul_precision("highest")   # yardstick: no TF32
    dev = resolve()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {_build.SOURCES}")
    for src in _build.SOURCES:
        for line in (_build.BUILD_DIR / f"{src}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # -- inputs and converters ------------------------------------------------
    b = args.batch
    ii = VideoInfo(format="I420", width=W, height=H)
    oi = VideoInfo(format="RGB", width=OW, height=OH)
    rng = np.random.default_rng(args.seed)
    host = tuple(rng.integers(0, 256, (b,) + s, dtype=np.uint8)
                 for s in ii.plane_shapes())
    planes = tuple(torch.as_tensor(p).to(dev) for p in host)
    convs = {k: VideoConverter(ii, oi, cfg) for k, cfg in CONFIGS.items()}
    lin, cub = convs["linear2"].plan, convs["cubic"].plan
    torch.cuda.synchronize()

    # -- each kernel against its plain version, at the main path's shapes ----
    err = {"yscale_hv": 0, "chroma420_scale": 0}
    for plan in (lin, cub):
        k = ysk.yscale_hv(planes[0], plan["h_res"], plan["v_res"])
        p = ysk.yscale_hv_plain(planes[0], plan["h_res"], plan["v_res"])
        torch.cuda.synchronize()
        require(k.dtype == p.dtype == torch.int16
                and tuple(k.shape) == (b, OH, OW), "yscale_hv: bad output")
        err["yscale_hv"] = max(err["yscale_hv"], int(
            (k.int() - p.int()).abs().max()))
    for c in planes[1:]:
        args_c = (cub["h_res"], cub["v_res"], cub["up_h_cosited"],
                  cub["up_v_cosited"])
        k = ck.chroma420_scale(c, *args_c, W, H)
        p = ck.chroma420_scale_plain(c, *args_c)
        torch.cuda.synchronize()
        require(k.dtype == p.dtype == torch.int32
                and tuple(k.shape) == (b, OH, OW), "chroma420: bad output")
        err["chroma420_scale"] = max(err["chroma420_scale"], int(
            (k - p).abs().max()))
    for kname, e in err.items():
        require(e == 0, f"{kname}: kernel differs from its plain version "
                f"by up to {e}")
    err["deint_both_parities"] = check_deint(planes, rng)
    err.update(check_new_kernels(planes, (lin, cub), rng))
    for check in (check_two_pass, check_h_only):
        for kname, e in check(planes, (lin, cub), rng).items():
            err[kname] = max(err[kname], e)
    print(f"kernel vs plain (bit for bit): {err}; deint at "
          f"{tuple(planes[0][:DEINT_BATCH].shape)}, "
          f"{tuple(planes[1][:DEINT_BATCH].shape)} and {DEINT_ODD}, both "
          f"methods, both parities; hscale_u8, scale_hv_u8 and "
          f"fused_i420_up_hscale at batch {b} of {W}x{H} (linear/2 and cubic "
          f"taps) and at {SMALL[:3]} -> {SMALL[3:]} (lanczos), both sitings; "
          f"yscale_hv, scale_hv_u8, chroma420_scale (four sitings), "
          f"hscale_u8 and fused_i420_up_hscale (both sitings) also "
          f"at batch {DEINT_BATCH}, at {ODD_WIDTH[:3]} -> {ODD_WIDTH[3:]} (a "
          f"width that is no multiple of 16) and on views that start off a "
          f"16-byte boundary ({SMALL[:3]} and {(SKEWED, H, W)})")

    # -- timings at the headline shapes ---------------------------------------
    timings = {}
    y_f32 = planes[0].float()
    for tag, plan in (("linear2", lin), ("cubic", cub)):
        hr, vr = plan["h_res"], plan["v_res"]
        rows = touched(vr, H)
        nbytes = b * rows * W + b * OH * OW * 2
        timings[("yscale_hv", tag)] = dict(
            ms=cuda_ms(lambda: ysk.yscale_hv(planes[0], hr, vr), 20),
            plain_ms=cuda_ms(lambda: ysk.yscale_hv_plain(planes[0], hr, vr),
                             3, 1),
            library_ms=cuda_ms(dense_pair(y_f32, hr, vr), 5, 1),
            bound=bound(nbytes, 0.0, two_pass_ops(b, rows, hr, vr)),
            taps=(hr.max_taps, vr.max_taps))
        y64 = planes[0][:DEINT_BATCH]
        print(f"time yscale_hv [{tag}] batch {DEINT_BATCH} (the launch "
              f"paths' batch; per call, host side included): "
              f"{cuda_ms(lambda: ysk.yscale_hv(y64, hr, vr), 50):.4f} ms")
    del y_f32
    hr, vr = cub["h_res"], cub["v_res"]
    args_c = (hr, vr, cub["up_h_cosited"], cub["up_v_cosited"])
    vrows = touched(vr, H)
    crow_ids = set()
    for y in np.unique(np.clip(vr.offset[:, None] + np.arange(vr.max_taps),
                               0, H - 1)):
        crow_ids.update({max(y // 2 - 1, 0), y // 2,
                         min(y // 2 + 1, H // 2 - 1)})
    nbytes = b * len(crow_ids) * (W // 2) + b * OH * OW * 4
    # the up2 filters: about 4 operations per sample of the column filter
    # (over the chroma rows read, at full width) and of the row filter (over
    # the rows the vertical taps read), four samples to an int32 lane
    dp4a_ops = (two_pass_ops(b, vrows, hr, vr)
                + 4.0 * b * W * (len(crow_ids) + vrows))
    up = (torch.repeat_interleave(torch.repeat_interleave(
        planes[1], 2, -1), 2, -2)).float()
    timings[("chroma420_scale", "cubic")] = dict(
        ms=cuda_ms(lambda: ck.chroma420_scale(planes[1], *args_c, W, H), 20),
        plain_ms=cuda_ms(lambda: ck.chroma420_scale_plain(planes[1], *args_c),
                         3, 1),
        library_ms=cuda_ms(dense_pair(up, hr, vr), 5, 1),
        bound=bound(nbytes, 0.0, dp4a_ops), taps=(hr.max_taps, vr.max_taps))
    del up
    for (kname, tag), t in timings.items():
        print(f"time {kname} [{tag}, taps {t['taps']}] batch {b}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"(2 dense fp32 matmuls) {t['library_ms']:.4f} ms, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}, {t['bound'][2]})")
    td = time_deint(planes)
    timings[("deint_both_parities", "linear")] = dict(td, library_ms=None)
    print(f"time deint_both_parities [linear, Y+U+V of {DEINT_BATCH} 1080p "
          f"I420 frames]: kernel {td['ms']:.4f} ms, plain "
          f"{td['plain_ms']:.4f} ms, bound {td['bound'][0]:.4f} ms "
          f"({td['bound'][1]}, {td['bound'][2]}, {td['bytes']} bytes); "
          f"library: none (no "
          f"single PyTorch call); copy_ yardstick of the same bytes "
          f"{td['copy_ms']:.4f} ms")

    for (kname, tag), t in time_new_kernels(
            planes, {"linear2": lin, "cubic": cub}).items():
        timings[(kname, tag)] = t
        lib = (f"library ({t['library']}) {t['library_ms']:.4f} ms"
               if t["library_ms"] is not None else
               f"library: none (no single PyTorch call); yardstick of 3 "
               f"dense fp32 h products {t['yardstick_ms']:.4f} ms")
        print(f"time {kname} [{tag}, taps {t['taps']}] batch {b}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, {lib}, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}, {t['bound'][2]})")
    for (kname, tag), t in timings.items():
        require(t["ms"] >= t["bound"][0],
                f"{kname} [{tag}]: {t['ms']:.4f} ms reads under its bound of "
                f"{t['bound'][0]:.4f} ms ({t['bound'][1]}): the bound is no "
                f"bound")
    print(f"bounds: none of the {len(timings)} kernel times reads under its "
          f"bound")

    # -- the main path: counts zeroed just before, read just after ------------
    counters = {"yscale_hv": ysk.yscale_hv,
                "chroma420_scale": ck.chroma420_scale,
                "deint_both_parities": dk.deint_both_parities,
                "fused_i420_up_hscale": fk.fused_i420_up_hscale,
                "scale_hv_u8": s2k.scale_hv_u8,
                "hscale_u8": hk.hscale_u8,
                "freeverb": fvk.freeverb,
                "vad_power": vk.vad_power}
    for c in counters.values():
        c.launches = 0
    outs, per_cfg = {}, {}
    for k, conv in convs.items():
        before = {n: c.launches for n, c in counters.items()}
        with opt_in(k in FUSED_CONFIGS):
            outs[k] = conv.convert(planes)
        torch.cuda.synchronize()
        per_cfg[k] = {n: c.launches - before[n] for n, c in counters.items()
                      if c.launches - before[n]}
    standalone_ops(planes, host, lin)
    launches = {k: c.launches for k, c in counters.items()}
    print(f"main path launches (converter configs and standalone ops) "
          f"{launches}; per config: {per_cfg}")
    require(per_cfg["linear2"] == {"yscale_hv": 1}
            and per_cfg["cubic"] == {"yscale_hv": 1, "chroma420_scale": 2},
            "yscale / chroma420 kernels not launched as expected on the "
            "main path")
    require(per_cfg["add_borders"] == {}, "add_borders launched a kernel")
    require(per_cfg["fused_ingest"] == {"fused_i420_up_hscale": 1},
            f"fused_ingest: want exactly one fused-ingest launch, got "
            f"{per_cfg['fused_ingest']}")
    require(launches["hscale_u8"] == 1 and launches["scale_hv_u8"] == 1,
            "standalone ops not launched")
    for o, r in zip(outs["fused_ingest"], outs["linear2"]):
        require(torch.equal(o, r),
                "fused_ingest: output differs from linear2's bytes")

    # -- outputs against the port's CPU path and numpy gold -------------------
    for k, cfg in CONFIGS.items():
        out = outs[k]
        require(len(out) == 3 and all(
            o.dtype == torch.uint8 and tuple(o.shape) == (b, OH, OW)
            for o in out), f"{k}: bad output {[o.shape for o in out]}")
        with opt_in(k in FUSED_CONFIGS):
            cpu = VideoConverter(ii, oi, cfg, device="cpu").convert(
                tuple(p[:2] for p in host))
        gold = convs[k].convert_ref(tuple(p[:1] for p in host))
        for o, c, g in zip(out, cpu, gold):
            require(torch.equal(o[:2].cpu(), c),
                    f"{k}: CUDA output differs from the port's CPU path")
            require(np.array_equal(o[:1].cpu().numpy(), g),
                    f"{k}: CUDA output differs from the numpy gold")
    print("outputs: CUDA == port CPU path (2 frames) == numpy gold (1 frame)"
          " for every config")

    # -- end to end: frames/s of convert() on inputs resident on the card -----
    for k, conv in convs.items():
        with opt_in(k in FUSED_CONFIGS):
            ms = cuda_ms(lambda: conv.convert(planes), 5, 1)
        print(f"e2e {k}: {ms:.3f} ms per batch of {b}, "
              f"{b / ms * 1e3:.1f} frames/s")
    del outs

    # -- launch strings: each path with its counts zeroed just before -------
    paths = launch_paths(planes, host, counters)
    for pname, r in paths.items():
        for k in launches:
            launches[k] += r["counts"][k]
        print(f"e2e {pname}: {r['fps']:.1f} output frames/s over ticks 2.."
              f"{r['ticks']} (batch {r['batch']} in, "
              f"{r['frames'][1:]} frames out, "
              f"{[round(s * 1e3, 3) for s in r['secs']]} ms per tick, host "
              f"clock between synchronises; tick 1 includes first calls)")
    del paths

    # -- the generic routes and the switches -----------------------------------
    for counts in generic_routes(host, counters).values():
        for k, n in counts.items():
            launches[k] += n
    for pname, r in launch_paths(planes, host, counters,
                                 GENERIC_LAUNCH).items():
        for k in launches:
            launches[k] += r["counts"][k]
        print(f"e2e {pname}: {r['fps']:.1f} output frames/s over ticks 2.."
              f"{r['ticks']} (batch {r['batch']}, "
              f"{[round(s * 1e3, 3) for s in r['secs']]} ms per tick, host "
              f"clock between synchronises)")
    for k, n in switched_off(convs, planes, counters).items():
        launches[k] += n
    del planes, convs
    torch.cuda.empty_cache()

    # -- the audio front-end: no kernel of the port on its path -----------------
    audio_phase(args.seed, counters, dev)

    # -- aggregators: BASELINE config 3, the wall, the audio mixer -------------
    agg_launches, agg_err = aggregator_phase(args.seed, counters, dev, host)
    for k, n in agg_launches.items():
        launches[k] += n
    for k, e in agg_err.items():
        err[k] = max(err[k], e)

    # -- stateful and controlled elements -------------------------------------
    for k, n in stateful_phase(args.seed, counters, dev, host).items():
        launches[k] += n

    # -- ingest from disk: y4m, JPEG, the example's train loop ----------------
    for k, n in ingest_phase(args.seed, counters, dev).items():
        launches[k] += n

    # -- the common filters and fittings ---------------------------------------
    fit_launches, fit_err = fittings_phase(args.seed, counters, dev, host)
    for k, n in fit_launches.items():
        launches[k] += n
    for k, e in fit_err.items():
        err[k] = max(err[k], e)

    # -- overlays and the device video effects ---------------------------------
    for k, n in overlays_phase(args.seed, counters, dev, host).items():
        launches[k] += n

    # -- the audio DSP family: freeverb's and the VAD's kernels -----------------
    dsp_launches, dsp_err, dsp_timings = dsp_phase(args.seed, counters, dev)
    for k, n in dsp_launches.items():
        launches[k] += n
    err.update(dsp_err)
    timings.update(dsp_timings)
    print(f"main path launches, all paths: {launches}")

    smi = smi_line()
    sources = {"yscale_hv": ("gstreamer_tpu_torch/csrc/yscale.cu",
                             "gstreamer_tpu/ops/yscale_kernel.py:109",
                             "linear2"),
               "chroma420_scale": ("gstreamer_tpu_torch/csrc/chroma420.cu",
                                   "gstreamer_tpu/ops/chroma420_kernel.py:159",
                                   "cubic"),
               "deint_both_parities": ("gstreamer_tpu_torch/csrc/deint.cu",
                                       "gstreamer_tpu/ops/deint_kernel.py:85",
                                       "linear"),
               "fused_i420_up_hscale": (
                   "gstreamer_tpu_torch/csrc/fused_ingest.cu",
                   "gstreamer_tpu/ops/convert_kernel.py:185", "linear2"),
               "scale_hv_u8": ("gstreamer_tpu_torch/csrc/scale2d.cu",
                               "gstreamer_tpu/ops/scale2d_kernel.py:88",
                               "linear2"),
               "hscale_u8": ("gstreamer_tpu_torch/csrc/hscale.cu",
                             "gstreamer_tpu/ops/hscale_kernel.py:73",
                             "linear2"),
               # no Pallas counterpart: each replaces a jitted lax.scan
               "freeverb": ("gstreamer_tpu_torch/csrc/freeverb.cu",
                            "gstreamer_tpu/elements/freeverb.py:198",
                            str(FV_CHECK)),
               "vad_power": ("gstreamer_tpu_torch/csrc/vad.cu",
                             "gstreamer_tpu/elements/removesilence.py:76",
                             "960")}
    kernels = []
    for kname, (src, repl, tag) in sources.items():
        t = timings[(kname, tag)]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[kname], "max_abs_err": err[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            **({"device_ms": t["device_ms"]} if "device_ms" in t else {})})
    require(smi is not None, "nvidia-smi printed nothing")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
