#!/usr/bin/env python3
"""Where the time goes in the torch port's main paths, on one GPU.

    python3 profile_torch_headline.py [--batch 256] [--iters 5] [--seed 0]
                                      [--only NAME,NAME,...]

For each of chip_smoke.py's converter configurations (linear2, cubic,
add_borders, and fused_ingest under GTPU_PALLAS=1) this runs
``VideoConverter.convert`` on a batch of 1920x1080 I420 frames already on
the card; for each of its generic-route configurations (GENERIC:
nv12_ingest, nv12_fused, upscale, same_size, encode_side, hdr_ingest,
rgb16_out, rgb16_serial, gamma_remap, interlaced) the same at that configuration's
formats, sizes and batch; and for each of its launch paths (deint_chain,
deint_rate_chain, headline_launch, headline_launch_noborders, quickstart,
quickstart_fused and launch_small_default) ``Pipeline.tick`` at the path's
batch, with the frames
pushed into appsrc as CUDA tensors (the quick-start paths' videotestsrc
makes its own on the card); for the audio front-end (BASELINE config 2)
chip_smoke.py's asr_resample_f32 and asr_resample_s16 (one call of
AudioResampler's resample_fn over 128 chunks of 2^17 frames) and its
AUDIO_LAUNCH paths (asr_launch, asr_quickstart, volume_s16, volume_f32: a
tick each); and its aggregator configurations (AGGREGATORS: compositor_4k,
BASELINE config 3; compositor_wall; audiomixer_s16, audiomixer_f32: a tick
each, every appsrc fed CUDA tensors); and its stateful and controlled
paths (deint_<method> for the nine deinterlace methods without a kernel,
deint_chain_controlled, effectv_chain, volume_controlled_s16 and _f32: a
tick each, control sources bound as chip_smoke.py binds them); and its
fittings paths (FITTINGS: filters_tee, selector_box; ``--only fittings``
names both: a tick each, every appsrc fed CUDA tensors); and its overlay
paths (OVERLAY_PATHS: burnin, camera_raw_rggb, camera_raw_rggb16le,
augment; ``--only overlays`` names all four: a tick each, the JSON line
also holding the host functions with the most time over 3 more ticks
under cProfile, ``host_top``); and its audio DSP paths (DSP_PATHS:
music_master, a 10 s push of 48 kHz stereo F32, and voice_chain, a 20 ms
push of 48 kHz mono S16; ``--only dsp`` names both: a push each, with
``host_top``).  Each runs
two times untraced,
then ``--iters`` times under ``torch.profiler``, and prints one JSON line:
the wall time per batch or tick, the device busy time (the union of the
kernels' device intervals), the device idle share, and the ten kernels
with the most device time, then the port's own kernels where they rank
lower.  ``--only`` profiles just the named configurations.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys


# names of the port's own CUDA kernels: listed even below the top ten
OWN_KERNELS = ("scale2pass", "fused_ingest", "deint_both_parities",
               "freeverb_kernel", "vad_power_kernel")


def host_top(step, ticks=3, n=8):
    """The n host functions with the most own time over `ticks` calls of
    `step` under cProfile: [{"function", "ms" a call, "calls" a call}]."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(ticks):
        step()
    prof.disable()
    stats = pstats.Stats(prof).stats
    ranked = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [{"function": f"{fn[0].split('/')[-1]}:{fn[1]}:{fn[2]}",
             "ms": tt / ticks * 1e3, "calls": nc // ticks}
            for fn, (_, nc, tt, _, _) in ranked]


def report(name, batch, step, iters, host=False):
    """Run `step` twice, then `iters` times under torch.profiler; print
    the JSON line described above (with ``host_top`` where `host`)."""
    import torch
    from chip_smoke import device_time
    wall, busy, idle, prof = device_time(step, iters)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name: dict = {}
    for e in kernels:
        us, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    top = ranked[:10]
    own = [kv for kv in ranked[10:] if any(w in kv[0] for w in OWN_KERNELS)]
    line = {
        "config": name, "batch": batch, "wall_ms": wall,
        "device_busy_ms": busy, "device_idle_share": idle,
        "top": [{"kernel": k[:90], "device_ms": us / iters / 1e3,
                 "calls": n // iters} for k, (us, n) in top + own]}
    if host:
        line["host_top"] = host_top(step)
    print(json.dumps(line))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None,
                    help="comma-separated configuration names")
    args = ap.parse_args()
    only = None if args.only is None else set(args.only.split(","))
    if only is not None and "fittings" in only:
        only |= {"filters_tee", "selector_box"}
    if only is not None and "overlays" in only:
        only |= {"burnin", "camera_raw_rggb", "camera_raw_rggb16le",
                 "augment"}
    if only is not None and "dsp" in only:
        only |= {"music_master", "voice_chain"}

    def profile(name, batch, step, host=False):
        if only is None or name in only:
            report(name, batch, step, args.iters, host)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_headline: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (AGGREGATORS, ASR_CHUNKS, ASR_FRAMES,
                            AUDIO_LAUNCH, CONFIGS, DUR, FUSED_CONFIGS,
                            GENERIC, GENERIC_LAUNCH, H, LAUNCH, OH, OW, W,
                            aggregator_inputs, asr_inputs, generic_converter,
                            generic_inputs, opt_in)
    from gstreamer_tpu_torch import AudioResampler
    from gstreamer_tpu_torch import VideoConverter, VideoInfo, parse_launch
    from gstreamer_tpu_torch.core.buffer import Buffer
    from gstreamer_tpu_torch.core.pipeline import State
    from gstreamer_tpu_torch.ops import _build

    _build.build()
    ii = VideoInfo(format="I420", width=W, height=H)
    oi = VideoInfo(format="RGB", width=OW, height=OH)
    rng = np.random.default_rng(args.seed)
    host = tuple(rng.integers(0, 256, (args.batch,) + s, dtype=np.uint8)
                 for s in ii.plane_shapes())
    planes = tuple(torch.as_tensor(p).cuda() for p in host)
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    for name, cfg in CONFIGS.items():
        conv = VideoConverter(ii, oi, cfg)
        with opt_in(name in FUSED_CONFIGS):
            profile(name, args.batch, lambda: conv.convert(planes))
    for name, g in GENERIC.items():
        conv = generic_converter(name)
        ins = tuple(torch.as_tensor(p).cuda()
                    for p in generic_inputs(name, host, g["batch"]))
        with opt_in(g.get("fused", False)):
            profile(name, g["batch"], lambda: conv.convert(ins))
        del ins
        torch.cuda.empty_cache()
    for name, (desc, batch, _, fused) in {**LAUNCH,
                                          **GENERIC_LAUNCH}.items():
        # n: frames a videotestsrc makes (2 untraced ticks + iters traced)
        pipe = parse_launch(desc.format(w=W, h=H,
                                        n=batch * (args.iters + 2)),
                            batch=batch)
        src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
        ins = tuple(p[:batch] for p in planes)
        pts = itertools.count(0, batch * DUR)
        pipe.set_state(State.PLAYING)

        def tick():
            if src is not None:
                src.push_buffer(Buffer(data=ins, pts=next(pts), duration=DUR,
                                       batch=batch))
            pipe.tick()
            while sink.pull_sample() is not None:
                pass
        with opt_in(fused):
            profile(name, batch, tick)
        pipe.set_state(State.NULL)
    del planes
    torch.cuda.empty_cache()

    x = torch.as_tensor(asr_inputs(args.seed)).cuda()
    res = AudioResampler("kaiser", 48000, 16000)
    rf = res.resample_fn("f32", ASR_FRAMES, 2)
    rs = res.resample_fn("s16", ASR_FRAMES, 2)
    profile("asr_resample_f32", ASR_CHUNKS,
            lambda: rf(x.float() / 32768.0).mean(dim=-1))
    profile("asr_resample_s16", ASR_CHUNKS, lambda: rs(x))
    del x
    for name, (desc, frames, _) in AUDIO_LAUNCH.items():
        pipe = parse_launch(desc.format(n=10 ** 6))
        src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
        ins = torch.zeros((frames, 2), device="cuda", dtype=(
            torch.float32 if name.endswith("f32") else torch.int16))
        pipe.set_state(State.PLAYING)

        def tick():
            if src is not None:
                src.push_buffer(Buffer(data=ins))
            pipe.tick()
            while sink.pull_sample() is not None:
                pass
        profile(name, frames, tick)
        pipe.set_state(State.NULL)

    for name, (make, batch, _, _) in AGGREGATORS.items():
        audio = name.startswith("audiomixer")
        ins = {k: (torch.as_tensor(v).cuda() if audio else
                   tuple(torch.as_tensor(p).cuda() for p in v))
               for k, v in aggregator_inputs(name, host, rng, W, H,
                                             batch).items()}
        pipe = parse_launch(make(W, H), batch=batch)
        sink = pipe.get_by_name("out")
        pipe.set_state(State.PLAYING)

        def tick():
            for k, v in ins.items():
                pipe.get_by_name(k).push_buffer(
                    Buffer(data=v, batch=1 if audio else batch))
            pipe.tick()
            while sink.pull_sample() is not None:
                pass
        profile(name, batch, tick)
        pipe.set_state(State.NULL)
        del ins
        torch.cuda.empty_cache()

    from chip_smoke import (AGG_FRAMES, ASR_SRC, BALANCE, DEINT_BATCH,
                            DEINT_NEW, EFFECT_CHAIN, EH, ESRC, EW, FADE, SRC,
                            VOLUME_RAMP, controlled, push_tick)
    video = tuple(p[:DEINT_BATCH] for p in host)
    rgb = tuple(rng.integers(0, 256, (EFFECT_CHAIN[1], EH, EW),
                             dtype=np.uint8) for _ in range(3))
    audio = rng.integers(-32768, 32767, (AGG_FRAMES, 2), dtype=np.int16)
    stateful = {f"deint_{m}": (SRC.format(w=W, h=H) + f"deinterlace "
                               f"method={m} ! " + BALANCE, video, None)
                for m in DEINT_NEW}
    stateful["deint_chain_controlled"] = (
        SRC.format(w=W, h=H) + "deinterlace method=linear ! videobalance "
        "name=vb ! appsink name=out", video, FADE)
    stateful["effectv_chain"] = (ESRC + EFFECT_CHAIN[0] + " ! appsink "
                                 "name=out", rgb, None)
    stateful["volume_controlled_s16"] = (
        ASR_SRC + "volume name=v ! appsink name=out", audio, VOLUME_RAMP)
    stateful["volume_controlled_f32"] = (
        ASR_SRC.replace("S16LE", "F32LE") + "volume name=v ! appsink "
        "name=out", (audio / 32768.0).astype(np.float32), VOLUME_RAMP)
    for name, (desc, data, ctl) in stateful.items():
        if only is not None and name not in only:
            continue
        if isinstance(data, tuple):
            batch = data[0].shape[0]
            data = tuple(torch.as_tensor(p).cuda() for p in data)
        else:
            batch = data.shape[0]
            data = torch.as_tensor(data).cuda()
        pipe = controlled(desc, "cuda", batch, ctl)
        src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
        pipe.set_state(State.PLAYING)
        pts = [0]

        def tick():
            pts[0] = push_tick(src, data, pts[0])
            pipe.tick()
            while sink.pull_sample() is not None:
                pass
        profile(name, batch, tick)
        pipe.set_state(State.NULL)
        del data
        torch.cuda.empty_cache()

    from chip_smoke import FITTINGS, drain, fit_desc, fittings_inputs
    for name, (_, _, sinks, batch, _, _, _) in FITTINGS.items():
        if only is not None and name not in only:
            continue
        ins = {k: tuple(torch.as_tensor(p).cuda() for p in v)
               for k, v in fittings_inputs(name, host, rng, batch).items()}
        pipe = parse_launch(fit_desc(name, W, H), batch=batch)
        pipe.set_state(State.PLAYING)

        def tick():
            for k, v in ins.items():
                pipe.get_by_name(k).push_buffer(Buffer(data=v, batch=batch))
            pipe.tick()
            for s in sinks:
                drain(pipe.get_by_name(s))
        profile(name, batch, tick)
        pipe.set_state(State.NULL)
        del ins
        torch.cuda.empty_cache()

    import tempfile
    from chip_smoke import DUR, OVERLAY_PATHS, overlay_path, write_logo
    with tempfile.TemporaryDirectory() as tmp:
        png = write_logo(tmp, rng)
        for name, (_, _, batch, _, _) in OVERLAY_PATHS.items():
            if only is not None and name not in only:
                continue
            desc, data = overlay_path(name, png, host, rng, W, H)
            data = (tuple(torch.as_tensor(p).cuda() for p in data)
                    if isinstance(data, tuple)
                    else torch.as_tensor(data).cuda())
            pipe = parse_launch(desc, batch=batch)
            pipe.set_state(State.PLAYING)
            ticks = [0]

            def tick():
                pipe.get_by_name("in").push_buffer(Buffer(
                    data=data, pts=ticks[0] * batch * DUR, duration=DUR,
                    batch=batch))
                ticks[0] += 1
                pipe.tick()
                drain(pipe.get_by_name("out"))
            profile(name, batch, tick, host=True)
            pipe.set_state(State.NULL)
            del data
            torch.cuda.empty_cache()

    from chip_smoke import DSP_PATHS, drain, dsp_desc, dsp_signal
    for name, (fmt, ch, chain, frames, _, _, _, _) in DSP_PATHS.items():
        if only is not None and name not in only:
            continue
        data = torch.as_tensor(dsp_signal(fmt, ch, frames, 1, rng)[0]).cuda()
        pipe = parse_launch(dsp_desc(fmt, ch, chain))
        pipe.set_state(State.PLAYING)
        ticks = [0]
        dur = frames * 10**9 // 48000

        def tick():
            pipe.get_by_name("in").push_buffer(Buffer(
                data=data, pts=ticks[0] * dur, duration=dur))
            ticks[0] += 1
            pipe.tick()
            drain(pipe.get_by_name("out"))
        profile(name, frames, tick, host=True)
        pipe.set_state(State.NULL)
        del data
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
