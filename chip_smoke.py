#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gstreamer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--batch N]

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel), holds each kernel against its plain PyTorch version on the card
at the headline shapes (bit for bit), times kernel, plain version, a
library yardstick and the byte/operation bound, then drives the port's
VideoConverter at full width -- a batch of 1920x1080 I420 frames, made from
the seed, to RGB 224x224 -- in three configurations:

  linear2      method=linear, 2 taps (videoscale's default): yscale kernel
               + 2-tap gather chroma
  cubic        the converter's default cubic: yscale kernel + chroma420
               kernel
  add_borders  linear/2 with the 16:9 -> 1:1 dest rect (dest-y=49,
               dest-height=126): phase-split path + rect embed, no kernel

Launch counts are zeroed just before those three conversions and read just
after.  Outputs are checked against the port's own CPU path (first two
frames) and its numpy gold (first frame).  Any failure raises.  The last
line of standard output is one JSON object {"ok": true, "device": ...};
the line before it holds the kernels' JSON.  Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor fp32 (used for int32 MACs)
W, H, OW, OH = 1920, 1080, 224, 224
CONFIGS = {
    "linear2": {"resampler-method": "linear", "resampler-taps": 2},
    "cubic": None,
    "add_borders": {"resampler-method": "linear", "resampler-taps": 2,
                    "dest-x": 0, "dest-y": 49, "dest-width": 224,
                    "dest-height": 126},
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


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


def touched(res, limit: int) -> int:
    """Distinct source samples a resampler's taps read."""
    import numpy as np
    idx = res.offset[:, None] + np.arange(res.max_taps)[None, :]
    return int(np.unique(np.clip(idx, 0, limit - 1)).size)


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def dense_pair(x_f32, h_res, v_res):
    """The library yardstick: two dense fp32 tap-matrix products (no TF32)."""
    import torch
    from gstreamer_tpu_torch.video.scaler import tap_matrix
    mh = torch.as_tensor(tap_matrix(h_res).T.astype("float32"),
                         device=x_f32.device)
    mv = torch.as_tensor(tap_matrix(v_res).astype("float32"),
                         device=x_f32.device)
    return lambda: torch.matmul(mv, torch.matmul(x_f32, mh))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()

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
    print(f"kernel vs plain (bit for bit): {err}")

    # -- timings at the headline shapes ---------------------------------------
    timings = {}
    y_f32 = planes[0].float()
    for tag, plan in (("linear2", lin), ("cubic", cub)):
        hr, vr = plan["h_res"], plan["v_res"]
        rows = touched(vr, H)
        nbytes = b * rows * W + b * OH * OW * 2
        ops = 2.0 * b * (rows * OW * hr.max_taps + OH * OW * vr.max_taps)
        timings[("yscale_hv", tag)] = dict(
            ms=cuda_ms(lambda: ysk.yscale_hv(planes[0], hr, vr), 20),
            plain_ms=cuda_ms(lambda: ysk.yscale_hv_plain(planes[0], hr, vr),
                             3, 1),
            library_ms=cuda_ms(dense_pair(y_f32, hr, vr), 5, 1),
            bound=bound(nbytes, ops), taps=(hr.max_taps, vr.max_taps))
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
    ops = 2.0 * b * (vrows * OW * hr.max_taps + OH * OW * vr.max_taps)
    up = (torch.repeat_interleave(torch.repeat_interleave(
        planes[1], 2, -1), 2, -2)).float()
    timings[("chroma420_scale", "cubic")] = dict(
        ms=cuda_ms(lambda: ck.chroma420_scale(planes[1], *args_c, W, H), 20),
        plain_ms=cuda_ms(lambda: ck.chroma420_scale_plain(planes[1], *args_c),
                         3, 1),
        library_ms=cuda_ms(dense_pair(up, hr, vr), 5, 1),
        bound=bound(nbytes, ops), taps=(hr.max_taps, vr.max_taps))
    del up
    for (kname, tag), t in timings.items():
        print(f"time {kname} [{tag}, taps {t['taps']}] batch {b}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"(2 dense fp32 matmuls) {t['library_ms']:.4f} ms, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]})")

    # -- the main path: counts zeroed just before, read just after ------------
    ysk.yscale_hv.launches = 0
    ck.chroma420_scale.launches = 0
    outs, per_cfg = {}, {}
    for k, conv in convs.items():
        before = (ysk.yscale_hv.launches, ck.chroma420_scale.launches)
        outs[k] = conv.convert(planes)
        torch.cuda.synchronize()
        per_cfg[k] = (ysk.yscale_hv.launches - before[0],
                      ck.chroma420_scale.launches - before[1])
    launches = {"yscale_hv": ysk.yscale_hv.launches,
                "chroma420_scale": ck.chroma420_scale.launches}
    print(f"main path launches {launches}; per config (yscale, chroma420): "
          f"{per_cfg}")
    require(per_cfg["linear2"][0] >= 1 and per_cfg["cubic"][0] >= 1,
            "yscale kernel not launched on the main path")
    require(per_cfg["cubic"][1] >= 1,
            "chroma420 kernel not launched on the main path")

    # -- outputs against the port's CPU path and numpy gold -------------------
    for k, cfg in CONFIGS.items():
        out = outs[k]
        require(len(out) == 3 and all(
            o.dtype == torch.uint8 and tuple(o.shape) == (b, OH, OW)
            for o in out), f"{k}: bad output {[o.shape for o in out]}")
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
        ms = cuda_ms(lambda: conv.convert(planes), 5, 1)
        print(f"e2e {k}: {ms:.3f} ms per batch of {b}, "
              f"{b / ms * 1e3:.1f} frames/s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    sources = {"yscale_hv": ("gstreamer_tpu_torch/csrc/yscale.cu",
                             "gstreamer_tpu/ops/yscale_kernel.py:109",
                             "linear2"),
               "chroma420_scale": ("gstreamer_tpu_torch/csrc/chroma420.cu",
                                   "gstreamer_tpu/ops/chroma420_kernel.py:159",
                                   "cubic")}
    kernels = []
    for kname, (src, repl, tag) in sources.items():
        t = timings[(kname, tag)]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[kname], "max_abs_err": err[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"]})
    require(bool(smi), "nvidia-smi printed nothing")
    print(smi[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
