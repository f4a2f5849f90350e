#!/usr/bin/env python3
"""Where the time goes in the torch port's headline conversions, on one GPU.

    python3 profile_torch_headline.py [--batch 256] [--iters 5] [--seed 0]

For each of chip_smoke.py's configurations (linear2, cubic, add_borders)
this runs ``VideoConverter.convert`` on a batch of 1920x1080 I420 frames
already on the card, under ``torch.profiler`` for ``--iters`` conversions,
and prints one JSON line: the wall time per batch, the device busy time per
batch (the union of the kernels' device intervals), the device idle share,
and the ten kernels with the most device time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_headline: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import CONFIGS, H, OH, OW, W
    from gstreamer_tpu_torch import VideoConverter, VideoInfo
    from gstreamer_tpu_torch.ops import _build

    _build.build()
    ii = VideoInfo(format="I420", width=W, height=H)
    oi = VideoInfo(format="RGB", width=OW, height=OH)
    rng = np.random.default_rng(args.seed)
    planes = tuple(torch.as_tensor(rng.integers(0, 256, (args.batch,) + s,
                                                dtype=np.uint8)).cuda()
                   for s in ii.plane_shapes())
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    for name, cfg in CONFIGS.items():
        conv = VideoConverter(ii, oi, cfg)
        for _ in range(2):
            conv.convert(planes)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                conv.convert(planes)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.iters * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in kernels)
        busy_us, reach = 0.0, float("-inf")
        for start, end in spans:            # union of the device intervals
            busy_us += max(0.0, end - max(start, reach))
            reach = max(reach, end)
        per_name: dict = {}
        for e in kernels:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
        busy = busy_us / args.iters / 1e3
        print(json.dumps({
            "config": name, "batch": args.batch, "wall_ms": wall,
            "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"kernel": k[:90], "device_ms": us / args.iters / 1e3,
                     "calls": n // args.iters} for k, (us, n) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
