#!/usr/bin/env python3
"""The OpenCV family's two kernels, timed alone at their main paths' shapes.

    python3 tools/cv_kernel_times.py [--rounds N]

Times ``ops/gmm_kernel.py::gmm`` as ``chip_smoke.py`` does (``cv_segment``'s
first tick of 64 1080p RGBA frames on the carry after its four ticks) and
``ops/sgbm_kernel.py::disparity`` on its ``cv_stereo`` tick (8 pairs of
720p gray planes, sgbm and sbm): a call back to back (CUDA events) and a
CUDA graph of calls (device time), then one ``torch.profiler`` trace of
three calls of each, which gives each CUDA kernel's device time by name
(the disparity call launches two: the column sums above each strip, then
the strips' walk) and shows whether the trace holds the ctypes launches
at all.  The plain cost volume on the card (the part of disparity that ran
in plain torch before it was fused) is timed beside.  Prints the card's
name and power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from gstreamer_tpu_torch.ops import cv_kernels as cvk
    from gstreamer_tpu_torch.ops import gmm_kernel as gk
    from gstreamer_tpu_torch.ops import sgbm_kernel as sk

    dev = torch.device("cuda")
    w, h, n, ticks = cs.CV_SEGMENT
    frames = cs.cv_segment_frames(n, h, w, ticks, 0, dev)
    carry = {k: torch.from_numpy(v).to(dev)
             for k, v in gk.init_carry(h, w).items()}
    alpha, act = gk.rates(0.01, True)
    for planes in frames:             # chip_smoke.py's state: the last carry
        carry, _ = gk.gmm(carry, *planes[:3], alpha, act, True)
    r, g, b = frames[0][:3]
    sw, sh, pairs, _ = cs.CV_STEREO
    left, right = cs.stereo_frames(pairs, sh, sw, 0, dev)
    gl, gr = cvk.rgb2gray_u8(torch, *left), cvk.rgb2gray_u8(torch, *right)
    calls = {
        "gmm [1080p64]": lambda: gk.gmm(carry, r, g, b, alpha, act, True),
        "disparity sgbm [720p8]": lambda: sk.disparity(gl, gr, "sgbm"),
        "disparity sbm [720p8]": lambda: sk.disparity(gl, gr, "sbm"),
    }
    for _ in range(args.rounds):
        for name, fn in calls.items():
            print(f"{name}: {cs.cuda_ms(fn, 10, 2):.4f} ms a call back to "
                  f"back, {cs.graph_ms(fn, 5):.4f} ms on the device (a CUDA "
                  f"graph)")
    plain = cs.cuda_ms(lambda: sk.cost_volume(gl.float(), gr.float()), 3, 1)
    print(f"plain cost volume [720p8]: {plain:.4f} ms")
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        per = collections.defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = e.name.split("(")[0].split("::")[-1][:40]
                per[key][0] += e.time_range.elapsed_us() / 3e3
                per[key][1] += 1
        print(f"{name} traced: " + (", ".join(
            f"{k} {ms:.4f} ms a call ({c} events)"
            for k, (ms, c) in per.items()) or "no device event"))
    print(cs.smi_line() or "nvidia-smi printed nothing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
