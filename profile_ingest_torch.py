#!/usr/bin/env python3
"""Where the host time goes on the port's ingest path, on one GPU.

    python3 profile_ingest_torch.py [--passes 3] [--seed 0] [--top 12]

Writes chip_smoke.py's ingest clip (96 seeded random 1920x1080 I420 frames
in a y4m under a temporary directory) and runs chip_smoke.py's INGEST string
(filesrc ! videoconvertscale add-borders=false ! RGB 224x224 ! appsink) at
batch 16 and 64 with prefetch off and on: one pass to warm up, then
``--passes`` passes with ``seek(0)`` between them on the host clock (a
synchronise at the end of each), then one more under cProfile.  Prints one
JSON line per configuration: frames/s per pass and the functions with the
most host time of the profiled pass (own time, ms, and calls).  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import tempfile
import time


def one_pass(pipe, sink):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = 0
    while pipe.tick():
        while (s := sink.pull_sample()) is not None:
            frames += s.buffer.batch
    torch.cuda.synchronize()
    return frames, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_ingest_torch: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gstreamer_tpu_torch import parse_launch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ingest.y4m")
        cs.write_y4m(path, cs.INGEST_FRAMES, args.seed)
        for batch in (16, 64):
            for prefetch in (False, True):
                pipe = parse_launch(cs.INGEST.format(path=path))
                pipe.compile(batch=batch, prefetch=prefetch)
                sink = pipe.get_by_name("out")
                pipe.set_state("playing")
                one_pass(pipe, sink)
                fps = []
                for _ in range(args.passes):
                    pipe.seek(0)
                    n, secs = one_pass(pipe, sink)
                    fps.append(round(n / secs, 1))
                pipe.seek(0)
                prof = cProfile.Profile()
                prof.enable()
                n, secs = one_pass(pipe, sink)
                prof.disable()
                pipe.set_state("null")
                stats = pstats.Stats(prof).stats
                top = sorted(stats.items(), key=lambda kv: -kv[1][2])
                print(json.dumps({
                    "config": f"batch {batch}, prefetch "
                              f"{'on' if prefetch else 'off'}",
                    "frames_per_s": fps,
                    "profiled_pass_ms": round(secs * 1e3, 2),
                    "host_top": [
                        [f"{os.path.basename(f)}:{line}:{fn}",
                         round(v[2] * 1e3, 2), v[1]]
                        for (f, line, fn), v in top[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
