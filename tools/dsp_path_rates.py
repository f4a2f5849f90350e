#!/usr/bin/env python3
"""Input frames/s of chip_smoke.py's audio DSP paths, run after run.

    python3 tools/dsp_path_rates.py [--root DIR] [--runs N]
        [--paths voice_chain music_master] [--kernel-timing]

Drives each path of ``chip_smoke.py``'s ``DSP_PATHS`` at its full size
(``music_master``: 3 pushes of 480 000 frames of 48 kHz stereo F32;
``voice_chain``: 250 pushes of 960 frames of 48 kHz mono S16) `--runs`
times on the card, each run a fresh pipeline on fresh seeded data, and
prints the input frames/s over pushes 2.. on the host clock, as
``chip_smoke.py``'s ``e2e`` lines count them.  ``--root`` takes the port
and ``chip_smoke.py`` from another checkout (an older tree unpacked beside
this one), so two trees compare on one card: run it for each, in turn.
``--kernel-timing`` first runs that checkout's ``check_dsp_kernels`` and
``time_dsp_kernels``, as its ``chip_smoke.py`` does before the paths.
Prints the card's name and power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--paths", nargs="+",
                    default=["voice_chain", "music_master"])
    ap.add_argument("--kernel-timing", action="store_true")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import chip_smoke as cs
    import gstreamer_tpu_torch
    for mod in (cs, gstreamer_tpu_torch):
        if root not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} came from {mod.__file__}, "
                             f"not from {root}")
    if not torch.cuda.is_available():
        print("dsp_path_rates: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    if args.kernel_timing:
        cs.check_dsp_kernels(rng, dev)
        cs.time_dsp_kernels(rng, dev)
    for name in args.paths:
        fmt, ch, chain, frames, pushes = cs.DSP_PATHS[name][:5]
        desc = cs.dsp_desc(fmt, ch, chain)
        rates = []
        for _ in range(args.runs):
            arrays = cs.dsp_signal(fmt, ch, frames, pushes, rng)
            bufs = cs.on_device(cs.dsp_bufs(arrays, frames), dev)
            _, outs, secs = cs.drive_bufs(desc, bufs, dev, 1)
            rates.append(frames * (pushes - 1) / sum(secs[1:]))
            del outs, bufs
        print(f"{name} [{root.name}]: input frames/s "
              f"{[round(r, 1) for r in rates]} over {args.runs} runs of "
              f"{pushes} pushes of {frames} frames (pushes 2..{pushes}, "
              f"host clock)", flush=True)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
