#!/usr/bin/env python3
"""The freeverb kernel against its plain version at one rate, small enough
to run under compute-sanitizer's race checker.

    compute-sanitizer --tool racecheck python3 tools/freeverb_racecheck.py \
        [--rate 48000]

Mono and stereo, a push of 4800 frames then one of 777 (no multiple of a
block) with the state carried: the outputs and the final rings, indices
and filterstores must equal the plain version's bit for bit.  Exits 1 if
they differ.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=int, default=48000)
    args = ap.parse_args()
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import freeverb_kernel as fvk
    rng = np.random.default_rng(0)
    sizes = fvk.ring_sizes(args.rate)
    prm = fvk.params(0.6, 0.2, 1.0, 0.5)
    ok = True
    for ch in (1, 2):
        kst = fvk.fresh_state(1, sizes, "cuda")
        pst = fvk.fresh_state(1, sizes, "cpu")
        for frames in (4800, 777):
            x = torch.from_numpy((rng.standard_normal((1, frames, ch))
                                  * 0.3).astype(np.float32))
            k = fvk.freeverb(x.cuda(), kst, sizes, prm).cpu()
            p = fvk.freeverb_plain(x, pst, sizes, prm)
            ok &= torch.equal(k.view(torch.int32), p.view(torch.int32))
        ok &= all(torch.equal(kst[key].cpu(), pst[key]) for key in pst)
    print(f"freeverb at {args.rate} Hz, mono and stereo, 4800 + 777 frames: "
          f"{'equal to' if ok else 'DIFFERS from'} the plain version "
          f"(schedule {fvk.schedule(sizes)})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
