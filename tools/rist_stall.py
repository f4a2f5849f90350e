"""Run chip_smoke.py's phase 22 (``net_tail_phase``) with one stall in
each RIST receiver's pipeline, at the 40th buffer its ristsrc hands on:
the receiving thread sleeps (``--kind sleep``, the GIL free) or sorts a
list for as long (``--kind gil``, one C call at a time that holds the
GIL).  ristsrc has to go on recovering the relay's drops meanwhile;
phase 22's own checks (every drop recovered, none lost, 32 of 32 frames
whole) decide the exit code.  ``--tree`` runs another checkout of the
repo (a parent, say) with the same stall.

    python3 tools/rist_stall.py [--tree DIR] [--stall SECONDS]
                                [--kind sleep|gil]

Prints "STALL <kind> <seconds>" where each stall happened, then the
phase's own output.  Needs a CUDA card, as the phase does.
"""

import argparse
import os
import random
import runpy
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--stall", type=float, default=0.6)
    ap.add_argument("--kind", choices=("sleep", "gil"), default="sleep")
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    os.chdir(root)
    from gstreamer_tpu_torch.net import rist
    create = rist.RistSrc.create
    data = [random.random() for _ in range(800_000)]

    def stalled(self, n_frames):
        buf = create(self, n_frames)
        if buf is not None:
            self._stall_n = getattr(self, "_stall_n", 0) + 1
            if self._stall_n == 40:
                t = time.perf_counter()
                if args.kind == "sleep":
                    time.sleep(args.stall)
                else:
                    while time.perf_counter() - t < args.stall:
                        sorted(data)
                print(f"STALL {args.kind} {time.perf_counter() - t:.3f} s",
                      flush=True)
        return buf
    rist.RistSrc.create = stalled
    sys.argv = ["rtp_phase.py", "--phase", "22"]
    runpy.run_path(os.path.join(root, "tools", "rtp_phase.py"),
                   run_name="__main__")


if __name__ == "__main__":
    main()
