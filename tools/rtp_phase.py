#!/usr/bin/env python3
"""Run chip_smoke.py's RTP / RTSP phase (phase 20, ``rtp_rtsp_phase``), its
FEC / payloader / Siren phase (phase 21, ``rtp_fec_phase``), its phase of
the rest of net/ (phase 22, ``net_tail_phase``), its phase of the libav
family, LC3, Smoke and FLIC (phase 23, ``codec_tail_phase``), its phase
of subtitles, tags and the last parsers (phase 24, ``tags_subs_phase``) or
its phase of the last factories (phase 25, ``leaves_phase``) or its
phase of the last host modules (phase 26, ``tail_modules_phase``:
convert_sample, Harness, the validate monitor, the editing timeline and
the host items) alone on one CUDA card: build the port's kernels, count the kernel
wrappers' launches as chip_smoke.py does, run the phase, print the card's
name and power limit.

    python3 tools/rtp_phase.py [--seed N] [--phase 20|21|22|23|24|25|26]

Exits non-zero without a card, or when any check of the phase fails.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", type=int, choices=(20, 21, 22, 23, 24, 25, 26),
                    default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rtp_phase: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from gstreamer_tpu_torch.device import resolve
    from gstreamer_tpu_torch.ops import _build
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    _build.build()
    counters = {"yscale_hv": ysk.yscale_hv,
                "chroma420_scale": ck.chroma420_scale}
    phase = {20: chip_smoke.rtp_rtsp_phase,
             21: chip_smoke.rtp_fec_phase,
             22: chip_smoke.net_tail_phase,
             23: chip_smoke.codec_tail_phase,
             24: chip_smoke.tags_subs_phase,
             25: chip_smoke.leaves_phase,
             26: chip_smoke.tail_modules_phase}[args.phase]
    total = phase(args.seed, counters, resolve())
    print(f"phase {args.phase} launches: {total}")
    print(chip_smoke.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
