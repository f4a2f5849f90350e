#!/usr/bin/env python3
"""Check and time the tap-scale kernels under different tilings.

    python3 sweep_scale2pass.py [--check-only] [--h-only] [--seed N]

Needs one CUDA card.  Builds csrc/yscale.cu, scale2d.cu, chroma420.cu,
hscale.cu and fused_ingest.cu, holds yscale_hv, scale_hv_u8, chroma420_scale,
hscale_u8 and fused_i420_up_hscale against their plain versions bit for bit
at small and awkward shapes (odd sizes, widths that are no multiple of 16,
views that start off a 16-byte boundary, all sitings), then times them at
1920x1080 -> 224x224 (linear/2 and cubic taps, batch 256 and 64) for each
tiling variant.  Two-pass kernels: (largest tile of output rows, ring depths
tried, shared-memory target of a block).  h-only kernels (hscale_u8,
fused_i420_up_hscale): (ring depths tried, blocks an SM tried, blocks a slot of
the card takes in turn for hscale_u8 and for the fused kernel, fewest chunks
a block owns); --h-only times only these.  The variant the package ships is
the first of each list.  Prints one line per measurement and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys

VARIANTS = [      # MAX_TILE_ROWS, STAGES, SMEM_TARGET
    (32, (3, 2), 112 * 1024),
    (32, (2,), 112 * 1024),
    (16, (3, 2), 75 * 1024),
    (32, (3, 2), 75 * 1024),
]
H_VARIANTS = [    # H_STAGES, H_BLOCKS_PER_SM, HSCALE_WAVES, FUSED_WAVES, MIN_RUN
    ((4, 3, 2), (3, 2, 1), 16, 2, 2),
    ((4, 3, 2), (3, 2, 1), 16, 1, 2),
    ((4, 3, 2), (3, 2, 1), 16, 4, 2),
    ((4, 3, 2), (3, 2, 1), 16, 8, 2),
    ((4, 3, 2), (3, 2, 1), 1, 2, 2),
    ((4, 3, 2), (3, 2, 1), 32, 2, 2),
    ((4, 3, 2), (2, 1), 16, 2, 2),
    ((2,), (3, 2, 1), 16, 2, 2),
]
CHECKS = [        # B, H, W, OH, OW, method, taps
    (2, 48, 64, 24, 32, "linear", 2),
    (2, 48, 64, 24, 32, "cubic", 0),
    (3, 46, 70, 20, 33, "lanczos", 0),
    (2, 47, 71, 20, 33, "cubic", 0),
    (2, 270, 484, 112, 112, "linear", 2),
    (2, 62, 130, 40, 100, "lanczos", 0),
    (2, 128, 256, 256, 64, "linear", 0),
    (1, 48, 64, 1, 5, "cubic", 0),
    (4, 1080, 1920, 224, 224, "linear", 2),
    (4, 1080, 1920, 224, 224, "cubic", 0),
    (2, 720, 1280, 224, 224, "lanczos", 0),
    (1, 1080, 1920, 540, 960, "cubic", 0),      # a smaller tile, ring of 2
    (1, 2160, 3840, 1080, 1920, "cubic", 0),    # one block an SM
    (1, 2160, 3840, 224, 224, "cubic", 0),      # 69 x 38 taps
]


def cuda_ms(fn, iters=20, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def resamplers(method, taps, w, h, ow, oh):
    from gstreamer_tpu_torch.video.scaler import make_resampler
    kw = {"max_taps_opt": taps} if taps else {}
    return (make_resampler(method, w, ow, 0, **kw),
            make_resampler(method, h, oh, 0, **kw))


def same(k, p, what):
    """True when kernel output k equals plain output p; else say where."""
    import torch
    if torch.equal(k, p):
        return True
    bad = (k != p).nonzero()
    print(f"  {what}: {len(bad)} of {k.numel()} differ, max "
          f"{int((k.int() - p.int()).abs().max())}; first at "
          f"{bad[:6].tolist()}: kernel "
          f"{[int(k[tuple(i)]) for i in bad[:6]]}, plain "
          f"{[int(p[tuple(i)]) for i in bad[:6]]}; rows "
          f"{sorted(set(bad[:, 1].tolist()))[:12]}, cols "
          f"{sorted(set(bad[:, 2].tolist()))[:12]}")
    return False


def check(rng, dev):
    import torch
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    good = True
    for b, h, w, oh, ow, method, taps in CHECKS:
        hr, vr = resamplers(method, taps, w, h, ow, oh)
        ch, cw = (h + 1) // 2, (w + 1) // 2
        for skew in (0, 1):      # skew 1: a view that starts one byte in
            def plane(hh, ww):
                flat = torch.as_tensor(rng.integers(
                    0, 256, b * hh * ww + 16, dtype="uint8")).to(dev)
                return flat[skew:skew + b * hh * ww].view(b, hh, ww)
            y, c = plane(h, w), plane(ch, cw)
            ok = same(ysk.yscale_hv(y, hr, vr),
                      ysk.yscale_hv_plain(y, hr, vr), "yscale_hv")
            ok2 = same(s2k.scale_hv_u8(y, hr, vr),
                       s2k.scale_hv_u8_plain(y, hr, vr), "scale_hv_u8")
            oks = [same(ck.chroma420_scale(c, hr, vr, hc, vc, w, h),
                        ck.chroma420_scale_plain(c, hr, vr, hc, vc),
                        f"chroma420_scale {hc} {vc}")
                   for hc, vc in itertools.product((False, True), repeat=2)]
            ok3 = same(hk.hscale_u8(y, hr), hk.hscale_u8_plain(y, hr),
                       "hscale_u8")
            okf = []
            if h % 2 == 0 and w % 2 == 0:
                c2 = plane(ch, cw)
                for hc in (False, True):
                    okf += [same(k, p, f"fused_i420_up_hscale {hc} out {i}")
                            for i, (k, p) in enumerate(zip(
                                fk.fused_i420_up_hscale(y, c, c2, hr, hc),
                                fk.fused_i420_up_hscale_plain(y, c, c2, hr,
                                                              hc)))]
            torch.cuda.synchronize()
            print(f"check {(b, h, w)} -> {(oh, ow)} {method}/{taps} skew "
                  f"{skew}: yscale {ok}, scale_hv {ok2}, chroma {oks}, "
                  f"hscale {ok3}, fused {okf}")
            good = good and ok and ok2 and ok3 and all(oks) and all(okf)
    if not good:
        raise SystemExit("kernel differs from its plain version")


def sweep(rng, dev):
    import torch
    from gstreamer_tpu_torch.ops import _scale2pass as sp
    from gstreamer_tpu_torch.ops import chroma420_kernel as ck
    from gstreamer_tpu_torch.ops import scale2d_kernel as s2k
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    w, h, ow, oh = 1920, 1080, 224, 224
    y = torch.as_tensor(rng.integers(0, 256, (256, h, w), dtype="uint8")
                        ).to(dev)
    c = torch.as_tensor(rng.integers(0, 256, (256, h // 2, w // 2),
                                     dtype="uint8")).to(dev)
    for tile, stages, target in VARIANTS * 2:
        sp.MAX_TILE_ROWS, sp.STAGES, sp.SMEM_TARGET = tile, stages, target
        for method, taps in (("linear", 2), ("cubic", 0)):
            hr, vr = resamplers(method, taps, w, h, ow, oh)
            p = sp.plan(hr, vr, 12)
            pc = sp.plan(hr, vr, 12, h // 2, w // 2, False)
            for n in (256, 64):
                ms = dict(
                    yscale=cuda_ms(lambda: ysk.yscale_hv(y[:n], hr, vr)),
                    scale_hv=cuda_ms(lambda: s2k.scale_hv_u8(y[:n], hr, vr)),
                    chroma=cuda_ms(lambda: ck.chroma420_scale(
                        c[:n], hr, vr, False, False, w, h)))
                print(f"time tile<={tile} stages{stages} target {target}: "
                      f"{method}/{hr.max_taps}x{vr.max_taps} batch {n}: "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                      + f"; plane tile {p.tile_rows} stages {p.stages} smem "
                      f"{p.smem}; chroma tile {pc.tile_rows} stages "
                      f"{pc.stages} smem {pc.smem}")
    sp.MAX_TILE_ROWS, sp.STAGES, sp.SMEM_TARGET = VARIANTS[0]


def sweep_h(rng, dev):
    """hscale_u8 and fused_i420_up_hscale under H_VARIANTS, twice over, in
    turns, so that a drift of the card shows."""
    import torch
    from gstreamer_tpu_torch.ops import _scale2pass as sp
    from gstreamer_tpu_torch.ops import convert_kernel as fk
    from gstreamer_tpu_torch.ops import hscale_kernel as hk
    w, h, ow, oh = 1920, 1080, 224, 224
    y, u, v = (torch.as_tensor(rng.integers(0, 256, shape, dtype="uint8")
                               ).to(dev)
               for shape in ((256, h, w), (256, h // 2, w // 2),
                             (256, h // 2, w // 2)))
    for variant in H_VARIANTS * 2:
        (sp.H_STAGES, sp.H_BLOCKS_PER_SM, sp.HSCALE_WAVES, sp.FUSED_WAVES,
         sp.MIN_RUN) = variant
        for method, taps in (("linear", 2), ("cubic", 0)):
            hr, _ = resamplers(method, taps, w, h, ow, oh)
            p, pf = sp.hplan(hr, 12), sp.hplan(hr, 12, fused=True)
            for n in (256, 64):
                ms = dict(
                    hscale=cuda_ms(lambda: hk.hscale_u8(y[:n], hr)),
                    fused=cuda_ms(lambda: fk.fused_i420_up_hscale(
                        y[:n], u[:n], v[:n], hr, False)))
                print(f"time h-only {variant}: {method}/{hr.max_taps} batch "
                      f"{n}: " + ", ".join(f"{k} {t:.4f} ms"
                                           for k, t in ms.items())
                      + f"; hscale stages {p.stages} smem {p.smem} blocks/SM "
                      f"{p.blocks_per_sm}; fused stages {pf.stages} smem "
                      f"{pf.smem} blocks/SM {pf.blocks_per_sm}")
    (sp.H_STAGES, sp.H_BLOCKS_PER_SM, sp.HSCALE_WAVES, sp.FUSED_WAVES,
     sp.MIN_RUN) = H_VARIANTS[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--h-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_scale2pass: needs a CUDA card", file=sys.stderr)
        return 2
    from gstreamer_tpu_torch.ops import _build
    names = ("yscale", "scale2d", "chroma420", "hscale", "fused_ingest")
    _build.build(names)
    for src in names:
        for line in (_build.BUILD_DIR / f"{src}.log").read_text().splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"ptxas {src}: {line.strip()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    check(rng, dev)
    if not args.check_only:
        if not args.h_only:
            sweep(rng, dev)
        sweep_h(rng, dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
