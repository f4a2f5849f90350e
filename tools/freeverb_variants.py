#!/usr/bin/env python3
"""Where the freeverb kernel spends its time on the card.

    python3 tools/freeverb_variants.py

Builds variants of ``gstreamer_tpu_torch/csrc/freeverb.cu``, each the
source with one text edit, and times each on one 480 000-frame push of
48 kHz stereo (the ``music_master`` push):

  full              the kernel as it is
  combs_alone       the consumers' loops cut: the comb warp and the barriers
  consumers_alone   the comb warp's loop cut: the consumers and the barriers
  no_stage, no_write_back, no_finish
                    consumers alone with one of their phases cut too
  barriers_only     both sides' loops cut
  allpasses_in_shared, rings_in_device_memory
                    the whole kernel with fewer rings in shared memory
                    than its schedule places there (the comb rings, then
                    all, read and written in device memory)

Every variant counts the comb warp's cycles with ``clock64()`` and stores
them a frame in place of the first filterstore, so the outputs of all but
``full`` are wrong by design (``chip_smoke.py`` checks the kernel itself).
A bare dependent float32 multiply and add, built with the same
``-fmad=false``, gives the floor.  Prints ms, cycles a frame and the SM
clock they imply, and the card's name and power limit; ``--rounds``
rounds, the variants in turn in each.  Needs a CUDA card and nvcc; builds
under ``gstreamer_tpu_torch/_build/variants``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CHAIN = r"""
extern "C" __global__ void chain(float* out, long long* cycles, int n,
                                 float d1, float d2) {
  float fs = threadIdx.x * 1e-3f, t = 0.5f;
  long long c0 = clock64();
  for (int i = 0; i < n; ++i) {
    fs = t * d2 + fs * d1;
    t = t + 1e-7f;
  }
  cycles[threadIdx.x] = clock64() - c0;
  out[threadIdx.x] = fs;
}
extern "C" int run(float* out, long long* cycles, int n) {
  chain<<<1, 32>>>(out, cycles, n, 0.3f, 0.7f);
  return 0;
}
"""

COMB_LOOP = "      if (comb) {\n        float4* w"
CONSUMER_FRAMES = "for (int f = q; f < nb; f += kConsumers)"
STAGE = CONSUMER_FRAMES + " {\n        const size_t t"
WRITE_BACK = CONSUMER_FRAMES + " {\n#pragma unroll\n        for (int k = 0;"
FINISH = "for (int j = q; j < len; j += kConsumers)"
PLACEMENT = "  return sc;\n}"


def edit(src: str, old: str, new: str) -> str:
    out = src.replace(old, new)
    if out == src:
        raise SystemExit(f"freeverb.cu no longer holds {old!r}")
    return out


def instrument(src: str) -> str:
    src = edit(src, "    bar_sync(kStart, kThreads);            // slots",
               "    const long long c0 = clock64();\n"
               "    bar_sync(kStart, kThreads);            // slots")
    return edit(src, "    if (comb) fss[s * kCombs + tid] = fs;",
                "    if (tid == 0) fss[s * kCombs] = "
                "static_cast<float>(clock64() - c0) / n;")


def cut(src: str, loop: str) -> str:
    """`loop` made to run no time."""
    return edit(src, loop, loop.replace(" < nb;", " < 0;")
                .replace(" < len;", " < 0;"))


def placed(src: str, most: int) -> str:
    """At most `most` as the schedule's ring placement."""
    return edit(src, PLACEMENT, f"  sc.shared = min(sc.shared, {most});\n"
                + PLACEMENT)


def variants(src: str) -> dict:
    no_combs = edit(src, COMB_LOOP, COMB_LOOP.replace("(comb)", "(false)"))
    combs_alone = cut(cut(src, CONSUMER_FRAMES), FINISH)
    return {
        "full": src,
        "combs_alone": combs_alone,
        "consumers_alone": no_combs,
        "no_stage": cut(no_combs, STAGE),
        "no_write_back": cut(no_combs, WRITE_BACK),
        "no_finish": cut(no_combs, FINISH),
        "barriers_only": cut(cut(no_combs, CONSUMER_FRAMES), FINISH),
        "allpasses_in_shared": placed(src, 1),
        "rings_in_device_memory": placed(src, 0),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    from gstreamer_tpu_torch.ops import _build
    from gstreamer_tpu_torch.ops import freeverb_kernel as fvk
    if not torch.cuda.is_available():
        print("freeverb_variants: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {f"freeverb_{k}": instrument(v) for k, v in variants(
        (_build.CSRC_DIR / "freeverb.cu").read_text()).items()}
    sources["chain"] = CHAIN
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        flags = (_build.flags("freeverb") if name != "chain" else
                 _build.flags("freeverb")[:2] + ("-O3", "-shared",
                                                 "-Xcompiler", "-fPIC",
                                                 "-fmad=false"))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *flags, "-I", str(_build.CSRC_DIR), "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            raise SystemExit(f"{name}: nvcc exited {proc.returncode}")

    def events_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    lib = ctypes.CDLL(str(out_dir / "libchain.so"))
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    out = torch.zeros(32, device="cuda")
    cycles = torch.zeros(32, dtype=torch.int64, device="cuda")
    steps = 4_000_000
    lib.run(out.data_ptr(), cycles.data_ptr(), steps)
    ms = events_ms(lambda: lib.run(out.data_ptr(), cycles.data_ptr(), steps))
    c = int(cycles[0]) / steps
    print(f"bare multiply-add chain: {c:.2f} cycles a step "
          f"({int(cycles[0]) / ms / 1e3:.0f} MHz over {ms:.3f} ms)")

    sizes = fvk.ring_sizes(48000)
    lay = fvk.layout(sizes)
    prm = fvk.params(0.6, 0.2, 1.0, 0.5)
    frames = 480000
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (1, frames, 2)) * 0.3).astype(np.float32)).cuda()
    res = torch.empty((1, frames, 2), device="cuda")
    fns = {}
    for name in sources:
        if name == "chain":
            continue
        vlib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        fn = vlib.gst_freeverb
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_float] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        # the variant's own placement, which its launch checks
        sched = (ctypes.c_int * 5)()
        vlib.gst_freeverb_schedule(ctypes.c_void_p(lay.ctypes.data),
                                   ctypes.byref(sched))
        fns[name] = (fn, sched[4])
    for rep in range(args.rounds):
        for name, (fn, shared) in fns.items():
            st = fvk.fresh_state(1, sizes, "cuda")

            def call():
                status = fn(
                    x.data_ptr(), res.data_ptr(), st["rings"].data_ptr(),
                    st["idx"].data_ptr(), st["fs"].data_ptr(), 1, frames, 2,
                    lay.ctypes.data, shared,
                    *(float(v) for v in prm), float(fvk.FIXED_GAIN),
                    float(fvk.DC_OFFSET),
                    torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise SystemExit(f"{name}: CUDA error {status}")
            call()
            ms = events_ms(call)
            c = float(st["fs"][0, 0])
            print(f"round {rep + 1} {name[len('freeverb_'):]} (rings in "
                  f"shared: {('none', 'allpasses', 'all')[shared]}): "
                  f"{ms:.4f} ms, comb warp {c:.2f} cycles a frame "
                  f"({c * frames / ms / 1e3:.0f} MHz)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
