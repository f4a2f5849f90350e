#!/usr/bin/env python3
"""What each part of the mixture kernel's design costs on the card.

    python3 tools/gmm_variants.py [--older PATH] [--rounds N]

Builds variants of ``gstreamer_tpu_torch/csrc/gmm.cu``, each the source with
one text edit, and runs each through the port's wrapper
(``ops/gmm_kernel.py::gmm``, its library swapped):

  as_built            the kernel as it is
  owned_select        two passes over the modes: the tests, then the
                      owned mode's values selected by its index, one
                      update, written back by selects, in place of one pass
                      that updates the owned mode in a branch
  sort_always         the sort and the running sum for every pixel, in
                      place of the heaviest mode alone where it holds at
                      least kSoleBg of the weight
  skip_zero_weights   the normalisation's division skipped where a weight is
                      zero (a warp whose lanes all hold a zero skips it), in
                      place of a division for every mode below nn
  normalise_live_only the normalisation's division in a branch on k < nn (a
                      warp skips the modes past its lanes' counts)
  no_prefetch         the frame's pixel loaded in its own trip, in place of
                      a trip ahead
  five_blocks_an_sm   registers capped for five blocks of 256 an SM (40
                      warps) in place of what the compiler takes
  shadow_every_mode   the shadow test of all five modes, background or not
  older               ``--older PATH``: another gmm.cu with the same C entry
                      point, e.g. the parent's from a ``git archive``
  cut_sort, cut_normalise, cut_shadow
                      the kernel with one part cut (the sorting network's
                      exchanges, the normalisation's divisions, the shadow
                      test): their outputs are wrong by design, their
                      times say what the part costs

Each variant but the cut ones is first held to ``gmm_plain`` bit for bit
on two small scenes (masks and carry), then each is timed as
``chip_smoke.py`` times the kernel (``cv_segment``'s first tick of 64 1080p
RGBA frames on the carry after its four ticks; a call back to back, CUDA
events), with its frame loop's SASS instructions (``tools/kernel_sass.py``'s
reading).
``--rounds`` rounds, the variants in turn in each.  Prints the card's name
and power limit.  Needs a CUDA card, nvcc and cuobjdump; builds under
``gstreamer_tpu_torch/_build/variants``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

OWNED_IN_PLACE = """    unsigned near = 0, live = 0;
    int first = -1;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = x[c] - m[k][c];
      const float dist2 = dot3(d, d);
      if (dist2 < v[k] * kTb) near |= 1u << k;
      const float w0 = w[k];
      w[k] = fmaf(alpha, -w0, w0) - act;
      if (first < 0 && k < n && dist2 < v[k] * kTg) {
        first = k;
        w[k] = fmaf(alpha, 1.0f - w0, w0) - act;
        // var's rate is the reference's second alpha / max(w', eps): the
        // same value as rho
        const float rho = alpha / fmaxf(w[k], kEps);
#pragma unroll
        for (int c = 0; c < 3; ++c) m[k][c] = fmaf(rho, d[c], m[k][c]);
        v[k] = fminf(fmaxf(fmaf(rho, dist2 - v[k], v[k]), kVarMin), kVarMax);
      }
      const bool alive = k < n && w[k] > 0.0f;
      if (!alive) w[k] = 0.0f;
      live |= alive ? 1u << k : 0u;
    }
"""

OWNED_SELECT = """    unsigned near = 0, own = 0;
    float dist2[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = x[c] - m[k][c];
      dist2[k] = dot3(d, d);
      if (dist2[k] < v[k] * kTb) near |= 1u << k;
      if (k < n && dist2[k] < v[k] * kTg) own |= 1u << k;
    }
    const int first = __ffs(static_cast<int>(own)) - 1;
    float wf = 0.0f, vf = 0.0f, d2f = 0.0f, mf[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const bool mine = k == first;
      w[k] = fmaf(alpha, (mine ? 1.0f : 0.0f) - w[k], w[k]) - act;
      wf = mine ? w[k] : wf;
      vf = mine ? v[k] : vf;
      d2f = mine ? dist2[k] : d2f;
#pragma unroll
      for (int c = 0; c < 3; ++c) mf[c] = mine ? m[k][c] : mf[c];
    }
    const float rho = alpha / fmaxf(wf, kEps);
    float um[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) um[c] = fmaf(rho, x[c] - mf[c], mf[c]);
    const float uv = fminf(fmaxf(fmaf(rho, d2f - vf, vf), kVarMin), kVarMax);
    unsigned live = 0;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const bool mine = k == first;
#pragma unroll
      for (int c = 0; c < 3; ++c) m[k][c] = mine ? um[c] : m[k][c];
      v[k] = mine ? uv : v[k];
      const bool alive = k < n && w[k] > 0.0f;
      if (!alive) w[k] = 0.0f;
      live |= alive ? 1u << k : 0u;
    }
"""

BOUNDS = "__global__ void __launch_bounds__(kThreads)\n"
SHADOW_GUARD = "        if (bg & (1u << k)) {\n"
SHADOW_BRANCH = "    if (!matches_bg && with_shadow) {"
EXCHANGE = "          exchange(ws[i], ws[i + 1], pm[i], pm[i + 1]);\n"
SOLE = "    if (wmax < kSoleBg) {\n"
NORMALISE = "w[k] = (k < nn) ? w[k] / tot : 0.0f;\n"
NORM_LOOP = "    for (int k = 0; k < kK; ++k) " + NORMALISE
LIVE_ONLY = """    for (int k = 0; k < kK; ++k) {
      if (k < nn) {
        w[k] = w[k] / tot;
      } else {
        w[k] = 0.0f;
      }
    }
"""
PREFETCH = """    if (f + 1 < frames) {
      nr = rp[off + pixels];
      ng = gp[off + pixels];
      nb = bp[off + pixels];
    }
"""
PIXEL = """    const float x[3] = {static_cast<float>(nr), static_cast<float>(ng),
                        static_cast<float>(nb)};
"""
PIXEL_NOW = """    const float x[3] = {static_cast<float>(rp[off]),
                        static_cast<float>(gp[off]),
                        static_cast<float>(bp[off])};
"""
ZERO_SKIP = """    for (int k = 0; k < kK; ++k) {
      if (k >= nn) {
        w[k] = 0.0f;
      } else if (w[k] != 0.0f) {
        w[k] = w[k] / tot;
      }
    }
"""
SHADOW_TEST = "          if (ratio >= kShadowTau"


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"gmm.cu no longer holds the text this variant "
                         f"edits: {old[:60]!r}")
    return src.replace(old, new)


def variants(src: str, older) -> dict:
    out = {"as_built": src,
           "owned_select": edit(src, OWNED_IN_PLACE, OWNED_SELECT),
           "sort_always": edit(src, SOLE, "    if (true) {\n"),
           "skip_zero_weights": edit(src, NORM_LOOP, ZERO_SKIP),
           "normalise_live_only": edit(src, NORM_LOOP, LIVE_ONLY),
           "no_prefetch": edit(edit(src, PREFETCH, ""), PIXEL, PIXEL_NOW),
           "five_blocks_an_sm": edit(
               src, BOUNDS,
               "__global__ void __launch_bounds__(kThreads, 5)\n"),
           "shadow_every_mode": edit(
               edit(src, SHADOW_GUARD, "        {\n"), SHADOW_TEST,
               "          if ((bg & (1u << k)) && ratio >= kShadowTau")}
    if older:
        out["older"] = Path(older).read_text()
    # timing only, their outputs wrong by design: one part cut each
    out["cut_sort"] = edit(src, EXCHANGE, "")
    out["cut_normalise"] = edit(src, NORMALISE,
                                "w[k] = (k < nn) ? w[k] : 0.0f;\n")
    out["cut_shadow"] = edit(src, SHADOW_BRANCH, "    if (false) {")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--older", help="another gmm.cu to time beside")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    import kernel_sass as ks
    from gstreamer_tpu_torch.ops import _build
    from gstreamer_tpu_torch.ops import gmm_kernel as gk

    dev = torch.device("cuda")
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((_build.CSRC_DIR / "gmm.cu").read_text(), args.older)
    procs = {}
    for name, text in srcs.items():
        cu = out_dir / f"gmm_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.flags("gmm"), "-I",
             str(_build.CSRC_DIR), "-o", str(out_dir / f"libgmm_{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns, sass = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        lib_path = out_dir / f"libgmm_{name}.so"
        lib = ctypes.CDLL(str(lib_path))
        lib.gst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gst_cuda_error_string.restype = ctypes.c_char_p
        fn = lib.gst_gmm
        fn.argtypes = [_build._C_TYPES[c] for c in "ppppppppppppiiffip"]
        fn.restype = ctypes.c_int
        fns[name] = (lib, fn)
        text = subprocess.run([ks.cuobjdump(), "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              check=True).stdout
        parsed = ks.parse(text)
        for fname, code in parsed["funcs"].items():
            loop = ks.outer_loop(fname, code, parsed["labels"])
            if code and loop:
                body = [c for c in code if loop[0] <= c[0] <= loop[1]]
                sass[name] = (len(body), dict(collections.Counter(
                    ks.klass(op) for _, op, _ in body).most_common()),
                    regs[-1] if regs else "")

    real = _build.function

    def use(name):
        def function(lib_name, symbol, signature):
            if lib_name == "gmm":
                return fns[name]
            return real(lib_name, symbol, signature)
        _build.function = function

    rng = np.random.default_rng(1)
    try:
        for name in srcs:
            if name.startswith("cut_"):
                continue
            use(name)
            for kind in ("noisy", "five"):
                planes = [p.to(dev) for p in cs.cv_scene(kind, 6, 37, 45,
                                                         rng)]
                carry = {k: torch.from_numpy(v).to(dev)
                         for k, v in gk.init_carry(37, 45).items()}
                alpha, act = gk.rates(0.05, True)
                kc, km = gk.gmm(carry, *planes, alpha, act, True)
                pc, pm = gk.gmm_plain(carry, *planes, alpha, act, True)
                if not (cs.cv_bits_equal(km, pm) and all(
                        cs.cv_bits_equal(kc[k], pc[k]) for k in kc)):
                    raise SystemExit(f"{name}: differs from gmm_plain "
                                     f"({kind})")
        w, h, n, ticks = cs.CV_SEGMENT
        frames = cs.cv_segment_frames(n, h, w, ticks, 0, dev)
        carry = {k: torch.from_numpy(v).to(dev)
                 for k, v in gk.init_carry(h, w).items()}
        alpha, act = gk.rates(0.01, True)
        use("as_built")
        for planes in frames:         # chip_smoke.py's state: the last carry
            carry, _ = gk.gmm(carry, *planes[:3], alpha, act, True)
        r, g, b = frames[0][:3]
        times = collections.defaultdict(list)
        for _ in range(args.rounds):
            for name in srcs:
                use(name)
                times[name].append(cs.cuda_ms(
                    lambda: gk.gmm(carry, r, g, b, alpha, act, True), 5, 1))
    finally:
        _build.function = real
    for name in srcs:
        count, classes, regs = sass.get(name, (0, {}, ""))
        print(f"{name}: {' '.join(f'{t:.4f}' for t in times[name])} ms a "
              f"1080p tick of 64 (a call back to back); frame loop "
              f"{count} SASS instructions a trip {classes}; {regs}")
    print(cs.smi_line() or "nvidia-smi printed nothing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
