#!/usr/bin/env python3
"""What a port kernel's main loop compiles to, and the issue time it implies.

    python3 tools/kernel_sass.py gmm --threads 2073600 --trips 64

Builds ``gstreamer_tpu_torch/csrc/<source>.cu`` as the port builds it
(``ops/_build.py``), disassembles the library with ``cuobjdump -sass`` and
finds each kernel's outermost loop (the backward branch that spans the
most code; ``--loop N`` picks another of the top-level loops it lists).
Prints, for each kernel, its SASS instructions, the loop's
instructions by class (float32 arithmetic, float compares and selects,
special functions, conversions, integer and predicate work, memory,
control), and, given ``--threads`` (threads launched) and ``--trips`` (the
loop's trips a thread), the issue bound: every warp issues the whole loop
body each trip, at one instruction a cycle on each of an SM's four
schedulers, at the card's maximum SM clock.  Branches a warp skips are
counted as issued, so the bound is the straight line's.  Needs nvcc,
cuobjdump and a CUDA card (for the SM count and clock); prints the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
CLASSES = (
    ("float32 arithmetic", ("FADD", "FMUL", "FFMA", "FMNMX")),
    ("float compare/select", ("FSETP", "FSET", "FSEL", "FCHK")),
    ("special function", ("MUFU",)),
    ("conversion", ("I2F", "F2I", "F2F", "I2FP", "F2IP", "FRND")),
    ("memory", ("LD", "ST", "LDG", "STG", "LDC", "LDS", "STS", "ULDC")),
    ("control", ("BRA", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "WARPSYNC",
                 "NOP", "BAR")),
)


def klass(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in CLASSES:
        if base in ops:
            return name
    return "integer/predicate/move"


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    from gstreamer_tpu_torch.ops import _build
    return str(Path(_build.nvcc_path()).with_name("cuobjdump"))


def parse(text: str) -> dict:
    """{function: [(address, opcode, text)]} and each label's address."""
    funcs: dict = {}
    labels: dict = {}
    name, pending = None, []
    for line in text.splitlines():
        m = FUNC.match(line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = LABEL.match(line)
        if m and name:
            pending.append(m.group(1))
            continue
        m = INSTR.match(line)
        if m and name:
            addr = int(m.group(1), 16)
            body = m.group(2).strip()
            if body.startswith("@"):
                body = body.split(None, 1)[1]
            op = body.split()[0]
            funcs[name].append((addr, op, body))
            for lab in pending:
                labels[(name, lab)] = addr
            pending = []
    return {"funcs": funcs, "labels": labels}


def loops(name: str, code: list, labels: dict) -> list:
    """(start, end) addresses of every backward branch's loop that no other
    such loop contains, in address order."""
    found = []
    for addr, op, body in code:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"(0x[0-9a-f]+)|(\.L_x_\d+)", body)
        if not m:
            continue
        target = (int(m.group(1), 16) if m.group(1)
                  else labels.get((name, m.group(2))))
        if target is not None and target < addr:
            found.append((target, addr))
    return sorted(a for a in found
                  if not any(b != a and b[0] <= a[0] and a[1] <= b[1]
                             for b in found))


def outer_loop(name: str, code: list, labels: dict):
    """(start, end) addresses of the backward branch spanning the most."""
    found = loops(name, code, labels)
    return max(found, key=lambda a: a[1] - a[0]) if found else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", help="csrc/<source>.cu, e.g. gmm")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--trips", type=int, default=0)
    ap.add_argument("--loop", type=int, default=None,
                    help="which top-level loop to read (default: the one "
                         "spanning the most code), e.g. 0 for disparity's "
                         "loop over the chunks inside the image")
    args = ap.parse_args()
    from gstreamer_tpu_torch.ops import _build
    lib = _build.build((args.source,))[args.source]
    text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    parsed = parse(text)
    for name, code in parsed["funcs"].items():
        if not code:
            continue
        print(f"{name}: {len(code)} SASS instructions")
        top = loops(name, code, parsed["labels"])
        if not top:
            print("  no loop")
            continue
        if len(top) > 1:
            print("  top-level loops: " + ", ".join(
                f"[{i}] {a:#x}..{b:#x} "
                f"{sum(a <= c[0] <= b for c in code)} instructions"
                for i, (a, b) in enumerate(top)))
        loop = (top[args.loop] if args.loop is not None
                and args.loop < len(top) else
                max(top, key=lambda a: a[1] - a[0]))
        body = [c for c in code if loop[0] <= c[0] <= loop[1]]
        by_class = collections.Counter(klass(op) for _, op, _ in body)
        by_op = collections.Counter(op.split(".")[0] for _, op, _ in body)
        print(f"  outer loop {loop[0]:#x}..{loop[1]:#x}: {len(body)} "
              f"instructions a trip; by class {dict(by_class.most_common())}")
        print(f"  by opcode {dict(by_op.most_common(24))}")
        if args.threads and args.trips:
            import torch
            props = torch.cuda.get_device_properties(0)
            clock = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60).stdout.split()[0]) * 1e6
            warps = -(-args.threads // 32)
            ms = (warps * args.trips * len(body)
                  / (4 * props.multi_processor_count * clock) * 1e3)
            print(f"  issue bound {ms:.4f} ms: {warps} warps x {args.trips} "
                  f"trips x {len(body)} instructions at 4 a cycle on each of "
                  f"{props.multi_processor_count} SMs at {clock / 1e6:.0f} "
                  f"MHz")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi or "nvidia-smi printed nothing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
