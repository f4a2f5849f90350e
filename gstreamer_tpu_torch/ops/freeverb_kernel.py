"""Freeverb's per-sample recursion: CUDA kernel, plain version, count.

Replaces the jitted ``lax.scan`` of ``gstreamer_tpu/elements/freeverb.py``
(:131-198; Pallas has no counterpart).  Reference: gst-plugins-bad
gst/freeverb/gstfreeverb.c (Jezar's Freeverb) — per stereo engine 8 + 8
damped combs in parallel and 4 + 4 allpasses in series:

  comb:    tmp = buf[i]; fs = tmp*damp2 + fs*damp1; buf[i] = in + fs*feedback
  allpass: bo = buf[i]; out = bo - in; buf[i] = in + bo*0.5
  out_l    ((0 + c0) + c1) + ... + c7 through the allpasses, minus DC
  L        out_l*wet1 + out_r*wet2 + in_l*dry   (R mirrored)

every operation rounded to float32 on its own, as the scalar reference
does (the kernel is built with ``-fmad=false``).  A stream's state is one
flat float32 row of rings (24 rings: combs left, combs right, allpasses
left, allpasses right, at ``layout``'s offsets), 24 int32 ring indices and
16 float32 filterstores; both versions update it in place.

The kernel is ``csrc/freeverb.cu``, a block-pipelined schedule of one
8-warp block a stream.  Every ring is a delay at least as long as itself,
so in a block of B frames (``schedule``: at most half the shortest comb
ring, at most 512) no comb reads what the block writes, and in a chunk of
C frames (the shortest allpass ring) no allpass does.  One warp runs only
the 16 comb recursions (``fs = tmp*damp2 + fs*damp1``, the one dependency
from frame to frame), reading each block's ring values from a
shared-memory window and writing the new ones over them.  Seven warps stay
a block behind it and ahead of it: they stage the windows of later blocks
from the comb rings with the comb inputs and the channels' comb sums,
write the comb warp's values back, and run the allpasses chunk by chunk,
DC and the mix.  The rings sit in shared memory for the call where they
fit (``schedule``), else in device memory.  Only independent operations
are reordered, so the bits are the reference's.  ``schedule`` mirrors the
kernel's own derivation, which ``kernel_schedule`` reads back on a card;
the kernel refuses a launch whose placement differs from its own.

Bound on the H100: latency — the filterstore's float32 multiply and add a
frame (8 cycles), not bytes or operations.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import numpy as np
import torch

from . import _build

COMB_TUNINGS = [1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617]
ALLPASS_TUNINGS = [556, 441, 341, 225]
STEREO_SPREAD = 23
FIXED_GAIN = np.float32(0.015)
SCALE_ROOM = np.float32(0.28)
OFFSET_ROOM = np.float32(0.7)
DC_OFFSET = np.float32(1e-8)

N_COMBS = 16
N_RINGS = 24
MAX_BLOCK = 512                 # the kernel's frames a block at most
SLOT_ROWS = N_COMBS + 6         # a slot: 16 windows, 2 inputs, sums, samples
# the opt-in shared memory of a block on the H100 (232 448 bytes)
SHARED_LIMIT = 227 * 1024


def ring_sizes(rate: int) -> list:
    """The 24 ring lengths at `rate`: the 44.1 kHz tunings scaled in
    float32 and truncated as the reference's C does
    (gst_freeverb_init_rev_model :484-530), at least 1."""
    srf = np.float32(rate) / np.float32(44100.0)

    def scaled(tunings, spread):
        return [max(int(np.float32(t + spread) * srf), 1) for t in tunings]

    return (scaled(COMB_TUNINGS, 0) + scaled(COMB_TUNINGS, STEREO_SPREAD)
            + scaled(ALLPASS_TUNINGS, 0)
            + scaled(ALLPASS_TUNINGS, STEREO_SPREAD))


def layout(sizes: Sequence[int]) -> np.ndarray:
    """The 24 ring offsets, the 24 sizes and the total, as 49 int32."""
    sizes = [int(s) for s in sizes]
    if len(sizes) != N_RINGS or min(sizes) < 1:
        raise ValueError(f"freeverb: need {N_RINGS} ring sizes >= 1, got "
                         f"{sizes}")
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return np.ascontiguousarray(
        np.concatenate([off, sizes, [sum(sizes)]]), dtype=np.int32)


def schedule(sizes: Sequence[int]) -> Dict[str, int]:
    """The kernel's schedule, derived from the ring lengths as
    ``csrc/freeverb.cu``'s ``schedule`` derives it: frames a block (at most
    half the shortest comb ring, at most MAX_BLOCK, at least 1), the lag
    (blocks the consumers stage ahead of the comb warp: 2 when a block is
    at most half the shortest comb ring, else 1), frames an allpass chunk
    (the shortest allpass ring), the floats of a row of the block buffers,
    and which rings the kernel keeps in shared memory for the call beside
    its two slots of block buffers (``shared``: 2 all 24 when they fit, 1
    the allpasses when they do, else 0; the rest stay in device
    memory)."""
    sizes = [int(v) for v in sizes]
    cmin, amin = min(sizes[:N_COMBS]), min(sizes[N_COMBS:])
    block = min(cmin // 2, MAX_BLOCK) if cmin >= 2 else 1
    pitch = (block + 31) // 32 * 32 + 4
    buffers = 2 * SLOT_ROWS * pitch * 4
    shared = (2 if buffers + sum(sizes) * 4 <= SHARED_LIMIT else
              1 if buffers + sum(sizes[N_COMBS:]) * 4 <= SHARED_LIMIT else 0)
    return {"block": block, "lag": 2 if 2 * block <= cmin else 1,
            "chunk": amin, "pitch": pitch, "shared": shared}


@functools.lru_cache(maxsize=None)
def _plan(sizes: tuple) -> tuple:
    """(layout, schedule) of a tuple of ring lengths, derived once: a
    stream's ring lengths are fixed by its rate, and deriving them costs
    more host time than the kernel takes on a short push."""
    lay = layout(sizes)
    lay.setflags(write=False)
    return lay, schedule(sizes)


def kernel_schedule(sizes: Sequence[int]) -> Dict[str, int]:
    """The schedule ``csrc/freeverb.cu`` itself derives for these ring
    lengths (``gst_freeverb_schedule``; builds the kernel, so it needs
    nvcc), to hold ``schedule`` to it.  The kernel refuses a launch whose
    placement differs from its own."""
    lay, _ = _plan(tuple(int(v) for v in sizes))
    lib, fn = _build.function("freeverb", "gst_freeverb_schedule", "pp")
    out = (ctypes.c_int * 5)()
    _build.check(lib, fn(lay.ctypes.data, ctypes.addressof(out)),
                 "freeverb schedule")
    return dict(zip(("block", "lag", "chunk", "pitch", "shared"), out))


def fresh_state(streams: int, sizes: Sequence[int],
                device) -> Dict[str, torch.Tensor]:
    """Rings filled with DC_OFFSET, indices and filterstores 0."""
    total = int(layout(sizes)[-1])
    return {
        "rings": torch.full((streams, total), float(DC_OFFSET),
                            dtype=torch.float32, device=device),
        "idx": torch.zeros((streams, N_RINGS), dtype=torch.int32,
                           device=device),
        "fs": torch.zeros((streams, N_COMBS), dtype=torch.float32,
                          device=device),
    }


def params(room_size: float, damping: float, width: float,
           level: float) -> tuple:
    """(feedback, damp1, damp2, wet1, wet2, dry) as float32, mapped as the
    reference maps its properties (:543-568; scaledamp = scalewet = 1)."""
    f = np.float32
    feedback = f(room_size) * SCALE_ROOM + OFFSET_ROOM
    damp1 = f(damping)
    damp2 = f(1.0) - damp1
    wet = f(level)
    wet1 = wet * (f(width) / f(2.0) + f(0.5))
    wet2 = wet * ((f(1.0) - f(width)) / f(2.0))
    dry = f(1.0) - f(level)
    return tuple(f(v) for v in (feedback, damp1, damp2, wet1, wet2, dry))


def _check_args(x, state, sizes, prm) -> tuple:
    lay, sc = _plan(tuple(int(v) for v in sizes))
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] not in (1, 2):
        raise ValueError("freeverb: needs (streams, n, 1 or 2) float32 "
                         f"samples, got {tuple(x.shape)} {x.dtype}")
    s = x.shape[0]
    want = {"rings": ((s, int(lay[-1])), torch.float32),
            "idx": ((s, N_RINGS), torch.int32),
            "fs": ((s, N_COMBS), torch.float32)}
    for key, (shape, dtype) in want.items():
        t = state[key]
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != x.device:
            raise ValueError(f"freeverb: state {key!r} must be {shape} "
                             f"{dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if len(prm) != 6:
        raise ValueError(f"freeverb: need 6 parameters, got {len(prm)}")
    return lay, sc


def freeverb_plain(x: torch.Tensor, state: Dict[str, torch.Tensor],
                   sizes: Sequence[int], prm: Sequence) -> torch.Tensor:
    """The plain version: a torch loop over the samples, each step
    vectorised over the streams and the 16 combs (and the two channels'
    allpasses), every operation a float32 one."""
    lay, _ = _check_args(x, state, sizes, prm)
    feedback, damp1, damp2, wet1, wet2, dry = (float(v) for v in prm)
    dc, gain = float(DC_OFFSET), float(FIXED_GAIN)
    dev = x.device
    s, n, ch = x.shape
    in2 = x.expand(s, n, 2) if ch == 1 else x
    if ch == 2:
        in1 = (x + dc) * gain
    else:
        in1 = ((x * 2.0 + dc) * gain).expand(s, n, 2)
    # each comb's input: the left channel's for combs 0-7, the right's after
    comb_in = in1[:, :, [0] * 8 + [1] * 8].unbind(1)
    off = torch.as_tensor(lay[:N_RINGS].astype(np.int64), device=dev)
    size = torch.as_tensor(lay[N_RINGS:2 * N_RINGS].astype(np.int64),
                           device=dev)
    rings = state["rings"]
    idx = state["idx"].to(torch.int64)
    fs = state["fs"].clone()
    zero = torch.zeros((s, 2), dtype=torch.float32, device=dev)
    wet = torch.empty((s, n, 2), dtype=torch.float32, device=dev)
    for t in range(n):
        pos = off + idx
        vals = rings.gather(1, pos)
        tmp = vals[:, :N_COMBS]
        fs = tmp * damp2 + fs * damp1
        comb_w = comb_in[t] + fs * feedback
        # the comb outputs summed in the reference's order, both channels
        # at once
        v = zero
        for c in tmp.view(s, 2, 8).unbind(2):
            v = v + c
        bo = vals[:, N_COMBS:].view(s, 2, 4)
        ins = []
        for k in range(4):
            ins.append(v)
            v = bo[:, :, k] - v
        ap_w = torch.stack(ins, dim=2) + bo * 0.5
        rings.scatter_(1, pos, torch.cat([comb_w, ap_w.view(s, 8)], dim=1))
        idx = torch.remainder(idx + 1, size)
        wet[:, t] = v
    state["idx"].copy_(idx)
    state["fs"].copy_(fs)
    wet = wet - dc
    return (wet * wet1 + wet.flip(2) * wet2) + in2 * dry


def freeverb(x: torch.Tensor, state: Dict[str, torch.Tensor],
             sizes: Sequence[int], prm: Sequence) -> torch.Tensor:
    """(streams, n, 1 or 2) float32 -> (streams, n, 2) float32 through one
    stereo engine a stream (mono input feeds both sides), `state`
    (``fresh_state``) carried in place; `sizes` the 24 ring lengths
    (``ring_sizes``), `prm` the six float32 parameters (``params``).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream (without synchronising) or raises.  The kernel
    keeps the rings in shared memory for the call where they fit
    (``schedule``), else in device memory."""
    if x.device.type == "cpu":
        return freeverb_plain(x, state, sizes, prm)
    if x.device.type != "cuda":
        raise ValueError(f"freeverb: unsupported device {x.device}")
    lay, sc = _check_args(x, state, sizes, prm)
    if not (x.is_contiguous()
            and all(t.is_contiguous() for t in state.values())):
        raise ValueError("freeverb: the samples and the state must be "
                         "contiguous")
    s, n, ch = x.shape
    out = torch.empty((s, n, 2), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib, fn = _build.function("freeverb", "gst_freeverb",
                              "pppppiiipiffffffffp")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), out.data_ptr(), state["rings"].data_ptr(),
                    state["idx"].data_ptr(), state["fs"].data_ptr(), s, n,
                    ch, lay.ctypes.data, sc["shared"],
                    *(float(v) for v in prm), float(FIXED_GAIN),
                    float(DC_OFFSET), stream)
    _build.check(lib, status, "freeverb")
    freeverb.launches += 1
    return out


freeverb.launches = 0
