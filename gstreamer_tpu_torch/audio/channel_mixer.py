"""Channel up/down-mix matrices: construction and application.

A copy of the JAX package's ``audio/channel_mixer.py`` (GstAudioChannelMixer,
reference: gst-libs/gst/audio/audio-channel-mixer.c — fill_identical,
fill_compatible, crossfeed ratios :377-392, fill_normalize, Q10 integer
matrix setup_matrix_int with PRECISION_INT 10).  The matrix is built at
negotiation time in numpy float32, as the C code does in gfloat; ``mix_int``
and ``mix_float`` apply it to torch tensors of (..., frames, in_channels).

CUDA has no int64 matrix product, so ``mix_int`` sums the products over the
input channels elementwise in int64: exact, as the reference's int64 ``@``
is (|Q10 tap| <= 1024 and at most 64 channels keep every sum under 2^47).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .info import (FC, FL, FLC, FR, FRC, LFE1, MONO, RC, RL, RR, SL, SR)

PRECISION_INT = 10   # audio-channel-mixer.c:55

RATIO_CENTER_FRONT = 1.0 / math.sqrt(2.0)
RATIO_CENTER_SIDE = 1.0 / 2.0
RATIO_CENTER_REAR = 1.0 / math.sqrt(8.0)
RATIO_FRONT_CENTER = 1.0 / math.sqrt(2.0)
RATIO_FRONT_SIDE = 1.0 / math.sqrt(2.0)
RATIO_FRONT_REAR = 1.0 / 2.0
RATIO_SIDE_CENTER = 1.0 / 2.0
RATIO_SIDE_FRONT = 1.0 / math.sqrt(2.0)
RATIO_SIDE_REAR = 1.0 / math.sqrt(2.0)
RATIO_CENTER_BASS = 1.0 / math.sqrt(2.0)
RATIO_FRONT_BASS = 1.0
RATIO_SIDE_BASS = 1.0 / math.sqrt(2.0)
RATIO_REAR_BASS = 1.0 / math.sqrt(2.0)


def _f32(x):
    return np.float32(x)


def build_matrix(in_pos: Sequence[str], out_pos: Sequence[str],
                 unpositioned_in: bool = False) -> np.ndarray:
    """(in_ch, out_ch) float32 mixing matrix."""
    ni, no = len(in_pos), len(out_pos)
    m = np.zeros((ni, no), np.float32)

    # 1. identical positions (fill_identical)
    for co in range(no):
        for ci in range(ni):
            if unpositioned_in:
                if ci == co:
                    m[ci][co] = 1.0
            elif in_pos[ci] == out_pos[co]:
                m[ci][co] = 1.0
    if unpositioned_in:
        return m

    # 2. compatible pairs (fill_compatible): (left,right) <-> center
    for (l, r), c in (((FL, FR), MONO), ((FLC, FRC), FC), ((RL, RR), RC)):
        i_l = in_pos.index(l) if l in in_pos else -1
        i_r = in_pos.index(r) if r in in_pos else -1
        i_c = in_pos.index(c) if c in in_pos else -1
        o_l = out_pos.index(l) if l in out_pos else -1
        o_r = out_pos.index(r) if r in out_pos else -1
        o_c = out_pos.index(c) if c in out_pos else -1

        # left -> center
        if i_l != -1 and i_c == -1 and o_l == -1 and o_c != -1:
            m[i_l][o_c] = 1.0
        elif i_l != -1 and i_c != -1 and o_l == -1 and o_c != -1:
            m[i_l][o_c] = 0.5
        elif i_l != -1 and i_c == -1 and o_l != -1 and o_c != -1:
            m[i_l][o_c] = 1.0
        # right -> center
        if i_r != -1 and i_c == -1 and o_r == -1 and o_c != -1:
            m[i_r][o_c] = 1.0
        elif i_r != -1 and i_c != -1 and o_r == -1 and o_c != -1:
            m[i_r][o_c] = 0.5
        elif i_r != -1 and i_c == -1 and o_r != -1 and o_c != -1:
            m[i_r][o_c] = 1.0
        # center -> left
        if i_c != -1 and i_l == -1 and o_c == -1 and o_l != -1:
            m[i_c][o_l] = 1.0
        elif i_c != -1 and i_l != -1 and o_c == -1 and o_l != -1:
            m[i_c][o_l] = 0.5
        elif i_c != -1 and i_l == -1 and o_c != -1 and o_l != -1:
            m[i_c][o_l] = 1.0
        # center -> right
        if i_c != -1 and i_r == -1 and o_c == -1 and o_r != -1:
            m[i_c][o_r] = 1.0
        elif i_c != -1 and i_r != -1 and o_c == -1 and o_r != -1:
            m[i_c][o_r] = 0.5
        elif i_c != -1 and i_r == -1 and o_c != -1 and o_r != -1:
            m[i_c][o_r] = 1.0

    # 3. "one-other" crossfeeds (fill_others, audio-channel-mixer.c:443-585)
    in_set = set(in_pos)
    out_set = set(out_pos)

    def has(side, *names):
        s = in_set if side == "in" else out_set
        return any(n in s for n in names)

    def feed(src_names, dst_names, ratio):
        """Mix every present src channel into every present dst channel."""
        for sn in src_names:
            if sn not in in_set:
                continue
            si = in_pos.index(sn)
            for dn in dst_names:
                if dn not in out_set:
                    continue
                di = out_pos.index(dn)
                if m[si][di] == 0.0:
                    m[si][di] = _f32(ratio)

    # front center <-> front left/right
    if has("in", FC, MONO) and not has("out", FC, MONO):
        feed((FC, MONO), (FL, FR), RATIO_CENTER_FRONT)
        feed((FC, MONO), (SL, SR), RATIO_CENTER_SIDE)
        feed((FC, MONO), (RL, RR, RC), RATIO_CENTER_REAR)
    if not has("in", FC, MONO) and has("out", FC, MONO):
        feed((FL, FR), (FC, MONO), RATIO_CENTER_FRONT)
        feed((SL, SR), (FC, MONO), RATIO_CENTER_SIDE)
        feed((RL, RR, RC), (FC, MONO), RATIO_CENTER_REAR)
    # front left/right -> side/rear and back
    if has("in", FL, FR) and not has("out", FL, FR):
        feed((FL,), (SL,), RATIO_FRONT_SIDE)
        feed((FR,), (SR,), RATIO_FRONT_SIDE)
        feed((FL,), (RL, RC), RATIO_FRONT_REAR)
        feed((FR,), (RR, RC), RATIO_FRONT_REAR)
    if not has("in", FL, FR) and has("out", FL, FR):
        feed((SL,), (FL,), RATIO_SIDE_FRONT)
        feed((SR,), (FR,), RATIO_SIDE_FRONT)
        feed((RL, RC), (FL,), RATIO_FRONT_REAR)
        feed((RR, RC), (FR,), RATIO_FRONT_REAR)
    # side -> front/rear when sides dropped
    if has("in", SL, SR) and not has("out", SL, SR):
        feed((SL,), (FL,), RATIO_FRONT_SIDE)
        feed((SR,), (FR,), RATIO_FRONT_SIDE)
        feed((SL,), (RL,), RATIO_SIDE_REAR)
        feed((SR,), (RR,), RATIO_SIDE_REAR)
    # rear -> front/side when rears dropped
    if has("in", RL, RR, RC) and not has("out", RL, RR, RC):
        feed((RL, RC), (FL,), RATIO_FRONT_REAR)
        feed((RR, RC), (FR,), RATIO_FRONT_REAR)
        feed((RL,), (SL,), RATIO_SIDE_REAR)
        feed((RR,), (SR,), RATIO_SIDE_REAR)
    # LFE
    if LFE1 in in_set and LFE1 not in out_set:
        feed((LFE1,), (FC, MONO), RATIO_CENTER_BASS)
        feed((LFE1,), (FL, FR), RATIO_FRONT_BASS)
        feed((LFE1,), (SL, SR), RATIO_SIDE_BASS)
        feed((LFE1,), (RL, RR, RC), RATIO_REAR_BASS)
    if LFE1 not in in_set and LFE1 in out_set:
        feed((FC, MONO), (LFE1,), RATIO_CENTER_BASS)
        feed((FL, FR), (LFE1,), RATIO_FRONT_BASS)
        feed((SL, SR), (LFE1,), RATIO_SIDE_BASS)
        feed((RL, RR, RC), (LFE1,), RATIO_REAR_BASS)

    # 4. normalize so the loudest output sums to 1 (fill_normalize)
    top = np.abs(m).sum(axis=0).max()
    if top > 0:
        m = (m.astype(np.float32) / np.float32(top)).astype(np.float32)
    return m


def matrix_int(m: np.ndarray) -> np.ndarray:
    """Q10 integer matrix (setup_matrix_int: C truncation of f*1024)."""
    return (m * np.float32(1 << PRECISION_INT)).astype(np.int32)


def mix_int(samples: torch.Tensor, mint: np.ndarray) -> torch.Tensor:
    """S32 mix: out = (sum_in s*m + rounding) >> 10
    (audio-channel-mixer.c:916 round-shift).  samples: (..., frames, in)
    int32 -> (..., frames, out) int32."""
    m = torch.as_tensor(np.asarray(mint, np.int64), device=samples.device)
    s = samples.to(torch.int64)
    acc = s[..., 0:1] * m[0]
    for ci in range(1, m.shape[0]):
        acc = acc + s[..., ci:ci + 1] * m[ci]
    acc = (acc + (1 << (PRECISION_INT - 1))) >> PRECISION_INT
    acc = torch.clamp(acc, -(1 << 31), (1 << 31) - 1)
    return acc.to(torch.int32)


def mix_float(samples: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """float64 (..., frames, in) @ (in, out) matrix."""
    return samples @ torch.as_tensor(np.asarray(m, np.float64),
                                     device=samples.device)
