"""Fused 4:2:0 chroma upsample + h+v scale: CUDA kernel, plain version, count.

Replaces ``gstreamer_tpu/ops/chroma420_kernel.py::chroma420_scale``
(pallas_call at :159): a (B, ch, cw) uint8 half-resolution chroma plane is
upsampled 2x in both directions with the video-chroma.c integer filters
(cosited or interstitial) and scaled h then v with per-pass rounding, into
(B, OH, OW) int32 in 0..255.  The kernel is ``csrc/chroma420.cu``.

Bound on the H100: operations.  The half-res plane read is small (0.52 MB
per 1080p frame); the tap products over the full-resolution virtual plane
(35x20 taps at cubic, run on ``dp4a``) and the two up2 filters over it are
the larger side.  Per chunk of 8 needed full-resolution rows the kernel
stages only the chroma rows they are built from (``_scale2pass.
chroma_table``), filters columns, then rows, as byte arithmetic on whole
words in shared memory, and hands the rows to the two-pass kernel; the up2
samples never reach device memory and each output is written once.
"""

from __future__ import annotations

import torch

from ..video import chroma as chroma_mod
from ..video.scaler import (SCALE_U8, scale_cols_split_exact,
                            scale_rows_split_exact)
from . import _scale2pass


def applicable(h_res, v_res, cw: int, ch: int) -> bool:
    """Downscales only, as the reference routes (its bf16 limb bound is a
    TPU arithmetic limit and does not apply here)."""
    return (h_res is not None and v_res is not None
            and h_res.out_size <= cw and v_res.out_size <= ch)


def chroma420_scale_plain(c, h_res, v_res, h_cosited: bool, v_cosited: bool,
                          precision: int = SCALE_U8):
    """The plain version: up2_phases (columns, then rows) ->
    scale_cols_split_exact -> scale_rows_split_exact."""
    ci = c.to(torch.int16)               # before any arithmetic: u8 wraps
    ce, co = chroma_mod.up2_phases(torch, ci, -1, h_cosited)
    ce_re, ce_ro = chroma_mod.up2_phases(torch, ce, -2, v_cosited)
    co_re, co_ro = chroma_mod.up2_phases(torch, co, -2, v_cosited)
    h_re = scale_cols_split_exact(torch, ce_re, co_re, h_res, precision)
    h_ro = scale_cols_split_exact(torch, ce_ro, co_ro, h_res, precision)
    return scale_rows_split_exact(torch, h_re, h_ro, v_res, precision)


def chroma420_scale(c: torch.Tensor, h_res, v_res, h_cosited: bool,
                    v_cosited: bool, full_w: int, full_h: int,
                    precision: int = SCALE_U8) -> torch.Tensor:
    """(..., ch, cw) uint8 half-res chroma of a full_w x full_h frame ->
    (..., OH, OW) int32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream (without synchronising) or raises."""
    if (h_res.in_size, v_res.in_size) != (full_w, full_h):
        raise ValueError(
            f"chroma420_scale: resamplers scale {h_res.in_size}x"
            f"{v_res.in_size}, frame is {full_w}x{full_h}")
    if c.device.type == "cpu":
        return chroma420_scale_plain(c, h_res, v_res, h_cosited, v_cosited,
                                     precision)
    if c.device.type != "cuda":
        raise ValueError(f"chroma420_scale: unsupported device {c.device}")
    ch, cw = (full_h + 1) // 2, (full_w + 1) // 2
    _scale2pass.check_plane(c, (ch, cw), "chroma420_scale")
    oh, ow = v_res.out_size, h_res.out_size
    out = torch.empty(c.shape[:-2] + (oh, ow), dtype=torch.int32,
                      device=c.device)
    batch = c.numel() // (ch * cw) if ch * cw else 0
    if batch == 0:
        return out
    _scale2pass.launch("chroma420", "gst_chroma420_scale_u8", c, out, h_res,
                       v_res, precision, batch, (h_cosited, v_cosited))
    chroma420_scale.launches += 1
    return out


chroma420_scale.launches = 0
