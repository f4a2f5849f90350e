"""Fused I420 ingest (unpack + chroma upsample + h-scale): CUDA kernel, its
plain PyTorch version, launch count.

Replaces ``gstreamer_tpu/ops/convert_kernel.py::fused_i420_up_hscale``
(pallas_call at :185).  From y (B, H, W) and u, v (B, H/2, W/2) uint8 it
produces Y (B, H, out_w) and, per chroma plane, the even and the odd
full-resolution rows (B, H/2, out_w), all int16 in 0..255: chroma is
upsampled 2x horizontally (cosited or interstitial), then 2x vertically
(interstitial), then every row is scaled horizontally with
``clamp((sum tap_s16 * px + 4095) >> 12)``; each filter keeps its own
shift.  The kernel is ``csrc/fused_ingest.cu``.

Bound on the H100: bytes (1.5 per source pixel read, 4 * H * out_w per
frame written); the products run on ``dp4a`` over packed byte-limb taps and
the two up2 filters on whole words, so they come second.  One launch holds
luma blocks (a run of consecutive rows each, ``hscale_u8``'s loop with an
int16 store) and chroma blocks (one frame, one plane and a long run of
chroma rows each, so the halo row each side costs a few percent); the host
sizes both kinds of run from the batch (``_scale2pass.run_chunks``) and lists the
chroma runs with their clamped halo (``_scale2pass.chroma_runs``).  Each
chroma row is column-filtered once into a rolling window in shared memory;
the full-width up2 rows never reach device memory.
"""

from __future__ import annotations

import torch

from ..video import chroma as chroma_mod
from ..video.scaler import (SCALE_U8, scale_axis_exact,
                            scale_cols_split_exact)
from . import _build, _scale2pass

_ARGS = "p" * 11 + "i" * 11 + "p"


def applicable(ifmt, ii, oi, plan) -> bool:
    """The fused kernel covers: 8-bit 4:2:0 input, vertical interstitial +
    horizontal cosited-or-not chroma, downscale with scale-before-matrix."""
    return bool(
        ifmt.bits == 8
        and ifmt.w_sub[1] == 1 and ifmt.h_sub[1] == 1
        and plan.get("upsample")
        and not plan.get("up_v_cosited")
        and plan.get("scale_before_matrix")
        and plan.get("h_res") is not None
        and ii.height % 2 == 0
        and ii.width % 2 == 0)


def fused_i420_up_hscale_plain(y, u, v, h_res, h_cosited: bool,
                               precision: int = SCALE_U8):
    """The plain version: scale_axis_exact for Y; up2_phases (columns, then
    rows) and scale_cols_split_exact for each chroma row parity."""
    def i16(x):
        return x.to(torch.int16)

    out = [i16(scale_axis_exact(torch, y, -1, h_res, precision, 8))]
    for c in (u, v):
        ce, co = chroma_mod.up2_phases(torch, i16(c), -1, h_cosited)
        ce_re, ce_ro = chroma_mod.up2_phases(torch, ce, -2, False)
        co_re, co_ro = chroma_mod.up2_phases(torch, co, -2, False)
        out.append(i16(scale_cols_split_exact(torch, ce_re, co_re, h_res,
                                              precision)))
        out.append(i16(scale_cols_split_exact(torch, ce_ro, co_ro, h_res,
                                              precision)))
    return tuple(out)


def fused_i420_up_hscale(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         h_res, h_cosited: bool,
                         precision: int = SCALE_U8):
    """y (..., H, W), u, v (..., H/2, W/2) uint8 -> (Y, U_even, U_odd,
    V_even, V_odd) int16; H and W even.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (without synchronising) or raise."""
    if y.ndim < 2 or y.shape[-1] != h_res.in_size:
        raise ValueError(f"fused_i420_up_hscale: y {tuple(y.shape)} does "
                         f"not match the resampler's width {h_res.in_size}")
    in_h, in_w = y.shape[-2], y.shape[-1]
    if in_h % 2 or in_w % 2:
        raise ValueError(f"fused_i420_up_hscale: odd size {in_w}x{in_h}")
    lead = tuple(y.shape[:-2])
    _scale2pass.check_plane(y, (in_h, in_w), "fused_i420_up_hscale y")
    for name, c in (("u", u), ("v", v)):
        _scale2pass.check_plane(c, (in_h // 2, in_w // 2),
                                f"fused_i420_up_hscale {name}")
        if tuple(c.shape[:-2]) != lead or c.device != y.device:
            raise ValueError(f"fused_i420_up_hscale: {name} "
                             f"{tuple(c.shape)} on {c.device} does not "
                             f"belong to y {tuple(y.shape)} on {y.device}")
    if y.device.type == "cpu":
        return fused_i420_up_hscale_plain(y, u, v, h_res, h_cosited,
                                          precision)
    if y.device.type != "cuda":
        raise ValueError(f"fused_i420_up_hscale: unsupported device "
                         f"{y.device}")
    ow = h_res.out_size
    outs = (torch.empty(lead + (in_h, ow), dtype=torch.int16,
                        device=y.device),) + tuple(
        torch.empty(lead + (in_h // 2, ow), dtype=torch.int16,
                    device=y.device) for _ in range(4))
    batch = y.numel() // (in_h * in_w) if in_h * in_w else 0
    if batch == 0:
        return outs
    if batch * in_h >= 1 << 30:
        raise ValueError(f"fused_i420_up_hscale: {batch * in_h} rows in one "
                         f"call")
    sp = _scale2pass
    p = sp.hplan(h_res, precision, fused=True)
    hc = in_h // 2
    y_run = sp.run_chunks(-(-batch * in_h // sp.ROWS_PER_CHUNK),
                          sp.slots(p, y.device), sp.HSCALE_WAVES)
    c_run = sp.run_chunks(2 * batch * -(-hc // sp.CHROMA_ROWS_PER_CHUNK),
                          sp.slots(p, y.device), sp.FUSED_WAVES)
    cruns = sp.on_device(p, y.device, f"cruns {hc} {c_run}",
                         lambda: sp.chroma_runs(hc, c_run))
    h_cols = sp.on_device(p, y.device, "hcols")
    h_taps = sp.on_device(p, y.device, "htaps")
    lib, fn = _build.function("fused_ingest", "gst_fused_i420_up_hscale",
                              _ARGS)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(y.data_ptr(), u.data_ptr(), v.data_ptr(),
                    *(o.data_ptr() for o in outs), h_cols.data_ptr(),
                    h_taps.data_ptr(), cruns.data_ptr(), batch, in_h, in_w,
                    ow, p.nw, precision, int(bool(h_cosited)), y_run,
                    len(cruns), p.stages, p.smem, stream)
    _build.check(lib, status, "fused_i420_up_hscale")
    fused_i420_up_hscale.launches += 1
    return outs


fused_i420_up_hscale.launches = 0
