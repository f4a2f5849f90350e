"""Fused luma h+v scale: CUDA kernel, its plain PyTorch version, launch count.

Replaces ``gstreamer_tpu/ops/yscale_kernel.py::yscale_hv`` (pallas_call at
:109): a (B, H, W) uint8 plane scaled horizontally, clamped to 0..255, then
scaled vertically, each pass ``clamp((sum tap_s16 * px + 4095) >> 12)``,
into (B, oh, ow) int16.  The kernel is ``csrc/yscale.cu``.

Bound on the H100: bytes, the u8 rows the vertical taps read (2.07 MB per
1080p frame when all are needed).  The kernel gets the list of rows each
tile of output rows needs from the host (``_scale2pass.row_table``), brings
them in by bulk copies (TMA) a chunk of 8 ahead of the arithmetic, runs both
passes as ``dp4a`` dot products over taps split into byte limbs
(``_scale2pass.pack_taps``), keeps the h pass in shared memory and writes
each output once.
"""

from __future__ import annotations

import torch

from ..video.scaler import SCALE_U8, scale_axis_exact
from . import _scale2pass


def yscale_hv_plain(y, h_res, v_res, precision: int = SCALE_U8):
    """The plain version: scale_axis_exact along W, then along H."""
    out = scale_axis_exact(torch, y, -1, h_res, precision, 8)
    out = scale_axis_exact(torch, out, -2, v_res, precision, 8)
    return out.to(torch.int16)


def yscale_hv(y: torch.Tensor, h_res, v_res,
              precision: int = SCALE_U8) -> torch.Tensor:
    """(..., H, W) uint8 -> (..., oh, ow) int16, bit-identical to
    scale_axis_exact(h) then scale_axis_exact(v).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream (without synchronising) or raises."""
    if y.device.type == "cpu":
        return yscale_hv_plain(y, h_res, v_res, precision)
    if y.device.type != "cuda":
        raise ValueError(f"yscale_hv: unsupported device {y.device}")
    in_h, in_w = v_res.in_size, h_res.in_size
    _scale2pass.check_plane(y, (in_h, in_w), "yscale_hv")
    oh, ow = v_res.out_size, h_res.out_size
    out = torch.empty(y.shape[:-2] + (oh, ow), dtype=torch.int16,
                      device=y.device)
    batch = y.numel() // (in_h * in_w) if in_h * in_w else 0
    if batch == 0:
        return out
    _scale2pass.launch("yscale", "gst_yscale_hv_u8", y, out, h_res, v_res,
                       precision, batch)
    yscale_hv.launches += 1
    return out


yscale_hv.launches = 0
