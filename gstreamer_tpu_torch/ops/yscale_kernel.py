"""Fused luma h+v scale: CUDA kernel, its plain PyTorch version, launch count.

Replaces ``gstreamer_tpu/ops/yscale_kernel.py::yscale_hv`` (pallas_call at
:109): a (B, H, W) uint8 plane scaled horizontally, clamped to 0..255, then
scaled vertically, each pass ``clamp((sum tap_s16 * px + 4095) >> 12)``,
into (B, oh, ow) int16.  The kernel is ``csrc/yscale.cu``.

Bound on the H100: bytes.  The work is a few int32 multiply-adds per source
byte (35 + 20 taps at 1080p -> 224 cubic), while the u8 frame (2.07 MB at
1080p) has to come from device memory.  The kernel reads each source row a
tile of output rows needs once, keeps the h-pass in shared memory, skips
rows no vertical tap reads (more than half of them with 2 taps) and writes
each output once.
"""

from __future__ import annotations

import torch

from ..video.scaler import SCALE_U8, scale_axis_exact
from . import _build, _scale2pass

_ARGS = "pppppp" + "i" * 10 + "p"


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
    th, tv = h_res.max_taps, v_res.max_taps
    out = torch.empty(y.shape[:-2] + (oh, ow), dtype=torch.int16,
                      device=y.device)
    batch = y.numel() // (in_h * in_w) if in_h * in_w else 0
    if batch == 0:
        return out
    h_off, h_taps = _scale2pass.tables(h_res, y.device, precision, True)
    v_off, v_taps = _scale2pass.tables(v_res, y.device, precision, False)
    tile_rows, span = _scale2pass.tiling(v_res, in_w, ow, th)
    lib, fn = _build.function("yscale", "gst_yscale_hv_u8", _ARGS)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(y.data_ptr(), out.data_ptr(), h_off.data_ptr(),
                    h_taps.data_ptr(), v_off.data_ptr(), v_taps.data_ptr(),
                    batch, in_h, in_w, oh, ow, th, tv, precision, tile_rows,
                    span, stream)
    _build.check(lib, status, "yscale_hv")
    yscale_hv.launches += 1
    return out


yscale_hv.launches = 0
