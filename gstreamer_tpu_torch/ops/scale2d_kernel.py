"""Fused h+v scale of a u8 plane to int32: CUDA kernel, plain version, count.

Replaces ``gstreamer_tpu/ops/scale2d_kernel.py::scale_hv_u8`` (pallas_call
at :88): a (B, H, W) uint8 plane scaled horizontally, rounded and clamped to
0..255, then scaled vertically likewise, each pass
``clamp((sum tap_s16 * px + 4095) >> 12)``, into (B, OH, OW) int32.  It is a
standalone op (the reference package has no caller either).  The kernel is
``csrc/scale2d.cu``: the two-pass kernel of ``yscale_hv`` with an int32
output.

Bound on the H100: bytes (the source rows the vertical taps read, 4 bytes
per output).  As in ``yscale_kernel``: host row lists, bulk copies ahead of
the arithmetic, ``dp4a`` over byte-limb taps, the h pass kept in shared
memory, each output written once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..video.scaler import SCALE_U8, scale_axis_exact, tap_matrix
from . import _scale2pass


def applicable(h_res, v_res, shape) -> bool:
    """Downscales with 13-bit taps, as the reference gates it; its
    ``w % 128`` rule is a TPU lane tiling and does not apply here."""
    if h_res is None or v_res is None:
        return False
    w, h = shape[-1], shape[-2]
    return (int(np.abs(tap_matrix(h_res)).max()) < (1 << 13)
            and int(np.abs(tap_matrix(v_res)).max()) < (1 << 13)
            and h_res.out_size <= w and v_res.out_size <= h)


def scale_hv_u8_plain(y, h_res, v_res):
    """The plain version: scale_axis_exact along W, then along H."""
    out = scale_axis_exact(torch, y, -1, h_res, SCALE_U8, 8)
    out = scale_axis_exact(torch, out, -2, v_res, SCALE_U8, 8)
    return out.to(torch.int32)


def scale_hv_u8(y: torch.Tensor, h_res, v_res) -> torch.Tensor:
    """(..., H, W) uint8 -> (..., OH, OW) int32, bit-identical to
    scale_axis_exact(h) then scale_axis_exact(v).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream (without synchronising) or raises."""
    if y.device.type == "cpu":
        return scale_hv_u8_plain(y, h_res, v_res)
    if y.device.type != "cuda":
        raise ValueError(f"scale_hv_u8: unsupported device {y.device}")
    in_h, in_w = v_res.in_size, h_res.in_size
    _scale2pass.check_plane(y, (in_h, in_w), "scale_hv_u8")
    oh, ow = v_res.out_size, h_res.out_size
    out = torch.empty(y.shape[:-2] + (oh, ow), dtype=torch.int32,
                      device=y.device)
    batch = y.numel() // (in_h * in_w)
    if batch == 0:
        return out
    _scale2pass.launch("scale2d", "gst_scale_hv_u8", y, out, h_res, v_res,
                       SCALE_U8, batch)
    scale_hv_u8.launches += 1
    return out


scale_hv_u8.launches = 0
