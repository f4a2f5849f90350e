"""Horizontal tap scale of a u8 plane to int32: CUDA kernel, plain version,
count.

Replaces ``gstreamer_tpu/ops/hscale_kernel.py::hscale_u8`` (pallas_call at
:73): every row of a (B, H, W) uint8 plane scaled to out_w samples,
``clamp((sum tap_s16 * px + 4095) >> 12, 0, 255)``, into (B, H, out_w)
int32.  It is a standalone op (the reference package has no caller either).
The kernel is ``csrc/hscale.cu``.

Bound on the H100: bytes (1 per source pixel read, 4 per output written).
The products run on ``dp4a`` over taps packed as byte limbs (the two-pass
kernel's horizontal pass), so that even at 35 taps they cost less than the
bytes.  Rows are independent, so all frames' rows are taken back to back: a
block owns a run of 8-row chunks (``_scale2pass.run_chunks``: some sixteen
blocks for each block the card runs at a time, three an SM), reads the
packed taps once, and walks the run through a ring of bulk copies, one a
chunk, that load while it computes; results leave through shared memory,
16 bytes a thread.
"""

from __future__ import annotations

import numpy as np
import torch

from ..video.scaler import SCALE_U8, scale_axis_exact, tap_matrix
from . import _build, _scale2pass

_ARGS = "pppp" + "i" * 8 + "p"


def applicable(res, shape) -> bool:
    """Shrinks with 13-bit taps, as the reference gates it; its ``w % 128``
    rule is a TPU lane tiling and does not apply here."""
    return (int(np.abs(tap_matrix(res)).max()) < (1 << 13)
            and res.out_size <= shape[-1])


def hscale_u8_plain(y, res):
    """The plain version: scale_axis_exact along W."""
    return scale_axis_exact(torch, y, -1, res, SCALE_U8, 8).to(torch.int32)


def hscale_u8(y: torch.Tensor, res) -> torch.Tensor:
    """(..., H, W) uint8 -> (..., H, out_w) int32, bit-identical to
    scale_axis_exact along W.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream (without synchronising) or raises."""
    if y.device.type == "cpu":
        return hscale_u8_plain(y, res)
    if y.device.type != "cuda":
        raise ValueError(f"hscale_u8: unsupported device {y.device}")
    in_w, ow = res.in_size, res.out_size
    if y.ndim < 2:
        raise ValueError(f"hscale_u8: expected (..., H, W), got "
                         f"{tuple(y.shape)}")
    _scale2pass.check_plane(y, (y.shape[-2], in_w), "hscale_u8")
    out = torch.empty(y.shape[:-1] + (ow,), dtype=torch.int32,
                      device=y.device)
    total_rows = y.numel() // in_w
    if total_rows == 0:
        return out
    if total_rows >= 1 << 31:
        raise ValueError(f"hscale_u8: {total_rows} rows in one call")
    p = _scale2pass.hplan(res, SCALE_U8)
    run = _scale2pass.run_chunks(
        -(-total_rows // _scale2pass.ROWS_PER_CHUNK),
        _scale2pass.slots(p, y.device), _scale2pass.HSCALE_WAVES)
    h_cols = _scale2pass.on_device(p, y.device, "hcols")
    h_taps = _scale2pass.on_device(p, y.device, "htaps")
    lib, fn = _build.function("hscale", "gst_hscale_u8", _ARGS)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(y.data_ptr(), out.data_ptr(), h_cols.data_ptr(),
                    h_taps.data_ptr(), total_rows, in_w, ow, p.nw, SCALE_U8,
                    run, p.stages, p.smem, stream)
    _build.check(lib, status, "hscale_u8")
    hscale_u8.launches += 1
    return out


hscale_u8.launches = 0
