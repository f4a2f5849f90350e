"""Both field-parity frames of a plane: CUDA kernel, plain version, count.

Replaces ``gstreamer_tpu/ops/deint_kernel.py::deint_both_parities``
(pallas_call at :85; body :54-76), the intra-frame (linear / scalerbob)
deinterlace of ``elements/deinterlace.py``.  For output row r of frame n,
``out[n, k, r]`` is ``src[n, r]`` where r has the parity slot k keeps, else
the interpolated row:

  linear     (src[max(r-1, 0)] + src[min(r+1, H-1)] + 1) >> 1
  scalerbob  src[max(r-1, 0)]

Slot 0 keeps even rows when ``parity0 == 0`` and odd rows when it is 1; slot
1 keeps the other parity, so (NF, 2, H, W) reshaped to (2 NF, H, W) is the
field sequence.  The kernel is ``csrc/deint.cu``.

Bound on the H100: bytes.  One u8 read and two u8 writes per pixel and a
handful of integer operations: 3 bytes per pixel over 3.35 TB/s.  The
kernel reads each row and writes both output rows once from device memory
(the row's neighbours come through the caches), 16 bytes per thread.
"""

from __future__ import annotations

import torch

from . import _build

METHODS = ("linear", "scalerbob")


def _shift_rows(p: torch.Tensor, n: int) -> torch.Tensor:
    """Row p[y+n] with edge clamping (get_line CLAMP semantics)."""
    h = p.shape[-2]
    idx = torch.clamp(torch.arange(h, device=p.device) + n, 0, h - 1)
    return p.index_select(-2, idx)


def _check_args(plane: torch.Tensor, method: str, parity0: int) -> None:
    if method not in METHODS:
        raise ValueError(f"deint_both_parities: method {method!r} is not "
                         f"one of {METHODS}")
    if parity0 not in (0, 1):
        raise ValueError(f"deint_both_parities: parity0 {parity0!r} is "
                         "not 0 or 1")
    if plane.dtype != torch.uint8 or plane.dim() != 3:
        raise ValueError("deint_both_parities: needs a (NF, H, W) uint8 "
                         f"plane, got {tuple(plane.shape)} {plane.dtype}")


def deint_both_parities_plain(plane: torch.Tensor, method: str,
                              parity0: int) -> torch.Tensor:
    """The plain version: the XLA formulation of deinterlace.py:385-398
    (int16 row shifts, the parity mask, a stack into (NF, 2, H, W))."""
    _check_args(plane, method, parity0)
    src16 = plane.to(torch.int16)
    t = _shift_rows(src16, -1)
    interp = (t if method == "scalerbob"
              else (t + _shift_rows(src16, 1) + 1) >> 1).to(torch.uint8)
    m_even = (torch.arange(plane.shape[-2], device=plane.device) % 2
              == 0)[:, None]
    out_p0 = torch.where(m_even, plane, interp)
    out_p1 = torch.where(~m_even, plane, interp)
    first, second = (out_p0, out_p1) if parity0 == 0 else (out_p1, out_p0)
    return torch.stack([first, second], dim=1)


def deint_both_parities(plane: torch.Tensor, method: str,
                        parity0: int) -> torch.Tensor:
    """(NF, H, W) uint8 -> (NF, 2, H, W) uint8 deinterlaced frames in
    field order, for any H >= 1 and W >= 1.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream (without synchronising) or raises."""
    if plane.device.type == "cpu":
        return deint_both_parities_plain(plane, method, parity0)
    if plane.device.type != "cuda":
        raise ValueError(f"deint_both_parities: unsupported device "
                         f"{plane.device}")
    _check_args(plane, method, parity0)
    if not plane.is_contiguous():
        raise ValueError("deint_both_parities: the plane must be contiguous")
    nf, h, w = plane.shape
    if nf * h >= 2 ** 31:
        raise ValueError(f"deint_both_parities: {nf} x {h} rows exceed the "
                         "kernel's int32 row index")
    out = torch.empty((nf, 2, h, w), dtype=torch.uint8, device=plane.device)
    if out.numel() == 0:
        return out
    lib, fn = _build.function("deint", "gst_deint_both_parities_u8",
                              "ppiiiiip")
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(plane.data_ptr(), out.data_ptr(), nf, h, w,
                    METHODS.index(method), parity0, stream)
    _build.check(lib, status, "deint_both_parities")
    deint_both_parities.launches += 1
    return out


deint_both_parities.launches = 0
