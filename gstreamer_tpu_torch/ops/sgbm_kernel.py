"""disparity's SAD cost volume, its left-to-right semi-global pass and the
first argmin: one CUDA kernel from the gray planes, the plain versions,
the count.

Replaces the jitted expression and ``lax.scan`` of the JAX package's
``elements/opencv_analysis.py`` (``Disparity.aggregate_fn``: the volume
:928-944, ``col_step`` :954, run at :964; Pallas has no counterpart).  Over
the columns of a (..., H, W, D) cost volume, D = NUM_DISP = 32:

  m     = min_d prev[d]
  trans = min_d' min(prev[d'] + P1*[|d-d'| == 1] + P2*[|d-d'| > 1], m + P2)
  agg   = (cost[col] + trans) - m

the first column taken as it is.  The reference forms the dense D x D
transition; only three of its candidates can be the minimum: prev[d],
prev[d +- 1] + P1 and m + P2 (rounding is monotone, so
prev[d'] + P2 >= m + P2 for every far d').  The plain version
(``sgbm_plain``) is the reference's dense form, a torch loop over the
columns.

``cost_volume`` is the reference's SAD volume in plain torch: |L - R
shifted by d|, edge-padded by BLOCK // 2, summed over BLOCK x BLOCK boxes
through a float32 integral image.  Its totals pass 2^24 from 640x480 on,
where the order of the adds changes the sums.  The reference's
``jnp.cumsum`` is a reduce-window that XLA's CPU compiler rewrites into
blocks of 16 summed in order, the blocks' totals scanned the same way and
added back (``scan_cumsum`` replays that order as elementwise adds, the
same on every device); numpy's, torch's and ``lax.associative_scan``'s
orders each differ from it.

``disparity`` runs the three on the card as one kernel
(``csrc/disparity.cu``) that walks the columns left to right and never
writes the volume: the sums down a column are exact integers (|L - R| is
one, and (H + 8) * 255 < 2^24), the sums along a row replay
``scan_cumsum``'s order with one running float32 sum a level, and the pass
and the argmin run 8 columns behind the boxes (``STRIP_ROWS`` output rows
a block).
"""

from __future__ import annotations

import torch

from . import _build

NUM_DISP = 32
BLOCK = 9
P1 = 8.0
P2 = 32.0


# XLA's CPU compiler rewrites a cumulative sum longer than this into
# blocks of this length (ReduceWindowRewriter's base)
SCAN_BASE = 16


def _seq_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumsum along `dim`, one float32 add after another (torch's
    CPU cumsum accumulates in float64, its CUDA one in a parallel order)."""
    out = x.clone()
    for k in range(1, x.shape[dim]):
        out.select(dim, k).add_(out.select(dim, k - 1))
    return out


def scan_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """cumsum along `dim` in the order of ``jnp.cumsum`` on the CPU: a
    reduce-window that XLA rewrites, past SCAN_BASE elements, into blocks
    of SCAN_BASE summed one after another, the blocks' totals scanned the
    same way (recursively), and each block's exclusive prefix added to its
    entries.  Elementwise float32 adds: the same bytes on every device."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n <= SCAN_BASE:
        return _seq_cumsum(x, dim)
    nb = -(-n // SCAN_BASE)
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, nb * SCAN_BASE - n]
    blocks = torch.nn.functional.pad(x, pad).unflatten(dim, (nb,
                                                             SCAN_BASE))
    inner = _seq_cumsum(blocks, dim + 1)
    inc = scan_cumsum(inner.select(dim + 1, SCAN_BASE - 1), dim)
    excl = torch.cat([torch.zeros_like(inc.narrow(dim, 0, 1)),
                      inc.narrow(dim, 0, nb - 1)], dim=dim)
    out = (inner + excl.unsqueeze(dim + 1)).flatten(dim, dim + 1)
    return out.narrow(dim, 0, n)


def cost_volume(gl: torch.Tensor, gr: torch.Tensor, nd: int = NUM_DISP,
                blk: int = BLOCK) -> torch.Tensor:
    """(..., H, W) float32 gray planes -> (..., H, W, nd) float32 SAD
    costs, the reference's (:928-944): the right plane shifted by d (zeros
    entering), |L - R|, edge-padded by blk // 2, box sums from the float32
    integral image as (c[blk:, blk:] - c[:-blk, blk:]) - c[blk:, :-blk]
    + c[:-blk, :-blk]."""
    w = gl.shape[-1]
    r = blk // 2
    shifted = torch.stack(
        [gr] + [torch.nn.functional.pad(gr, (d, 0))[..., :w]
                for d in range(1, nd)], dim=-3)          # (..., nd, H, W)
    ad = (gl.unsqueeze(-3) - shifted).abs()
    rows = torch.cat([ad[..., :1, :]] * r + [ad] + [ad[..., -1:, :]] * r,
                     dim=-2)
    padded = torch.cat([rows[..., :1]] * r + [rows] + [rows[..., -1:]] * r,
                       dim=-1)
    c = scan_cumsum(scan_cumsum(padded, -2), -1)
    c = torch.nn.functional.pad(c, (1, 0, 1, 0))
    s = ((c[..., blk:, blk:] - c[..., :-blk, blk:])
         - c[..., blk:, :-blk]) + c[..., :-blk, :-blk]
    return s.movedim(-3, -1).contiguous()


def sgbm_plain(cost: torch.Tensor) -> torch.Tensor:
    """The plain version: the reference's column step with the dense D x D
    transition, a torch loop over the W columns of a (..., H, W, D)
    volume.  Returns the aggregated volume."""
    _check(cost)
    nd = cost.shape[-1]
    dd = torch.arange(nd, device=cost.device)
    gap = (dd[:, None] - dd[None, :]).abs()
    pen = (gap == 1).to(torch.float32) * P1
    far = (gap > 1).to(torch.float32) * P2
    agg = torch.empty_like(cost)
    prev = cost[..., 0, :]
    agg[..., 0, :] = prev
    for col in range(1, cost.shape[-2]):
        m = prev.min(-1, keepdim=True).values
        trans = torch.minimum((prev[..., None, :] + pen) + far,
                              (m + P2)[..., None])
        prev = (cost[..., col, :] + trans.min(-1).values) - m
        agg[..., col, :] = prev
    return agg


def _check(cost: torch.Tensor) -> None:
    if cost.dtype != torch.float32 or cost.dim() < 3 \
            or cost.shape[-1] != NUM_DISP:
        raise ValueError(f"sgbm: needs a (..., H, W, {NUM_DISP}) float32 "
                         f"cost volume, got {tuple(cost.shape)} {cost.dtype}")


def first_argmin(volume: torch.Tensor) -> torch.Tensor:
    """The first minimal disparity of each pixel, uint8."""
    return volume.argmin(-1).to(torch.uint8)


# the kernel's schedule (csrc/disparity.cu): a strip's padded rows, one a
# lane, and the output rows that leaves; the padded width the W-scan's four
# levels reach
STRIP_LANES = 32
STRIP_ROWS = STRIP_LANES - BLOCK
MAX_PADDED_W = SCAN_BASE ** 4
# the column sums down a padded column stay exact in float32 (and so in
# any order) while (H + 2 * (BLOCK // 2)) * 255 < 2**24
MAX_H = (2 ** 24 - 1) // 255 - 2 * (BLOCK // 2)


def _check_planes(gl: torch.Tensor, gr: torch.Tensor, method: str) -> None:
    if method not in ("sgbm", "sbm"):
        raise ValueError(f"disparity: method {method!r}, want sgbm or sbm")
    if gl.dtype != torch.uint8 or gr.dtype != torch.uint8 \
            or gl.shape != gr.shape or gl.dim() < 2 \
            or gl.device != gr.device:
        raise ValueError(f"disparity: needs two (..., H, W) uint8 gray "
                         f"planes of one shape on one device, got "
                         f"{tuple(gl.shape)} {gl.dtype}, {tuple(gr.shape)} "
                         f"{gr.dtype}")
    h, w = gl.shape[-2:]
    if h > MAX_H or w + 2 * (BLOCK // 2) > MAX_PADDED_W:
        raise ValueError(f"disparity: {h}x{w} is past the kernel's exact "
                         f"range (H <= {MAX_H}, W + 8 <= {MAX_PADDED_W})")


def disparity(gl: torch.Tensor, gr: torch.Tensor, method: str = "sgbm",
              want_volumes: bool = False):
    """(..., H, W) uint8 left and right gray planes -> (each pixel's first
    minimal disparity, (..., H, W) uint8: after the semi-global pass for
    "sgbm", of the cost volume for "sbm"; with `want_volumes` the cost
    volume and, for "sgbm", the aggregated volume, (..., H, W, 32)
    float32, else None and None).

    A CPU tensor runs the plain versions (``cost_volume``, ``sgbm_plain``,
    ``first_argmin``); a CUDA tensor launches the kernel on the current
    stream (without synchronising) or raises.  The kernel forms the volume
    as it walks the columns and never writes it, unless asked."""
    _check_planes(gl, gr, method)
    if gl.device.type == "cpu":
        cost = cost_volume(gl.to(torch.float32), gr.to(torch.float32))
        agg = sgbm_plain(cost) if method == "sgbm" else None
        disp = first_argmin(agg if agg is not None else cost)
        if not want_volumes:
            return disp, None, None
        return disp, cost, agg
    if gl.device.type != "cuda":
        raise ValueError(f"disparity: unsupported device {gl.device}")
    gl, gr = gl.contiguous(), gr.contiguous()
    h, w = gl.shape[-2:]
    pairs = gl.numel() // (h * w) if h * w else 0
    dev = gl.device
    disp = torch.empty(gl.shape, dtype=torch.uint8, device=dev)
    vol_shape = tuple(gl.shape) + (NUM_DISP,)
    cost = (torch.empty(vol_shape, dtype=torch.float32, device=dev)
            if want_volumes else None)
    agg = (torch.empty(vol_shape, dtype=torch.float32, device=dev)
           if want_volumes and method == "sgbm" else None)
    if pairs == 0:
        return disp, cost, agg
    strips = -(-h // STRIP_ROWS)
    prefix = torch.empty((pairs, strips, NUM_DISP, w + 2 * (BLOCK // 2)),
                         dtype=torch.int32, device=dev)
    lib, fn = _build.function("disparity", "gst_disparity", "ppppppiiiiffp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(gl.data_ptr(), gr.data_ptr(), prefix.data_ptr(),
                    disp.data_ptr(),
                    cost.data_ptr() if cost is not None else None,
                    agg.data_ptr() if agg is not None else None, pairs, h,
                    w, int(method == "sgbm"), P1, P2, stream)
    _build.check(lib, status, "disparity")
    disparity.launches += 1
    return disp, cost, agg


disparity.launches = 0
