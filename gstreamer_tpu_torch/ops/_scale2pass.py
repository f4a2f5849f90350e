"""Host side of the two-pass tap-scale kernels (csrc/scale2pass.cuh).

Builds the device tap tables from a Resampler, picks the tile of output rows
each block owns, and sizes the block's shared memory exactly as the kernel
lays it out.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS_PER_CHUNK = 8             # scale2pass.cuh kRowsPerChunk
MAX_TILE_ROWS = 32
SMEM_TARGET = 100 * 1024       # leaves room for two blocks on one SM
SMEM_LIMIT = 227 * 1024        # what one Hopper block may use


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(in_w: int, ow: int, th: int, span: int) -> int:
    """scale2pass.cuh SmemLayout.total."""
    return (_align16(th * ow * 2) + _align16(span * ow)
            + _align16(ROWS_PER_CHUNK * in_w) + 4 * span)


def htable_bytes(th: int, ow: int) -> int:
    """scale2pass.cuh htable_bytes: the h taps and offsets of a block."""
    return _align16(th * ow * 2) + _align16(ow * 4)


def rows_per_block(need, most: int, what: str) -> int:
    """The largest row count (most, most/2, ..., 1) of an h-only kernel
    whose block fits the shared-memory target; need(n) is the block's
    bytes at n rows."""
    n = most
    while n > 1 and need(n) > SMEM_TARGET:
        n //= 2
    if need(n) > SMEM_LIMIT:
        raise ValueError(f"{what}: {need(n)} bytes of shared memory per "
                         f"block at {n} row(s), more than {SMEM_LIMIT}")
    return n


def _cache(res) -> dict:
    return res.__dict__.setdefault("_cuda_cache", {})


def tables(res, device, precision: int, tap_major: bool):
    """(offset int32 [out], taps int16) on `device`; taps are [T][out] when
    tap_major (the h pass) else [out][T] (the v pass)."""
    key = ("tables", str(device), precision, tap_major)
    cache = _cache(res)
    if key not in cache:
        taps = np.asarray(res.taps_s16(precision), np.int16)
        if tap_major:
            taps = taps.T
        cache[key] = (
            torch.as_tensor(np.asarray(res.offset, np.int32)).to(device),
            torch.as_tensor(np.ascontiguousarray(taps)).to(device))
    return cache[key]


def tiling(v_res, in_w: int, ow: int, th: int):
    """(tile_rows, span_max): the largest tile of output rows (at most 32)
    whose input row span fits the shared-memory target."""
    key = ("tiling", in_w, ow, th)
    cache = _cache(v_res)
    if key not in cache:
        off = np.asarray(v_res.offset, np.int64)
        tv, oh = v_res.max_taps, v_res.out_size
        tile = MAX_TILE_ROWS
        while True:
            span = max(int(off[r:r + tile].max() - off[r:r + tile].min()) + tv
                       for r in range(0, oh, tile))
            need = smem_bytes(in_w, ow, th, span)
            if need <= SMEM_TARGET or (tile == 1 and need <= SMEM_LIMIT):
                break
            if tile == 1:
                raise ValueError(
                    f"scale of width {in_w}->{ow} with {th}x{tv} taps needs "
                    f"{need} bytes of shared memory per block, more than "
                    f"{SMEM_LIMIT}")
            tile //= 2
        cache[key] = (tile, span)
    return cache[key]


def check_plane(x: torch.Tensor, shape_hw, what: str) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"{what}: expected uint8, got {x.dtype}")
    if x.ndim < 2 or tuple(x.shape[-2:]) != tuple(shape_hw):
        raise ValueError(f"{what}: expected (..., {shape_hw[0]}, "
                         f"{shape_hw[1]}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
