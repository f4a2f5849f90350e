"""The few array operations whose numpy and torch spellings differ.

The converter runs one pipeline under two array modules: numpy for the host
gold (``VideoConverter.convert_ref``) and torch for the device path.  Each
function takes the module (``np`` or ``torch``) first, as the JAX package's
``xp`` argument does.  Dtypes are named by string.
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {
    "uint8": torch.uint8, "uint16": torch.uint16, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "float32": torch.float32, "float64": torch.float64,
}


def astype(xp, x, dtype: str):
    if xp is np:
        return np.asarray(x).astype(dtype)
    return x.to(_TORCH_DTYPES[dtype])


def clip(xp, x, lo, hi):
    if xp is np:
        return np.clip(x, lo, hi)
    return torch.clamp(x, lo, hi)


def cat(xp, parts, axis: int):
    if xp is np:
        return np.concatenate(parts, axis=axis)
    return torch.cat(parts, dim=axis)


def stack(xp, parts, axis: int):
    if xp is np:
        return np.stack(parts, axis=axis)
    return torch.stack(parts, dim=axis)


def repeat(xp, x, n: int, axis: int):
    if xp is np:
        return np.repeat(x, n, axis=axis)
    return torch.repeat_interleave(x, n, dim=axis)


def full(xp, shape, value: int, like, dtype: str = None):
    """A constant array of `shape` beside `like`, of its dtype unless one
    is named."""
    if xp is np:
        return np.full(shape, value, dtype=dtype or like.dtype)
    return torch.full(tuple(shape), value,
                      dtype=_TORCH_DTYPES[dtype] if dtype else like.dtype,
                      device=like.device)


def full_like(xp, x, value: int):
    if xp is np:
        return np.full_like(x, value)
    return torch.full_like(x, value)


def index(xp, idx: np.ndarray, like):
    """A host index array as an index for arrays like `like`."""
    if xp is np:
        return np.asarray(idx, np.int64)
    return torch.as_tensor(np.asarray(idx, np.int64), device=like.device)


def const(xp, a: np.ndarray, dtype: str, like):
    """A host constant as an array of `dtype` beside `like`."""
    if xp is np:
        return np.asarray(a, dtype)
    return torch.as_tensor(np.asarray(a, dtype), device=like.device)


def take(a, axis: int, start, stop, step: int = 1):
    """a[start:stop:step] along `axis` (positive steps only)."""
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(start, stop, step)
    return a[tuple(sl)]


def pad_edge(xp, a, axis: int, before: int, after: int):
    """Edge-replicating pad along one axis."""
    n = a.shape[axis]
    parts = [take(a, axis, 0, 1)] * before + [a] \
        + [take(a, axis, n - 1, n)] * after
    return cat(xp, parts, axis) if len(parts) > 1 else a
