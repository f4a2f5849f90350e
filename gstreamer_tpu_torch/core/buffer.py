"""Buffers and samples — the data-plane unit of the pipeline.

A copy of the JAX package's ``core/buffer.py``: GstBuffer/GstSample
(reference: subprojects/gstreamer/gst/gstbuffer.c — PTS/DTS/duration/offset
+ memory + metas).

The *data plane* is a tree (tuple, list or dict) of tensors — one or more
planes, batched on the leading axis — on the pipeline's device; the
*control plane* (timestamps, flags, metas) stays on the host.  A Buffer may
carry a whole BATCH of frames.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

CLOCK_TIME_NONE = -1


def _fmt_time(t: Optional[int]) -> str:
    if t is None or t == CLOCK_TIME_NONE:
        return "none"
    s, ns = divmod(t, 1_000_000_000)
    m, s = divmod(s, 60)
    h, m = divmod(m, 60)
    return f"{h}:{m:02d}:{s:02d}.{ns:09d}"


class BufferFlags:
    """Mirrors GST_BUFFER_FLAG_* (gstbuffer.h)."""
    LIVE = 1 << 0
    DISCONT = 1 << 1
    RESYNC = 1 << 2
    CORRUPTED = 1 << 3
    MARKER = 1 << 4
    HEADER = 1 << 5
    GAP = 1 << 6
    DROPPABLE = 1 << 7
    DELTA_UNIT = 1 << 8
    INTERLACED_TFF = 1 << 9
    # video buffer flags (gstvideometa.h GST_VIDEO_BUFFER_FLAG_*)
    INTERLACED = 1 << 10
    RFF = 1 << 11
    ONEFIELD = 1 << 12
    TOP_FIELD = 1 << 13
    BOTTOM_FIELD = 1 << 14


@dataclass
class Buffer:
    """data: a tree of tensors (tuple of planes for video, (frames, ch)
    tensor for audio; see ``map_leaves``).  Timestamps in nanoseconds
    (host ints).

    When `batch` > 1 the arrays carry a leading batch axis and pts/duration
    describe the FIRST frame; per-frame timestamps are derivable from
    `duration` (constant-rate batches) or carried in `meta['pts']`."""

    data: Any
    pts: Optional[int] = None
    dts: Optional[int] = None
    duration: Optional[int] = None
    offset: Optional[int] = None
    flags: int = 0
    batch: int = 1
    meta: Dict[str, Any] = field(default_factory=dict)

    def with_(self, **kw) -> "Buffer":
        return dataclasses.replace(self, **kw)

    def copy_metadata_from(self, other: "Buffer") -> "Buffer":
        return self.with_(pts=other.pts, dts=other.dts,
                          duration=other.duration, offset=other.offset,
                          flags=other.flags, batch=other.batch,
                          meta=dict(other.meta))

    def __repr__(self):
        return (f"Buffer(pts={_fmt_time(self.pts)}, "
                f"dur={_fmt_time(self.duration)}, batch={self.batch})")


def map_leaves(fn, data):
    """Apply `fn` to every leaf of a buffer's data tree (tuples, lists
    and dicts are walked; anything else is a leaf)."""
    if isinstance(data, (tuple, list)):
        return type(data)(map_leaves(fn, x) for x in data)
    if isinstance(data, dict):
        return {k: map_leaves(fn, v) for k, v in data.items()}
    return fn(data)


def host_array(x) -> np.ndarray:
    """A leaf on the host: a tensor is copied from its device, anything
    else goes through ``np.asarray``."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _device_of(like) -> torch.device:
    """`like` if it is a device, else the device of a buffer's data tree
    (its first tensor leaf decides; the CPU when it holds none)."""
    if isinstance(like, torch.device):
        return like
    leaves = []
    map_leaves(leaves.append, like)
    return next((x.device for x in leaves if isinstance(x, torch.Tensor)),
                torch.device("cpu"))


def device_array(a, like) -> torch.Tensor:
    """A host result `a` as a tensor on the device of `like`: a device, or
    a buffer's data tree (see ``_device_of``)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(
        _device_of(like))


def device_planes(arrays, like) -> tuple:
    """Host arrays of one dtype as tensors on the device of `like` (as
    ``device_array``) in one copy: laid end to end in one host array (a
    page-locked one for a card, copied without blocking the host), moved
    together, and cut into contiguous views of their shapes."""
    arrays = [np.asarray(a) for a in arrays]
    dev = _device_of(like)
    parts = [a.reshape(-1) for a in arrays]
    if dev.type == "cuda":
        dtype = torch.from_numpy(np.empty(0, arrays[0].dtype)).dtype
        pinned = torch.empty(sum(a.size for a in arrays), dtype=dtype,
                             pin_memory=True)
        np.concatenate(parts, out=pinned.numpy())
        flat = pinned.to(dev, non_blocking=True)
    else:
        flat = torch.from_numpy(np.concatenate(parts))
    out, pos = [], 0
    for a in arrays:
        out.append(flat[pos:pos + a.size].view(a.shape))
        pos += a.size
    return tuple(out)


@dataclass
class Sample:
    """Buffer + its caps (GstSample, used at the appsink boundary)."""
    buffer: Buffer
    caps: Any


class FlowReturn:
    """Mirrors GstFlowReturn (gstpad.h)."""
    OK = "ok"
    NOT_LINKED = "not-linked"
    FLUSHING = "flushing"
    EOS = "eos"
    NOT_NEGOTIATED = "not-negotiated"
    ERROR = "error"
