"""Buffer metadata registry with transform functions.

TPU-native equivalent of GstMeta (reference:
subprojects/gstreamer/gst/gstmeta.c, 913 LoC — API-type registry with
per-meta transform functions invoked when buffers are copied/scaled,
gst_meta_register / GstMetaTransformFunction) and the video metas
(gst-plugins-base/gst-libs/gst/video/gstvideometa.c:1736 —
GstVideoMeta with per-plane strides/offsets, GstVideoCropMeta).

A Meta is a dataclass registered under an API name with an optional
transform table: `transform(meta, op, **kw)` returns the transformed
meta (or None to drop it) when a buffer undergoes `op` ("copy",
"scale", ...).  Elements call `transform_metas(buf, op, **kw)` when
they change buffer geometry.

A copy of the JAX package's ``core/meta.py``.  Metas are host objects;
``frame_map_strided`` takes its bytes to the host (a tensor on a card is
copied from it) and returns host planes, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .buffer import host_array

_META_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_meta(api: str, transforms: Optional[Dict[str, Callable]]
                  = None) -> None:
    """gst_meta_register: declare a meta API and its transform table."""
    _META_REGISTRY[api] = transforms or {}


def meta_is_registered(api: str) -> bool:
    return api in _META_REGISTRY


def transform_metas(buf, op: str, **kw):
    """Apply every registered transform for `op` to the buffer's metas
    (gst_buffer_copy_into meta loop semantics): metas whose API has no
    transform for `op` are DROPPED (the reference drops metas it cannot
    transform)."""
    new = {}
    for api, meta in buf.meta.items():
        table = _META_REGISTRY.get(api)
        if table is None:
            new[api] = meta            # unregistered free-form entries pass
            continue
        fn = table.get(op)
        if op == "copy" and fn is None:
            new[api] = meta
        elif fn is not None:
            out = fn(meta, **kw)
            if out is not None:
                new[api] = out
    return buf.with_(meta=new)


# ---------------------------------------------------------------------------
# Video metas (gstvideometa.c)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VideoMeta:
    """GstVideoMeta: per-plane strides/offsets for non-default layouts
    (gstvideometa.c gst_buffer_add_video_meta_full)."""
    format: str
    width: int
    height: int
    strides: Tuple[int, ...]
    offsets: Tuple[int, ...]


@dataclass(frozen=True)
class VideoCropMeta:
    """GstVideoCropMeta (gstvideometa.c:1736): crop rectangle carried as
    metadata so downstream can crop lazily (or fold it into a scale)."""
    x: int
    y: int
    width: int
    height: int


def _crop_scale(meta: VideoCropMeta, in_size=None, out_size=None, **kw):
    """gst_video_meta_transform_scale analog: the crop rect scales with
    the frame."""
    if in_size is None or out_size is None:
        return meta
    iw, ih = in_size
    ow, oh = out_size
    return VideoCropMeta(meta.x * ow // iw, meta.y * oh // ih,
                         meta.width * ow // iw, meta.height * oh // ih)


register_meta("video-crop", {"scale": _crop_scale})
register_meta("video", {
    # geometry-changing ops invalidate a strided-layout description
    "scale": lambda meta, **kw: None,
})


def frame_map_strided(fmt, data: np.ndarray, meta: VideoMeta):
    """gst_video_frame_map honoring GstVideoMeta (video-frame.c:190):
    decode a frame laid out with CUSTOM strides/offsets into tight
    component planes."""
    from ..video.format import from_bytes, plane_shapes

    data = host_array(data).astype(np.uint8, copy=False).ravel()
    bps = fmt.bits // 8
    shapes = plane_shapes(fmt, meta.width, meta.height)
    # reference memory planes: planar -> one memory plane per stored
    # plane; semi/packed handled via the tight path after de-striding
    if fmt.layout == "planar":
        planes = [None] * len(shapes)
        for store_idx, comp in enumerate(fmt.plane_order):
            h, w = shapes[comp]
            stride = meta.strides[store_idx]
            off = meta.offsets[store_idx]
            rows = data[off:off + h * stride].reshape(h, stride)
            raw = np.ascontiguousarray(rows[:, :w * bps])
            if fmt.bits == 16:
                raw = raw.view(fmt.word_dtype)
                if fmt.endian == "be":
                    raw = raw.astype(np.uint16)
            planes[comp] = raw.reshape(h, w)
        return tuple(planes)
    # non-planar: de-stride the single (or semi) memory planes into the
    # tight layout, then reuse the standard decoder
    tight = []
    n_mem = len(meta.strides)
    from ..video.format import frame_size
    for p in range(n_mem):
        if fmt.layout == "semi":
            h = shapes[0][0] if p == 0 else shapes[1][0]
            rowbytes = (meta.width * bps if p == 0
                        else 2 * shapes[1][1] * bps)
        else:
            h = meta.height
            rowbytes = frame_size(fmt, meta.width, 1)
        stride, off = meta.strides[p], meta.offsets[p]
        rows = data[off:off + h * stride].reshape(h, stride)
        tight.append(np.ascontiguousarray(rows[:, :rowbytes]).ravel())
    return from_bytes(fmt, np.concatenate(tight), meta.width, meta.height)
