"""Video overlay composition: overlay rectangles and their blend.

The JAX package's ``video/overlay.py`` (GstVideoOverlayComposition /
GstVideoOverlayRectangle, subprojects/gst-plugins-base/gst-libs/gst/video/
video-overlay-composition.c, and video-blend.c) with the blend on torch:

* host numpy, copied: ``scale_linear_rgba`` (gst_video_blend_scale_linear_
  RGBA, video-blend.c:156: the 16.16 fixed-point bilinear with
  ``video_orc_merge_linear_u8``'s wrap-around u16 arithmetic, which stays
  in numpy because torch's uint16 has few operations), the two fixed
  matrices (video-blend.c:64-137), ``VideoOverlayRectangle`` with its cache
  of scaled pixels, and ``VideoOverlayComposition``;
* ``video_blend`` (gst_video_blend, video-blend.c:299, BLENDLOOP :411) on
  torch in int64: OVER00/01/10/11 (:246-282), ``keep = asrc == 0``, the
  clamp that caps only the high side (BLENDC :284), the 16-bit ``shift``
  and ``global_alpha`` taken through float32 on the host.  It writes the
  rectangle's region into the caller's channel planes IN PLACE: the caller
  owns them (``owned_chans``: unpack's widened planes are the buffer's one
  copy) and may blend a run of frames at once through ``frames``.  The
  clipped, colour-adapted source goes to the device once per rectangle, as
  uint8, and its int64 alpha, keep mask and shifted colours are kept on
  the rectangle for every later frame and buffer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .format import pack_planes, unpack_planes


# -- rectangle scaling (gst_video_blend_scale_linear_RGBA), host copy ------

def _resample_bilinear_u32(row: np.ndarray, x_increment: int,
                           dest_width: int) -> np.ndarray:
    """ldreslinl over one row of (W, 4) u8 pixels (exact orc emulation)."""
    tmp = np.arange(dest_width, dtype=np.int64) * x_increment
    j = (tmp >> 16).astype(np.int64)
    f = ((tmp >> 8) & 0xFF).astype(np.int64)
    a = row[j].astype(np.int64)
    b = row[np.minimum(j + 1, row.shape[0] - 1)].astype(np.int64)
    return ((a * (256 - f)[:, None] + b * f[:, None]) >> 8).astype(np.uint8)


def _merge_linear_u8(s1: np.ndarray, s2: np.ndarray, w: int) -> np.ndarray:
    """video_orc_merge_linear_u8: d = s1 + hi8((s2-s1)*w + 128), all in
    wrap-around u16/u8 arithmetic."""
    a = s1.astype(np.uint16)
    t2 = ((s2.astype(np.uint16) - a) * np.uint16(w) + np.uint16(128))
    t = (t2 >> 8).astype(np.uint8)
    return (t + s1.astype(np.uint8)).astype(np.uint8)


def scale_linear_rgba(pixels: np.ndarray, dest_width: int,
                      dest_height: int) -> np.ndarray:
    """Scale (H, W, 4) u8 ARGB pixels to (dest_height, dest_width, 4).

    Bit-exact port of gst_video_blend_scale_linear_RGBA
    (video-blend.c:156)."""
    src_h, src_w = pixels.shape[:2]
    if (src_h, src_w) == (dest_height, dest_width):
        return pixels
    y_inc = 0 if (dest_height == 1 or src_h == 1) else \
        ((src_h - 1) << 16) // (dest_height - 1) - 1
    x_inc = 0 if (dest_width == 1 or src_w == 1) else \
        ((src_w - 1) << 16) // (dest_width - 1) - 1

    hrows = np.stack([_resample_bilinear_u32(pixels[r], x_inc, dest_width)
                      for r in range(src_h)])
    out = np.empty((dest_height, dest_width, 4), np.uint8)
    acc = 0
    for i in range(dest_height):
        j = acc >> 16
        x = acc & 0xFFFF
        if x == 0:
            out[i] = hrows[j]
        else:
            out[i] = _merge_linear_u8(hrows[j], hrows[min(j + 1, src_h - 1)],
                                      x >> 8)
        acc += y_inc
    return out


# -- fixed conversion matrices (video-blend.c:64-137), host copy -----------

def _matrix_rgb_to_yuv(px: np.ndarray, unpremultiply: bool) -> np.ndarray:
    px = px.astype(np.int64)
    a, r, g, b = px[..., 0], px[..., 1], px[..., 2], px[..., 3]
    if unpremultiply:
        safe = np.maximum(a, 1)
        r = np.where(a != 0, (r * 255 + a // 2) // safe, r)
        g = np.where(a != 0, (g * 255 + a // 2) // safe, g)
        b = np.where(a != 0, (b * 255 + a // 2) // safe, b)
    y = (47 * r + 157 * g + 16 * b + 4096) >> 8
    u = (-26 * r - 87 * g + 112 * b + 32768) >> 8
    v = (112 * r - 102 * g - 10 * b + 32768) >> 8
    out = np.stack([a, np.clip(y, 0, 255), np.clip(u, 0, 255),
                    np.clip(v, 0, 255)], axis=-1)
    return out.astype(np.uint8)


def _matrix_yuv_to_rgb(px: np.ndarray) -> np.ndarray:
    px = px.astype(np.int64)
    a, y, u, v = px[..., 0], px[..., 1], px[..., 2], px[..., 3]
    r = (298 * y + 459 * v - 63514) >> 8
    g = (298 * y - 55 * u - 136 * v + 19681) >> 8
    b = (298 * y + 541 * u - 73988) >> 8
    out = np.stack([a, np.clip(r, 0, 255), np.clip(g, 0, 255),
                    np.clip(b, 0, 255)], axis=-1)
    return out.astype(np.uint8)


# -- overlay rectangle / composition ---------------------------------------

@dataclass
class VideoOverlayRectangle:
    """An ARGB overlay rectangle (gst_video_overlay_rectangle_new_raw).

    pixels: (H, W, 4) uint8 in canonical unpack order (A, R, G, B).
    render_x/y/width/height: placement on the video frame.  ``_device``
    holds the blend's prepared source per device and destination (see
    ``video_blend``)."""
    pixels: np.ndarray
    render_x: int = 0
    render_y: int = 0
    render_width: int = 0
    render_height: int = 0
    global_alpha: float = 1.0
    premultiplied: bool = False
    _scaled: Optional[np.ndarray] = field(default=None, repr=False)
    _device: Dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.pixels = np.asarray(self.pixels, np.uint8)
        if not self.render_width:
            self.render_width = self.pixels.shape[1]
        if not self.render_height:
            self.render_height = self.pixels.shape[0]

    def get_pixels_scaled(self) -> np.ndarray:
        """Rectangle pixels at render size (cached, like the reference's
        scaled-pixels cache in video-overlay-composition.c)."""
        if self._scaled is None:
            self._scaled = scale_linear_rgba(
                self.pixels, self.render_width, self.render_height)
        return self._scaled


class VideoOverlayComposition:
    """An ordered set of overlay rectangles
    (gst_video_overlay_composition_new / _add_rectangle)."""

    def __init__(self, rectangles: Sequence[VideoOverlayRectangle] = ()):
        self.rectangles: List[VideoOverlayRectangle] = list(rectangles)

    def add_rectangle(self, rect: VideoOverlayRectangle):
        self.rectangles.append(rect)

    @property
    def n_rectangles(self) -> int:
        return len(self.rectangles)

    def blend(self, chans, dest_is_rgb: bool, width: int, height: int,
              dest_premultiplied: bool = False, bits: int = 8, frames=None):
        """Blend all rectangles onto canonical channel planes, in place
        (gst_video_overlay_composition_blend), over the frames `frames`
        selects on the first axis (all of them if None)."""
        for rect in self.rectangles:
            chans = video_blend(
                chans, dest_is_rgb, rect.get_pixels_scaled(),
                rect.render_x, rect.render_y, rect.global_alpha,
                src_premultiplied=rect.premultiplied,
                dest_premultiplied=dest_premultiplied,
                width=width, height=height, bits=bits, frames=frames,
                cache=rect._device)
        return chans


def owned_chans(chans, planes):
    """`chans` (unpack_planes' output) with every plane that shares memory
    with an input plane or an earlier channel cloned, so that video_blend
    may write into them (a 16-bit container handed in as int32 unpacks to
    the same tensor; gray formats share one neutral chroma plane)."""
    seen = {p.untyped_storage().data_ptr() for p in planes
            if isinstance(p, torch.Tensor)}
    out = []
    for c in chans:
        if c is not None:
            if c.untyped_storage().data_ptr() in seen:
                c = c.clone()
            seen.add(c.untyped_storage().data_ptr())
        out.append(c)
    return out


def _prepare(src_argb: np.ndarray, sx0: int, sy0: int, w: int, h: int,
             dest_is_rgb: bool, src_premultiplied: bool,
             global_alpha: float, bits: int, device: torch.device):
    """The blend's source on the device: (alpha_val, src_premultiplied
    after adaption, asrc, keep, (c1, c2, c3)), the last three int64.  The
    clip and the fixed-matrix colour adaption run on the host, as in the
    reference; one uint8 upload, then the integer products on the device."""
    src = src_argb[sy0:sy0 + h, sx0:sx0 + w]
    src_is_rgb = True   # overlay rectangles are ARGB by definition
    if src_is_rgb != dest_is_rgb:
        src = _matrix_rgb_to_yuv(src, src_premultiplied)
        src_premultiplied = False
    maxv = 255 if bits == 8 else 65535
    shift = 0 if bits == 8 else 8
    alpha_val = int(float(np.float32(maxv) * np.float32(global_alpha)))
    alpha_val = max(0, min(maxv, alpha_val))
    px = torch.as_tensor(np.ascontiguousarray(np.moveaxis(src, -1, 0)),
                         device=device).to(torch.int64)
    asrc = ((px[0] * alpha_val) // maxv) << shift
    cols = tuple(px[c] << shift for c in (1, 2, 3))
    return alpha_val, src_premultiplied, asrc, asrc == 0, cols


def video_blend(chans, dest_is_rgb: bool, src_argb: np.ndarray,
                x: int, y: int, global_alpha: float = 1.0,
                src_premultiplied: bool = False,
                dest_premultiplied: bool = False,
                width: int = 0, height: int = 0, bits: int = 8,
                frames=None, cache: Optional[Dict] = None):
    """gst_video_blend: blend an ARGB image into canonical channel planes.

    chans: (A, c0, c1, c2) torch planes, each (..., H, W) int, in the
    frame's unpack domain (8- or 16-bit per `bits`), written IN PLACE over
    the frames `frames` selects (a slice or index of the first axis; all
    of them if None).  Exact BLENDLOOP integer math (video-blend.c:411)
    in int64.  `cache` (a rectangle's ``_device``) keeps the prepared
    source across calls."""
    a_pl, c0, c1, c2 = chans
    dest_h = height or c0.shape[-2]
    dest_w = width or c0.shape[-1]
    src_h, src_w = src_argb.shape[:2]

    # clip (video-blend.c:333,373-393)
    if x + src_w <= 0 or y + src_h <= 0 or x >= dest_w or y >= dest_h:
        return chans
    sx0 = -x if x < 0 else 0
    sy0 = -y if y < 0 else 0
    x = max(x, 0)
    y = max(y, 0)
    w = min(src_w - sx0, dest_w - x)
    h = min(src_h - sy0, dest_h - y)

    key = (c0.device, dest_is_rgb, bits, sx0, sy0, w, h, src_premultiplied,
           global_alpha)
    prep = None if cache is None else cache.get(key)
    if prep is None:
        prep = _prepare(src_argb, sx0, sy0, w, h, dest_is_rgb,
                        src_premultiplied, global_alpha, bits, c0.device)
        if cache is not None:
            cache[key] = prep
    alpha_val, src_pre, asrc, keep, cols = prep

    maxv = 255 if bits == 8 else 65535
    sl = (Ellipsis if frames is None else frames, slice(y, y + h),
          slice(x, x + w))

    if a_pl is None:   # alpha plane elided -> opaque destination
        adst = torch.full((h, w), maxv, dtype=torch.int64, device=c0.device)
    else:
        adst = a_pl[sl].to(torch.int64)
    inv = maxv - asrc
    final_alpha = asrc + adst * inv // maxv
    div_a = torch.clamp(final_alpha, min=1)

    for plane, col in ((c0, cols[0]), (c1, cols[1]), (c2, cols[2])):
        dc = plane[sl].to(torch.int64)
        if src_pre and dest_premultiplied:                # OVER11
            c = (col * alpha_val + dc * inv) // maxv
        elif (not src_pre) and dest_premultiplied:        # OVER01
            c = (col * asrc + dc * inv) // maxv
        elif src_pre:                                     # OVER10
            c = (col * alpha_val + dc * adst * inv // maxv) // div_a
        else:                                             # OVER00
            c = (col * asrc + dc * adst * inv // maxv) // div_a
        plane[sl] = torch.where(keep, dc, torch.clamp(c, max=maxv)) \
            .to(plane.dtype)
    if a_pl is not None:
        a_pl[sl] = torch.where(keep, adst, final_alpha).to(a_pl.dtype)
    return chans


def blend_planes(fmt, planes, width: int, height: int, groups):
    """Unpack a batch of component planes once, blend each (frames,
    composition) of `groups` into it (frames: a slice or index of the
    batch axis), and pack: the planes of the blended batch."""
    chans = owned_chans(unpack_planes(torch, fmt, planes, width, height),
                        planes)
    for frames, comp in groups:
        comp.blend(chans, fmt.is_rgb, width, height, bits=fmt.bits,
                   frames=frames)
    return pack_planes(torch, fmt, chans, width, height)


def runs(items):
    """[(slice of consecutive indices, item)] for the non-None entries of
    `items`, consecutive equal (the same object) entries merged: frames
    that carry the same composition blend in one call."""
    out = []
    start = 0
    for k in range(1, len(items) + 1):
        if k == len(items) or items[k] is not items[start]:
            if items[start] is not None:
                out.append((slice(start, k), items[start]))
            start = k
    return out
