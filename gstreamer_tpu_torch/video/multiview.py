"""Stereoscopic / multiview video representation.

TPU-native counterpart of
gst-plugins-base/gst-libs/gst/video/video-multiview.c:
- mode enum (video-info.h:132 GstVideoMultiviewMode) and flags
  (video-info.h GstVideoMultiviewFlags),
- caps mnemonics table (video-multiview.c:43 gst_multiview_modes),
- mode-category lists (init_mview_mode_vals, video-multiview.c:122),
- half-aspect heuristic (gst_video_multiview_guess_half_aspect,
  video-multiview.c:381).

A copy of the JAX package's ``video/multiview.py`` (host tables only).
"""

from __future__ import annotations

import enum
from typing import List, Optional, Tuple


class MultiviewMode(enum.IntEnum):
    """GstVideoMultiviewMode (video-info.h:132)."""
    NONE = -1
    MONO = 0
    LEFT = 1
    RIGHT = 2
    SIDE_BY_SIDE = 3
    SIDE_BY_SIDE_QUINCUNX = 4
    COLUMN_INTERLEAVED = 5
    ROW_INTERLEAVED = 6
    TOP_BOTTOM = 7
    CHECKERBOARD = 8
    FRAME_BY_FRAME = 32
    MULTIVIEW_FRAME_BY_FRAME = 33
    SEPARATED = 34


class MultiviewFlags(enum.IntFlag):
    """GstVideoMultiviewFlags (video-info.h)."""
    NONE = 0
    RIGHT_VIEW_FIRST = 1 << 0
    LEFT_FLIPPED = 1 << 1
    LEFT_FLOPPED = 1 << 2
    RIGHT_FLIPPED = 1 << 3
    RIGHT_FLOPPED = 1 << 4
    HALF_ASPECT = 1 << 14
    MIXED_MONO = 1 << 15


# caps mnemonics (video-multiview.c:43)
_MODES = [
    ("mono", MultiviewMode.MONO),
    ("left", MultiviewMode.LEFT),
    ("right", MultiviewMode.RIGHT),
    ("side-by-side", MultiviewMode.SIDE_BY_SIDE),
    ("side-by-side-quincunx", MultiviewMode.SIDE_BY_SIDE_QUINCUNX),
    ("column-interleaved", MultiviewMode.COLUMN_INTERLEAVED),
    ("row-interleaved", MultiviewMode.ROW_INTERLEAVED),
    ("top-bottom", MultiviewMode.TOP_BOTTOM),
    ("checkerboard", MultiviewMode.CHECKERBOARD),
    ("frame-by-frame", MultiviewMode.FRAME_BY_FRAME),
    ("multiview-frame-by-frame", MultiviewMode.MULTIVIEW_FRAME_BY_FRAME),
    ("separated", MultiviewMode.SEPARATED),
]


def mode_to_caps_string(mode: MultiviewMode) -> Optional[str]:
    """gst_video_multiview_mode_to_caps_string (video-multiview.c:76)."""
    for s, m in _MODES:
        if m == mode:
            return s
    return None


def mode_from_caps_string(s: str) -> MultiviewMode:
    """gst_video_multiview_mode_from_caps_string
    (video-multiview.c:102): NONE on unknown strings."""
    for name, m in _MODES:
        if name == s:
            return m
    return MultiviewMode.NONE


# mode categories (init_mview_mode_vals, video-multiview.c:122)
MONO_MODES = ["mono", "left", "right"]
UNPACKED_MODES = ["separated", "frame-by-frame", "multiview-frame-by-frame"]
DOUBLED_HEIGHT_MODES = ["top-bottom", "row-interleaved"]
DOUBLED_WIDTH_MODES = ["side-by-side", "side-by-side-quincunx",
                       "column-interleaved"]
DOUBLED_SIZE_MODES = ["checkerboard"]


def guess_half_aspect(mode: MultiviewMode, width: int, height: int,
                      par_n: int, par_d: int) -> bool:
    """gst_video_multiview_guess_half_aspect (video-multiview.c:381)."""
    if mode in (MultiviewMode.TOP_BOTTOM, MultiviewMode.ROW_INTERLEAVED):
        return height * par_d <= width * par_n
    if mode in (MultiviewMode.SIDE_BY_SIDE,
                MultiviewMode.SIDE_BY_SIDE_QUINCUNX,
                MultiviewMode.COLUMN_INTERLEAVED):
        return width * par_n < 2.39 * height * par_d
    return False


def change_mode_geometry(
        width: int, height: int, par: Tuple[int, int],
        in_mode: MultiviewMode, in_flags: MultiviewFlags,
        out_mode: MultiviewMode, out_flags: MultiviewFlags,
) -> Tuple[int, int, Tuple[int, int]]:
    """Geometry half of gst_video_multiview_video_info_change_mode
    (video-multiview.c:240): converting between packings rescales the
    per-view width/height and folds HALF_ASPECT into the PAR."""
    def unpacked(mode, flags):
        """per-view geometry for a packing."""
        w, h, (pn, pd) = width, height, par
        name = mode_to_caps_string(mode) or "mono"
        if name in DOUBLED_HEIGHT_MODES:
            h //= 2
        elif name in DOUBLED_WIDTH_MODES:
            w //= 2
        elif name in DOUBLED_SIZE_MODES:
            w //= 2
            h //= 2
        if flags & MultiviewFlags.HALF_ASPECT:
            if name in DOUBLED_HEIGHT_MODES:
                pd *= 2
            elif name in DOUBLED_WIDTH_MODES:
                pn *= 2
        return w, h, (pn, pd)

    w, h, (pn, pd) = unpacked(in_mode, in_flags)
    name = mode_to_caps_string(out_mode) or "mono"
    if name in DOUBLED_HEIGHT_MODES:
        h *= 2
        if out_flags & MultiviewFlags.HALF_ASPECT:
            pn *= 2
    elif name in DOUBLED_WIDTH_MODES:
        w *= 2
        if out_flags & MultiviewFlags.HALF_ASPECT:
            pd *= 2
    elif name in DOUBLED_SIZE_MODES:
        w *= 2
        h *= 2
    from math import gcd
    g = gcd(pn, pd) or 1
    return w, h, (pn // g, pd // g)
