"""SMPTE transition masks — a copy of the JAX package's
``video/smpte_mask.py`` (host numpy; the port keeps its own copy and imports
nothing of the JAX package).

Reference: subprojects/gst-plugins-good/gst/smpte/ —
paint.c (gst_smpte_paint_vbox :32, _hbox :55, _triangle_linear :155,
draw_bresenham_line :221, _triangle_clock :268, _box_clock :311),
barboxwipes.c (wipe object tables + gst_wipe_boxes_draw :557,
gst_wipe_triangles_draw :633), gstmask.c (gst_mask_factory_new :70 with
invert handling).

Masks are built ONCE per (type, size, depth) on the host (numpy) at
negotiation time — like the reference, which rasterizes the guint32 mask
once in update_mask — then live as device tensors; the per-frame
threshold/blend math runs in torch (see elements/smpte.py).

The integer rasterizers (Bresenham 3D-line triangle fill, gradient
boxes) are ported operation-for-operation so mask values match the
reference bit-for-bit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

BOX_VERTICAL = 1
BOX_HORIZONTAL = 2
BOX_CLOCK = 3


# -- paint.c ---------------------------------------------------------------

def paint_vbox(dest, stride, x0, y0, c0, x1, y1, c1):
    width = x1 - x0
    j = np.arange(width, dtype=np.int64)
    row = (c1 * j + c0 * (width - j)) // width
    dest[y0:y1, x0:x1] = row[None, :]


def paint_hbox(dest, stride, x0, y0, c0, x1, y1, c1):
    height = y1 - y0
    i = np.arange(height, dtype=np.int64)
    col = (c1 * i + c0 * (height - i)) // height
    dest[y0:y1, x0:x1] = col[:, None]


def _sign(a):
    return -1 if a < 0 else 1


class _Line3D:
    """PREPARE_3D_LINE / STEP_3D_LINE state (paint.c:122-141, :80)."""

    def __init__(self, x0, y0, z0, x1, y1, z1):
        dx, dy, dz = x1 - x0, y1 - y0, z1 - z0
        self.dxabs, self.dyabs, self.dzabs = abs(dx), abs(dy), abs(dz)
        self.sdx, self.sdy, self.sdz = _sign(dx), _sign(dy), _sign(dz)
        self.xr, self.yr, self.zr = (self.dxabs >> 1, self.dyabs >> 1,
                                     self.dzabs >> 1)
        self.px, self.py, self.pz = x0, y0, z0

    def step(self):
        # exact port of STEP_3D_LINE, including its quirky third branch
        if self.dxabs >= self.dyabs and self.dxabs >= self.dzabs:
            self.yr += self.dyabs
            self.zr += self.dzabs
            if self.yr >= self.dxabs:
                self.py += self.sdy
                self.yr -= self.dxabs
            if self.zr >= self.dzabs:
                self.pz += self.sdz
                self.zr -= self.dxabs
            self.px += self.sdx
        elif self.dyabs >= self.dxabs and self.dyabs >= self.dzabs:
            self.xr += self.dxabs
            self.zr += self.dzabs
            if self.xr >= self.dyabs:
                self.px += self.sdx
                self.xr -= self.dyabs
            if self.zr >= self.dzabs:
                self.pz += self.sdz
                self.zr -= self.dyabs
            self.py += self.sdy
        else:
            self.yr += self.dyabs
            self.xr += self.dxabs
            if self.yr >= self.dyabs:
                self.py += self.sdy
                self.yr -= self.dzabs
            if self.xr >= self.dyabs:
                self.px += self.sdx
                self.xr -= self.dzabs
            self.pz += self.sdz


def paint_triangle_linear(dest, stride, x0, y0, c0, x1, y1, c1, x2, y2, c2):
    if y0 > y1:
        x0, x1 = x1, x0
        y0, y1 = y1, y0
        c0, c1 = c1, c0
    if y0 > y2:
        x0, x2 = x2, x0
        y0, y2 = y2, y0
        c0, c2 = c2, c0
    if y1 > y2:
        x1, x2 = x2, x1
        y1, y2 = y2, y1
        c1, c2 = c2, c1

    left = _Line3D(x0, y0, c0, x2, y2, c2)
    right = _Line3D(x0, y0, c0, x1, y1, c1)

    row = y0
    seg_start, seg_end = y0, y1
    for _k in range(2):
        for i in range(seg_start, seg_end):
            s, e, sc, ec = left.px, right.px, left.pz, right.pz
            sign = _sign(e - s)
            e += sign
            for j in range(s, e, sign):
                dest[row, j] = (ec * (j - s) + sc * (e - j)) // (e - s)
            while right.py == i:
                right.step()
            while left.py == i:
                left.step()
            row += 1
        right = _Line3D(x1, y1, c1, x2, y2, c2)
        seg_start, seg_end = y1, y2


def _draw_bresenham_line(dest, stride, x0, y0, x1, y1, col):
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    px, py = x0, y0
    x_incr = _sign(x1 - x0)
    y_incr = _sign(y1 - y0)
    if dx >= dy:
        dpr = dy << 1
        i = dx
        indep = (x_incr, 0)
    else:
        dpr = dx << 1
        i = dy
        indep = (0, y_incr)
    dpru = dpr - (i << 1)
    P = dpr - i
    while i >= 0:
        dest[py, px] = col
        if P > 0:
            px += x_incr
            py += y_incr
            P += dpru
        else:
            px += indep[0]
            py += indep[1]
            P += dpr
        i -= 1


def paint_triangle_clock(dest, stride, x0, y0, c0, x1, y1, c1, x2, y2, c2):
    angle_e = math.acos(
        ((x1 - x0) * (x2 - x0) + (y1 - y0) * (y2 - y0)) /
        (math.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2) *
         math.sqrt((x2 - x0) ** 2 + (y2 - y0) ** 2)))
    len1 = math.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2)

    if x1 == x2:
        sign = _sign(y2 - y1)
        for i in range(y1, y2 + sign, sign):
            if y1 == i:
                angle = 0.0
            else:
                angle = math.acos(
                    ((x1 - x0) * (x2 - x0) + (y1 - y0) * (i - y0)) /
                    (len1 * math.sqrt((x1 - x0) ** 2 + (i - y0) ** 2))
                ) / angle_e
            _draw_bresenham_line(dest, stride, x0, y0, x1, i,
                                 int(c2 * angle + c1 * (1.0 - angle)))
    elif y1 == y2:
        sign = _sign(x2 - x1)
        for i in range(x1, x2 + sign, sign):
            if x1 == i:
                angle = 0.0
            else:
                angle = math.acos(
                    ((x1 - x0) * (i - x0) + (y1 - y0) * (y2 - y0)) /
                    (len1 * math.sqrt((i - x0) ** 2 + (y2 - y0) ** 2))
                ) / angle_e
            _draw_bresenham_line(dest, stride, x0, y0, i, y1,
                                 int(c2 * angle + c1 * (1.0 - angle)))


def paint_box_clock(dest, stride, x0, y0, c0, x1, y1, c1, x2, y2, c2):
    if x1 == x0:
        xv, yv = x2, y1
    elif y1 == y0:
        xv, yv = x1, y2
    else:
        return
    angle_m = 2 * math.acos(
        ((x1 - x0) * (xv - x0) + (y1 - y0) * (yv - y0)) /
        (math.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2) *
         math.sqrt((xv - x0) ** 2 + (yv - y0) ** 2))) / math.pi
    # C truncates col_m to gint at the call boundary (paint.c:334)
    col_m = int(c2 * angle_m + c1 * (1.0 - angle_m))
    paint_triangle_clock(dest, stride, x0, y0, c0, x1, y1, c1, xv, yv, col_m)
    paint_triangle_clock(dest, stride, x0, y0, c0, xv, yv, col_m, x2, y2, c2)


# -- barboxwipes.c object tables -------------------------------------------
# (pure data: box/triangle endpoints in grid units, scales select the
#  grid granularity; transcribed from barboxwipes.c:36-232)

_BOXES_1B = [
    [BOX_VERTICAL, 0, 0, 0, 1, 1, 1],
    [BOX_HORIZONTAL, 0, 0, 0, 1, 1, 1],
]

_BOXES_2B = [
    [BOX_VERTICAL, 0, 0, 1, 1, 2, 0, BOX_VERTICAL, 1, 0, 0, 2, 2, 1],
    [BOX_HORIZONTAL, 0, 0, 1, 2, 1, 0, BOX_HORIZONTAL, 0, 1, 0, 2, 2, 1],
]

_BOX_CLOCK_1B = [
    [BOX_CLOCK, 0, 0, 0, 1, 0, 0, 0, 1, 1],
    [BOX_CLOCK, 0, 1, 0, 1, 1, 0, 0, 0, 1],
    [BOX_CLOCK, 1, 1, 0, 0, 1, 0, 1, 0, 1],
    [BOX_CLOCK, 1, 0, 0, 0, 0, 0, 1, 1, 1],
]

_BOX_CLOCK_2B = [
    [BOX_CLOCK, 1, 0, 0, 2, 0, 0, 1, 2, 1,
     BOX_CLOCK, 1, 0, 0, 1, 2, 1, 0, 0, 2],
    [BOX_CLOCK, 2, 1, 0, 2, 2, 0, 0, 1, 1,
     BOX_CLOCK, 2, 1, 0, 0, 1, 1, 2, 0, 2],
    [BOX_CLOCK, 1, 2, 0, 0, 2, 0, 1, 0, 1,
     BOX_CLOCK, 1, 2, 0, 1, 0, 1, 2, 2, 2],
    [BOX_CLOCK, 0, 1, 0, 0, 0, 0, 2, 1, 1,
     BOX_CLOCK, 0, 1, 0, 2, 1, 1, 0, 2, 2],
    [BOX_CLOCK, 1, 0, 0, 2, 0, 0, 1, 2, 1,
     BOX_CLOCK, 1, 2, 0, 0, 2, 0, 1, 0, 1],
    [BOX_CLOCK, 0, 1, 0, 0, 0, 0, 2, 1, 1,
     BOX_CLOCK, 2, 1, 0, 2, 2, 0, 0, 1, 1],
    [BOX_CLOCK, 1, 0, 0, 1, 2, 0, 2, 0, 1,
     BOX_CLOCK, 1, 0, 0, 1, 2, 0, 0, 0, 1],
    [BOX_CLOCK, 2, 1, 0, 0, 1, 0, 2, 0, 1,
     BOX_CLOCK, 2, 1, 0, 0, 1, 0, 2, 2, 1],
    [BOX_CLOCK, 1, 2, 0, 1, 0, 0, 2, 2, 1,
     BOX_CLOCK, 1, 2, 0, 1, 0, 0, 0, 2, 1],
    [BOX_CLOCK, 0, 1, 0, 2, 1, 0, 0, 0, 1,
     BOX_CLOCK, 0, 1, 0, 2, 1, 0, 0, 2, 1],
    [BOX_CLOCK, 0, 0, 0, 1, 0, 0, 0, 2, 1,
     BOX_CLOCK, 2, 0, 0, 1, 0, 0, 2, 2, 1],
    [BOX_CLOCK, 0, 0, 0, 0, 1, 0, 2, 0, 1,
     BOX_CLOCK, 0, 2, 0, 0, 1, 0, 2, 2, 1],
    [BOX_CLOCK, 0, 2, 0, 1, 2, 0, 0, 0, 1,
     BOX_CLOCK, 2, 2, 0, 1, 2, 0, 2, 0, 1],
    [BOX_CLOCK, 2, 0, 0, 2, 1, 0, 0, 0, 1,
     BOX_CLOCK, 2, 2, 0, 2, 1, 0, 0, 2, 1],
]

_BOX_CLOCK_4B = [
    [BOX_CLOCK, 1, 1, 0, 1, 0, 0, 2, 1, 1,
     BOX_CLOCK, 1, 1, 0, 2, 1, 1, 1, 2, 2,
     BOX_CLOCK, 1, 1, 0, 1, 2, 2, 0, 1, 3,
     BOX_CLOCK, 1, 1, 0, 0, 1, 3, 1, 0, 4],
    [BOX_CLOCK, 1, 1, 0, 1, 0, 3, 2, 1, 4,
     BOX_CLOCK, 1, 1, 0, 2, 1, 0, 1, 2, 1,
     BOX_CLOCK, 1, 1, 0, 1, 2, 1, 0, 1, 2,
     BOX_CLOCK, 1, 1, 0, 0, 1, 2, 1, 0, 3],
    [BOX_CLOCK, 1, 1, 0, 1, 0, 2, 2, 1, 3,
     BOX_CLOCK, 1, 1, 0, 2, 1, 3, 1, 2, 4,
     BOX_CLOCK, 1, 1, 0, 1, 2, 0, 0, 1, 1,
     BOX_CLOCK, 1, 1, 0, 0, 1, 1, 1, 0, 2],
    [BOX_CLOCK, 1, 1, 0, 1, 0, 1, 2, 1, 2,
     BOX_CLOCK, 1, 1, 0, 2, 1, 2, 1, 2, 3,
     BOX_CLOCK, 1, 1, 0, 1, 2, 3, 0, 1, 4,
     BOX_CLOCK, 1, 1, 0, 0, 1, 0, 1, 0, 1],
    [BOX_CLOCK, 1, 1, 0, 1, 0, 0, 2, 1, 1,
     BOX_CLOCK, 1, 1, 0, 2, 1, 1, 1, 2, 2,
     BOX_CLOCK, 1, 1, 0, 1, 2, 0, 0, 1, 1,
     BOX_CLOCK, 1, 1, 0, 0, 1, 1, 1, 0, 2],
    [BOX_CLOCK, 1, 1, 0, 1, 0, 1, 2, 1, 2,
     BOX_CLOCK, 1, 1, 0, 2, 1, 0, 1, 2, 1,
     BOX_CLOCK, 1, 1, 0, 1, 2, 1, 0, 1, 2,
     BOX_CLOCK, 1, 1, 0, 0, 1, 0, 1, 0, 1],
    [BOX_CLOCK, 1, 1, 0, 1, 0, 0, 2, 1, 1,
     BOX_CLOCK, 1, 1, 0, 2, 1, 0, 1, 2, 1,
     BOX_CLOCK, 1, 1, 0, 1, 2, 0, 0, 1, 1,
     BOX_CLOCK, 1, 1, 0, 0, 1, 0, 1, 0, 1],
    [BOX_CLOCK, 1, 1, 0, 1, 0, 0, 2, 1, 1,
     BOX_CLOCK, 1, 1, 0, 2, 1, 1, 1, 2, 2,
     BOX_CLOCK, 1, 1, 0, 1, 0, 0, 0, 1, 1,
     BOX_CLOCK, 1, 1, 0, 0, 1, 1, 1, 2, 2],
    [BOX_CLOCK, 1, 1, 0, 2, 1, 0, 1, 0, 1,
     BOX_CLOCK, 1, 1, 0, 1, 0, 1, 0, 1, 2,
     BOX_CLOCK, 1, 1, 0, 2, 1, 0, 1, 2, 1,
     BOX_CLOCK, 1, 1, 0, 1, 2, 1, 0, 1, 2],
    [BOX_CLOCK, 1, 1, 0, 1, 0, 0, 2, 1, 1,
     BOX_CLOCK, 1, 1, 0, 1, 0, 0, 0, 1, 1,
     BOX_CLOCK, 1, 1, 0, 1, 2, 0, 2, 1, 1,
     BOX_CLOCK, 1, 1, 0, 1, 2, 0, 0, 1, 1],
    [BOX_CLOCK, 1, 1, 0, 2, 1, 0, 1, 0, 1,
     BOX_CLOCK, 1, 1, 0, 2, 1, 0, 1, 2, 1,
     BOX_CLOCK, 1, 1, 0, 0, 1, 0, 1, 0, 1,
     BOX_CLOCK, 1, 1, 0, 0, 1, 0, 1, 2, 1],
    [BOX_CLOCK, 1, 0, 0, 2, 0, 0, 1, 1, 1,
     BOX_CLOCK, 1, 0, 0, 1, 1, 1, 0, 0, 2,
     BOX_CLOCK, 1, 2, 0, 2, 2, 0, 1, 1, 1,
     BOX_CLOCK, 1, 2, 0, 1, 1, 1, 0, 2, 2],
    [BOX_CLOCK, 0, 1, 0, 0, 0, 0, 1, 1, 1,
     BOX_CLOCK, 0, 1, 0, 1, 1, 1, 0, 2, 2,
     BOX_CLOCK, 2, 1, 0, 2, 0, 0, 1, 1, 1,
     BOX_CLOCK, 2, 1, 0, 1, 1, 1, 2, 2, 2],
    [BOX_CLOCK, 1, 0, 0, 1, 1, 0, 0, 0, 1,
     BOX_CLOCK, 1, 0, 0, 1, 1, 0, 2, 0, 1,
     BOX_CLOCK, 1, 2, 0, 1, 1, 0, 2, 2, 1,
     BOX_CLOCK, 1, 2, 0, 1, 1, 0, 0, 2, 1],
    [BOX_CLOCK, 0, 1, 0, 1, 1, 0, 0, 0, 1,
     BOX_CLOCK, 0, 1, 0, 1, 1, 0, 0, 2, 1,
     BOX_CLOCK, 2, 1, 0, 1, 1, 0, 2, 0, 1,
     BOX_CLOCK, 2, 1, 0, 1, 1, 0, 2, 2, 1],
]

_TRIANGLES_2T = [
    [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 1],
    [0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 1],
    [0, 0, 1, 0, 1, 1, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0],
    [0, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1],
    [0, 0, 0, 1, 0, 1, 0, 1, 1, 1, 0, 1, 0, 1, 1, 1, 1, 2],
    [0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 1, 2, 1, 1, 1],
    [0, 0, 1, 1, 0, 0, 0, 1, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1],
    [0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0],
    [0, 0, 0, 2, 0, 0, 2, 2, 1, 2, 2, 0, 0, 2, 0, 0, 0, 1],
    [0, 2, 0, 0, 0, 0, 2, 0, 1, 2, 0, 0, 2, 2, 0, 0, 2, 1],
]

_TRIANGLES_3T = [
    [0, 0, 1, 1, 0, 0, 0, 2, 1, 1, 0, 0, 0, 2, 1, 2, 2, 1,
     1, 0, 0, 2, 0, 1, 2, 2, 1],
    [0, 0, 1, 2, 0, 1, 2, 1, 0, 0, 0, 1, 2, 1, 0, 0, 2, 1,
     2, 1, 0, 0, 2, 1, 2, 2, 1],
    [0, 0, 1, 0, 2, 1, 1, 2, 0, 0, 0, 1, 2, 0, 1, 1, 2, 0,
     2, 0, 1, 1, 2, 0, 2, 2, 1],
    [0, 0, 1, 2, 0, 1, 0, 1, 0, 2, 0, 1, 0, 1, 0, 2, 2, 1,
     0, 1, 0, 0, 2, 1, 2, 2, 1],
]

_TRIANGLES_4T = [
    [0, 0, 1, 1, 0, 0, 1, 2, 1, 0, 0, 1, 0, 2, 2, 1, 2, 1,
     1, 0, 0, 2, 0, 1, 1, 2, 1, 2, 0, 1, 1, 2, 1, 2, 2, 2],
    [0, 0, 2, 2, 0, 1, 0, 1, 1, 2, 0, 1, 0, 1, 1, 2, 1, 0,
     0, 1, 1, 2, 1, 0, 2, 2, 1, 0, 1, 1, 0, 2, 2, 2, 2, 1],
    [0, 0, 2, 1, 0, 1, 0, 2, 1, 1, 0, 1, 0, 2, 1, 1, 2, 0,
     1, 0, 1, 1, 2, 0, 2, 2, 1, 1, 0, 1, 2, 0, 2, 2, 2, 1],
    [0, 0, 1, 2, 0, 2, 2, 1, 1, 0, 0, 1, 0, 1, 0, 2, 1, 1,
     0, 1, 0, 2, 1, 1, 0, 2, 1, 2, 1, 1, 0, 2, 1, 2, 2, 2],
    [0, 0, 0, 1, 0, 1, 1, 2, 0, 0, 0, 0, 0, 2, 1, 1, 2, 0,
     1, 0, 1, 2, 0, 0, 1, 2, 0, 2, 0, 0, 1, 2, 0, 2, 2, 1],
    [0, 0, 1, 2, 0, 0, 0, 1, 0, 2, 0, 0, 0, 1, 0, 2, 1, 1,
     0, 1, 0, 2, 1, 1, 2, 2, 0, 0, 1, 0, 0, 2, 1, 2, 2, 0],
    [0, 0, 1, 1, 0, 0, 0, 2, 0, 1, 0, 0, 0, 2, 0, 1, 2, 1,
     1, 0, 0, 1, 2, 1, 2, 2, 0, 1, 0, 0, 2, 0, 1, 2, 2, 0],
    [0, 0, 0, 2, 0, 1, 2, 1, 0, 0, 0, 0, 0, 1, 1, 2, 1, 0,
     0, 1, 1, 2, 1, 0, 0, 2, 0, 2, 1, 0, 0, 2, 0, 2, 2, 1],
    [0, 0, 1, 2, 0, 1, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 2, 1,
     1, 1, 0, 0, 2, 1, 2, 2, 1, 2, 0, 1, 1, 1, 0, 2, 2, 1],
]

_TRIANGLES_8T = [
    [0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 0, 1, 2, 0, 0, 1, 1, 1,
     2, 0, 0, 1, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1, 2, 2, 0,
     1, 1, 1, 1, 2, 1, 2, 2, 0, 1, 1, 1, 0, 2, 0, 1, 2, 1,
     0, 1, 1, 1, 1, 1, 0, 2, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1],
    [0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 2, 0, 1, 1, 1, 1,
     2, 0, 1, 1, 1, 1, 2, 1, 2, 1, 1, 1, 2, 1, 2, 2, 2, 1,
     1, 1, 1, 1, 2, 0, 2, 2, 1, 1, 1, 1, 0, 2, 1, 1, 2, 0,
     0, 1, 2, 1, 1, 1, 0, 2, 1, 0, 0, 1, 0, 1, 2, 1, 1, 1],
    [0, 0, 1, 1, 0, 2, 1, 1, 1, 1, 0, 2, 2, 0, 1, 1, 1, 1,
     2, 0, 1, 1, 1, 1, 2, 1, 0, 1, 1, 1, 2, 1, 0, 2, 2, 1,
     1, 1, 1, 1, 2, 2, 2, 2, 1, 1, 1, 1, 0, 2, 1, 1, 2, 2,
     0, 1, 0, 1, 1, 1, 0, 2, 1, 0, 0, 1, 0, 1, 0, 1, 1, 1],
    [0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 0, 1, 2, 0, 0, 1, 1, 0,
     2, 0, 0, 1, 1, 0, 2, 1, 1, 1, 1, 0, 2, 1, 1, 2, 2, 0,
     1, 1, 0, 1, 2, 1, 2, 2, 0, 1, 1, 0, 0, 2, 0, 1, 2, 1,
     0, 1, 1, 1, 1, 0, 0, 2, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0],
    [0, 0, 1, 1, 0, 0, 0, 1, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1,
     1, 0, 0, 2, 0, 1, 2, 1, 0, 1, 0, 0, 1, 1, 1, 2, 1, 0,
     0, 1, 0, 1, 1, 1, 1, 2, 0, 0, 1, 0, 0, 2, 1, 1, 2, 0,
     1, 1, 1, 2, 1, 0, 1, 2, 0, 2, 1, 0, 1, 2, 0, 2, 2, 1],
]

_TRIANGLES_16T = [
    [0, 0, 1, 2, 0, 1, 1, 1, 0, 2, 0, 1, 1, 1, 0, 2, 2, 1,
     1, 1, 0, 0, 2, 1, 2, 2, 1, 0, 0, 1, 1, 1, 0, 0, 2, 1,
     2, 0, 1, 4, 0, 1, 3, 1, 0, 4, 0, 1, 3, 1, 0, 4, 2, 1,
     3, 1, 0, 2, 2, 1, 4, 2, 1, 2, 0, 1, 3, 1, 0, 2, 2, 1,
     0, 2, 1, 2, 2, 1, 1, 3, 0, 2, 2, 1, 1, 3, 0, 2, 4, 1,
     1, 3, 0, 0, 4, 1, 2, 4, 1, 0, 2, 1, 1, 3, 0, 0, 4, 1,
     2, 2, 1, 4, 2, 1, 3, 3, 0, 4, 2, 1, 3, 3, 0, 4, 4, 1,
     3, 3, 0, 2, 4, 1, 4, 4, 1, 2, 2, 1, 3, 3, 0, 2, 4, 1],
]

# (objects, nobjects, kind, xscale, yscale, cscale) keyed by transition type.
# kind: "boxes" -> gst_wipe_boxes_draw, "triangles" -> triangles_draw
_WIPE_CONFIG: Dict[int, Tuple[list, int, str, int, int, int]] = {
    1: (_BOXES_1B[0], 1, "boxes", 0, 0, 0),
    2: (_BOXES_1B[1], 1, "boxes", 0, 0, 0),
    3: (_TRIANGLES_2T[0], 2, "triangles", 0, 0, 0),
    4: (_TRIANGLES_2T[1], 2, "triangles", 0, 0, 0),
    5: (_TRIANGLES_2T[2], 2, "triangles", 0, 0, 0),
    6: (_TRIANGLES_2T[3], 2, "triangles", 0, 0, 0),
    7: (_TRIANGLES_8T[0], 8, "triangles", 1, 1, 0),
    8: (_TRIANGLES_16T[0], 16, "triangles", 2, 2, 0),
    21: (_BOXES_2B[0], 2, "boxes", 1, 1, 0),
    22: (_BOXES_2B[1], 2, "boxes", 1, 1, 0),
    23: (_TRIANGLES_3T[0], 3, "triangles", 1, 1, 0),
    24: (_TRIANGLES_3T[1], 3, "triangles", 1, 1, 0),
    25: (_TRIANGLES_3T[2], 3, "triangles", 1, 1, 0),
    26: (_TRIANGLES_3T[3], 3, "triangles", 1, 1, 0),
    41: (_TRIANGLES_2T[4], 2, "triangles", 0, 0, 1),
    42: (_TRIANGLES_2T[5], 2, "triangles", 0, 0, 1),
    43: (_TRIANGLES_8T[1], 8, "triangles", 1, 1, 1),
    44: (_TRIANGLES_8T[2], 8, "triangles", 1, 1, 1),
    45: (_TRIANGLES_2T[6], 2, "triangles", 0, 0, 0),
    46: (_TRIANGLES_2T[7], 2, "triangles", 0, 0, 0),
    47: (_TRIANGLES_8T[3], 8, "triangles", 1, 1, 0),
    48: (_TRIANGLES_8T[4], 8, "triangles", 1, 1, 0),
    61: (_TRIANGLES_4T[0], 4, "triangles", 1, 1, 1),
    62: (_TRIANGLES_4T[1], 4, "triangles", 1, 1, 1),
    63: (_TRIANGLES_4T[2], 4, "triangles", 1, 1, 1),
    64: (_TRIANGLES_4T[3], 4, "triangles", 1, 1, 1),
    65: (_TRIANGLES_4T[4], 4, "triangles", 1, 1, 0),
    66: (_TRIANGLES_4T[5], 4, "triangles", 1, 1, 0),
    67: (_TRIANGLES_4T[6], 4, "triangles", 1, 1, 0),
    68: (_TRIANGLES_4T[7], 4, "triangles", 1, 1, 0),
    101: (_TRIANGLES_4T[8], 4, "triangles", 1, 1, 0),
    201: (_BOX_CLOCK_4B[0], 4, "boxes", 1, 1, 2),
    202: (_BOX_CLOCK_4B[1], 4, "boxes", 1, 1, 2),
    203: (_BOX_CLOCK_4B[2], 4, "boxes", 1, 1, 2),
    204: (_BOX_CLOCK_4B[3], 4, "boxes", 1, 1, 2),
    205: (_BOX_CLOCK_4B[4], 4, "boxes", 1, 1, 1),
    206: (_BOX_CLOCK_4B[5], 4, "boxes", 1, 1, 1),
    207: (_BOX_CLOCK_4B[6], 4, "boxes", 1, 1, 0),
    211: (_BOX_CLOCK_4B[7], 4, "boxes", 1, 1, 1),
    212: (_BOX_CLOCK_4B[8], 4, "boxes", 1, 1, 1),
    213: (_BOX_CLOCK_4B[9], 4, "boxes", 1, 1, 0),
    214: (_BOX_CLOCK_4B[10], 4, "boxes", 1, 1, 0),
    221: (_BOX_CLOCK_2B[0], 2, "boxes", 1, 1, 1),
    222: (_BOX_CLOCK_2B[1], 2, "boxes", 1, 1, 1),
    223: (_BOX_CLOCK_2B[2], 2, "boxes", 1, 1, 1),
    224: (_BOX_CLOCK_2B[3], 2, "boxes", 1, 1, 1),
    225: (_BOX_CLOCK_2B[4], 2, "boxes", 1, 1, 0),
    226: (_BOX_CLOCK_2B[5], 2, "boxes", 1, 1, 0),
    227: (_BOX_CLOCK_4B[11], 4, "boxes", 1, 1, 1),
    228: (_BOX_CLOCK_4B[12], 4, "boxes", 1, 1, 1),
    231: (_BOX_CLOCK_2B[6], 2, "boxes", 1, 1, 0),
    232: (_BOX_CLOCK_2B[7], 2, "boxes", 1, 1, 0),
    233: (_BOX_CLOCK_2B[8], 2, "boxes", 1, 1, 0),
    234: (_BOX_CLOCK_2B[9], 2, "boxes", 1, 1, 0),
    235: (_BOX_CLOCK_4B[13], 4, "boxes", 1, 1, 0),
    236: (_BOX_CLOCK_4B[14], 4, "boxes", 1, 1, 0),
    241: (_BOX_CLOCK_1B[0], 1, "boxes", 0, 0, 0),
    242: (_BOX_CLOCK_1B[1], 1, "boxes", 0, 0, 0),
    243: (_BOX_CLOCK_1B[2], 1, "boxes", 0, 0, 0),
    244: (_BOX_CLOCK_1B[3], 1, "boxes", 0, 0, 0),
    245: (_TRIANGLES_2T[8], 2, "triangles", 1, 1, 0),
    246: (_TRIANGLES_2T[9], 2, "triangles", 1, 1, 0),
    251: (_BOX_CLOCK_2B[10], 2, "boxes", 1, 1, 0),
    252: (_BOX_CLOCK_2B[11], 2, "boxes", 1, 1, 0),
    253: (_BOX_CLOCK_2B[12], 2, "boxes", 1, 1, 0),
    254: (_BOX_CLOCK_2B[13], 2, "boxes", 1, 1, 0),
}

MASK_TYPES = sorted(_WIPE_CONFIG)

# human names from barboxwipes.c definitions[] (for gst-inspect parity)
MASK_NAMES = {
    1: "bar-wipe-lr", 2: "bar-wipe-tb", 3: "box-wipe-tl", 4: "box-wipe-tr",
    5: "box-wipe-br", 6: "box-wipe-bl", 7: "four-box-wipe-ci",
    8: "four-box-wipe-co", 21: "barndoor-v", 22: "barndoor-h",
    23: "box-wipe-tc", 24: "box-wipe-rc", 25: "box-wipe-bc",
    26: "box-wipe-lc", 41: "diagonal-tl", 42: "diagonal-tr",
    43: "bowtie-v", 44: "bowtie-h", 45: "barndoor-dbl", 46: "barndoor-dtl",
    47: "misc-diagonal-dbd", 48: "misc-diagonal-dd", 61: "vee-d",
    62: "vee-l", 63: "vee-u", 64: "vee-r", 65: "barnvee-d",
    66: "barnvee-l", 67: "barnvee-u", 68: "barnvee-r", 101: "iris-rect",
    201: "clock-cw12", 202: "clock-cw3", 203: "clock-cw6", 204: "clock-cw9",
    205: "pinwheel-tbv", 206: "pinwheel-tbh", 207: "pinwheel-fb",
    211: "fan-ct", 212: "fan-cr", 213: "doublefan-fov", 214: "doublefan-foh",
    221: "singlesweep-cwt", 222: "singlesweep-cwr", 223: "singlesweep-cwb",
    224: "singlesweep-cwl", 225: "doublesweep-pv", 226: "doublesweep-pd",
    227: "doublesweep-ov", 228: "doublesweep-oh", 231: "fan-t", 232: "fan-r",
    233: "fan-b", 234: "fan-l", 235: "doublefan-fiv", 236: "doublefan-fih",
    241: "singlesweep-ccwt", 242: "singlesweep-ccwr",
    243: "singlesweep-ccwb", 244: "singlesweep-ccwl",
    245: "doublesweep-pdtl", 246: "doublesweep-pdbl",
    251: "saloondoor-t", 252: "saloondoor-r", 253: "saloondoor-b",
    254: "saloondoor-l",
}


def _draw_boxes(dest, objects, nobjects, width, height, depth,
                mask_w, mask_h):
    imp = objects
    i = 0
    k = 0
    while k < nobjects:
        kind = imp[i]
        if kind == BOX_VERTICAL:
            paint_vbox(dest, mask_w,
                       imp[i + 1] * width, imp[i + 2] * height,
                       imp[i + 3] * depth,
                       imp[i + 4] * width, imp[i + 5] * height,
                       imp[i + 6] * depth)
            i += 7
        elif kind == BOX_HORIZONTAL:
            paint_hbox(dest, mask_w,
                       imp[i + 1] * width, imp[i + 2] * height,
                       imp[i + 3] * depth,
                       imp[i + 4] * width, imp[i + 5] * height,
                       imp[i + 6] * depth)
            i += 7
        elif kind == BOX_CLOCK:
            x0 = min(imp[i + 1] * width, mask_w - 1)
            y0 = min(imp[i + 2] * height, mask_h - 1)
            x1 = min(imp[i + 4] * width, mask_w - 1)
            y1 = min(imp[i + 5] * height, mask_h - 1)
            x2 = min(imp[i + 7] * width, mask_w - 1)
            y2 = min(imp[i + 8] * height, mask_h - 1)
            paint_box_clock(dest, mask_w, x0, y0, imp[i + 3] * depth,
                            x1, y1, imp[i + 6] * depth,
                            x2, y2, imp[i + 9] * depth)
            i += 10
        k += 1


def _draw_triangles(dest, objects, nobjects, width, height, depth,
                    mask_w, mask_h):
    imp = objects
    for k in range(nobjects):
        i = k * 9
        x0 = min(imp[i + 0] * width, mask_w - 1)
        y0 = min(imp[i + 1] * height, mask_h - 1)
        x1 = min(imp[i + 3] * width, mask_w - 1)
        y1 = min(imp[i + 4] * height, mask_h - 1)
        x2 = min(imp[i + 6] * width, mask_w - 1)
        y2 = min(imp[i + 7] * height, mask_h - 1)
        paint_triangle_linear(dest, mask_w, x0, y0, imp[i + 2] * depth,
                              x1, y1, imp[i + 5] * depth,
                              x2, y2, imp[i + 8] * depth)


_mask_cache: Dict[Tuple[int, bool, int, int, int], np.ndarray] = {}


def mask_factory_new(mask_type: int, invert: bool, bpp: int,
                     width: int, height: int) -> Optional[np.ndarray]:
    """gst_mask_factory_new: rasterize the wipe mask, (H, W) int64."""
    key = (mask_type, invert, bpp, width, height)
    if key in _mask_cache:
        return _mask_cache[key]
    cfg = _WIPE_CONFIG.get(mask_type)
    if cfg is None:
        return None
    objects, nobjects, kind, xscale, yscale, cscale = cfg
    dest = np.zeros((height, width), dtype=np.int64)
    gw = width >> xscale
    gh = height >> yscale
    depth = (1 << bpp) >> cscale
    if kind == "boxes":
        _draw_boxes(dest, objects, nobjects, gw, gh, depth, width, height)
    else:
        _draw_triangles(dest, objects, nobjects, gw, gh, depth, width, height)
    if invert:
        dest = (1 << bpp) - dest
    _mask_cache[key] = dest
    return dest
