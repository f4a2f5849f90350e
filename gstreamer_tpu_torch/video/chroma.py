"""Chroma up/down-sampling with the reference's exact integer filters.

Port of the two filters of the JAX package's ``video/chroma.py`` that the
VideoConverter's 4:2:x paths run (GstVideoChromaResample, video-chroma.c
MAKE_UPSAMPLE_H2 :277, _V2 :309 and the 2x downsamplers :396):

* 2x up, cosited: even = c[k], odd = (c[k] + c[k+1] + 1) >> 1
* 2x up, interstitial: even = (c[k-1] + 3*c[k] + 2) >> 2,
  odd = (3*c[k] + c[k+1] + 2) >> 2, edges clamped
* 2x down, interstitial: c[k] = (p[2k] + p[2k+1] + 1) >> 1
* 2x down, cosited: FILT_1_2_1 with the reference's FILT_3_1 head and
  FILT_1_3 tail

Inputs must already be a signed integer type wide enough for the sums
(int16 or wider): torch's uint8 arithmetic wraps.
"""

from __future__ import annotations

from .. import _xp
from .._xp import take as _take


def up2_phases(xp, c, axis, cosited: bool):
    """2x chroma upsample WITHOUT interleaving: returns (even, odd) phase
    arrays such that full[2k] = even[k], full[2k+1] = odd[k]."""
    nc = c.shape[axis]
    cn = _take(_xp.pad_edge(xp, c, axis, 0, 1), axis, 1, nc + 1)   # c[k+1]
    if cosited:
        return c, (c + cn + 1) >> 1
    cp = _take(_xp.pad_edge(xp, c, axis, 1, 0), axis, 0, nc)       # c[k-1]
    return (cp + 3 * c + 2) >> 2, (3 * c + cn + 2) >> 2


def down2(xp, plane, axis, cosited: bool):
    """2x chroma downsample along axis; output written back at duplicated
    full resolution (pack then selects the even samples)."""
    n = plane.shape[axis]
    if cosited:
        p_prev = _take(_xp.pad_edge(xp, plane, axis, 1, 0), axis, 0, n)
        p_next = _take(_xp.pad_edge(xp, plane, axis, 0, 1), axis, 1, n + 1)
        res = (p_prev + 2 * plane + p_next + 2) >> 2
        c = _take(res, axis, 0, None, 2)
        nc = c.shape[axis]
        # c[0]: FILT_3_1(p0, p1); last chroma group: FILT_1_3(p[ie-1], p[ie])
        first = (3 * _take(plane, axis, 0, 1) + _take(plane, axis, 1, 2)
                 + 2) >> 2
        ie = 2 * (nc - 1)
        last = (_take(plane, axis, ie - 1, ie)
                + 3 * _take(plane, axis, ie, ie + 1) + 2) >> 2
        mid = _take(c, axis, 1, nc - 1)
        c = _xp.cat(xp, [first, mid, last], axis)
    else:
        a = _take(plane, axis, 0, None, 2)
        b = _take(_xp.pad_edge(xp, plane, axis, 0, 1), axis, 1, n + 1, 2)
        if b.shape[axis] > a.shape[axis]:
            b = _take(b, axis, 0, a.shape[axis])
        c = (a + b + 1) >> 1
    out = _xp.repeat(xp, c, 2, axis)
    return _take(out, axis, 0, n)
