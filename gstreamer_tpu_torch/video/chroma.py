"""Chroma up/down-sampling with the reference's exact integer filters.

Port of the JAX package's ``video/chroma.py`` (GstVideoChromaResample,
video-chroma.c MAKE_UPSAMPLE_H2 :277, _V2 :309, _VI2 :345, the cosited
variants and the downsamplers :396; vertical line grouping from
video-converter.c do_upsample_lines with v_resamplers offsets
video-chroma.c:995):

* 2x up, cosited: even = c[k], odd = (c[k] + c[k+1] + 1) >> 1
* 2x up, interstitial: even = (c[k-1] + 3*c[k] + 2) >> 2,
  odd = (3*c[k] + c[k+1] + 2) >> 2, edges clamped
* 2x down, interstitial: c[k] = (p[2k] + p[2k+1] + 1) >> 1
* 2x down, cosited: FILT_1_2_1 with the reference's FILT_3_1 head and
  FILT_1_3 tail
* 4x variants: FILT_7_1/5_3/3_5/1_7 up, FILT_1_3_3_1 down
* interlaced 2x vertical: 4-line field groups up, row selection down

``up2``, ``up4``, ``down2``, ``down4`` and the interlaced pair take and
return the full-resolution nearest-duplicated plane that ``unpack_planes``
produces; ``up2_half`` and ``up2_phases`` take the stored samples.

Inputs must already be a signed integer type wide enough for the sums
(int16 or wider): torch's uint8 arithmetic wraps.
"""

from __future__ import annotations

import numpy as np

from .. import _xp
from .._xp import take as _take


def _interleave(xp, parts, axis):
    """Interleave equally-shaped arrays along axis: a0 b0 a1 b1 ..."""
    ax = axis if axis >= 0 else parts[0].ndim + axis
    shape = list(parts[0].shape)
    shape[ax] *= len(parts)
    return _xp.stack(xp, parts, ax + 1).reshape(shape)


def up2_phases(xp, c, axis, cosited: bool):
    """2x chroma upsample of the stored samples `c` WITHOUT interleaving:
    returns (even, odd) phase arrays such that full[2k] = even[k],
    full[2k+1] = odd[k]."""
    nc = c.shape[axis]
    cn = _take(_xp.pad_edge(xp, c, axis, 0, 1), axis, 1, nc + 1)   # c[k+1]
    if cosited:
        # the last odd sample: the edge pad gives (c+c+1)>>1 = c, the
        # untouched trailing duplicate of the reference loop (i < width-1)
        return c, (c + cn + 1) >> 1
    cp = _take(_xp.pad_edge(xp, c, axis, 1, 0), axis, 0, nc)       # c[k-1]
    return (cp + 3 * c + 2) >> 2, (3 * c + cn + 2) >> 2


def up2(xp, plane, axis, cosited: bool):
    """2x chroma upsample along `axis` of a nearest-duplicated plane
    (plane[2k] == plane[2k+1] == c[k], except a trailing odd sample)."""
    n = plane.shape[axis]
    c = _take(plane, axis, 0, None, 2)          # the true chroma samples
    out = _interleave(xp, up2_phases(xp, c, axis, cosited), axis)
    return _take(out, axis, 0, n)


def up2_half(xp, c, axis, cosited: bool, out_size: int):
    """2x chroma upsample directly from the stored samples `c` (the
    arithmetic of up2, which extracts c = plane[::2] first)."""
    out = _interleave(xp, up2_phases(xp, c, axis, cosited), axis)
    n = out.shape[axis]
    if out_size < n:
        out = _take(out, axis, 0, out_size)
    elif out_size > n:   # odd full size: trailing sample = duplicate
        out = _xp.cat(xp, [out, _take(out, axis, n - 1, n)], axis)
    return out


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


def up4(xp, plane, axis, cosited: bool):
    """4x chroma upsample (Y41B, YUV9).  Interstitial:
    FILT_7_1/5_3/3_5/1_7."""
    n = plane.shape[axis]
    ax = axis if axis >= 0 else plane.ndim + axis
    c = _take(plane, ax, 0, None, 4)
    nc = c.shape[ax]
    cn = _take(_xp.pad_edge(xp, c, ax, 0, 1), ax, 1, nc + 1)       # c[k+1]
    if cosited:
        out = _interleave(xp, [c, (3 * c + cn + 2) >> 2, (c + cn + 1) >> 1,
                               (c + 3 * cn + 2) >> 2], ax)
        return _take(out, ax, 0, n)
    # the reference loop (MAKE_UPSAMPLE_H4, i from 2 step 4) writes
    # p[4m+2..4m+5] from a = c[m], b = c[m+1]; positions 0, 1 keep c[0]
    tail = _interleave(xp, [(7 * c + cn + 4) >> 3, (5 * c + 3 * cn + 4) >> 3,
                            (3 * c + 5 * cn + 4) >> 3, (c + 7 * cn + 4) >> 3],
                       ax)
    out = _xp.cat(xp, [_take(plane, ax, 0, 2), tail], ax)
    return _take(out, ax, 0, n)


def down4(xp, plane, axis, cosited: bool):
    """4x chroma downsample: FILT_1_3_3_1 over each group of 4 (the
    reference has one filter for both sitings)."""
    del cosited
    n = plane.shape[axis]
    ax = axis if axis >= 0 else plane.ndim + axis
    m = (n // 4) * 4
    p0, p1, p2, p3 = (_take(plane, ax, i, m, 4) for i in range(4))
    c = (p0 + 3 * (p1 + p2) + p3 + 4) >> 3
    out = _xp.repeat(xp, c, 4, ax)
    if m < n:   # tail samples keep their values
        out = _xp.cat(xp, [out, _take(plane, ax, m, n)], ax)
    return out


def _take_rows(xp, plane, ax: int, rows: np.ndarray):
    sl = [slice(None)] * plane.ndim
    sl[ax] = _xp.index(xp, rows, plane)
    return plane[tuple(sl)]


def down2_interlaced(xp, plane, axis, cosited: bool):
    """2x vertical chroma downsample for interlaced content; output at
    duplicated full resolution, like down2.

    The vertical filter is a passthrough stub in the reference
    (video-chroma.c MAKE_DOWNSAMPLE_VI2 :461, dispatch n_lines=1 :1018), so
    the row selection is the 4:2:0 pack's: IS_CHROMA_LINE_420 interlaced is
    !(y & 2) and the target row is GET_UV_420(y) (video-format.c :71,:80).
    Chroma row c comes from full row (c & ~1) * 2 + (c & 1): rows
    0, 1, 4, 5, 8, 9, ...  Rows 2c and 2c+1 of the result both hold it, so
    pack's every-other-row selection stores exactly those rows."""
    del cosited  # both variants hit the same stub in the reference
    ax = axis if axis >= 0 else plane.ndim + axis
    n = plane.shape[ax]
    cs = np.arange(n) // 2
    rows = np.minimum((cs & ~1) * 2 + (cs & 1), n - 1)
    return _take_rows(xp, plane, ax, rows)


def up2_interlaced(xp, plane, axis, cosited: bool):
    """2x vertical chroma upsample for interlaced content (video-chroma.c
    MAKE_UPSAMPLE_VI2 :345, line groups of 4 at offset -2 per
    v_resamplers[] :1017).

    `plane` is the nearest-duplicated full-resolution plane whose chroma
    lines alternate fields.  Each group of 4 lines (4g-2 .. 4g+1, edges
    clamped) maps to
        l0' = (5*l0 + 3*l2 + 4) >> 3      l1' = (7*l1 + l3 + 4) >> 3
        l2' = (l0 + 7*l2 + 4) >> 3        l3' = (3*l1 + 5*l3 + 4) >> 3
    The cosited interlaced variants are unimplemented in the reference
    (:1021) and pass the plane through.

    Evaluated as two row gathers: output line r in group position k takes
    (wa*plane[ia] + wb*plane[ib] + 4) >> 3 with the pair and weights of k."""
    if cosited:
        return plane
    ax = axis if axis >= 0 else plane.ndim + axis
    n = plane.shape[ax]
    r = np.arange(n)
    s = ((r + 2) // 4) * 4 - 2                   # first line of r's group
    k = r - s
    ia = np.clip(s + (k & 1), 0, n - 1)          # l0 for k = 0, 2; l1 else
    ib = np.clip(s + (k & 1) + 2, 0, n - 1)      # l2 for k = 0, 2; l3 else
    wa = np.array([5, 7, 1, 3])[k]
    shape = [1] * plane.ndim
    shape[ax] = n
    dt = str(plane.dtype).replace("torch.", "")
    wa_c = _xp.const(xp, wa.reshape(shape), dt, plane)
    wb_c = _xp.const(xp, (8 - wa).reshape(shape), dt, plane)
    return (wa_c * _take_rows(xp, plane, ax, ia)
            + wb_c * _take_rows(xp, plane, ax, ib) + 4) >> 3
