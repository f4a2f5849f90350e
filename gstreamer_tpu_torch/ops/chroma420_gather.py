"""2-tap 4:2:0 chroma upsample + scale as static gathers (plain torch).

Port of the JAX package's ``ops/chroma420_gather.py``, which is XLA there
(no Pallas kernel), so it stays plain PyTorch here.  For 2-tap scalers every
output sample reads two consecutive full-res samples, one even-phase and one
odd-phase, so the up2 filters are evaluated only at the gathered columns and
rows, then weighted and rounded per pass:

    raw u8 plane -> gathered column phases -> vertical up2 phases
    -> h weighted sum + (acc+4095)>>12 -> row gathers + v sum + rounding

Bit-exact to up2_phases -> scale_cols_split_exact -> scale_rows_split_exact.
"""

from __future__ import annotations

import numpy as np

from .. import _xp
from ..video import chroma as chroma_mod


def _split_2tap(res):
    """Per-output (even_idx, odd_idx, even_tap, odd_tap): a 2-tap filter
    reads full-res samples o and o+1 — one even, one odd."""
    o = res.offset
    t = res.taps_s16()
    ie = np.where(o % 2 == 0, o // 2, (o + 1) // 2).astype(np.int64)
    io = np.where(o % 2 == 0, o // 2, (o - 1) // 2).astype(np.int64)
    te = np.where(o % 2 == 0, t[:, 0], t[:, 1]).astype(np.int32)
    to = np.where(o % 2 == 0, t[:, 1], t[:, 0]).astype(np.int32)
    return ie, io, te, to


def applicable(h_res, v_res, cw: int, ch: int) -> bool:
    return (h_res is not None and v_res is not None
            and h_res.max_taps == 2 and v_res.max_taps == 2
            and h_res.out_size <= 2 * cw and v_res.out_size <= 2 * ch)


def chroma420_scale_2tap(xp, c, h_res, v_res, h_cosited: bool,
                         v_cosited: bool):
    """c: (..., ch, cw) uint8 half-res chroma -> (..., OH, OW) int32."""
    ice, ico, tce, tco = _split_2tap(h_res)
    ire, iro, tre, tro = _split_2tap(v_res)
    cw = c.shape[-1]

    def ix(i):
        return _xp.index(xp, i, c)

    ci = _xp.astype(xp, c, "int16")      # before any arithmetic: u8 wraps
    if h_cosited:
        ceg = ci[..., ix(ice)]
        cog = (ci[..., ix(ico)] + ci[..., ix(np.minimum(ico + 1, cw - 1))]
               + 1) >> 1
    else:
        ceg = (ci[..., ix(np.maximum(ice - 1, 0))] + 3 * ci[..., ix(ice)]
               + 2) >> 2
        cog = (3 * ci[..., ix(ico)] + ci[..., ix(np.minimum(ico + 1, cw - 1))]
               + 2) >> 2

    ceg_re, ceg_ro = chroma_mod.up2_phases(xp, ceg, -2, v_cosited)
    cog_re, cog_ro = chroma_mod.up2_phases(xp, cog, -2, v_cosited)

    tce = _xp.const(xp, tce, "int32", c)
    tco = _xp.const(xp, tco, "int32", c)

    def hsum(a, b):
        acc = (tce * _xp.astype(xp, a, "int32")
               + tco * _xp.astype(xp, b, "int32"))
        return _xp.astype(xp, _xp.clip(xp, (acc + 4095) >> 12, 0, 255),
                          "int16")

    h_re = hsum(ceg_re, cog_re)
    h_ro = hsum(ceg_ro, cog_ro)

    vre = _xp.astype(xp, h_re[..., ix(ire), :], "int32")
    vro = _xp.astype(xp, h_ro[..., ix(iro), :], "int32")
    acc = (_xp.const(xp, tre[:, None], "int32", c) * vre
           + _xp.const(xp, tro[:, None], "int32", c) * vro)
    return _xp.clip(xp, (acc + 4095) >> 12, 0, 255)
