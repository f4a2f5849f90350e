"""Alpha blends with the reference's exact integer math, in torch.

A port of the JAX package's ``ops/blend.py`` (reference:
subprojects/gst-plugins-base/gst/compositor/):

* compositororc.orc compositor_orc_blend_u8 :20 —
    d = clamp_u8((d<<8 + (s-d)*alpha) >> 8)        (alpha in [0..256])
* compositor_orc_overlay_argb :295 — per-pixel source alpha OVER:
    a_s = div255(a_pix * a_pad);  s' = s * a_s
    a_d = div255(a_dst * (255 - a_s));  d' = d * a_d
    out = divluw(s' + d', a_s + a_d);  out_alpha = a_s + a_d
* div255w emulation (compositororc-dist.c:1959): (x * 0x8081) >> 23
* divluw emulation (:3345): b==0 ? 255 : clamp_u8(a / b)

Every function takes int32 tensors and computes in int32, as the reference
does under jit; the canonical arrays are (..., 4) int32 (A, c0, c1, c2).
Plain torch, like the reference's plain XLA: there is no Pallas kernel
here.  ``//`` on these tensors is floor division, which equals the ORC
truncating division because every dividend is non-negative.
"""

from __future__ import annotations

import torch


def div255w(x):
    """Exact ORC div255w: (x * 0x8081) >> 23 for x in [0, 65535]."""
    return (x * 0x8081) >> 23


def blend_plane(dst, src, alpha_256: int):
    """compositor_orc_blend_u8: alpha_256 = pad alpha mapped to [0..256].
    dst/src int32 planes of equal shape."""
    t = ((dst << 8) + (src - dst) * alpha_256) >> 8
    return torch.clamp(t, 0, 255)


def _with_alpha(out, a):
    """`out` with its alpha lane replaced by `a` (a new tensor: the
    reference writes the lane in place, ``out.at[..., 0].set``)."""
    return torch.cat((a.unsqueeze(-1), out[..., 1:]), dim=-1)


def _over(dst, src, a_s):
    """The colour lanes shared by OVER and ADD: divluw(s*a_s + d*a_d,
    a_s + a_d) with a_d = div255(a_dst * (255 - a_s)); returns (out, a_s +
    a_d), both in 16-bit and 8-bit ORC wraparound."""
    s_wide = src * a_s.unsqueeze(-1)
    a_d = div255w((dst[..., 0] * (255 - a_s)) & 0xFFFF)
    d_wide = dst * a_d.unsqueeze(-1)
    acc = (s_wide + d_wide) & 0xFFFF
    a_out = (a_s + a_d) & 0xFF
    # acc and a_out are non-negative: floor division is ORC's division
    quotient = torch.clamp(acc // torch.clamp(a_out, min=1).unsqueeze(-1),
                           0, 255)
    return torch.where(a_out.unsqueeze(-1) == 0, 255, quotient), a_out


def overlay_argb(dst, src, alpha_256: int):
    """compositor_orc_overlay_argb (OVER operator, per-pixel alpha).

    dst/src: (..., 4) int32 canonical (A, c0, c1, c2).  alpha_256 is the
    pad alpha in [0..256] (the ORC param `alpha`)."""
    a_s = div255w((src[..., 0] * alpha_256) & 0xFFFF)
    out, a_out = _over(dst, src, a_s)
    return _with_alpha(out, a_out)


def overlay_argb_addition(dst, src, alpha_256: int):
    """compositor_orc_overlay_argb_addition (ADD operator): like OVER but
    the output alpha accumulates: a_factor = div255(a_pix*alpha),
    a_dst' = clamp(a_dst + a_factor)."""
    a_s = div255w((src[..., 0] * alpha_256) & 0xFFFF)
    out, _ = _over(dst, src, a_s)
    return _with_alpha(out, torch.clamp(dst[..., 0] + a_s, 0, 255))


def source_plane(dst, src, alpha_256: int):
    """SOURCE operator: plain replacement."""
    return src
