"""Video dithering: port of GstVideoDither over channel planes.

Counterpart of the JAX package's ``video/dither.py`` (video-dither.c: none
:58, verterr :76, floyd-steinberg :116, sierra-lite :183, ordered Bayer
16x16 bayer_map :234 + setup_bayer :296, quantizer -> shift/mask
gst_video_dither_new :377; ORC kernels video-orc.orc:2843-2935: andn
quantize, saturated adds).

* none / ordered: elementwise over the whole (batched) frame; the Bayer
  threshold plane is a host constant tiled from the 16x16 map.
* verterr: errors propagate down columns only: a loop over rows that
  carries the error row, the full width vectorized.
* floyd-steinberg / sierra-lite: the error feeds the next pixel of the
  same row (strictly sequential in x and y), so they are evaluated in
  numpy on the host; a tensor makes the round trip and comes back on its
  device.  The reference does the same (video-orc.orc:2885 notes that the
  error propagation defeats vectorization).

Operates on canonical channel planes (A, c0, c1, c2) like the rest of the
converter; the reference's packed AYUV line layout maps to per-component
masks (mask index (i+3)&3 per gst_video_dither_new:487: component 0 is
alpha in packed AYUV, whose quantizer arrives last).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _xp

# video-dither.c:234 — exact table (note the reference's asymmetries,
# e.g. rows 4/12 containing 240..254: kept verbatim)
BAYER_MAP = np.array([
    [0, 128, 32, 160, 8, 136, 40, 168, 2, 130, 34, 162, 10, 138, 42, 170],
    [192, 64, 224, 96, 200, 72, 232, 104, 194, 66, 226, 98, 202, 74, 234, 106],
    [48, 176, 16, 144, 56, 184, 24, 152, 50, 178, 18, 146, 58, 186, 26, 154],
    [240, 112, 208, 80, 248, 120, 216, 88, 242, 114, 210, 82, 250, 122, 218, 90],
    [12, 240, 44, 172, 4, 132, 36, 164, 14, 242, 46, 174, 6, 134, 38, 166],
    [204, 76, 236, 108, 196, 68, 228, 100, 206, 78, 238, 110, 198, 70, 230, 102],
    [60, 188, 28, 156, 52, 180, 20, 148, 62, 190, 30, 158, 54, 182, 22, 150],
    [252, 142, 220, 92, 244, 116, 212, 84, 254, 144, 222, 94, 246, 118, 214, 86],
    [3, 131, 35, 163, 11, 139, 43, 171, 1, 129, 33, 161, 9, 137, 41, 169],
    [195, 67, 227, 99, 203, 75, 235, 107, 193, 65, 225, 97, 201, 73, 233, 105],
    [51, 179, 19, 147, 59, 187, 27, 155, 49, 177, 17, 145, 57, 185, 25, 153],
    [243, 115, 211, 83, 251, 123, 219, 91, 241, 113, 209, 81, 249, 121, 217, 89],
    [15, 243, 47, 175, 7, 135, 39, 167, 13, 241, 45, 173, 5, 133, 37, 165],
    [207, 79, 239, 111, 199, 71, 231, 103, 205, 77, 237, 109, 197, 69, 229, 101],
    [63, 191, 31, 159, 55, 183, 23, 151, 61, 189, 29, 157, 53, 181, 21, 149],
    [255, 145, 223, 95, 247, 119, 215, 87, 253, 143, 221, 93, 245, 117, 213, 85],
], dtype=np.int64)


def _count_power(v: int) -> int:
    res = 0
    while v > 1:
        res += 1
        v >>= 1
    return res


class VideoDither:
    """gst_video_dither_new equivalent over channel planes.

    quantizer: 4 per-component quantizers in canonical order
    (A, c0, c1, c2) — matching the GstVideoConverter quant[] array."""

    def __init__(self, method: str, quantize_flag: bool, bits: int,
                 quantizer: Sequence[int]):
        self.method = method
        self.flags_quantize = quantize_flag
        self.bits = bits          # 8 (AYUV/ARGB) or 16 (AYUV64/ARGB64)
        # gst_video_dither_new:487 — q = quantizer[(i+3)&3] maps the
        # packed component i to the converter's quant order; in the
        # canonical tuple component 0 is alpha already, so shifts align.
        self.shift = [_count_power(max(int(q), 0) or 1) if q else 0
                      for q in quantizer]
        self.mask = [(1 << s) - 1 for s in self.shift]
        self.maxv = 255 if bits == 8 else 65535

    # -- pattern plane ----------------------------------------------------
    def _bayer_plane(self, comp: int, height: int, width: int) -> np.ndarray:
        v = BAYER_MAP[np.arange(height)[:, None] % 16,
                      np.arange(width)[None, :] % 16]
        s = self.shift[comp]
        if s < 8:
            v = v >> (8 - s)
        return v

    # -- application ------------------------------------------------------
    def apply(self, xp, chans: Tuple, height: int, width: int):
        """Apply dither+quantize to channel planes (values in the frame's
        unpack domain).  Returns a new channel tuple."""
        m = self.method
        if m == "none":
            if not self.flags_quantize:
                return chans
            return tuple(
                c if c is None else _xp.astype(xp, c, "int32") & ~self.mask[i]
                for i, c in enumerate(chans))
        if m in ("bayer", "ordered"):
            return self._apply_ordered(xp, chans, height, width)
        if m == "verterr":
            return self._apply_verterr(xp, chans)
        if m in ("floyd-steinberg", "sierra-lite"):
            return self._apply_serial(xp, chans)
        raise ValueError(f"unknown dither method {m!r}")

    def _apply_ordered(self, xp, chans, height, width):
        outs = []
        for i, c in enumerate(chans):
            if c is None:
                outs.append(None)
                continue
            mask = self.mask[i]
            v = _xp.astype(xp, c, "int32")
            t = v + _xp.const(xp, self._bayer_plane(i, height, width),
                              "int32", v)
            if self.bits == 8 and not self.flags_quantize:
                # video_orc_dither_ordered_u8: saturated byte add, no mask
                outs.append(_xp.clip(xp, t, None, 255))
            elif self.bits == 8:
                # ordered_4u8_mask: (p + e) & ~m, unsigned-saturate to u8
                outs.append(_xp.clip(xp, t & ~mask, 0, 255))
            else:
                # ordered_4u16_mask: addusw (saturated u16 add) then andn
                outs.append(_xp.clip(xp, t, None, 65535) & ~mask)
        return tuple(outs)

    def _apply_verterr(self, xp, chans):
        outs = []
        for i, c in enumerate(chans):
            if c is None:
                outs.append(None)
                continue
            mask = self.mask[i]
            v32 = _xp.astype(xp, c, "int32")
            e = 0
            rows = []
            for r in range(v32.shape[-2]):
                v = v32[..., r, :] + e
                e = v & mask
                rows.append(_xp.clip(xp, v & ~mask, None, self.maxv))
            out = _xp.stack(xp, rows, -2)
            outs.append(out.astype(c.dtype) if xp is np else out.to(c.dtype))
        return tuple(outs)

    def _apply_serial(self, xp, chans):
        """floyd-steinberg / sierra-lite: strictly sequential error
        propagation (video-dither.c:116,:183), evaluated in numpy on the
        host."""
        fs = self.method == "floyd-steinberg"
        outs = []
        for ci, c in enumerate(chans):
            if c is None:
                outs.append(None)
                continue
            mask = self.mask[ci]
            host = np.asarray(c) if xp is np else c.cpu().numpy()
            arr = host.astype(np.int64)
            flat = arr.reshape((-1,) + arr.shape[-2:])
            for b in range(flat.shape[0]):
                p = flat[b]
                h, w = p.shape
                if fs and self.bits == 8:
                    # u8 variant: previous-line errors merged by
                    # fs_muladd (e[j] += 5*e[j+1px] + 3*e[j+2px], u16
                    # wrap, forward reads see original values), then
                    # v = p + (7*e[j] + e[j+1px]) >> 4
                    e = np.zeros(w + 8, np.int64)   # alloc_errors w+8
                    for y in range(h):
                        em = e.copy()
                        em[:w] = (e[:w] + 5 * e[1:w + 1]
                                  + 3 * e[2:w + 2]) & 0xFFFF
                        for j in range(w):
                            v = p[y, j] + ((7 * em[j] + em[j + 1]) >> 4)
                            em[j + 1] = v & mask
                            p[y, j] = min(v & ~mask, 255)
                        e = em
                elif fs:
                    # u16 variant: 4-tap (7,1,5,3)>>4 over the running
                    # error line
                    e = np.zeros(w + 4, np.int64)
                    for y in range(h):
                        for j in range(w):
                            v = p[y, j] + ((7 * e[j] + e[j + 1]
                                            + 5 * e[j + 2] + 3 * e[j + 3])
                                           >> 4)
                            e[j + 1] = v & mask
                            p[y, j] = min(v & ~mask, 65535)
                else:
                    # sierra-lite: v = p + (2*e[i] + e[i+2px] + e[i+3px])>>2
                    e = np.zeros(w + 4, np.int64)
                    for y in range(h):
                        for j in range(w):
                            v = p[y, j] + ((2 * e[j] + e[j + 2] + e[j + 3])
                                           >> 2)
                            e[j + 1] = v & mask
                            p[y, j] = min(v & ~mask, self.maxv)
            out = flat.reshape(arr.shape).astype(host.dtype)
            outs.append(out if xp is np
                        else torch.as_tensor(out, device=c.device))
        return tuple(outs)


def make_converter_dither(method: str, target_quant: int, out_finfo,
                          pack_bits: int) -> Optional[VideoDither]:
    """chain_dither (video-converter.c:2034): build the quant[] array
    from output component depths; None when no dithering is needed."""
    if method == "none":
        return None
    quant = []
    flags_quantize = False
    do_dither = False
    # canonical component order (A, c0, c1, c2): depths from the output
    # format; alpha depth = container bits when present else 0
    depths = [out_finfo.depth[out_finfo.n_components - 1]
              if out_finfo.has_alpha else 0]
    depths += [out_finfo.depth[i] if i < out_finfo.n_components else 0
               for i in range(3)]
    for depth in depths:
        if depth == 0:
            quant.append(0)
            continue
        if pack_bits >= depth:
            q = 1 << (pack_bits - depth)
            if target_quant > q:
                flags_quantize = True
                q = target_quant
        else:
            q = 0
        quant.append(q)
        if q > 1:
            do_dither = True
    if not do_dither:
        return None
    return VideoDither(method, flags_quantize, pack_bits, quant)
