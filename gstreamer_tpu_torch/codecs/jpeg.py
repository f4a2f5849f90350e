"""Baseline JPEG (ITU-T T.81 / JFIF), self-implemented, on torch.

The JAX package's ``codecs/jpeg.py`` with its transform stages rewritten on
torch: level shift, 8x8 DCT-II / IDCT (``A @ X @ A.T`` over all blocks) and
quantization run on the caller's device; the sequential entropy coding
(Huffman + DC prediction + byte stuffing, restart markers on decode) runs on
the host, natively (``native/jpeg.py``) or in the Python coder kept as its
gold.  The tables, the quality scaling, the marker parsing and both entropy
coders are copies.  Covers baseline sequential, 8-bit, YCbCr 4:2:0 and 4:4:4
and greyscale, standard Annex K Huffman tables.

Precision: every JAX launch string imports the audio stack, which turns x64
on, so the reference's products run in float64 (its float32 level shift or
dequantisation promoted against the float64 DCT matrix).  XLA's CPU dot sums
each output's eight products in order with one rounding per step; a torch
matmul sums in another order (and may fuse a multiply and an add), and a
float64 result that lands on a rounding tie (a flat block at quality 50 is
one) then rounds the other way.  So ``_products`` spells the two products
out as elementwise multiplies and adds in that order: the same bits as the
reference on the CPU, and on the card the same bits as on the CPU.

Capability row: gst-plugins-good/ext/jpeg (gstjpegenc.c/gstjpegdec.c
wrap libjpeg; this is a native reimplementation).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve
from ..native import jpeg as njpeg

# ---------------------------------------------------------------------------
# tables (ITU-T T.81 Annex K)
# ---------------------------------------------------------------------------

STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int32)

STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int32)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)
UNZIGZAG = np.argsort(ZIGZAG)

# Annex K Huffman specs: (bits[1..16], values)
DC_LUMA_SPEC = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
                list(range(12)))
DC_CHROMA_SPEC = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                  list(range(12)))
AC_LUMA_SPEC = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
     0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
     0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
     0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
     0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
     0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
     0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
     0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
     0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
     0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
     0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
     0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA_SPEC = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
     0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
     0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
     0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
     0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
     0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
     0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
     0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
     0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
     0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
     0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
     0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _huff_codes(spec) -> Dict[int, Tuple[int, int]]:
    """value -> (code, length) per T.81 C.2."""
    bits, vals = spec
    out = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg jpeg_quality_scaling (jcparam.c)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    lq = np.clip((STD_LUMA_Q * scale + 50) // 100, 1, 255)
    cq = np.clip((STD_CHROMA_Q * scale + 50) // 100, 1, 255)
    return lq.astype(np.int32), cq.astype(np.int32)


def dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix A: coeffs = A @ X @ A.T."""
    k = np.arange(8)
    a = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    a *= np.sqrt(2.0 / 8)
    a[0] *= np.sqrt(0.5)
    return a


_A = dct_matrix()


def _products(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """``left @ right`` over the last two axes (8x8 each, either side
    broadcast over the blocks), each output the sum of its eight products
    in order with one rounding per step: XLA's CPU dot (module
    docstring)."""
    acc = left[..., :, 0:1] * right[..., 0:1, :]
    for k in range(1, left.shape[-1]):
        acc += left[..., :, k:k + 1] * right[..., k:k + 1, :]
    return acc


def _fdct(blocks: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """blocks (N,8,8) uint8 -> quantized int32 coeffs: float32 level
    shift, float64 ``A @ X @ A.T``, division by the float32 table,
    round half to even."""
    a = torch.as_tensor(_A, device=blocks.device)
    x = (blocks.to(torch.float32) - 128.0).to(torch.float64)
    c = _products(_products(a, x), a.T)
    return torch.round(c / q.to(torch.float64)).to(torch.int32)


def _idct(coeffs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """coeffs (N,8,8) int32 and their tables q (N or 1,8,8) float32 ->
    uint8 pixels: float32 dequantisation, float64 ``A.T @ C @ A``, +128,
    round half to even, clip."""
    a = torch.as_tensor(_A, device=coeffs.device)
    c = (coeffs.to(torch.float32) * q).to(torch.float64)
    x = _products(_products(a.T, c), a)
    return torch.clamp(torch.round(x + 128.0), 0, 255).to(torch.uint8)


def _to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) (multiples of 8) -> (N, 8, 8) in raster MCU order."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3) \
        .reshape(-1, 8, 8)


def _from_blocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return blocks.reshape(h // 8, w // 8, 8, 8).permute(0, 2, 1, 3) \
        .reshape(h, w)


def _pad_to(plane: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Edge-replicate to multiples (libjpeg's sample expansion)."""
    h, w = plane.shape
    rows = torch.arange(h + (-h) % mh, device=plane.device).clamp_(max=h - 1)
    cols = torch.arange(w + (-w) % mw, device=plane.device).clamp_(max=w - 1)
    return plane[rows][:, cols]


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            b = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)          # byte stuffing
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)      # pad with 1s


def _magnitude(v: int) -> Tuple[int, int]:
    """(category, offset bits) of a DC/AC value (T.81 F.1.2.1)."""
    if v == 0:
        return 0, 0
    a = abs(v)
    size = a.bit_length()
    bits = v if v > 0 else v + (1 << size) - 1
    return size, bits


def _encode_blocks(bw: _BitWriter, coeffs: np.ndarray, dc_tab, ac_tab,
                   pred: int) -> int:
    """coeffs: (N,64) zigzagged ints of one component, sequential."""
    for blk in coeffs:
        dc = int(blk[0])
        diff = dc - pred
        pred = dc
        size, bits = _magnitude(diff)
        code, length = dc_tab[size]
        bw.put(code, length)
        if size:
            bw.put(bits, size)
        run = 0
        nz = np.nonzero(blk[1:])[0]
        last = nz[-1] + 1 if nz.size else 0
        for k in range(1, last + 1):
            v = int(blk[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                code, length = ac_tab[0xF0]    # ZRL
                bw.put(code, length)
                run -= 16
            size, bits = _magnitude(v)
            code, length = ac_tab[(run << 4) | size]
            bw.put(code, length)
            bw.put(bits, size)
            run = 0
        if last < 63:
            code, length = ac_tab[0x00]        # EOB
            bw.put(code, length)
    return pred


def _dht_payload(tc: int, th: int, spec) -> bytes:
    bits, vals = spec
    return bytes([(tc << 4) | th] + bits + list(vals))


def _huff_code_arrays():
    """(codes uint16 (4,256), lens uint8 (4,256)) for the standard
    tables, order [dc_luma, ac_luma, dc_chroma, ac_chroma]."""
    codes = np.zeros((4, 256), np.uint16)
    lens = np.zeros((4, 256), np.uint8)
    for t, spec in enumerate((DC_LUMA_SPEC, AC_LUMA_SPEC,
                              DC_CHROMA_SPEC, AC_CHROMA_SPEC)):
        for sym, (code, ln) in _huff_codes(spec).items():
            codes[t, sym] = code
            lens[t, sym] = ln
    return codes, lens


def _native_encode_scan(gray: bool, subsampling: str, comps, zz):
    """Entropy-encode the scan with the native codec
    (native/gtpu_jpeg.cpp); None (no g++) -> the Python coder."""
    if not njpeg.available():
        return None
    hy, wy = comps[0][1].shape
    if gray:
        cs = [{"h": 1, "v": 1, "bw": wy // 8, "bh": hy // 8,
               "dc_idx": 0, "ac_idx": 1}]
        coef = [zz["y"]]
        mcux, mcuy = wy // 8, hy // 8
    elif subsampling == "420":
        cs = [{"h": 2, "v": 2, "bw": wy // 8, "bh": hy // 8,
               "dc_idx": 0, "ac_idx": 1},
              {"h": 1, "v": 1, "bw": wy // 16, "bh": hy // 16,
               "dc_idx": 2, "ac_idx": 3},
              {"h": 1, "v": 1, "bw": wy // 16, "bh": hy // 16,
               "dc_idx": 2, "ac_idx": 3}]
        coef = [zz["y"], zz["u"], zz["v"]]
        mcux, mcuy = wy // 16, hy // 16
    else:
        cs = [{"h": 1, "v": 1, "bw": wy // 8, "bh": hy // 8,
               "dc_idx": 0, "ac_idx": 1},
              {"h": 1, "v": 1, "bw": wy // 8, "bh": hy // 8,
               "dc_idx": 2, "ac_idx": 3},
              {"h": 1, "v": 1, "bw": wy // 8, "bh": hy // 8,
               "dc_idx": 2, "ac_idx": 3}]
        coef = [zz["y"], zz["u"], zz["v"]]
        mcux, mcuy = wy // 8, hy // 8
    codes, lens = _huff_code_arrays()
    return njpeg.encode_scan(mcux, mcuy, cs, codes, lens, coef)


def jpeg_encode(planes, width: int, height: int, quality: int = 85,
                subsampling: str = "420", device=None) -> bytes:
    """planes: (Y, U, V) uint8 full-range (Y full res; U/V subsampled for
    '420', full res for '444'), or a single (Y,) for greyscale; numpy
    arrays or tensors.  The transform runs on `device` (CUDA unless the
    caller names another; a tensor's own device when None is passed and
    the planes are tensors), the entropy coding on the host."""
    if device is None and isinstance(planes[0], torch.Tensor):
        dev = planes[0].device
    else:
        dev = resolve(device)
    lq, cq = quality_tables(quality)
    gray = len(planes) == 1

    def put(p):
        return torch.as_tensor(np.asarray(p, np.uint8)
                               if not isinstance(p, torch.Tensor) else p,
                               device=dev)
    y = put(planes[0])
    lqm = torch.as_tensor(lq.reshape(8, 8).astype(np.float32), device=dev)
    cqm = torch.as_tensor(cq.reshape(8, 8).astype(np.float32), device=dev)

    if gray:
        comps = [("y", _pad_to(y, 8, 8), lqm)]
        sof_comps = [(1, 0x11, 0)]
    elif subsampling == "420":
        ypad = _pad_to(y, 16, 16)
        u = _pad_to(put(planes[1]), ypad.shape[0] // 2, ypad.shape[1] // 2)
        v = _pad_to(put(planes[2]), ypad.shape[0] // 2, ypad.shape[1] // 2)
        comps = [("y", ypad, lqm), ("u", u, cqm), ("v", v, cqm)]
        sof_comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    else:
        ypad = _pad_to(y, 8, 8)
        u = _pad_to(put(planes[1]), 8, 8)
        v = _pad_to(put(planes[2]), 8, 8)
        comps = [("y", ypad, lqm), ("u", u, cqm), ("v", v, cqm)]
        sof_comps = [(1, 0x11, 0), (2, 0x11, 1), (3, 0x11, 1)]

    # device transform and zigzag per component, entropy coding on host
    zigzag = torch.as_tensor(ZIGZAG, dtype=torch.long, device=dev)
    zz: Dict[str, np.ndarray] = {}
    for name, plane, qm in comps:
        coeffs = _fdct(_to_blocks(plane), qm)
        zz[name] = coeffs.reshape(-1, 64)[:, zigzag].cpu().numpy()

    dc_l = _huff_codes(DC_LUMA_SPEC)
    ac_l = _huff_codes(AC_LUMA_SPEC)
    dc_c = _huff_codes(DC_CHROMA_SPEC)
    ac_c = _huff_codes(AC_CHROMA_SPEC)

    bw = _BitWriter()
    scan = _native_encode_scan(gray, subsampling, comps, zz)
    if scan is not None:
        bw.out = bytearray(scan)     # native output is already flushed
    elif gray:
        _encode_blocks(bw, zz["y"], dc_l, ac_l, 0)
        bw.flush()
    elif subsampling == "420":
        hy, wy = comps[0][1].shape
        mby, mbx = hy // 16, wy // 16
        preds = [0, 0, 0]
        for my in range(mby):
            for mx in range(mbx):
                # luma blocks of the MCU: raster order within the 16x16
                four = zz["y"].reshape(
                    hy // 8, wy // 8, 64)[2 * my:2 * my + 2,
                                          2 * mx:2 * mx + 2].reshape(4, 64)
                preds[0] = _encode_blocks(bw, four, dc_l, ac_l, preds[0])
                cu = zz["u"].reshape(hy // 16, wy // 16, 64)[my, mx][None]
                preds[1] = _encode_blocks(bw, cu, dc_c, ac_c, preds[1])
                cv = zz["v"].reshape(hy // 16, wy // 16, 64)[my, mx][None]
                preds[2] = _encode_blocks(bw, cv, dc_c, ac_c, preds[2])
        bw.flush()
    else:
        hy, wy = comps[0][1].shape
        nby, nbx = hy // 8, wy // 8
        preds = [0, 0, 0]
        for by in range(nby):
            for bx in range(nbx):
                for ci, (name, dct_, act_) in enumerate(
                        (("y", dc_l, ac_l), ("u", dc_c, ac_c),
                         ("v", dc_c, ac_c))):
                    blk = zz[name].reshape(nby, nbx, 64)[by, bx][None]
                    preds[ci] = _encode_blocks(bw, blk, dct_, act_,
                                               preds[ci])
        bw.flush()

    # -- markers ------------------------------------------------------------
    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(
            ">H", len(payload) + 2) + payload

    out = bytearray(b"\xFF\xD8")                       # SOI
    out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += seg(0xDB, b"\x00" + bytes(lq[ZIGZAG].astype(np.uint8)))
    if not gray:
        out += seg(0xDB, b"\x01" + bytes(cq[ZIGZAG].astype(np.uint8)))
    ncomp = 1 if gray else 3
    sof = struct.pack(">BHHB", 8, height, width, ncomp)
    for cid, sampling, tq in sof_comps:
        sof += bytes([cid, sampling, tq])
    out += seg(0xC0, sof)
    out += seg(0xC4, _dht_payload(0, 0, DC_LUMA_SPEC))
    out += seg(0xC4, _dht_payload(1, 0, AC_LUMA_SPEC))
    if not gray:
        out += seg(0xC4, _dht_payload(0, 1, DC_CHROMA_SPEC))
        out += seg(0xC4, _dht_payload(1, 1, AC_CHROMA_SPEC))
    sos = bytes([ncomp])
    for cid, _, tq in sof_comps:
        sos += bytes([cid, 0x00 if cid == 1 else 0x11])
    sos += bytes([0, 63, 0])
    out += seg(0xDA, sos)
    out += bw.out
    out += b"\xFF\xD9"                                 # EOI
    return bytes(out)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 24:
            if self.pos >= len(self.data):
                self.acc = (self.acc << 8) | 0
                self.nbits += 8
                continue
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.data[self.pos] if self.pos < len(self.data) \
                    else 0
                if nxt == 0x00:
                    self.pos += 1
                else:
                    # marker: rewind and feed zeros
                    self.pos -= 1
                    self.acc = (self.acc << 8) | 0
                    self.nbits += 8
                    continue
            self.acc = (self.acc << 8) | b
            self.nbits += 8

    def peek16(self) -> int:
        self._fill()
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def skip(self, n: int):
        self.nbits -= n
        self.acc &= (1 << self.nbits) - 1

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill()
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.skip(n)
        return v

    def align(self):
        self.skip(self.nbits % 8)

    def at_marker(self) -> bool:
        return (self.pos < len(self.data) - 1
                and self.data[self.pos] == 0xFF
                and self.data[self.pos + 1] != 0x00)


class _HuffDecoder:
    """16-bit lookahead table: peek 16 bits -> (value, length)."""

    def __init__(self, spec):
        self.lut_val = np.zeros(1 << 16, np.int16)
        self.lut_len = np.zeros(1 << 16, np.int8)
        code = 0
        k = 0
        bits, vals = spec
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                self.lut_val[lo:hi] = vals[k]
                self.lut_len[lo:hi] = length
                code += 1
                k += 1
            code <<= 1

    def read(self, br: _BitReader) -> int:
        key = br.peek16()
        length = int(self.lut_len[key])
        if length == 0:
            raise ValueError("jpeg: bad Huffman code")
        br.skip(length)
        return int(self.lut_val[key])


def _extend(v: int, size: int) -> int:
    if size == 0:
        return 0
    return v if v >= (1 << (size - 1)) else v - (1 << size) + 1


@dataclass
class Coded:
    """One image after the host half of the decoder: per component its
    sampling, table index and zigzag coefficients ``coef`` (blocks, 64)
    int32; the quantisation tables; whether the native coder ran."""
    comps: List[dict]
    qtabs: Dict[int, np.ndarray]
    width: int
    height: int
    native: bool


def jpeg_decode(data: bytes, device=None):
    """Returns (planes, width, height, subsampling): Y/U/V uint8 planes
    (U/V at their coded resolution) as tensors on `device` (CUDA unless
    the caller names another), suitable for the video pipeline."""
    return decode_transform([decode_entropy(data)], resolve(device))[0]


def decode_entropy(data: bytes) -> Coded:
    """The host half: markers, tables and the entropy-coded scan."""
    data = bytes(data)
    if data[:2] != b"\xFF\xD8":
        raise ValueError("not a JPEG")
    pos = 2
    qtabs: Dict[int, np.ndarray] = {}
    htabs: Dict[Tuple[int, int], _HuffDecoder] = {}
    comps: List[dict] = []
    width = height = 0
    restart = 0
    scan_comps = []
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        payload = data[pos + 4:pos + 2 + length]
        if marker == 0xDB:
            p = 0
            while p < len(payload):
                pq, tq = payload[p] >> 4, payload[p] & 0xF
                if pq:
                    raise ValueError("jpeg: 16-bit qtables unsupported")
                tab = np.frombuffer(payload[p + 1:p + 65],
                                    np.uint8).astype(np.int32)
                qtabs[tq] = tab[UNZIGZAG].reshape(8, 8)
                p += 65
        elif marker in (0xC0, 0xC1):
            prec, height, width, nc = struct.unpack(
                ">BHHB", payload[:6])
            p = 6
            for _ in range(nc):
                cid, samp, tq = payload[p], payload[p + 1], payload[p + 2]
                comps.append({"id": cid, "h": samp >> 4, "v": samp & 0xF,
                              "tq": tq})
                p += 3
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise ValueError("jpeg: only baseline/extended sequential "
                             "supported")
        elif marker == 0xC4:
            p = 0
            while p < len(payload):
                tc, th = payload[p] >> 4, payload[p] & 0xF
                bits = list(payload[p + 1:p + 17])
                n = sum(bits)
                vals = list(payload[p + 17:p + 17 + n])
                htabs[(tc, th)] = _HuffDecoder((bits, vals))
                p += 17 + n
        elif marker == 0xDD:
            restart = struct.unpack(">H", payload[:2])[0]
        elif marker == 0xDA:
            ns = payload[0]
            p = 1
            scan_comps = []
            for _ in range(ns):
                cid, tabs = payload[p], payload[p + 1]
                p += 2
                comp = next(c for c in comps if c["id"] == cid)
                comp["dc"] = htabs[(0, tabs >> 4)]
                comp["ac"] = htabs[(1, tabs & 0xF)]
                scan_comps.append(comp)
            pos = pos + 2 + length
            break
        pos += 2 + length

    if not scan_comps:
        raise ValueError("jpeg: no scan found")
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for c in comps:
        c["bw"] = mcux * c["h"]
        c["bh"] = mcuy * c["v"]
        c["coef"] = np.zeros((c["bh"] * c["bw"], 64), np.int32)
        c["pred"] = 0

    # native entropy decode (bit-identical; the Python loop is its gold,
    # run when g++ is absent)
    if njpeg.available():
        tabs: List = []
        tab_of: Dict[int, int] = {}

        def _idx(dec) -> int:
            if id(dec) not in tab_of:
                tab_of[id(dec)] = len(tabs)
                tabs.append(dec)
            return tab_of[id(dec)]

        cs = [{"h": c["h"], "v": c["v"], "bw": c["bw"], "bh": c["bh"],
               "dc_idx": _idx(c["dc"]), "ac_idx": _idx(c["ac"])}
              for c in scan_comps]
        lut_val = np.stack([t.lut_val for t in tabs])
        lut_len = np.stack([t.lut_len for t in tabs])
        res = njpeg.decode_scan(data[pos:], mcux, mcuy, restart, cs,
                                (lut_val, lut_len))
        for c, coefs in zip(scan_comps, res):
            c["coef"] = coefs
        return Coded(comps, qtabs, width, height, native=True)

    br = _BitReader(data[pos:])
    mcu_count = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and mcu_count and mcu_count % restart == 0:
                br.align()
                if br.at_marker():
                    br.pos += 2                 # RSTn
                # drop the zero bytes the reader fed in front of the
                # marker, as the native coder does (the reference's Python
                # coder keeps them and misreads the next interval:
                # ROADMAP.md section 3)
                br.acc = br.nbits = 0
                for c in scan_comps:
                    c["pred"] = 0
            for c in scan_comps:
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        blk = np.zeros(64, np.int32)
                        size = c["dc"].read(br)
                        diff = _extend(br.get(size), size)
                        c["pred"] += diff
                        blk[0] = c["pred"]
                        k = 1
                        while k < 64:
                            rs = c["ac"].read(br)
                            r, s = rs >> 4, rs & 0xF
                            if s == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                break           # EOB
                            k += r
                            if k > 63:
                                break
                            blk[k] = _extend(br.get(s), s)
                            k += 1
                        row = my * c["v"] + by
                        col = mx * c["h"] + bx
                        c["coef"][row * c["bw"] + col] = blk
            mcu_count += 1

    return Coded(comps, qtabs, width, height, native=False)


def decode_transform(coded: List[Coded], device: torch.device):
    """The device half for a list of images at once: every block of every
    image and component goes through ONE dequantisation + IDCT call
    (blocks are independent, so the bytes are those of one call an
    image); then each plane is assembled and cropped.  Returns a list of
    (planes, width, height, subsampling), planes uint8 tensors on
    `device`."""
    coefs, tables, counts = [], [], []
    for img in coded:
        for c in img.comps:
            coefs.append(c["coef"])
            tables.append(img.qtabs[c["tq"]])
            counts.append(c["coef"].shape[0])
    if device.type == "cuda":
        # gathered into a page-locked buffer (torch's host cache) and
        # copied without blocking: a pageable copy runs at a fraction of
        # the link's rate
        host = torch.empty((sum(counts), 64), dtype=torch.int32,
                           pin_memory=True)
        np.concatenate(coefs, out=host.numpy())
        zz = host.to(device, non_blocking=True)
    else:
        zz = torch.from_numpy(np.concatenate(coefs))
    unzigzag = torch.as_tensor(UNZIGZAG, dtype=torch.long, device=device)
    q = torch.as_tensor(np.stack(tables).astype(np.float32), device=device)
    which = torch.repeat_interleave(
        torch.arange(len(counts), device=device),
        torch.as_tensor(counts, device=device), output_size=sum(counts))
    pix = _idct(zz[:, unzigzag].reshape(-1, 8, 8), q[which])
    out, off = [], 0
    for img in coded:
        hmax = max(c["h"] for c in img.comps)
        vmax = max(c["v"] for c in img.comps)
        planes = []
        for c in img.comps:
            n = c["coef"].shape[0]
            plane = _from_blocks(pix[off:off + n], c["bh"] * 8, c["bw"] * 8)
            off += n
            cw = -(-img.width * c["h"] // hmax)
            ch = -(-img.height * c["v"] // vmax)
            planes.append(plane[:ch, :cw])
        sub = "gray" if len(img.comps) == 1 else (
            "420" if img.comps[0]["h"] == 2 and img.comps[0]["v"] == 2
            else "444")
        out.append((tuple(planes), img.width, img.height, sub))
    return out
