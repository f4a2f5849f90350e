"""Clean-room QR code encoder (ISO/IEC 18004), byte mode, versions
1-10, all four EC levels, full 8-mask penalty selection.  Host numpy: a
copy of the JAX package's ``ops/qrencode.py``.

The reference qroverlay (gst-plugins-bad/ext/qroverlay/gstqroverlay.c)
wraps libqrencode; this is a native implementation of the published
standard: Reed-Solomon over GF(2^8)/0x11D, block interleaving per the
ISO capacity tables, BCH(15,5) format info and the v7+ version info
Golay blocks.  The JAX package's copy is validated against
cv2.QRCodeDetector (tests/test_pixbuf_overlay.py); this one is held to
it module for module (tests/test_torch_overlay.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# (ec codewords per block, [(nblocks, data codewords per block), ...])
# per version 1..10, levels L M Q H — ISO 18004 table 9 (normative)
_BLOCKS = {
    1: {"L": (7, [(1, 19)]), "M": (10, [(1, 16)]),
        "Q": (13, [(1, 13)]), "H": (17, [(1, 9)])},
    2: {"L": (10, [(1, 34)]), "M": (16, [(1, 28)]),
        "Q": (22, [(1, 22)]), "H": (28, [(1, 16)])},
    3: {"L": (15, [(1, 55)]), "M": (26, [(1, 44)]),
        "Q": (18, [(2, 17)]), "H": (22, [(2, 13)])},
    4: {"L": (20, [(1, 80)]), "M": (18, [(2, 32)]),
        "Q": (26, [(2, 24)]), "H": (16, [(4, 9)])},
    5: {"L": (26, [(1, 108)]), "M": (24, [(2, 43)]),
        "Q": (18, [(2, 15), (2, 16)]), "H": (22, [(2, 11), (2, 12)])},
    6: {"L": (18, [(2, 68)]), "M": (16, [(4, 27)]),
        "Q": (24, [(4, 19)]), "H": (28, [(4, 15)])},
    7: {"L": (20, [(2, 78)]), "M": (18, [(4, 31)]),
        "Q": (18, [(2, 14), (4, 15)]), "H": (26, [(4, 13), (1, 14)])},
    8: {"L": (24, [(2, 97)]), "M": (22, [(2, 38), (2, 39)]),
        "Q": (22, [(4, 18), (2, 19)]), "H": (26, [(4, 14), (2, 15)])},
    9: {"L": (30, [(2, 116)]), "M": (22, [(3, 36), (2, 37)]),
        "Q": (20, [(4, 16), (4, 17)]), "H": (24, [(4, 12), (4, 13)])},
    10: {"L": (18, [(2, 68), (2, 69)]), "M": (26, [(4, 43), (1, 44)]),
         "Q": (24, [(6, 19), (2, 20)]), "H": (28, [(6, 15), (2, 16)])},
}
_ALIGN = {1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30],
          6: [6, 34], 7: [6, 22, 38], 8: [6, 24, 42], 9: [6, 26, 46],
          10: [6, 28, 50]}
_EC_BITS = {"L": 0b01, "M": 0b00, "Q": 0b11, "H": 0b10}

# GF(256) tables, poly 0x11D
_EXP = np.zeros(512, np.int32)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _rs_gen(n: int) -> List[int]:
    g = [1]
    for i in range(n):
        ng = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            ng[j] ^= _gf_mul(c, int(_EXP[i]))
            ng[j + 1] ^= c
        g = ng
    return g


def _rs_encode(data: List[int], n_ec: int) -> List[int]:
    # _rs_gen returns coefficients constant-first; the synthetic
    # division below wants the leading 1 at gen[0]
    gen = _rs_gen(n_ec)[::-1]
    rem = [0] * n_ec
    for d in data:
        factor = d ^ rem[0]
        rem = rem[1:] + [0]
        if factor:
            for j in range(n_ec):
                rem[j] ^= _gf_mul(gen[j + 1], factor)
    return rem


def _bch15_5(data5: int) -> int:
    """Format info: 15-bit BCH with generator 0x537, mask 0x5412."""
    v = data5 << 10
    g = 0x537
    for i in range(14, 9, -1):
        if v & (1 << i):
            v ^= g << (i - 10)
    return ((data5 << 10) | v) ^ 0x5412


def _version_info(ver: int) -> int:
    """v7+ version info: 18-bit Golay, generator 0x1F25."""
    v = ver << 12
    g = 0x1F25
    for i in range(17, 11, -1):
        if v & (1 << i):
            v ^= g << (i - 12)
    return (ver << 12) | v


def _pick_version(n_bytes: int, ec: str) -> int:
    for ver in range(1, 11):
        ecw, blocks = _BLOCKS[ver][ec]
        cap = sum(nb * dc for nb, dc in blocks)
        # mode(4) + count(8 or 16) + data bits must fit
        cnt_bits = 8 if ver <= 9 else 16
        if 4 + cnt_bits + 8 * n_bytes <= cap * 8:
            return ver
    raise ValueError("data too long for QR versions 1-10")


def _build_codewords(data: bytes, ver: int, ec: str) -> List[int]:
    ecw, blocks = _BLOCKS[ver][ec]
    total_data = sum(nb * dc for nb, dc in blocks)
    cnt_bits = 8 if ver <= 9 else 16
    bits = []

    def put(v, n):
        for i in range(n - 1, -1, -1):
            bits.append((v >> i) & 1)

    put(0b0100, 4)
    put(len(data), cnt_bits)
    for b in data:
        put(b, 8)
    put(0, min(4, total_data * 8 - len(bits)))     # terminator
    while len(bits) % 8:
        bits.append(0)
    cw = []
    for i in range(0, len(bits), 8):
        cw.append(int("".join(map(str, bits[i:i + 8])), 2))
    pads = [0xEC, 0x11]
    k = 0
    while len(cw) < total_data:
        cw.append(pads[k & 1])
        k += 1
    # split into blocks, RS each, interleave
    dblocks, eblocks = [], []
    pos = 0
    for nb, dc in blocks:
        for _ in range(nb):
            blk = cw[pos:pos + dc]
            pos += dc
            dblocks.append(blk)
            eblocks.append(_rs_encode(blk, ecw))
    out = []
    for i in range(max(len(b) for b in dblocks)):
        for b in dblocks:
            if i < len(b):
                out.append(b[i])
    for i in range(ecw):
        for b in eblocks:
            out.append(b[i])
    return out


def _function_patterns(ver: int):
    """(matrix, reserved) with finders/timing/alignment/format areas."""
    n = 17 + 4 * ver
    m = np.zeros((n, n), np.uint8)
    res = np.zeros((n, n), bool)

    def finder(r, c):
        for dr in range(-1, 8):
            for dc in range(-1, 8):
                rr, cc = r + dr, c + dc
                if not (0 <= rr < n and 0 <= cc < n):
                    continue
                inside = 0 <= dr <= 6 and 0 <= dc <= 6
                ring = inside and (dr in (0, 6) or dc in (0, 6))
                core = 2 <= dr <= 4 and 2 <= dc <= 4
                m[rr, cc] = 1 if (ring or core) else 0
                res[rr, cc] = True

    finder(0, 0)
    finder(0, n - 7)
    finder(n - 7, 0)
    # timing
    for i in range(8, n - 8):
        m[6, i] = m[i, 6] = (i + 1) % 2
        res[6, i] = res[i, 6] = True
    # alignment: all center combinations except the three finder
    # corners (timing-line centers like v7's (6,22) DO exist)
    centers = _ALIGN[ver]
    lo = centers[0] if centers else 0
    hi = centers[-1] if centers else 0
    for r in centers:
        for c in centers:
            if (r, c) in ((lo, lo), (lo, hi), (hi, lo)):
                continue
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    ring = max(abs(dr), abs(dc)) != 1
                    m[r + dr, c + dc] = 1 if ring else 0
                    res[r + dr, c + dc] = True
    # format info areas
    for i in range(9):
        res[8, i] = res[i, 8] = True
    for i in range(8):
        res[8, n - 1 - i] = res[n - 1 - i, 8] = True
    m[n - 8, 8] = 1                        # dark module
    res[n - 8, 8] = True
    # version info areas (v7+)
    if ver >= 7:
        res[n - 11:n - 8, 0:6] = True
        res[0:6, n - 11:n - 8] = True
    return m, res


def _place_data(m, res, codewords):
    n = m.shape[0]
    bits = []
    for cw in codewords:
        for i in range(7, -1, -1):
            bits.append((cw >> i) & 1)
    # remainder bits
    bits += [0] * 8
    bi = 0
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for c in (col, col - 1):
                if not res[r, c]:
                    m[r, c] = bits[bi] if bi < len(bits) else 0
                    bi += 1
        upward = not upward
        col -= 2
    return m


_MASKS = [
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
]


def _penalty(m: np.ndarray) -> int:
    n = m.shape[0]
    p = 0
    # N1: runs >= 5
    for arr in (m, m.T):
        for row in arr:
            run = 1
            for i in range(1, n):
                if row[i] == row[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        p += 3 + run - 5
                    run = 1
            if run >= 5:
                p += 3 + run - 5
    # N2: 2x2 blocks
    blocks = (m[:-1, :-1] == m[1:, :-1]) & (m[:-1, :-1] == m[:-1, 1:]) \
        & (m[:-1, :-1] == m[1:, 1:])
    p += 3 * int(blocks.sum())
    # N3: finder-like 1011101 with 4 light on either side
    pat = np.array([1, 0, 1, 1, 1, 0, 1], np.uint8)
    for arr in (m, m.T):
        for row in arr:
            s = "".join(map(str, row))
            p += 40 * s.count("10111010000")
            p += 40 * s.count("00001011101")
    # N4: dark proportion
    dark = int(m.sum())
    k = abs(dark * 100 // (n * n) - 50) // 5
    p += 10 * k
    return p


def qr_encode(data: bytes, ec: str = "M") -> np.ndarray:
    """Encode bytes -> (n, n) uint8 module matrix (1 = dark)."""
    ec = ec.upper()
    if ec not in _EC_BITS:
        raise ValueError("ec level must be L, M, Q or H")
    ver = _pick_version(len(data), ec)
    cws = _build_codewords(data, ver, ec)
    base, res = _function_patterns(ver)
    base = _place_data(base.copy(), res, cws)
    n = base.shape[0]
    best = None
    for mask_id, fn in enumerate(_MASKS):
        m = base.copy()
        rr, cc = np.mgrid[0:n, 0:n]
        maskmat = np.fromfunction(
            lambda r, c: np.vectorize(fn)(r.astype(int), c.astype(int)),
            (n, n))
        flip = maskmat & ~res
        m[flip] ^= 1
        _write_format(m, res, ec, mask_id, ver)
        pen = _penalty(m)
        if best is None or pen < best[0]:
            best = (pen, m)
    return best[1]


def _write_format(m, res, ec: str, mask_id: int, ver: int) -> None:
    """ISO 18004 format/version info placement (bit 0 = LSB of the
    masked BCH word; both copies)."""
    n = m.shape[0]
    fmt = _bch15_5((_EC_BITS[ec] << 3) | mask_id)

    def bit(i):
        return (fmt >> i) & 1

    # first copy around the top-left finder
    for i in range(6):
        m[i, 8] = bit(i)
    m[7, 8] = bit(6)
    m[8, 8] = bit(7)
    m[8, 7] = bit(8)
    for i in range(9, 15):
        m[8, 14 - i] = bit(i)
    # second copy: top-right row + bottom-left column
    for i in range(8):
        m[8, n - 1 - i] = bit(i)
    for i in range(8, 15):
        m[n - 15 + i, 8] = bit(i)
    m[n - 8, 8] = 1                        # dark module
    if ver >= 7:
        vi = _version_info(ver)
        for i in range(18):
            b = (vi >> i) & 1
            a = n - 11 + i % 3
            c = i // 3
            m[a, c] = b
            m[c, a] = b
