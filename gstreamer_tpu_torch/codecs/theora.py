"""Clean-room Theora (VP3) video decoder.

Written from the public Theora I specification (Xiph.Org); NOT a port
of libtheora.  The reference theoradec
(gst-plugins-base/ext/theora/gsttheoradec.c:1) wraps libtheora — this
framework decodes natively, with the 8x8 iDCT batched across all coded
blocks (the MXU-shaped formulation, same design as the JPEG/vorbis/mp3
codecs here) and the bitstream stages on host.

Decode is integer-exact, so tests/test_theora.py asserts BIT-EXACT
output parity against the real libtheoradec on libtheoraenc-generated
vectors (tests/theora_oracle.py) and the reference repo's .ogg files.

A copy of the JAX package's ``codecs/theora.py``: the integer decoder,
host numpy.  Ogg pages come from the port's ``elements/ogg.py``.  One
difference: the coded-block flags' short runs toggle their value after a
run of 30 as libtheoradec does (``_decode_coded_flags``), where the JAX
package's decoder reads a bit and loses sync (ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class EndOfPacket(Exception):
    pass


class Bits:
    """MSB-first bit reader (Theora bit packing, spec §2)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > 8 * len(self.data):
            raise EndOfPacket
        v = 0
        p = self.pos
        d = self.data
        for _ in range(n):
            v = (v << 1) | ((d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def read1(self) -> int:
        p = self.pos
        if p >= 8 * len(self.data):
            raise EndOfPacket
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1


def ilog(v: int) -> int:
    return v.bit_length() if v > 0 else 0


ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# Hilbert traversal of the 4x4 blocks of a superblock (spec §2.3)
HILBERT_BLOCKS = [(0, 0), (1, 0), (1, 1), (0, 1),
                  (0, 2), (0, 3), (1, 3), (1, 2),
                  (2, 2), (2, 3), (3, 3), (3, 2),
                  (3, 1), (2, 1), (2, 0), (3, 0)]
# traversal of the 2x2 macroblocks of a superblock
HILBERT_MBS = [(0, 0), (0, 1), (1, 1), (1, 0)]

# mode alphabets (spec §7.6, schemes 1..6); scheme 0 is bitstream-
# defined and 7 is literal
MODE_ALPHABETS = [
    [3, 4, 2, 0, 1, 5, 6, 7],
    [3, 4, 0, 2, 1, 5, 6, 7],
    [3, 2, 4, 0, 1, 5, 6, 7],
    [3, 2, 0, 4, 1, 5, 6, 7],
    [0, 3, 4, 2, 1, 5, 6, 7],
    [0, 5, 3, 4, 2, 1, 6, 7],
]

(M_INTER_NOMV, M_INTRA, M_INTER_MV, M_INTER_MV_LAST,
 M_INTER_MV_LAST2, M_GOLDEN_NOMV, M_GOLDEN_MV,
 M_INTER_MV_FOUR) = range(8)


def _read_long_run(br: Bits) -> int:
    """Superblock run-length codeword (spec §7.4.1)."""
    if br.read1() == 0:
        return 1
    if br.read1() == 0:
        return 2 + br.read(1)
    if br.read1() == 0:
        return 4 + br.read(1)
    if br.read1() == 0:
        return 6 + br.read(2)
    if br.read1() == 0:
        return 10 + br.read(3)
    if br.read1() == 0:
        return 18 + br.read(4)
    return 34 + br.read(12)


def _read_short_run(br: Bits) -> int:
    """Block run-length codeword (spec §7.4.2)."""
    if br.read1() == 0:
        return 1 + br.read(1)
    if br.read1() == 0:
        return 3 + br.read(1)
    if br.read1() == 0:
        return 5 + br.read(1)
    if br.read1() == 0:
        return 7 + br.read(2)
    if br.read1() == 0:
        return 11 + br.read(2)
    return 15 + br.read(4)


def _read_mv_vlc(br: Bits) -> int:
    t = br.read(3)
    if t == 0:
        return 0
    if t == 1:
        return 1
    if t == 2:
        return -1
    if t == 3:
        return -2 if br.read1() else 2
    if t == 4:
        return -3 if br.read1() else 3
    if t == 5:
        m = 4 + br.read(2)
    elif t == 6:
        m = 8 + br.read(3)
    else:
        m = 16 + br.read(4)
    return -m if br.read1() else m


def _read_mv_clc(br: Bits) -> int:
    """Fixed-length MV component: 5-bit magnitude then a sign bit
    that is present even for zero magnitudes."""
    m = br.read(5)
    return -m if br.read1() else m


class TheoraDecoder:
    def __init__(self, ident: bytes, comment: Optional[bytes],
                 setup: bytes):
        self._parse_ident(ident)
        self._parse_setup(setup)
        self._geometry()
        self._prev = None               # previous reconstructed frame
        self._golden = None
        self._lastdc = [0, 0, 0]        # per reference type

    # ----------------------------------------------------------- headers
    def _parse_ident(self, pkt: bytes) -> None:
        if pkt[:7] != b"\x80theora":
            raise ValueError("theora: bad ident header")
        br = Bits(pkt[7:])
        vmaj, vmin, _vrev = br.read(8), br.read(8), br.read(8)
        if (vmaj, vmin) != (3, 2):
            raise ValueError("theora: unsupported version")
        self.fmbw = br.read(16)
        self.fmbh = br.read(16)
        self.frame_width = self.fmbw * 16
        self.frame_height = self.fmbh * 16
        self.pic_width = br.read(24)
        self.pic_height = br.read(24)
        self.pic_x = br.read(8)
        self.pic_y = br.read(8)
        self.fps_n = br.read(32)
        self.fps_d = br.read(32)
        self.par_n = br.read(24)
        self.par_d = br.read(24)
        self.colorspace = br.read(8)
        self.nombr = br.read(24)
        self.quality = br.read(6)
        self.kfgshift = br.read(5)
        self.pixel_fmt = br.read(2)
        if self.pixel_fmt == 1:
            raise ValueError("theora: reserved pixel format")
        br.read(3)

    def _parse_setup(self, pkt: bytes) -> None:
        if pkt[:7] != b"\x82theora":
            raise ValueError("theora: bad setup header")
        br = Bits(pkt[7:])
        # loop filter limits (spec §6.3)
        nbits = br.read(3)
        self.lflims = [br.read(nbits) for _ in range(64)]
        # quantization parameters (spec §6.4)
        nbits = br.read(4) + 1
        self.acscale = [br.read(nbits) for _ in range(64)]
        nbits = br.read(4) + 1
        self.dcscale = [br.read(nbits) for _ in range(64)]
        nbms = br.read(9) + 1
        self.bms = [[br.read(8) for _ in range(64)]
                    for _ in range(nbms)]
        self.qrsizes = [[None] * 3 for _ in range(2)]
        self.qrbmis = [[None] * 3 for _ in range(2)]
        for qti in range(2):
            for pli in range(3):
                newqr = 1 if (qti, pli) == (0, 0) else br.read1()
                if not newqr:
                    if qti > 0 and br.read1():
                        # copy from same plane of previous qtype
                        self.qrsizes[qti][pli] = \
                            self.qrsizes[qti - 1][pli]
                        self.qrbmis[qti][pli] = \
                            self.qrbmis[qti - 1][pli]
                    else:
                        # copy from previous in scan order
                        j = qti * 3 + pli - 1
                        self.qrsizes[qti][pli] = \
                            self.qrsizes[j // 3][j % 3]
                        self.qrbmis[qti][pli] = \
                            self.qrbmis[j // 3][j % 3]
                    continue
                sizes = []
                bmis = [br.read(ilog(nbms - 1))]
                qi = 0
                while qi < 63:
                    size = br.read(ilog(62 - qi)) + 1
                    sizes.append(size)
                    qi += size
                    bmis.append(br.read(ilog(nbms - 1)))
                if qi > 63:
                    raise ValueError("theora: quant ranges overflow")
                self.qrsizes[qti][pli] = sizes
                self.qrbmis[qti][pli] = bmis
        # huffman tables (spec §6.4.2): 80 trees
        self.huff = []
        for _ in range(80):
            table: Dict[Tuple[int, int], int] = {}

            def _tree(depth, code):
                if depth > 32:
                    raise ValueError("theora: huffman tree too deep")
                if br.read1():
                    table[(depth, code)] = br.read(5)
                else:
                    _tree(depth + 1, code << 1)
                    _tree(depth + 1, (code << 1) | 1)
            _tree(0, 0)
            maxlen = max((d for d, _ in table), default=0)
            self.huff.append((table, maxlen))
        self._qmat_cache: Dict[Tuple[int, int, int], np.ndarray] = {}

    def _read_token(self, br: Bits, hti: int) -> int:
        table, maxlen = self.huff[hti]
        if maxlen == 0:
            return table[(0, 0)]
        code = 0
        for depth in range(1, maxlen + 1):
            code = (code << 1) | br.read1()
            t = table.get((depth, code))
            if t is not None:
                return t
        raise ValueError("theora: bad huffman code")

    # ------------------------------------------------------ quant matrix
    def qmat(self, qti: int, pli: int, qi: int) -> np.ndarray:
        key = (qti, pli, qi)
        m = self._qmat_cache.get(key)
        if m is not None:
            return m
        sizes = self.qrsizes[qti][pli]
        bmis = self.qrbmis[qti][pli]
        qri = 0
        qistart = 0
        for qri, size in enumerate(sizes):
            if qistart + size >= qi:
                break
            qistart += size
        size = sizes[qri]
        bm_lo = np.array(self.bms[bmis[qri]], np.int64)
        bm_hi = np.array(self.bms[bmis[qri + 1]], np.int64)
        bm = (2 * (qistart + size - qi) * bm_lo
              + 2 * (qi - qistart) * bm_hi
              + size) // (2 * size)
        out = np.zeros(64, np.int64)
        for ci in range(64):
            qscale = (self.dcscale[qi] if ci == 0
                      else self.acscale[qi])
            if ci == 0:
                qmin = 16 if qti == 0 else 32
            else:
                qmin = 8 if qti == 0 else 16
            out[ci] = max(qmin,
                          min((qscale * int(bm[ci]) // 100) * 4, 4096))
        self._qmat_cache[key] = out
        return out

    # -------------------------------------------------------- geometry
    def _geometry(self) -> None:
        fw, fh = self.frame_width, self.frame_height
        if self.pixel_fmt == 0:          # 4:2:0
            cdims = (fw // 2, fh // 2)
        elif self.pixel_fmt == 2:        # 4:2:2
            cdims = (fw // 2, fh)
        else:                            # 4:4:4
            cdims = (fw, fh)
        self.plane_dims = [(fw, fh), cdims, cdims]
        self.nbs = []                    # blocks per plane
        self.block_xy: List[List[Tuple[int, int]]] = []
        self.coded_order: List[Tuple[int, int]] = []   # (pli, bi)
        self.raster_of: List[np.ndarray] = []
        for pli, (w, h) in enumerate(self.plane_dims):
            bw, bh = w // 8, h // 8
            self.nbs.append(bw * bh)
            sbw, sbh = (bw + 3) // 4, (bh + 3) // 4
            order = []
            for sby in range(sbh):
                for sbx in range(sbw):
                    for hx, hy in HILBERT_BLOCKS:
                        bx, by = sbx * 4 + hx, sby * 4 + hy
                        if bx < bw and by < bh:
                            order.append(by * bw + bx)
            self.block_xy.append([(bi % bw, bi // bw)
                                  for bi in range(bw * bh)])
            self.coded_order.extend((pli, bi) for bi in order)
        # macroblock coded order over the luma plane (spec: SBs raster,
        # 2x2 MBs per SB in the quadrant traversal)
        mbw, mbh = self.fmbw, self.fmbh
        self.mb_order: List[Tuple[int, int]] = []
        sbw, sbh = (mbw + 1) // 2, (mbh + 1) // 2
        for sby in range(sbh):
            for sbx in range(sbw):
                for hx, hy in HILBERT_MBS:
                    mbx, mby = sbx * 2 + hx, sby * 2 + hy
                    if mbx < mbw and mby < mbh:
                        self.mb_order.append((mbx, mby))

    # -------------------------------------------------------- frame API
    def decode_packet(self, pkt: bytes
                      ) -> Optional[Tuple[np.ndarray, ...]]:
        """-> (Y, Cb, Cr) full-frame planes (uncropped) or None for a
        zero-length (duplicate) packet."""
        if len(pkt) == 0:
            return self._emit()
        if pkt[0] & 0x80:
            raise ValueError("theora: header packet in stream")
        br = Bits(pkt)
        if br.read1() != 0:
            raise ValueError("theora: bad frame marker")
        ftype = br.read1()
        qis = [br.read(6)]
        if br.read1():
            qis.append(br.read(6))
            if br.read1():
                qis.append(br.read(6))
        if ftype == 0:
            if br.read(3) != 0:
                raise ValueError("theora: nonzero reserved bits")
            self._decode_intra(br, qis)
        else:
            if self._prev is None:
                raise ValueError("theora: inter frame before keyframe")
            self._decode_inter(br, qis)
        return self._emit()

    def _emit(self):
        # spec space is bottom-up (VP3 legacy); emit top-down planes
        return tuple(p[::-1].copy() for p in self._prev)

    # ---------------------------------------------------- coded flags
    def _decode_coded_flags(self, br: Bits) -> List[np.ndarray]:
        """spec §7.3: superblock partial/full flags + block flags."""
        coded = []
        sb_partial: List[bool] = []
        sb_full: List[bool] = []
        sb_geom = []                      # (pli, sbx, sby) per SB
        for pli, (w, h) in enumerate(self.plane_dims):
            bw, bh = w // 8, h // 8
            sbw, sbh = (bw + 3) // 4, (bh + 3) // 4
            for sby in range(sbh):
                for sbx in range(sbw):
                    sb_geom.append((pli, sbx, sby))
            coded.append(np.zeros(bw * bh, bool))
        nsbs = len(sb_geom)
        # partial flags
        val = br.read1()
        got = 0
        while got < nsbs:
            run = _read_long_run(br)
            run = min(run, nsbs - got)
            sb_partial.extend([bool(val)] * run)
            got += run
            if got < nsbs:
                if run == 4129:
                    val = br.read1()
                else:
                    val ^= 1
        # full flags for non-partial SBs
        n_nonpartial = sum(1 for p in sb_partial if not p)
        fulls: List[bool] = []
        if n_nonpartial:
            val = br.read1()
            got = 0
            while got < n_nonpartial:
                run = _read_long_run(br)
                run = min(run, n_nonpartial - got)
                fulls.extend([bool(val)] * run)
                got += run
                if got < n_nonpartial:
                    if run == 4129:
                        val = br.read1()
                    else:
                        val ^= 1
        fi = 0
        for i in range(nsbs):
            if sb_partial[i]:
                sb_full.append(False)
            else:
                sb_full.append(fulls[fi])
                fi += 1
        # block flags in partial SBs (short runs, spec §7.3: the value
        # flips after every run, a maximum-length run of 30 included, as
        # libtheoradec does; the JAX package's decoder reads a new value
        # after a run of 30 and loses sync there: ROADMAP.md section 3)
        n_partial_blocks = 0
        slots = []                        # (pli, bi) of partial-SB blocks
        for i, (pli, sbx, sby) in enumerate(sb_geom):
            w, h = self.plane_dims[pli]
            bw, bh = w // 8, h // 8
            for hx, hy in HILBERT_BLOCKS:
                bx, by = sbx * 4 + hx, sby * 4 + hy
                if bx >= bw or by >= bh:
                    continue
                bi = by * bw + bx
                if sb_full[i]:
                    coded[pli][bi] = True
                elif sb_partial[i]:
                    slots.append((pli, bi))
        n = len(slots)
        flags = []
        if n:
            val = br.read1()
            while len(flags) < n:
                run = _read_short_run(br)
                run = min(run, n - len(flags))
                flags.extend([bool(val)] * run)
                if len(flags) < n:
                    val ^= 1
        for (pli, bi), f in zip(slots, flags):
            coded[pli][bi] = f
        return coded

    # ------------------------------------------------------- DCT tokens
    def _decode_residuals(self, br: Bits, coded, qis,
                          block_qi) -> List[np.ndarray]:
        """Token decode (spec §7.5): returns per-plane (nbs, 64)
        coefficient arrays in zigzag order."""
        coeffs = [np.zeros((n, 64), np.int32) for n in self.nbs]
        coded_list = [(pli, bi) for (pli, bi) in self.coded_order
                      if coded[pli][bi]]
        nxt = {k: 0 for k in coded_list}
        # huffman table choices
        hti_dc_y = br.read(4)
        hti_dc_c = br.read(4)
        eob_run = 0
        # DC pass
        eob_run = self._token_pass(
            br, 0, coded_list, nxt, coeffs,
            hti_dc_y, hti_dc_c, eob_run)
        hti_ac_y = br.read(4)
        hti_ac_c = br.read(4)
        for ci in range(1, 64):
            if ci <= 5:
                g = 1
            elif ci <= 14:
                g = 2
            elif ci <= 27:
                g = 3
            else:
                g = 4
            eob_run = self._token_pass(
                br, ci, coded_list, nxt, coeffs,
                16 * g + hti_ac_y, 16 * g + hti_ac_c, eob_run)
        return coeffs

    def _token_pass(self, br, ci, coded_list, nxt, coeffs,
                    hti_y, hti_c, eob_run) -> int:
        for key in coded_list:
            if nxt[key] != ci:
                continue
            pli, bi = key
            if eob_run > 0:
                nxt[key] = 64
                eob_run -= 1
                continue
            hti = hti_y if pli == 0 else hti_c
            token = self._read_token(br, hti)
            if token <= 6:
                if token == 0:
                    eob_run = 1
                elif token == 1:
                    eob_run = 2
                elif token == 2:
                    eob_run = 3
                elif token == 3:
                    eob_run = 4 + br.read(2)
                elif token == 4:
                    eob_run = 8 + br.read(3)
                elif token == 5:
                    eob_run = 16 + br.read(4)
                else:
                    eob_run = br.read(12)
                nxt[key] = 64
                eob_run -= 1
            elif token == 7:
                nxt[key] = ci + 1 + br.read(3)
            elif token == 8:
                nxt[key] = ci + 1 + br.read(6)
            elif token <= 12:
                val = {9: 1, 10: -1, 11: 2, 12: -2}[token]
                coeffs[pli][bi, ci] = val
                nxt[key] = ci + 1
            elif token <= 16:
                sign = br.read1()
                mag = token - 13 + 3
                coeffs[pli][bi, ci] = -mag if sign else mag
                nxt[key] = ci + 1
            elif token <= 22:
                sign = br.read1()
                nb = {17: 1, 18: 2, 19: 3, 20: 4, 21: 5, 22: 9}[token]
                base = {17: 7, 18: 9, 19: 13, 20: 21, 21: 37,
                        22: 69}[token]
                mag = base + br.read(nb)
                coeffs[pli][bi, ci] = -mag if sign else mag
                nxt[key] = ci + 1
            elif token <= 27:
                sign = br.read1()
                run = token - 23 + 1
                pos = ci + run
                coeffs[pli][bi, pos] = -1 if sign else 1
                nxt[key] = pos + 1
            elif token == 28:
                sign = br.read1()
                run = 6 + br.read(2)
                pos = ci + run
                coeffs[pli][bi, pos] = -1 if sign else 1
                nxt[key] = pos + 1
            elif token == 29:
                sign = br.read1()
                run = 10 + br.read(3)
                pos = ci + run
                coeffs[pli][bi, pos] = -1 if sign else 1
                nxt[key] = pos + 1
            elif token == 30:
                sign = br.read1()
                mag = 2 + br.read(1)
                pos = ci + 1
                coeffs[pli][bi, pos] = -mag if sign else mag
                nxt[key] = pos + 1
            else:                                     # 31
                sign = br.read1()
                mag = 2 + br.read(1)
                run = 2 + br.read(1)
                pos = ci + run
                coeffs[pli][bi, pos] = -mag if sign else mag
                nxt[key] = pos + 1
        return eob_run

    # ---------------------------------------------------- DC prediction
    # mask (UR,U,UL,L bits) -> weights (L, UL, U, UR) in 128ths;
    # prediction uses an arithmetic shift (floor), spec §7.8
    _PRED_W = {
        1: (128, 0, 0, 0),
        2: (0, 128, 0, 0),
        3: (128, 0, 0, 0),
        4: (0, 0, 128, 0),
        5: (64, 0, 64, 0),
        6: (0, 0, 128, 0),
        7: (116, -104, 116, 0),
        8: (0, 0, 0, 128),
        9: (75, 0, 0, 53),
        10: (0, 64, 0, 64),
        11: (75, 0, 0, 53),
        12: (0, 0, 128, 0),
        13: (75, 0, 0, 53),
        14: (0, 24, 80, 24),
        15: (116, -104, 116, 0),
    }

    def _dc_predict(self, coded, coeffs, frame_types) -> None:
        """spec §7.8: DC prediction in raster order per plane.
        frame_types[pli][bi]: 0 intra, 1 prev, 2 golden."""
        for pli in range(3):
            w, h = self.plane_dims[pli]
            bw, bh = w // 8, h // 8
            dc = coeffs[pli][:, 0]
            lastdc = [0, 0, 0]          # resets at each plane start
            for by in range(bh):
                for bx in range(bw):
                    bi = by * bw + bx
                    if not coded[pli][bi]:
                        continue
                    ft = frame_types[pli][bi]
                    neigh = []            # (which, value)
                    mask = 0
                    if bx > 0:
                        nb = bi - 1
                        if coded[pli][nb] \
                                and frame_types[pli][nb] == ft:
                            mask |= 1
                            vl = int(dc[nb])
                        else:
                            vl = 0
                    else:
                        vl = 0
                    vul = vu = vur = 0
                    if by > 0:
                        if bx > 0:
                            nb = bi - bw - 1
                            if coded[pli][nb] \
                                    and frame_types[pli][nb] == ft:
                                mask |= 2
                                vul = int(dc[nb])
                        nb = bi - bw
                        if coded[pli][nb] \
                                and frame_types[pli][nb] == ft:
                            mask |= 4
                            vu = int(dc[nb])
                        if bx < bw - 1:
                            nb = bi - bw + 1
                            if coded[pli][nb] \
                                    and frame_types[pli][nb] == ft:
                                mask |= 8
                                vur = int(dc[nb])
                    if mask == 0:
                        pred = lastdc[ft]
                    else:
                        wl, wul, wu, wur = self._PRED_W[mask]
                        sacc = (wl * vl + wul * vul + wu * vu
                                + wur * vur)
                        pred = (sacc // 128 if sacc >= 0
                                else -((-sacc) // 128))   # C trunc
                        if mask in (7, 15):
                            # outlier rule (spec §7.8)
                            if abs(pred - vu) > 128:
                                pred = vu
                            elif abs(pred - vl) > 128:
                                pred = vl
                            elif abs(pred - vul) > 128:
                                pred = vul
                    v = int(dc[bi]) + pred
                    v = max(-32768, min(32767, v))
                    dc[bi] = v
                    lastdc[ft] = v

    # ------------------------------------------------------------- iDCT
    @staticmethod
    def _idct8(x: np.ndarray) -> np.ndarray:
        """Exact integer 1D iDCT over axis -1 (spec §7.9.3.1): all
        intermediates live in 16-bit registers (wrap-around), products
        are 32-bit with a truncating >>16."""
        C = [None, 64277, 60547, 54491, 46341, 36410, 25080, 12785]

        def w16(v):
            return ((v + 0x8000) & 0xFFFF) - 0x8000

        def m(c, v):
            return w16((c * v) >> 16)
        y = [x[..., i].astype(np.int64) for i in range(8)]
        A = w16(m(C[1], y[1]) + m(C[7], y[7]))
        B = w16(m(C[7], y[1]) - m(C[1], y[7]))
        Cc = w16(m(C[3], y[3]) + m(C[5], y[5]))
        D = w16(m(C[3], y[5]) - m(C[5], y[3]))
        Ad = m(C[4], w16(A - Cc))
        Bd = m(C[4], w16(B - D))
        Cd = w16(A + Cc)
        Dd = w16(B + D)
        E = m(C[4], w16(y[0] + y[4]))
        F = m(C[4], w16(y[0] - y[4]))
        G = w16(m(C[2], y[2]) + m(C[6], y[6]))
        H = w16(m(C[6], y[2]) - m(C[2], y[6]))
        Ed = w16(E - G)
        Gd = w16(E + G)
        Add = w16(F + Ad)
        Bdd = w16(Bd - H)
        Fd = w16(F - Ad)
        Hd = w16(Bd + H)
        out = np.stack([w16(Gd + Cd), w16(Add + Hd), w16(Add - Hd),
                        w16(Ed + Dd), w16(Ed - Dd), w16(Fd + Bdd),
                        w16(Fd - Bdd), w16(Gd - Cd)], axis=-1)
        return out

    @classmethod
    def _idct2d(cls, blocks: np.ndarray) -> np.ndarray:
        """(n, 8, 8) int32 freq -> (n, 8, 8) int32 spatial residual
        (spec §7.9.3: rows first, then columns; the truncating
        shifts make the order load-bearing)."""
        t = cls._idct8(blocks)                       # rows
        t = cls._idct8(t.transpose(0, 2, 1)).transpose(0, 2, 1)
        return ((t + 8) >> 4).astype(np.int32)

    # ------------------------------------------------------ reconstruct
    def _reconstruct(self, coded, coeffs, qis, block_qi, frame_types,
                     predictors) -> None:
        """Dequant + iDCT + add prediction; writes into self._prev
        planes."""
        planes = self._prev
        for pli in range(3):
            w, h = self.plane_dims[pli]
            bw = w // 8
            idxs = np.nonzero(coded[pli])[0]
            if len(idxs) == 0:
                continue
            blocks = coeffs[pli][idxs].astype(np.int64)   # (n,64) zigzag
            nat = np.zeros_like(blocks)
            nat[:, ZIGZAG] = blocks                       # de-zigzag
            # dequant in natural order: DC from qi0, AC from the
            # block's qi (spec §7.9.1)
            qtis = frame_types[pli][idxs] != 0            # inter bool
            deq = np.zeros_like(nat)
            for inter in (False, True):
                sel = np.nonzero(qtis == inter)[0]
                if not len(sel):
                    continue
                qt = 1 if inter else 0
                for qi_i, qi in enumerate(qis):
                    qsel = sel[block_qi[pli][idxs[sel]] == qi_i]
                    if not len(qsel):
                        continue
                    qm = self.qmat(qt, pli, qi).copy()
                    qm0 = self.qmat(qt, pli, qis[0])
                    qm[0] = qm0[0]                      # DC from qi0
                    deq[qsel] = nat[qsel] * qm[None, :]
            # dequantized coefficients live in 16-bit registers
            deq = np.clip(deq, -32768, 32767)
            res = self._idct2d(deq.reshape(-1, 8, 8))
            pred = predictors[pli][idxs]                 # (n,8,8) int32
            out = np.clip(pred + res, 0, 255).astype(np.uint8)
            for k, bi in enumerate(idxs):
                bx, by = bi % bw, bi // bw
                planes[pli][by * 8:by * 8 + 8,
                            bx * 8:bx * 8 + 8] = out[k]

    # ---------------------------------------------------------- intra
    def _decode_intra(self, br: Bits, qis: List[int]) -> None:
        coded = [np.ones(n, bool) for n in self.nbs]
        block_qi = self._decode_block_qi(br, coded, qis)
        frame_types = [np.zeros(n, np.int32) for n in self.nbs]
        coeffs = self._decode_residuals(br, coded, qis, block_qi)
        self._lastdc = [0, 0, 0]
        self._dc_predict(coded, coeffs, frame_types)
        self._prev = [np.empty((h, w), np.uint8)
                      for (w, h) in self.plane_dims]
        predictors = [np.full((n, 8, 8), 128, np.int32)
                      for n in self.nbs]
        self._reconstruct(coded, coeffs, qis, block_qi, frame_types,
                          predictors)
        self._loop_filter(coded, qis[0])
        self._golden = [p.copy() for p in self._prev]

    def _decode_block_qi(self, br: Bits, coded, qis):
        """spec §7.7: per-block qi index via run-coded bitmaps."""
        block_qi = [np.zeros(n, np.int32) for n in self.nbs]
        if len(qis) == 1:
            return block_qi
        coded_list = [(pli, bi) for (pli, bi) in self.coded_order
                      if coded[pli][bi]]
        ncoded = len(coded_list)
        # pass 1: qi > 0?
        flags = []
        val = br.read1()
        got = 0
        while got < ncoded:
            run = _read_long_run(br)
            run = min(run, ncoded - got)
            flags.extend([val] * run)
            got += run
            if got < ncoded:
                if run == 4129:
                    val = br.read1()
                else:
                    val ^= 1
        for (pli, bi), f in zip(coded_list, flags):
            block_qi[pli][bi] = f
        if len(qis) == 3:
            sub = [(pli, bi) for (pli, bi), f in zip(coded_list, flags)
                   if f]
            if sub:
                flags2 = []
                val = br.read1()
                got = 0
                while got < len(sub):
                    run = _read_long_run(br)
                    run = min(run, len(sub) - got)
                    flags2.extend([val] * run)
                    got += run
                    if got < len(sub):
                        if run == 4129:
                            val = br.read1()
                        else:
                            val ^= 1
                for (pli, bi), f in zip(sub, flags2):
                    block_qi[pli][bi] = 1 + f
        return block_qi

    # ------------------------------------------------------ loop filter
    def _loop_filter(self, coded, qi0: int) -> None:
        L = self.lflims[qi0]
        if L == 0:
            return
        for pli in range(3):
            plane = self._prev[pli].astype(np.int32)
            w, h = self.plane_dims[pli]
            bw, bh = w // 8, h // 8
            cd = coded[pli].reshape(bh, bw)

            def lflim(d):
                ad = np.abs(d)
                out = np.where(ad < L, d,
                               np.where(ad < 2 * L,
                                        np.sign(d) * (2 * L - ad), 0))
                return out

            def filt_v(x):          # vertical edge at column x*8
                rows = np.arange(h)
                p0 = plane[:, x * 8 - 2]
                p1 = plane[:, x * 8 - 1]
                p2 = plane[:, x * 8]
                p3 = plane[:, x * 8 + 1]
                r = (p0 - 3 * p1 + 3 * p2 - p3 + 4) >> 3
                f = lflim(r)
                plane[:, x * 8 - 1] = np.clip(p1 + f, 0, 255)
                plane[:, x * 8] = np.clip(p2 - f, 0, 255)

            # the spec filters per block edge (only rows of that block)
            for by in range(bh):
                ys = slice(by * 8, by * 8 + 8)
                for bx in range(bw):
                    if not cd[by, bx]:
                        continue
                    if bx > 0:
                        self._filter_edge_v(plane, ys, bx * 8, L)
                    if by > 0:
                        self._filter_edge_h(plane, by * 8,
                                            slice(bx * 8, bx * 8 + 8),
                                            L)
                    if bx < bw - 1 and not cd[by, bx + 1]:
                        self._filter_edge_v(plane, ys, bx * 8 + 8, L)
                    if by < bh - 1 and not cd[by + 1, bx]:
                        self._filter_edge_h(plane, by * 8 + 8,
                                            slice(bx * 8, bx * 8 + 8),
                                            L)
            self._prev[pli] = plane.astype(np.uint8)

    @staticmethod
    def _lflim_arr(d, L):
        ad = np.abs(d)
        return np.where(ad < L, d,
                        np.where(ad < 2 * L,
                                 np.sign(d) * (2 * L - ad), 0))

    def _filter_edge_v(self, plane, ys, x, L):
        p0 = plane[ys, x - 2]
        p1 = plane[ys, x - 1]
        p2 = plane[ys, x]
        p3 = plane[ys, x + 1]
        r = (p0 - 3 * p1 + 3 * p2 - p3 + 4) >> 3
        f = self._lflim_arr(r, L)
        plane[ys, x - 1] = np.clip(p1 + f, 0, 255)
        plane[ys, x] = np.clip(p2 - f, 0, 255)

    def _filter_edge_h(self, plane, y, xs, L):
        p0 = plane[y - 2, xs]
        p1 = plane[y - 1, xs]
        p2 = plane[y, xs]
        p3 = plane[y + 1, xs]
        r = (p0 - 3 * p1 + 3 * p2 - p3 + 4) >> 3
        f = self._lflim_arr(r, L)
        plane[y - 1, xs] = np.clip(p1 + f, 0, 255)
        plane[y, xs] = np.clip(p2 - f, 0, 255)

    # ------------------------------------------------------------ inter
    def _decode_inter(self, br: Bits, qis: List[int]) -> None:
        coded = self._decode_coded_flags(br)
        modes = self._decode_mb_modes(br, coded)
        mvs = self._decode_mvs(br, coded, modes)
        block_qi = self._decode_block_qi(br, coded, qis)
        frame_types, predictors = self._predictors(coded, modes, mvs)
        coeffs = self._decode_residuals(br, coded, qis, block_qi)
        self._dc_predict(coded, coeffs, frame_types)
        self._prev = [p.copy() for p in self._prev]
        self._reconstruct(coded, coeffs, qis, block_qi, frame_types,
                          predictors)
        self._loop_filter(coded, qis[0])

    def _mb_blocks(self, mbx: int, mby: int):
        """Luma block indices of a macroblock (raster in the MB)."""
        bw = self.frame_width // 8
        out = []
        for dy in range(2):
            for dx in range(2):
                bx, by = mbx * 2 + dx, mby * 2 + dy
                out.append(by * bw + bx)
        return out

    def _mb_chroma_blocks(self, mbx: int, mby: int, pli: int):
        w, h = self.plane_dims[pli]
        bw = w // 8
        if self.pixel_fmt == 0:       # 420: one chroma block per MB
            return [mby * bw + mbx]
        if self.pixel_fmt == 2:       # 422: two stacked
            return [(mby * 2) * bw + mbx, (mby * 2 + 1) * bw + mbx]
        out = []                      # 444: four
        for dy in range(2):
            for dx in range(2):
                out.append((mby * 2 + dy) * bw + (mbx * 2 + dx))
        return out

    def _decode_mb_modes(self, br: Bits, coded) -> Dict[Tuple[int, int],
                                                        int]:
        scheme = br.read(3)
        if scheme == 0:
            alphabet = [0] * 8
            for mode in range(8):
                alphabet[br.read(3)] = mode
        elif scheme == 7:
            alphabet = None
        else:
            alphabet = MODE_ALPHABETS[scheme - 1]
        modes = {}
        for mbx, mby in self.mb_order:
            blocks = self._mb_blocks(mbx, mby)
            if not any(coded[0][bi] for bi in blocks):
                modes[(mbx, mby)] = M_INTER_NOMV
                continue
            if alphabet is None:
                mode = br.read(3)
            else:
                rank = 0
                while rank < 7 and br.read1():
                    rank += 1
                mode = alphabet[rank]
            modes[(mbx, mby)] = mode
        return modes

    def _decode_mvs(self, br: Bits, coded, modes):
        read_comp = (_read_mv_clc if br.read1() else _read_mv_vlc)
        last = (0, 0)
        last2 = (0, 0)
        mvs = {}                        # (mbx,mby) -> list per block
        for mbx, mby in self.mb_order:
            mode = modes[(mbx, mby)]
            blocks = self._mb_blocks(mbx, mby)
            mb_coded = any(coded[0][bi] for bi in blocks)
            if not mb_coded:
                mvs[(mbx, mby)] = None
                continue
            if mode == M_INTER_MV or mode == M_GOLDEN_MV:
                mv = (read_comp(br), read_comp(br))
                if mode == M_INTER_MV:
                    last2 = last
                    last = mv
                mvs[(mbx, mby)] = [mv] * 4
            elif mode == M_INTER_MV_LAST:
                mvs[(mbx, mby)] = [last] * 4
            elif mode == M_INTER_MV_LAST2:
                mv = last2
                last2 = last
                last = mv
                mvs[(mbx, mby)] = [mv] * 4
            elif mode == M_INTER_MV_FOUR:
                four = []
                lastmv = last
                for bi in blocks:
                    if coded[0][bi]:
                        mv = (read_comp(br), read_comp(br))
                        lastmv = mv
                    else:
                        mv = (0, 0)
                    four.append(mv)
                last2 = last
                last = lastmv
                mvs[(mbx, mby)] = four
            else:
                mvs[(mbx, mby)] = [(0, 0)] * 4
        return mvs

    def _predictors(self, coded, modes, mvs):
        """Build per-plane (nbs, 8, 8) int32 predictor blocks and
        frame-type arrays."""
        frame_types = [np.zeros(n, np.int32) for n in self.nbs]
        predictors = [np.zeros((n, 8, 8), np.int32)
                      for n in self.nbs]
        # pad reference frames for out-of-frame MVs
        pad = 32
        prev_p = [np.pad(p.astype(np.int32), pad, mode="edge")
                  for p in self._prev]
        gold_p = [np.pad(p.astype(np.int32), pad, mode="edge")
                  for p in self._golden]
        for mbx, mby in self.mb_order:
            mode = modes[(mbx, mby)]
            mv4 = mvs[(mbx, mby)]
            luma = self._mb_blocks(mbx, mby)
            if mode == M_INTRA:
                ft = 0
            elif mode in (M_GOLDEN_NOMV, M_GOLDEN_MV):
                ft = 2
            else:
                ft = 1
            ref = gold_p if ft == 2 else prev_p
            # luma blocks
            for k, bi in enumerate(luma):
                if not coded[0][bi]:
                    continue
                frame_types[0][bi] = ft
                if mode == M_INTRA:
                    predictors[0][bi] = 128
                    continue
                mv = mv4[k] if mv4 is not None else (0, 0)
                bx, by = self.block_xy[0][bi]
                predictors[0][bi] = self._mc_block(
                    ref[0], pad, bx * 8, by * 8, mv)
            # chroma blocks
            cmv = self._chroma_mv(mode, mv4, coded, luma)
            for pli in (1, 2):
                for bi in self._mb_chroma_blocks(mbx, mby, pli):
                    if bi >= self.nbs[pli] or not coded[pli][bi]:
                        continue
                    frame_types[pli][bi] = ft
                    if mode == M_INTRA:
                        predictors[pli][bi] = 128
                        continue
                    bx, by = self.block_xy[pli][bi]
                    predictors[pli][bi] = self._mc_block(
                        ref[pli], pad, bx * 8, by * 8, cmv)
        return frame_types, predictors

    @staticmethod
    def _halve(v: int) -> int:
        """Chroma MV halving: arithmetic shift with the dropped bit
        ORed back (VP3 rounding-toward-odd)."""
        return (v >> 1) | (v & 1)

    def _chroma_mv(self, mode, mv4, coded, luma_blocks):
        if mv4 is None or mode in (M_INTRA, M_INTER_NOMV,
                                   M_GOLDEN_NOMV):
            return (0, 0)
        if mode == M_INTER_MV_FOUR:
            sx = sum(mv[0] for mv in mv4)
            sy = sum(mv[1] for mv in mv4)

            def rshift2(a):
                return (a + 2) >> 2 if a > 0 else (a + 1) >> 2
            mv = (rshift2(sx), rshift2(sy))
        else:
            mv = mv4[0]
        if self.pixel_fmt == 0:          # 4:2:0
            return (self._halve(mv[0]), self._halve(mv[1]))
        if self.pixel_fmt == 2:          # 4:2:2
            return (self._halve(mv[0]), mv[1])
        return mv                        # 4:4:4

    def _mc_block(self, ref_padded, pad, x0, y0, mv):
        """8x8 predictor from the padded reference; mv in half-pel."""
        if self.pixel_fmt == 0:
            pass
        mvx, mvy = mv
        fx, hx = mvx >> 1, mvx & 1
        fy, hy = mvy >> 1, mvy & 1
        x = x0 + fx + pad
        y = y0 + fy + pad
        if not hx and not hy:
            return ref_padded[y:y + 8, x:x + 8]
        if hx and hy:
            # both half-pel: two-sample DIAGONAL average; the pair
            # follows the MV direction — main diagonal for same signs,
            # anti-diagonal when the signs differ (VP3 semantics)
            d = -1 if (mvx ^ mvy) < 0 else 0
            a = ref_padded[y:y + 8, x - d:x - d + 8]
            b = ref_padded[y + 1:y + 9, x + 1 + d:x + 9 + d]
        else:
            a = ref_padded[y:y + 8, x:x + 8]
            b = ref_padded[y + (1 if hy else 0):
                           y + 8 + (1 if hy else 0),
                           x + (1 if hx else 0):
                           x + 8 + (1 if hx else 0)]
        return (a + b) >> 1


def decode_ogg(data: bytes, with_info: bool = False):
    """Whole Ogg/Theora stream -> (frames, fps, dims).

    frames: list of (Y, Cb, Cr) uint8 planes cropped to the picture
    region (top-down); dims = (pic_width, pic_height)."""
    from ..elements.ogg import parse_ogg_pages

    pages = parse_ogg_pages(data)
    streams: Dict[int, List[bytes]] = {}
    for serial, granule, pkts in pages:
        streams.setdefault(serial, []).extend(pkts)
    th = None
    for pkts in streams.values():
        if pkts and pkts[0].startswith(b"\x80theora"):
            th = pkts
            break
    if th is None or len(th) < 3:
        raise ValueError("theora: no theora stream in ogg")
    dec = TheoraDecoder(th[0], th[1], th[2])
    frames = []
    for pkt in th[3:]:
        out = dec.decode_packet(pkt)
        if out is not None:
            frames.append(dec.crop(out))
    fps = (dec.fps_n, dec.fps_d)
    dims = (dec.pic_width, dec.pic_height)
    if with_info:
        return frames, fps, dims, dec
    return frames, fps, dims


def _crop(self, planes):
    """Crop full-frame planes to the picture region (planes are
    emitted top-down; pic offsets are in the bottom-up spec space)."""
    x0 = self.pic_x
    y0 = self.frame_height - self.pic_height - self.pic_y
    out = []
    for pli, p in enumerate(planes):
        if pli == 0 or self.pixel_fmt == 3:
            xs, ys = x0, y0
            w, h = self.pic_width, self.pic_height
        elif self.pixel_fmt == 0:
            xs, ys = x0 // 2, y0 // 2
            w, h = (self.pic_width + 1) // 2, (self.pic_height + 1) // 2
        else:                                   # 422
            xs, ys = x0 // 2, y0
            w, h = (self.pic_width + 1) // 2, self.pic_height
        out.append(p[ys:ys + h, xs:xs + w])
    return tuple(out)


TheoraDecoder.crop = _crop
