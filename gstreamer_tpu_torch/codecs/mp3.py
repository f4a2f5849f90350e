"""Clean-room MPEG-1/2/2.5 audio Layer III decoder ("mp3").

Written from the ISO/IEC 11172-3 / 13818-3 specifications; the
constant tables (Huffman codes, scalefactor bands, synthesis window D)
are the published standard constants (_mp3_tables.py).  The reference
GStreamer decoder (gst-plugins-ugly/ext/mpg123/gstmpg123audiodec.c:1)
wraps libmpg123 — this framework decodes natively.

TPU-first structure, same shape as codecs/vorbis.py: bitstream work
(side info, scalefactors, Huffman) is serial host code; the two
FLOP-heavy synthesis stages are expressed as batched matmuls —

* the per-subband IMDCT (18->36) runs as one (32, 18) @ (18, 36)
  multiply per granule/channel (`_IMDCT36`), short blocks as a batched
  (n, 6) @ (6, 12);
* the polyphase synthesis matrixing runs as one (slots, 32) @ (32, 64)
  multiply per frame (`_NMAT`), with the 512-tap window D applied as a
  (16, 32) fold.

Parity: tests/test_mp3.py compares PCM against the real libmpg123
(tests/audio_oracle.py) on libmp3lame-generated vectors and the
reference repo's .mp3 test files.

A copy of the JAX package's ``codecs/mp3.py`` (host numpy).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import _mp3_tables as T


class EndOfData(Exception):
    pass


class Bits:
    """MSB-first bit reader (MPEG audio bit order)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > 8 * len(self.data):
            raise EndOfData
        v = 0
        p = self.pos
        for _ in range(n):
            v = (v << 1) | ((self.data[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def read1(self) -> int:
        p = self.pos
        if p >= 8 * len(self.data):
            raise EndOfData
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1


# ------------------------------------------------------------- header

_BITRATES_V1 = [  # kbps per layer (1,2,3)
    [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448],
    [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384],
    [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320],
]
_BITRATES_V2 = [
    [0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256],
    [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
    [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
]
_RATES = {3: [44100, 48000, 32000],        # MPEG-1
          2: [22050, 24000, 16000],        # MPEG-2
          0: [11025, 12000, 8000]}         # MPEG-2.5


class FrameHeader:
    __slots__ = ("version_bits", "lsf", "layer", "crc", "bitrate",
                 "rate", "rate_index", "padding", "mode", "mode_ext",
                 "channels", "frame_size", "samples")

    def __init__(self, b: bytes):
        if len(b) < 4 or b[0] != 0xFF or (b[1] & 0xE0) != 0xE0:
            raise ValueError("mp3: lost frame sync")
        self.version_bits = (b[1] >> 3) & 0x3      # 3=MPEG1 2=MPEG2 0=2.5
        if self.version_bits == 1:
            raise ValueError("mp3: reserved version")
        self.lsf = self.version_bits != 3
        layer_bits = (b[1] >> 1) & 0x3
        if layer_bits == 0:
            raise ValueError("mp3: reserved layer")
        self.layer = 4 - layer_bits                 # 1, 2 or 3
        self.crc = not (b[1] & 1)
        br_idx = (b[2] >> 4) & 0xF
        rate_idx = (b[2] >> 2) & 0x3
        if br_idx in (0, 15) or rate_idx == 3:
            raise ValueError("mp3: bad bitrate/rate index")
        table = _BITRATES_V1 if not self.lsf else _BITRATES_V2
        self.bitrate = table[self.layer - 1][br_idx] * 1000
        self.rate = _RATES[self.version_bits][rate_idx]
        # sample-rate row in the band tables: 0..2 MPEG1, 3..5 MPEG2,
        # 6..8 MPEG2.5
        self.rate_index = rate_idx + {3: 0, 2: 3, 0: 6}[self.version_bits]
        self.padding = (b[2] >> 1) & 1
        self.mode = (b[3] >> 6) & 0x3               # 3 = mono
        self.mode_ext = (b[3] >> 4) & 0x3
        self.channels = 1 if self.mode == 3 else 2
        if self.layer == 1:
            self.samples = 384
            self.frame_size = (12 * self.bitrate // self.rate
                               + self.padding) * 4
        else:
            self.samples = (1152 if (self.layer == 2 or not self.lsf)
                            else 576)
            self.frame_size = (self.samples // 8 * self.bitrate
                               // self.rate + self.padding)


# ------------------------------------------------- huffman lookup maps

def _build_big_tables():
    maps = []
    for tab in T.BIG_VALUE_TABLES:
        m: Dict[Tuple[int, int], Tuple[int, int]] = {}
        maxlen = 0
        for x, y, l, code in tab:
            m[(l, code)] = (x, y)
            maxlen = max(maxlen, l)
        maps.append((m, maxlen))
    return maps


_BIG_MAPS = _build_big_tables()

_QUAD_A: Dict[Tuple[int, int], int] = {}
for _sym in range(16):
    _QUAD_A[(int(T.QUAD_BITS[0][_sym]), int(T.QUAD_CODES[0][_sym]))] = _sym

_POW43 = np.arange(8208, dtype=np.float64) ** (4.0 / 3.0)

_CS = np.zeros(8)
_CA = np.zeros(8)
for _i, _c in enumerate([-0.6, -0.535, -0.33, -0.185, -0.095,
                         -0.041, -0.0142, -0.0037]):
    _CS[_i] = 1.0 / math.sqrt(1.0 + _c * _c)
    _CA[_i] = _c * _CS[_i]


def _imdct_mat(n: int) -> np.ndarray:
    """(n/2, n) basis: s[j] = sum_k X[k] cos(pi/(2n)(2j+1+n/2)(2k+1))."""
    j = np.arange(n)[None, :]
    k = np.arange(n // 2)[:, None]
    return np.cos(np.pi / (2 * n) * (2 * j + 1 + n // 2) * (2 * k + 1))


_IMDCT36 = _imdct_mat(36)          # (18, 36)
_IMDCT12 = _imdct_mat(12)          # (6, 12)

# block-type windows for the 36-sample IMDCT output
_WIN = np.zeros((4, 36))
_i = np.arange(36)
_WIN[0] = np.sin(np.pi / 36 * (_i + 0.5))                      # normal
_WIN[1, :18] = np.sin(np.pi / 36 * (_i[:18] + 0.5))            # start
_WIN[1, 18:24] = 1.0
_WIN[1, 24:30] = np.sin(np.pi / 12 * (_i[24:30] - 18 + 0.5))
_WIN[3, 6:12] = np.sin(np.pi / 12 * (_i[6:12] - 6 + 0.5))      # stop
_WIN[3, 12:18] = 1.0
_WIN[3, 18:] = np.sin(np.pi / 36 * (_i[18:] + 0.5))
_WIN12 = np.sin(np.pi / 12 * (np.arange(12) + 0.5))

# polyphase synthesis: matrixing N (64, 32) and window D (512,)
_NMAT = np.cos((16 + np.arange(64))[:, None]
               * (2 * np.arange(32) + 1)[None, :] * np.pi / 64)
_D = np.zeros(512)
_e = np.asarray(T.ENWINDOW, np.float64) / 65536.0
_D[:257] = _e
for _i2 in range(1, 256):
    _D[512 - _i2] = -_e[_i2] if (_i2 & 63) else _e[_i2]


# layers I/II scalefactors: 2.0 * 2^(-idx/3), idx 0..62
_SCALE_TAB = 2.0 * 2.0 ** (-np.arange(64) / 3.0)


def _l1_unscale(v, nb):
    """ISO 11172-3 layer I requantization (nb-bit code, all-ones
    excluded): x = (2^nb/(2^nb-1)) * ((v+1)*2^(1-nb) - 1)."""
    n = 1 << nb
    return (n / (n - 1.0)) * ((v + 1.0) * 2.0 / n - 1.0)


def _l2_unscale(v, steps):
    """Layer II requantization for a `steps`-level class (midtread):
    x = (2v + 1 - steps) / steps."""
    return (2.0 * v + 1.0 - steps) / steps


def _l2_select_table(kbps, nb_channels, freq, lsf):
    """Allocation-table selection (ISO 11172-3 2.4.2.3 note)."""
    if lsf:
        return 4
    ch_bitrate = kbps // nb_channels
    if (freq == 48000 and ch_bitrate >= 56) or 56 <= ch_bitrate <= 80:
        return 0
    if freq != 48000 and ch_bitrate >= 96:
        return 1
    if freq != 32000 and ch_bitrate <= 48:
        return 2
    return 3


def _parse_l2_records(flat, sblimit):
    """[bits, then (1<<bits)-1 class indices] records per subband."""
    recs = []
    pos = 0
    for _ in range(sblimit):
        nbits = flat[pos]
        recs.append(flat[pos:pos + (1 << nbits)])
        pos += 1 << nbits
    return recs


_L2_RECORDS = [
    _parse_l2_records(T.L2_ALLOC_TABLE_1, 27),
    _parse_l2_records(T.L2_ALLOC_TABLE_1, 30),
    _parse_l2_records(T.L2_ALLOC_TABLE_3, 8),
    _parse_l2_records(T.L2_ALLOC_TABLE_3, 12),
    _parse_l2_records(T.L2_ALLOC_TABLE_4, 30),
]


class _Granule:
    __slots__ = ("part2_3_length", "big_values", "global_gain",
                 "scalefac_compress", "window_switching", "block_type",
                 "mixed", "table_select", "subblock_gain",
                 "region0_count", "region1_count", "preflag",
                 "scalefac_scale", "count1table_select", "scalefac",
                 "scalefac_s")


class MP3Decoder:
    """Stateful frame decoder: feed whole frames (header included) in
    stream order; maintains the bit reservoir, IMDCT overlap and the
    polyphase FIFO."""

    def __init__(self):
        self._resv = b""
        self._overlap = None                # (ch, 32, 18)
        self._v = None                      # synthesis ring (ch, 16, 64)
        self.rate = 0
        self.channels = 0

    # ---------------------------------------------------------- layer 3
    def decode_frame(self, frame: bytes) -> np.ndarray:
        h = FrameHeader(frame)
        if self.channels and h.channels != self.channels:
            raise ValueError("mp3: channel count changed mid-stream")
        self.rate, self.channels = h.rate, h.channels
        ch = h.channels
        if self._overlap is None:
            self._overlap = np.zeros((ch, 32, 18))
            self._v = np.zeros((ch, 16, 64))
        if h.layer != 3:
            return self._decode_layer12(h, frame)

        off = 4 + (2 if h.crc else 0)
        side_len = ((17 if ch == 1 else 32) if not h.lsf
                    else (9 if ch == 1 else 17))
        side = Bits(frame[off:off + side_len])
        ngr = 1 if h.lsf else 2
        main_data_begin = side.read(8 if h.lsf else 9)
        side.read((5 if ch == 1 else 3) if not h.lsf
                  else (1 if ch == 1 else 2))
        scfsi = [[0] * 4 for _ in range(ch)]
        if not h.lsf:
            for c in range(ch):
                scfsi[c] = [side.read1() for _ in range(4)]
        grans: List[List[_Granule]] = []
        for gi in range(ngr):
            row = []
            for c in range(ch):
                g = _Granule()
                g.part2_3_length = side.read(12)
                g.big_values = side.read(9)
                g.global_gain = side.read(8)
                g.scalefac_compress = side.read(9 if h.lsf else 4)
                g.window_switching = side.read1()
                if g.window_switching:
                    g.block_type = side.read(2)
                    g.mixed = side.read1()
                    g.table_select = [side.read(5), side.read(5), 0]
                    g.subblock_gain = [side.read(3) for _ in range(3)]
                    if g.block_type == 0:
                        raise ValueError("mp3: bad block type")
                    # implied regions (ISO 2.4.2.7)
                    g.region0_count = 7 if g.block_type == 2 else 7
                    g.region1_count = 36
                else:
                    g.block_type = 0
                    g.mixed = False
                    g.table_select = [side.read(5) for _ in range(3)]
                    g.region0_count = side.read(4)
                    g.region1_count = side.read(3)
                    g.subblock_gain = [0, 0, 0]
                g.preflag = 0 if h.lsf else side.read1()
                g.scalefac_scale = side.read1()
                g.count1table_select = side.read1()
                row.append(g)
            grans.append(row)

        # bit reservoir: main data of this frame appended to the tail
        main = frame[off + side_len:h.frame_size if h.frame_size <=
                     len(frame) else len(frame)]
        resv = self._resv + main
        start = len(self._resv) - main_data_begin
        if start < 0:
            # not enough reservoir yet (stream start / seek): skip
            self._resv = resv[-511:]
            return np.zeros((0, ch))
        bits = Bits(resv, (len(self._resv) - main_data_begin) * 8)
        self._resv = resv[-511:]

        out_granules = []
        for gi in range(ngr):
            xr = np.zeros((ch, 576))
            for c in range(ch):
                g = grans[gi][c]
                try:
                    part2_start = bits.pos
                    if h.lsf:
                        self._read_scalefactors_lsf(
                            bits, g, c, h.mode_ext)
                    else:
                        self._read_scalefactors(
                            bits, g, c, gi, grans, scfsi[c])
                    x = self._huffman(bits, g, h, part2_start)
                except EndOfData:
                    x = np.zeros(576)
                xr[c] = self._requantize(x, g, h)
            self._stereo(xr, grans[gi], h)
            for c in range(ch):
                g = grans[gi][c]
                s = xr[c]
                if g.block_type == 2:
                    s = self._reorder(s, g, h)
                s = self._alias(s, g)
                td = self._imdct_granule(s, g, c)
                out_granules.append((c, td))
        # synthesis: per channel, concatenate granule slot matrices
        nslots = 18 * ngr
        pcm = np.zeros((nslots * 32, ch))
        slots_by_ch: List[List[np.ndarray]] = [[] for _ in range(ch)]
        for c, td in out_granules:
            slots_by_ch[c].append(td)
        for c in range(ch):
            slots = np.concatenate(slots_by_ch[c], axis=1)  # (32, nslots)
            pcm[:, c] = self._synth(slots.T, c)
        return pcm

    # ------------------------------------------------------ scalefactors
    def _read_scalefactors(self, bits, g, c, gi, grans, scfsi):
        slen1 = int(T.SLEN_TABLE[0][g.scalefac_compress])
        slen2 = int(T.SLEN_TABLE[1][g.scalefac_compress])
        g.scalefac = np.zeros(23, np.int32)
        g.scalefac_s = np.zeros((13, 3), np.int32)
        if g.block_type == 2:
            if g.mixed:
                for b in range(8):
                    g.scalefac[b] = bits.read(slen1)
                for b in range(3, 6):
                    for w in range(3):
                        g.scalefac_s[b, w] = bits.read(slen1)
            else:
                for b in range(6):
                    for w in range(3):
                        g.scalefac_s[b, w] = bits.read(slen1)
            for b in range(6, 12):
                for w in range(3):
                    g.scalefac_s[b, w] = bits.read(slen2)
        else:
            groups = [(0, 6, slen1), (6, 11, slen1),
                      (11, 16, slen2), (16, 21, slen2)]
            for k, (lo, hi, sl) in enumerate(groups):
                if gi == 1 and scfsi[k]:
                    g.scalefac[lo:hi] = grans[0][c].scalefac[lo:hi]
                else:
                    for b in range(lo, hi):
                        g.scalefac[b] = bits.read(sl)

    def _read_scalefactors_lsf(self, bits, g, c, mode_ext):
        sf = g.scalefac_compress
        slen = [0, 0, 0, 0]
        g.preflag = 0
        if (mode_ext & 1) and c == 1:
            sf >>= 1
            if sf < 180:
                slen[0] = sf // 36
                slen[1] = (sf % 36) // 6
                slen[2] = sf % 6
                tindex2 = 3
            elif sf < 244:
                sf -= 180
                slen[0] = (sf % 64) >> 4
                slen[1] = (sf % 16) >> 2
                slen[2] = sf & 3
                tindex2 = 4
            else:
                sf -= 244
                slen[0] = sf // 3
                slen[1] = sf % 3
                tindex2 = 5
        else:
            if sf < 400:
                slen[0] = (sf >> 4) // 5
                slen[1] = (sf >> 4) % 5
                slen[2] = (sf & 0xF) >> 2
                slen[3] = sf & 3
                tindex2 = 0
            elif sf < 500:
                sf -= 400
                slen[0] = (sf >> 2) // 5
                slen[1] = (sf >> 2) % 5
                slen[2] = sf & 3
                tindex2 = 1
            else:
                sf -= 500
                slen[0] = sf // 3
                slen[1] = sf % 3
                g.preflag = 1
                tindex2 = 2
        tindex = 0 if g.block_type != 2 else (2 if g.mixed else 1)
        nsf = T.LSF_NSF_TABLE[tindex2][tindex]
        g.scalefac = np.zeros(23, np.int32)
        g.scalefac_s = np.zeros((13, 3), np.int32)
        vals = []
        for k in range(4):
            for _ in range(int(nsf[k])):
                vals.append(bits.read(slen[k]) if slen[k] else 0)
        if g.block_type == 2:
            if g.mixed:
                for b in range(6):
                    g.scalefac[b] = vals.pop(0) if vals else 0
                b0 = 3
            else:
                b0 = 0
            for b in range(b0, 12):
                for w in range(3):
                    g.scalefac_s[b, w] = vals.pop(0) if vals else 0
        else:
            for b in range(min(21, len(vals))):
                g.scalefac[b] = vals[b]

    # ---------------------------------------------------------- huffman
    def _huffman(self, bits, g, h, part2_start):
        x = np.zeros(576)
        band_long = T.BAND_SIZE_LONG[h.rate_index]
        idx_long = np.cumsum([0] + list(band_long))
        if g.window_switching:
            # implied region boundary (ISO 2.4.2.7): 36 samples for
            # short blocks (72 at 8 kHz MPEG-2.5); start/stop blocks
            # use 36 at MPEG-1 rates, 54 at LSF rates, 108 at 8 kHz
            if g.block_type == 2:
                r0 = 72 if h.rate_index == 8 else 36
            elif h.rate_index <= 2:
                r0 = 36
            elif h.rate_index != 8:
                r0 = 54
            else:
                r0 = 108
            regions = [r0, 576, 576]
        else:
            r0 = idx_long[min(g.region0_count + 1, 22)]
            r1 = idx_long[min(g.region0_count + 1
                              + g.region1_count + 1, 22)]
            regions = [int(r0), int(r1), 576]
        limit = part2_start + g.part2_3_length
        pos = 0
        nbig = min(g.big_values * 2, 576)
        for r in range(3):
            end = min(regions[r], nbig)
            tsel = g.table_select[r]
            tab_idx, linbits = T.HUFF_DATA[tsel]
            if tsel in (0, 4, 14):
                # table 0 / unused tables decode as zeros
                pos = max(pos, end)
                continue
            hmap, maxlen = _BIG_MAPS[tab_idx - 1] if tab_idx else ({}, 0)
            while pos < end:
                if bits.pos >= limit:
                    raise EndOfData
                xv, yv = self._read_code(bits, hmap, maxlen)
                for v in (xv, yv):
                    val = 0.0
                    if v:
                        if v == 15 and linbits:
                            v += bits.read(linbits)
                        val = _POW43[v]
                        if bits.read1():
                            val = -val
                    x[pos] = val
                    pos += 1
            pos = end if pos < end else pos
        # count1 region
        while pos <= 572 and bits.pos < limit:
            if g.count1table_select:
                sym = 15 - bits.read(4)
            else:
                sym = self._read_quad(bits)
            for b in range(4):
                if sym & (8 >> b):
                    v = 1.0
                    if bits.read1():
                        v = -1.0
                    x[pos] = v
                pos += 1
            if bits.pos > limit:
                # the last quadruple overran part2_3_length: discard it
                x[pos - 4:pos] = 0.0
                pos -= 4
                break
        bits.pos = limit
        return x

    @staticmethod
    def _read_code(bits, hmap, maxlen):
        code = 0
        for length in range(1, maxlen + 1):
            code = (code << 1) | bits.read1()
            v = hmap.get((length, code))
            if v is not None:
                return v
        raise ValueError("mp3: invalid huffman code")

    @staticmethod
    def _read_quad(bits):
        code = 0
        for length in range(1, 7):
            code = (code << 1) | bits.read1()
            v = _QUAD_A.get((length, code))
            if v is not None:
                return v
        raise ValueError("mp3: invalid count1 code")

    # ------------------------------------------------------ requantize
    def _requantize(self, x, g, h):
        band_long = T.BAND_SIZE_LONG[h.rate_index]
        band_short = T.BAND_SIZE_SHORT[h.rate_index]
        gain = 2.0 ** (0.25 * (g.global_gain - 210))
        mult = 2 if g.scalefac_scale else 1
        out = x.copy()
        if g.block_type == 2:
            pos = 0
            if g.mixed:
                # first 36 samples (2 subbands) use long bands
                b = 0
                while pos < 36:
                    w = int(band_long[b])
                    sf = int(g.scalefac[b]) + (int(T.PRETAB[b])
                                               if g.preflag else 0)
                    out[pos:pos + w] *= gain * 2.0 ** (
                        -0.5 * mult * sf)
                    pos += w
                    b += 1
                sb_start = 3
            else:
                sb_start = 0
            for b in range(sb_start, 13):
                w = int(band_short[b])
                for win in range(3):
                    if pos >= 576:
                        break
                    sf = int(g.scalefac_s[min(b, 12), win])
                    f = gain * 2.0 ** (
                        -2.0 * g.subblock_gain[win]
                        - 0.5 * mult * sf)
                    out[pos:pos + w] *= f
                    pos += w
        else:
            pos = 0
            for b in range(22):
                w = int(band_long[b])
                sf = int(g.scalefac[b] if b < 21 else 0)
                if g.preflag and b < 22:
                    sf += int(T.PRETAB[b])
                out[pos:pos + w] *= gain * 2.0 ** (-0.5 * mult * sf)
                pos += w
        return out

    # ---------------------------------------------------------- stereo
    def _stereo(self, xr, grans, h):
        if h.channels != 2:
            return
        ms = bool(h.mode_ext & 2)
        intensity = bool(h.mode_ext & 1)
        if ms and not intensity:
            m = xr[0].copy()
            s = xr[1].copy()
            inv = 1.0 / math.sqrt(2.0)
            xr[0] = (m + s) * inv
            xr[1] = (m - s) * inv
            return
        if not intensity:
            return
        # intensity stereo: applied above the right channel's last
        # nonzero scalefactor band (ISO 2.4.3.4.9.3); MS applies below
        g_r = grans[1]
        band_long = T.BAND_SIZE_LONG[h.rate_index]
        idx = np.cumsum([0] + list(band_long))
        nz = np.nonzero(xr[1])[0]
        bound = (int(nz[-1]) + 1) if len(nz) else 0
        # round bound up to a band edge
        b0 = int(np.searchsorted(idx, bound))
        start = int(idx[min(b0, 21)])
        if ms:
            inv = 1.0 / math.sqrt(2.0)
            m = xr[0][:start].copy()
            s = xr[1][:start].copy()
            xr[0][:start] = (m + s) * inv
            xr[1][:start] = (m - s) * inv
        for b in range(min(b0, 21), 21):
            lo, hi = int(idx[b]), int(idx[b + 1])
            is_pos = int(g_r.scalefac[b])
            if is_pos >= 7:
                continue
            if h.lsf:
                e = (is_pos + 1) >> 1
                io = 2.0 ** (-0.25 * (1 + (g_r.scalefac_compress & 1)))
                if is_pos == 0:
                    kl = kr = 1.0
                elif is_pos & 1:
                    kl, kr = io ** e, 1.0
                else:
                    kl, kr = 1.0, io ** e
            else:
                ratio = math.tan(is_pos * math.pi / 12.0)
                kl = ratio / (1.0 + ratio)
                kr = 1.0 / (1.0 + ratio)
            v = xr[0][lo:hi].copy()
            xr[0][lo:hi] = v * kl
            xr[1][lo:hi] = v * kr

    # --------------------------------------------------------- reorder
    def _reorder(self, s, g, h):
        band_short = T.BAND_SIZE_SHORT[h.rate_index]
        out = s.copy()
        pos = 36 if g.mixed else 0
        b = 3 if g.mixed else 0
        while b < 13 and pos < 576:
            w = int(band_short[b])
            if pos + 3 * w > 576:
                break
            src = s[pos:pos + 3 * w].reshape(3, w)
            out[pos:pos + 3 * w] = src.T.ravel()
            pos += 3 * w
            b += 1
        return out

    def _alias(self, s, g):
        if g.block_type == 2 and not g.mixed:
            return s
        n_b = 1 if (g.block_type == 2 and g.mixed) else 31
        out = s.copy()
        for sb in range(1, n_b + 1):
            base = 18 * sb
            lo = out[base - 1 - np.arange(8)].copy()
            hi = out[base + np.arange(8)].copy()
            out[base - 1 - np.arange(8)] = lo * _CS - hi * _CA
            out[base + np.arange(8)] = hi * _CS + lo * _CA
        return out

    # ------------------------------------------------------------ imdct
    def _imdct_granule(self, s, g, c):
        """(576,) spectral -> (32, 18) time-domain slots with overlap."""
        X = s.reshape(32, 18)
        out = np.zeros((32, 36))
        if g.block_type == 2:
            n_long = 2 if g.mixed else 0
            if n_long:
                out[:n_long] = (X[:n_long] @ _IMDCT36) * _WIN[0]
            Xs = X[n_long:]                       # (nsb, 18)
            # deinterleave windows: coef order is [k][window]
            xs = Xs.reshape(-1, 6, 3).transpose(0, 2, 1)  # (nsb, 3, 6)
            td = (xs.reshape(-1, 6) @ _IMDCT12) * _WIN12  # (nsb*3, 12)
            td = td.reshape(-1, 3, 12)
            block = np.zeros((td.shape[0], 36))
            block[:, 6:18] += td[:, 0]
            block[:, 12:24] += td[:, 1]
            block[:, 18:30] += td[:, 2]
            out[n_long:] = block
        else:
            out = (X @ _IMDCT36) * _WIN[g.block_type]
        # overlap-add: first half + stored second half of previous
        res = out[:, :18] + self._overlap[c]
        self._overlap[c] = out[:, 18:]
        # frequency inversion: odd subbands, odd time samples
        res[1::2, 1::2] = -res[1::2, 1::2]
        return res                                  # (32, 18)

    # -------------------------------------------------------- synthesis
    def _synth(self, slots, c):
        """(nslots, 32) subband slots -> (nslots*32,) PCM (ISO A.2
        polyphase: matrixing batched as one matmul, window fold)."""
        vnew = slots @ _NMAT.T                      # (nslots, 64)
        out = np.empty(len(slots) * 32)
        v = self._v[c]
        u = np.empty(512)
        for t in range(len(slots)):
            v = np.roll(v, 1, axis=0)
            v[0] = vnew[t]
            for i in range(8):
                u[i * 64:i * 64 + 32] = v[2 * i][:32]
                u[i * 64 + 32:i * 64 + 64] = v[2 * i + 1][32:]
            w = u * _D
            out[t * 32:(t + 1) * 32] = w.reshape(16, 32).sum(axis=0)
        self._v[c] = v
        return out

    # ------------------------------------------------------ layers 1/2
    def _decode_layer12(self, h, frame):
        off = 4 + (2 if h.crc else 0)
        bits = Bits(frame[off:])
        ch = h.channels
        if h.layer == 1:
            S = self._read_layer1(bits, h)
        else:
            S = self._read_layer2(bits, h)
        nslots = S.shape[1]
        pcm = np.zeros((nslots * 32, ch))
        for c in range(ch):
            pcm[:, c] = self._synth(S[c], c)
        return pcm

    def _read_layer1(self, bits, h):
        ch = h.channels
        bound = min((h.mode_ext + 1) * 4, 32) if h.mode == 1 else 32
        alloc = np.zeros((ch, 32), np.int32)
        for sb in range(32):
            if sb < bound:
                for c in range(ch):
                    alloc[c, sb] = bits.read(4)
            else:
                a = bits.read(4)
                alloc[:, sb] = a
        sf = np.zeros((ch, 32), np.int32)
        for sb in range(32):
            for c in range(ch):
                if alloc[c, sb]:
                    sf[c, sb] = bits.read(6)
        S = np.zeros((ch, 12, 32))
        for t in range(12):
            for sb in range(32):
                if sb < bound:
                    for c in range(ch):
                        nb = int(alloc[c, sb])
                        if nb:
                            v = bits.read(nb + 1)
                            S[c, t, sb] = (_l1_unscale(v, nb + 1)
                                           * _SCALE_TAB[sf[c, sb]])
                else:
                    nb = int(alloc[0, sb])
                    if nb:
                        v = bits.read(nb + 1)
                        for c in range(ch):
                            S[c, t, sb] = (_l1_unscale(v, nb + 1)
                                           * _SCALE_TAB[sf[c, sb]])
        return S

    def _read_layer2(self, bits, h):
        ch = h.channels
        table = _l2_select_table(h.bitrate // 1000, ch, h.rate, h.lsf)
        sblimit = int(T.L2_SBLIMIT[table])
        records = _L2_RECORDS[table]
        bound = min((h.mode_ext + 1) * 4, sblimit) \
            if h.mode == 1 else sblimit
        alloc = np.zeros((ch, sblimit), np.int32)
        for sb in range(sblimit):
            abits = records[sb][0]
            if sb < bound:
                for c in range(ch):
                    alloc[c, sb] = bits.read(abits)
            else:
                alloc[:, sb] = bits.read(abits)
        scfsi = np.zeros((ch, sblimit), np.int32)
        for sb in range(sblimit):
            for c in range(ch):
                if alloc[c, sb]:
                    scfsi[c, sb] = bits.read(2)
        sf = np.zeros((ch, sblimit, 3), np.int32)
        for sb in range(sblimit):
            for c in range(ch):
                if not alloc[c, sb]:
                    continue
                m = scfsi[c, sb]
                if m == 0:
                    a, b, d = (bits.read(6) for _ in range(3))
                elif m == 1:
                    a = b = bits.read(6)
                    d = bits.read(6)
                elif m == 2:
                    a = b = d = bits.read(6)
                else:
                    a = bits.read(6)
                    b = d = bits.read(6)
                sf[c, sb] = (a, b, d)
        S = np.zeros((ch, 36, 32))
        for gr in range(12):
            part = gr // 4
            for sb in range(sblimit):
                for c in range(ch if sb < bound else 1):
                    a = int(alloc[c, sb])
                    if not a:
                        continue
                    qclass = records[sb][a]
                    steps = int(T.L2_QUANT_STEPS[qclass])
                    qb = int(T.L2_QUANT_BITS[qclass])
                    if qb < 0:                       # grouped
                        code = bits.read(-qb)
                        samples = []
                        for _ in range(3):
                            samples.append(code % steps)
                            code //= steps
                    else:
                        samples = [bits.read(qb) for _ in range(3)]
                    targets = (range(ch) if sb >= bound and ch == 2
                               else (c,))
                    for k in range(3):
                        val = _l2_unscale(samples[k], steps)
                        for cc in (targets if isinstance(targets, range)
                                   else targets):
                            S[cc, gr * 3 + k, sb] = \
                                val * _SCALE_TAB[sf[cc, sb, part]]
        return S


def parse_xing(frame: bytes, h: FrameHeader):
    """Detect a Xing/Info (+LAME) tag frame.  Returns
    (frames, encoder_delay, encoder_padding) or None.  The tag frame
    carries no audio; the LAME extension's delay/padding fields drive
    gapless trimming (as mpg123 does by default)."""
    side_len = ((17 if h.channels == 1 else 32) if not h.lsf
                else (9 if h.channels == 1 else 17))
    off = 4 + (2 if h.crc else 0) + side_len
    magic = frame[off:off + 4]
    if magic not in (b"Xing", b"Info"):
        return None
    import struct
    pos = off + 4
    flags = struct.unpack(">I", frame[pos:pos + 4])[0]
    pos += 4
    frames = 0
    if flags & 1:
        frames = struct.unpack(">I", frame[pos:pos + 4])[0]
        pos += 4
    if flags & 2:
        pos += 4
    if flags & 4:
        pos += 100
    if flags & 8:
        pos += 4
    delay = padding = 0
    if frame[pos:pos + 4] == b"LAME" or frame[pos:pos + 4] == b"Lavf":
        # LAME tag: delay/padding packed in 3 bytes at offset 21
        dp = frame[pos + 21:pos + 24]
        if len(dp) == 3:
            delay = (dp[0] << 4) | (dp[1] >> 4)
            padding = ((dp[1] & 0xF) << 8) | dp[2]
    return frames, delay, padding


def _find_frames(data: bytes):
    """Yield whole frames at header syncs (resync on garbage)."""
    pos = 0
    while pos + 4 <= len(data):
        try:
            h = FrameHeader(data[pos:pos + 4])
        except ValueError:
            pos += 1
            continue
        if pos + h.frame_size > len(data):
            break
        yield data[pos:pos + h.frame_size], h
        pos += max(h.frame_size, 1)


def decode(data: bytes, gapless: bool = True
           ) -> Tuple[np.ndarray, int, int]:
    """Whole mp3 stream -> (float64 (n, ch), rate, channels).

    With gapless=True (the mpg123 default behavior), a leading
    Xing/Info+LAME tag frame is skipped and the encoder delay (+529
    filterbank delay) and padding are trimmed."""
    dec = MP3Decoder()
    chunks = []
    first = True
    trim = None
    for frame, h in _find_frames(data):
        if first:
            first = False
            tag = (parse_xing(frame, h)
                   if gapless and h.layer == 3 else None)
            if tag is not None:
                if tag[1] or tag[2]:
                    trim = (tag[1], tag[2])
                continue                      # tag frame: no audio
        try:
            pcm = dec.decode_frame(frame)
        except (ValueError, EndOfData):
            continue
        if len(pcm):
            chunks.append(pcm)
    if not chunks:
        raise ValueError("mp3: no decodable frames")
    out = np.concatenate(chunks, axis=0)
    if trim is not None:
        delay, padding = trim
        start = delay + 529
        end = len(out) - max(padding - 529, 0)
        out = out[start:max(start, end)]
    return out, dec.rate, dec.channels
