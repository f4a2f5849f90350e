"""Clean-room Siren7 (ITU-T G.722.1 at 16 kHz / 16 kbit/s) codec.

Siren7 is Polycom's G.722.1 variant used by MSN Messenger: 320-sample
(20 ms) frames at 16 kHz, coded at 16 kbit/s → 40-byte frames, mono.
It is a pure transform codec:

  RMLT (modulated lapped transform, 50% overlap, DCT-IV core)
    → 14 regions × 20 coefficients
    → per-region RMS power, differentially Huffman-coded (envelope)
    → categorization procedure assigning each region a quantization
      category 0-7 from the power envelope and the bit budget
    → scalar quantization + SQVH (vector Huffman) per region
    → 4-bit rate-control index selecting how many category bumps the
      decoder must replay to land on the encoder's actual bit usage

The re-specification here follows the behavior of the reference
element's bundled implementation
(gst-plugins-bad/gst/siren/{common,decoder,encoder,huffman,rmlt,dct4}.c:1,
element gstsirendec.c:1/gstsirenenc.c:1) and the published G.722.1
algorithm description; normative constant tables live in
``_siren_tables.py``.  All code is original: the DCT-IV is one matmul
(the reference uses a split-radix float butterfly network computing
the same transform), the Huffman decode trees are derived from the
normative (code, bitcount) tables at import time rather than carried
as opaque arrays, and the per-frame loops are vectorized numpy.

Frames are 16-bit big-endian words on the wire; bits are MSB-first
within each word.

A copy of the JAX package's ``codecs/siren.py`` (host numpy, its dtypes
kept: the encoder stays bit-identical).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import _siren_tables as T

# ---------------------------------------------------------------------------
# codec configuration (GetSirenCodecInfo flag=1, the element's mode)

REGION_SIZE = 20
STEPSIZE = 0.3010299957  # 2*log10(sqrt(2))

EXPECTED_BITS = [52, 47, 43, 37, 29, 22, 16, 0]
VECTOR_DIMENSION = [2, 2, 2, 4, 4, 5, 5, 1]
NUMBER_OF_VECTORS = [10, 10, 10, 5, 5, 4, 4, 20]
DEAD_ZONE = [0.3, 0.33, 0.36, 0.39, 0.42, 0.45, 0.5, 0.5]
MAX_BIN = [13, 9, 6, 4, 3, 2, 1, 1]
STEP_SIZE = [0.3536, 0.5, 0.70709997, 1.0, 1.4141999, 2.0,
             2.8283999, 2.8283999]
INDEX_BITS = [4, 4, 3, 3, 2, 2, 1, 0]  # bits per dimension in decode index

_CHECKSUM_TABLE = (0x7F80, 0x7878, 0x6666, 0x5555)


class SirenConfig:
    """flag=1 family (fixed sample-rate code in each frame)."""

    def __init__(self, sample_rate: int = 16000):
        if sample_rate == 16000:
            self.sample_rate_code = 1
        elif sample_rate == 24000:
            self.sample_rate_code = 2
        elif sample_rate == 32000:
            self.sample_rate_code = 3
        else:
            raise ValueError(f"unsupported siren sample rate {sample_rate}")
        self.sample_rate = sample_rate
        self.number_of_coefs = 320
        self.sample_rate_bits = 2
        self.rate_control_bits = 4
        self.rate_control_possibilities = 16
        self.checksum_bits = 4
        self.esf_adjustment = -2
        self.scale_factor = 1
        self.number_of_regions = 14
        self.bits_per_frame = sample_rate // 50
        self.bytes_per_frame = self.bits_per_frame // 8


# ---------------------------------------------------------------------------
# derived tables

_STANDARD_DEVIATION = np.sqrt(
    10.0 ** ((np.arange(64) - 24) * STEPSIZE)).astype(np.float32)
_DEVIATION_INVERSE = (1.0 / _STANDARD_DEVIATION).astype(np.float32)
_POWER_BOUNDARY = (10.0 ** ((np.arange(63) - 24 + 0.5) * STEPSIZE)
                   ).astype(np.float32)
_STEP_SIZE_INV = np.float32(1.0) / np.asarray(STEP_SIZE, np.float32)


def _dct4_matrix(n: int) -> np.ndarray:
    """Orthonormal-ish DCT-IV used by G.722.1: scale sqrt(2/N).

    X[k] = sqrt(2/N) * sum_j x[j] * cos((j+0.5)(k+0.5)*pi/N); with this
    scale the transform is its own inverse, which is what lets the
    decoder reuse the same routine.
    """
    j = np.arange(n)[None, :] + 0.5
    k = np.arange(n)[:, None] + 0.5
    return (np.sqrt(2.0 / n) * np.cos(j * k * np.pi / n)).astype(np.float64)


_DCT4_320 = _dct4_matrix(320)
_W320 = np.sin((np.arange(320) + 0.5) * (np.pi / 2) / 320).astype(np.float64)


def _build_tree(codes: List[int], bits: List[int],
                values: List[int]) -> List[List[int]]:
    """Build a binary Huffman decode tree from (code, bitcount) pairs.

    Returns a flat node list; node = [left, right] where an entry
    >= 0 is the index of the next internal node and an entry < 0
    holds ~value (bitwise complement, so value 0 is representable).
    """
    nodes: List[List[Optional[int]]] = [[None, None]]
    for code, nbits, value in zip(codes, bits, values):
        if nbits <= 0:
            continue
        idx = 0
        ok = True
        for pos in range(nbits - 1, -1, -1):
            bit = (code >> pos) & 1
            if pos == 0:
                # the normative SQVH tables share one codeword between
                # several saturated quantizer indices; the canonical
                # decoder resolves to the first (lowest) index, so keep
                # the first assignment and ignore later duplicates
                if nodes[idx][bit] is None:
                    nodes[idx][bit] = -1 - value  # leaf: ~value
            else:
                nxt = nodes[idx][bit]
                if nxt is None:
                    nodes.append([None, None])
                    nxt = len(nodes) - 1
                    nodes[idx][bit] = nxt
                elif nxt < 0:
                    ok = False  # duplicate prefix of an earlier leaf
                    break
                idx = nxt
        del ok
    return [[(-1 if c is None else c) for c in n] for n in nodes]


def _radix_to_fields(index: int, category: int) -> int:
    """Map the encoder's radix-(max_bin+1) vector index (MSB-first
    digit order) to the decoder's packed binary-field index (low field
    = first coefficient of the vector)."""
    vdim = VECTOR_DIMENSION[category]
    base = MAX_BIN[category] + 1
    fbits = INDEX_BITS[category]
    digits = []
    for _ in range(vdim):
        digits.append(index % base)
        index //= base
    digits.reverse()  # MSB-first → d[0] is the first coefficient
    out = 0
    for j, d in enumerate(digits):
        out |= d << (fbits * j)
    return out


_CODE_TABLES = [
    (T.CODE_TABLE_CATEGORY0, T.BITCOUNT_TABLE_CATEGORY0),
    (T.CODE_TABLE_CATEGORY1, T.BITCOUNT_TABLE_CATEGORY1),
    (T.CODE_TABLE_CATEGORY2, T.BITCOUNT_TABLE_CATEGORY2),
    (T.CODE_TABLE_CATEGORY3, T.BITCOUNT_TABLE_CATEGORY3),
    (T.CODE_TABLE_CATEGORY4, T.BITCOUNT_TABLE_CATEGORY4),
    (T.CODE_TABLE_CATEGORY5, T.BITCOUNT_TABLE_CATEGORY5),
    (T.CODE_TABLE_CATEGORY6, T.BITCOUNT_TABLE_CATEGORY6),
]


def _vector_trees():
    trees = []
    for cat, (codes, bits) in enumerate(_CODE_TABLES):
        n = (MAX_BIN[cat] + 1) ** VECTOR_DIMENSION[cat]
        values = [_radix_to_fields(i, cat) for i in range(n)]
        trees.append(_build_tree(codes[:n], bits[:n], values))
    return trees


_VECTOR_TREES = _vector_trees()

# differential envelope decode trees: encoder writes the Huffman code
# for symbol (diff+12); leaves hold the symbol and the decoder
# computes arpi = prev + symbol - 12.
_ENVELOPE_TREES = [
    _build_tree(T.DIFFERENTIAL_REGION_POWER_CODES[r],
                T.DIFFERENTIAL_REGION_POWER_BITS[r],
                list(range(24)))
    for r in range(27)
]

_MLT_QUANT = [np.asarray(q, np.float32) for q in T.MLT_QUANT]
_NOISE5 = np.asarray(T.NOISE_CATEGORY5, np.float32)
_NOISE6 = np.asarray(T.NOISE_CATEGORY6, np.float32)
_NOISE7 = np.float32(T.NOISE_CATEGORY7)


# ---------------------------------------------------------------------------
# bitstream


class _BitReader:
    def __init__(self, words: np.ndarray):
        self.words = words.astype(np.int64) & 0xFFFF
        self.word_idx = 0
        self.bit_idx = 0  # bits remaining in current word
        self.cur = 0

    def bit(self) -> int:
        if self.bit_idx == 0:
            self.cur = int(self.words[self.word_idx])
            self.word_idx += 1
            self.bit_idx = 16
        self.bit_idx -= 1
        return (self.cur >> self.bit_idx) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


class _BitWriter:
    """MSB-first writer into 16-bit words."""

    def __init__(self):
        self.words: List[int] = []
        self.cur = 0
        self.left = 16

    def put(self, value: int, nbits: int):
        while nbits > 0:
            take = min(nbits, self.left)
            chunk = (value >> (nbits - take)) & ((1 << take) - 1)
            self.cur |= chunk << (self.left - take)
            self.left -= take
            nbits -= take
            if self.left == 0:
                self.words.append(self.cur)
                self.cur = 0
                self.left = 16

    def bits_written(self) -> int:
        return len(self.words) * 16 + (16 - self.left)


def _checksum(words: List[int], bits_per_frame: int,
              checksum_bits: int) -> int:
    nwords = bits_per_frame >> 4
    s = 0
    for idx in range(nwords):
        s ^= (words[idx] & 0xFFFF) << (idx % 15)
    s = (s >> 15) ^ (s & 0x7FFF)
    out = 0
    for i in range(4):
        t1 = _CHECKSUM_TABLE[i] & s
        for j in (8, 4, 2, 1):
            t1 ^= t1 >> j
        out = (out << 1) | (t1 & 1)
    return out


# ---------------------------------------------------------------------------
# RMLT (modulated lapped transform)


def rmlt_encode(samples: np.ndarray, old: np.ndarray) -> np.ndarray:
    """samples: (320,) float; old: (160,) carried window state
    (mutated).  Returns 320 MLT coefficients."""
    n, h = 320, 160
    w = _W320
    i = np.arange(h)
    coefs = np.empty(n, np.float64)
    coefs[:h] = old
    s_lo = samples[i]
    s_hi = samples[n - 1 - i]
    coefs[h:] = s_lo * w[n - 1 - i] - s_hi * w[i]
    old[h - 1 - i] = s_hi * w[n - 1 - i] + s_lo * w[i]
    return _DCT4_320 @ coefs


def rmlt_decode(coefs: np.ndarray, old: np.ndarray) -> np.ndarray:
    """coefs: (320,); old: (160,) carried state (mutated).
    Returns 320 output samples."""
    n, h = 320, 160
    w = _W320
    d = _DCT4_320 @ coefs
    k = np.arange(h // 2)  # quarter-frame index, 80 entries
    out = np.empty(n, np.float64)
    old_lo = old[k].copy()            # old[k]
    old_hi = old[h - 1 - k].copy()    # old[159-k]
    out[k] = old_lo * w[n - 1 - k] + d[h - 1 - k] * w[k]
    out[n - 1 - k] = d[h - 1 - k] * w[n - 1 - k] - old_lo * w[k]
    out[h + k] = d[k] * w[h + k] - old_hi * w[h - 1 - k]
    out[h - 1 - k] = old_hi * w[h + k] + d[k] * w[h - 1 - k]
    old[k] = d[h + k]
    old[h - 1 - k] = d[n - 1 - k]
    return out


# ---------------------------------------------------------------------------
# envelope + categorization (shared encoder/decoder logic)


def categorize_regions(number_of_regions: int, available_bits: int,
                       arpi: List[int]) -> Tuple[List[int], List[int]]:
    """Port of the G.722.1 categorization procedure: returns the
    initial per-region power categories and the category-balance
    adjustment order the rate-control index replays."""
    if number_of_regions == 14:
        num_rc = 16
        if available_bits > 320:
            available_bits = ((available_bits - 320) * 5 // 8) + 320
    else:
        num_rc = 32
        if number_of_regions == 28 and available_bits > 640:
            available_bits = ((available_bits - 640) * 5 // 8) + 640

    offset = -32
    delta = 32
    while delta > 0:
        expected = 0
        for region in range(number_of_regions):
            i = (delta + offset - arpi[region]) >> 1
            i = min(7, max(0, i))
            expected += EXPECTED_BITS[i]
        if expected >= available_bits - 32:
            offset += delta
        delta //= 2

    cats = []
    expected = 0
    for region in range(number_of_regions):
        i = (offset - arpi[region]) >> 1
        i = min(7, max(0, i))
        cats.append(i)
        expected += EXPECTED_BITS[i]

    min_rate = list(cats)
    max_rate = list(cats)
    lo = hi = expected
    # temp balance list indexed around the midpoint, as in the spec:
    # raising a category saves bits (appended forward), lowering one
    # spends bits (prepended backward)
    fwd: List[int] = []
    bwd: List[int] = []
    for _ in range(num_rc - 1):
        if lo + hi > available_bits * 2:
            best, best_region = -99, 0
            for region in range(number_of_regions - 1, -1, -1):
                if min_rate[region] < 7:
                    t = offset - arpi[region] - 2 * min_rate[region]
                    if t > best:
                        best, best_region = t, region
            fwd.append(best_region)
            lo += (EXPECTED_BITS[min_rate[best_region] + 1]
                   - EXPECTED_BITS[min_rate[best_region]])
            min_rate[best_region] += 1
        else:
            best, best_region = 99, 0
            for region in range(number_of_regions):
                if max_rate[region] > 0:
                    t = offset - arpi[region] - 2 * max_rate[region]
                    if t < best:
                        best, best_region = t, region
            bwd.append(best_region)
            hi += (EXPECTED_BITS[max_rate[best_region] - 1]
                   - EXPECTED_BITS[max_rate[best_region]])
            max_rate[best_region] -= 1

    # the reference's rate-control up-walk can index one slot past the
    # num_rc-1 recorded adjustments; its zero-initialized array makes
    # that read region 0, so mirror it with an explicit trailing 0
    balance = list(reversed(bwd)) + fwd + [0]
    return max_rate, balance


def compute_region_powers(coefs: np.ndarray, cfg: SirenConfig
                          ) -> Tuple[List[int], List[Tuple[int, int]]]:
    """Encoder side: quantize per-region RMS power; returns the
    absolute indices and the (nbits, code) envelope codewords."""
    nreg = cfg.number_of_regions
    esf = cfg.esf_adjustment
    power = (coefs[:nreg * REGION_SIZE].reshape(nreg, REGION_SIZE)
             .astype(np.float32))
    region_power = np.sum(power * power, axis=1) / REGION_SIZE
    arpi = []
    for region in range(nreg):
        lo_i, hi_i = 0, 64
        for _ in range(6):
            mid = (lo_i + hi_i) // 2
            if _POWER_BOUNDARY[mid - 1] <= region_power[region]:
                lo_i = mid
            else:
                hi_i = mid
        arpi.append(lo_i - 24)

    for region in range(nreg - 2, -1, -1):
        if arpi[region] < arpi[region + 1] - 11:
            arpi[region] = arpi[region + 1] - 11

    arpi[0] = min(max(arpi[0], 1 - esf), 31 - esf)
    for region in range(1, nreg):
        arpi[region] = min(max(arpi[region], -8 - esf), 31 - esf)

    codes = [(5, arpi[0] + esf)]
    for region in range(nreg - 1):
        idx = arpi[region + 1] - arpi[region] + 12
        idx = max(idx, 0)
        arpi[region + 1] = arpi[region] + idx - 12
        codes.append((T.DIFFERENTIAL_REGION_POWER_BITS[region][idx],
                      T.DIFFERENTIAL_REGION_POWER_CODES[region][idx]))
    return arpi, codes


# ---------------------------------------------------------------------------
# decoder


class SirenDecoder:
    def __init__(self, sample_rate: int = 16000):
        self.cfg = SirenConfig(sample_rate)
        self.context = np.zeros(160, np.float64)
        self.backup_frame = np.zeros(
            self.cfg.number_of_regions * REGION_SIZE, np.float32)
        self._dw = [1, 1, 1, 1]

    # the reference's four-word lagged-Fibonacci noise generator
    def _get_dw(self) -> int:
        ret = (self._dw[0] + self._dw[3]) & 0xFFFFFFFF
        if ret & 0x8000:
            ret = (ret + 1) & 0xFFFFFFFF
        self._dw = [self._dw[1], self._dw[2], self._dw[3], ret]
        return ret

    def _decode_envelope(self, br: _BitReader
                         ) -> Tuple[List[int], np.ndarray, int]:
        cfg = self.cfg
        arpi = [br.bits(5) - cfg.esf_adjustment]
        envelope_bits = 5
        for i in range(1, cfg.number_of_regions):
            tree = _ENVELOPE_TREES[i - 1]
            idx = 0
            while True:
                idx = tree[idx][br.bit()]
                envelope_bits += 1
                if idx < 0:
                    symbol = -1 - idx
                    break
            val = min(max(arpi[i - 1] + symbol - 12, -24), 39)
            arpi.append(val)
        stddev = _STANDARD_DEVIATION[np.asarray(arpi) + 24]
        return arpi, stddev, envelope_bits

    def decode_frame(self, frame: bytes) -> np.ndarray:
        """Decode one 40-byte frame → 320 int16 samples."""
        cfg = self.cfg
        if len(frame) < cfg.bytes_per_frame:
            raise ValueError("short siren frame")
        words = np.frombuffer(frame[:cfg.bytes_per_frame], ">u2"
                              ).astype(np.int64)
        br = _BitReader(words)

        if br.bits(cfg.sample_rate_bits) != cfg.sample_rate_code:
            return self._conceal()

        available = (cfg.bits_per_frame - cfg.sample_rate_bits
                     - cfg.checksum_bits)
        arpi, stddev, env_bits = self._decode_envelope(br)
        available -= env_bits
        rate_control = br.bits(cfg.rate_control_bits)
        available -= cfg.rate_control_bits

        cats, balance = categorize_regions(cfg.number_of_regions,
                                           available, arpi)
        for i in range(rate_control):
            cats[balance[i]] += 1

        coefs, available, err = self._decode_vectors(
            br, cats, stddev, available)
        if err:
            available = -1

        frame_error = 0
        if available > 0:
            for _ in range(available):
                if br.bit() == 0:
                    frame_error |= 1
        elif (available < 0
              and rate_control + 1 < cfg.rate_control_possibilities):
            frame_error |= 2
        for v in arpi:
            if v > 33 or v < -31:
                frame_error |= 4

        if cfg.checksum_bits:
            got = int(words[-1]) & ((1 << cfg.checksum_bits) - 1)
            w = list(words)
            w[-1] &= ~((1 << cfg.checksum_bits) - 1)
            if got != _checksum(w, cfg.bits_per_frame, cfg.checksum_bits):
                frame_error |= 8

        nvalid = cfg.number_of_regions * REGION_SIZE
        if frame_error:
            coefs = self.backup_frame.copy()
            self.backup_frame[:] = 0
        else:
            self.backup_frame = coefs[:nvalid].copy()

        full = np.zeros(cfg.number_of_coefs, np.float64)
        full[:nvalid] = coefs[:nvalid]
        out = rmlt_decode(full, self.context)
        return np.clip(np.trunc(out), -32768, 32767).astype(np.int16)

    def _conceal(self) -> np.ndarray:
        coefs = self.backup_frame.copy()
        self.backup_frame[:] = 0
        full = np.zeros(self.cfg.number_of_coefs, np.float64)
        full[:len(coefs)] = coefs
        out = rmlt_decode(full, self.context)
        return np.clip(np.trunc(out), -32768, 32767).astype(np.int16)

    def _decode_vectors(self, br: _BitReader, cats: List[int],
                        stddev: np.ndarray, available: int
                        ) -> Tuple[np.ndarray, int, bool]:
        cfg = self.cfg
        nreg = cfg.number_of_regions
        coefs = np.zeros(nreg * REGION_SIZE, np.float32)
        error = False
        for region in range(nreg):
            cat = cats[region]
            base = region * REGION_SIZE
            if cat < 7:
                tree = _VECTOR_TREES[cat]
                fbits = INDEX_BITS[cat]
                quant = _MLT_QUANT[cat]
                pos = base
                for _ in range(NUMBER_OF_VECTORS[cat]):
                    idx = 0
                    while True:
                        if available <= 0:
                            error = True
                            break
                        idx = tree[idx][br.bit()]
                        available -= 1
                        if idx < 0:
                            idx = -1 - idx
                            break
                    if error or available < 0:
                        error = True
                        break
                    for _j in range(VECTOR_DIMENSION[cat]):
                        d = idx & ((1 << fbits) - 1)
                        idx >>= fbits
                        val = float(quant[d])
                        if val != 0.0:
                            if br.bit() == 0:
                                val = -val * float(stddev[region])
                            else:
                                val = val * float(stddev[region])
                            available -= 1
                        coefs[pos] = val * cfg.scale_factor
                        pos += 1
                if error:
                    for j in range(region + 1, nreg):
                        cats[j] = 7
                    cat = 7

            # noise fill for the sparse categories
            reg = coefs[base:base + REGION_SIZE]
            # the noise-gain index can exceed the 20-entry tables when
            # a region decodes mostly nonzero (out-of-bounds read in
            # the reference); clamp to the last (smallest) gain
            if cat == 5:
                i = int(np.count_nonzero(reg))
                i += 3 * int(np.count_nonzero(
                    np.abs(reg) > 2.0 * stddev[region]))
                noise = float(stddev[region]) * float(_NOISE5[min(i, 19)])
            elif cat == 6:
                noise = float(stddev[region]) * float(
                    _NOISE6[min(int(np.count_nonzero(reg)), 19)])
            elif cat == 7:
                noise = float(stddev[region]) * float(_NOISE7)
            else:
                noise = 0.0

            if cat in (5, 6, 7):
                dw1 = self._get_dw()
                dw2 = self._get_dw()
                for j in range(10):
                    if cat == 7 or reg[2 * j] == 0:
                        reg[2 * j] = noise if (dw1 & 1) else -noise
                    dw1 >>= 1
                    if cat == 7 or reg[2 * j + 1] == 0:
                        reg[2 * j + 1] = noise if (dw2 & 1) else -noise
                    dw2 >>= 1
        return coefs, available, error


# ---------------------------------------------------------------------------
# encoder


def _huffman_vector(cat: int, power_idx: int, mlts: np.ndarray
                    ) -> Tuple[int, List[Tuple[int, int]]]:
    """Quantize one region's coefficients for a category and Huffman-
    code them.  Returns (bit count, [(value, nbits), ...] codewords)."""
    codes_tab, bits_tab = _CODE_TABLES[cat]
    scale = float(_DEVIATION_INVERSE[power_idx]) * float(_STEP_SIZE_INV[cat])
    out: List[Tuple[int, int]] = []
    total_bits = 0
    pos = 0
    for _ in range(NUMBER_OF_VECTORS[cat]):
        sign_idx = 0
        idx = 0
        non_zeroes = 0
        for _j in range(VECTOR_DIMENSION[cat]):
            v = float(mlts[pos])
            pos += 1
            mag = int(abs(v) * scale + DEAD_ZONE[cat])
            if mag != 0:
                sign_idx <<= 1
                non_zeroes += 1
                if v > 0:
                    sign_idx |= 1
                if mag > MAX_BIN[cat] or mag < 0:
                    mag = MAX_BIN[cat]
            idx = idx * (MAX_BIN[cat] + 1) + mag
        nbits = bits_tab[idx] + non_zeroes
        code = (codes_tab[idx] << non_zeroes) | sign_idx
        out.append((code, nbits))
        total_bits += nbits
    return total_bits, out


class SirenEncoder:
    def __init__(self, sample_rate: int = 16000):
        self.cfg = SirenConfig(sample_rate)
        self.context = np.zeros(160, np.float64)

    def encode_frame(self, samples: np.ndarray) -> bytes:
        """samples: 320 int16 (or float) samples → 40-byte frame."""
        cfg = self.cfg
        x = np.asarray(samples, np.float64)
        if x.shape[0] != 320:
            raise ValueError("siren frames are 320 samples")
        coefs = rmlt_encode(x, self.context)

        arpi, env_codes = compute_region_powers(coefs, cfg)
        env_bits = sum(n for n, _c in env_codes)
        available = (cfg.bits_per_frame - cfg.rate_control_bits
                     - env_bits - cfg.sample_rate_bits - cfg.checksum_bits)
        cats, balance = categorize_regions(cfg.number_of_regions,
                                           available, arpi)
        power_idx = [v + 24 for v in arpi]

        rate_control, region_codes = self._quantize_mlt(
            coefs, power_idx, cats, balance, available)

        bw = _BitWriter()
        bw.put(cfg.sample_rate_code, cfg.sample_rate_bits)
        for nbits, code in env_codes:
            bw.put(code, nbits)
        bw.put(rate_control, cfg.rate_control_bits)
        for region in range(cfg.number_of_regions):
            if bw.bits_written() >= cfg.bits_per_frame:
                break
            for code, nbits in region_codes[region]:
                if bw.bits_written() >= cfg.bits_per_frame:
                    break
                bw.put(code, nbits)
        # pad with 1-bits to the frame boundary (frame_error flag bits)
        while bw.bits_written() < cfg.bits_per_frame:
            bw.put(0xFFFF, min(16, cfg.bits_per_frame - bw.bits_written()))
        words = list(bw.words)[:cfg.bits_per_frame >> 4]
        # truncation above may have split a codeword across the frame
        # boundary; the reference truncates identically (16*idx bound)
        if cfg.checksum_bits:
            words[-1] &= (0xFFFF << cfg.checksum_bits) & 0xFFFF
            words[-1] |= _checksum(words, cfg.bits_per_frame,
                                   cfg.checksum_bits)
        return np.asarray(words, ">u2").tobytes()

    def _quantize_mlt(self, coefs, power_idx, cats, balance, available):
        cfg = self.cfg
        nreg = cfg.number_of_regions

        rate_control = (cfg.rate_control_possibilities >> 1) - 1
        for i in range(rate_control):
            cats[balance[i]] += 1

        counts = [0] * nreg
        codes: List[List[Tuple[int, int]]] = [[] for _ in range(nreg)]

        def requant(region):
            if cats[region] > 6:
                counts[region], codes[region] = 0, []
            else:
                counts[region], codes[region] = _huffman_vector(
                    cats[region], power_idx[region],
                    coefs[region * REGION_SIZE:(region + 1) * REGION_SIZE])

        for region in range(nreg):
            requant(region)
        mlt_bits = sum(counts)

        while mlt_bits < available and rate_control > 0:
            rate_control -= 1
            region = balance[rate_control]
            cats[region] -= 1
            if cats[region] < 0:
                cats[region] = 0
            mlt_bits -= counts[region]
            requant(region)
            mlt_bits += counts[region]

        while (mlt_bits > available
               and rate_control < cfg.rate_control_possibilities):
            region = balance[rate_control]
            cats[region] += 1
            mlt_bits -= counts[region]
            requant(region)
            mlt_bits += counts[region]
            rate_control += 1

        return rate_control, codes


def encode(samples: np.ndarray, sample_rate: int = 16000) -> bytes:
    """Encode int16 samples (multiple of 320) → concatenated frames."""
    enc = SirenEncoder(sample_rate)
    x = np.asarray(samples).reshape(-1)
    n = (len(x) // 320) * 320
    return b"".join(enc.encode_frame(x[i:i + 320])
                    for i in range(0, n, 320))


def decode(data: bytes, sample_rate: int = 16000) -> np.ndarray:
    """Decode concatenated 40-byte frames → int16 samples."""
    dec = SirenDecoder(sample_rate)
    bpf = dec.cfg.bytes_per_frame
    n = (len(data) // bpf) * bpf
    outs = [dec.decode_frame(data[i:i + bpf]) for i in range(0, n, bpf)]
    return (np.concatenate(outs) if outs
            else np.zeros(0, np.int16))
