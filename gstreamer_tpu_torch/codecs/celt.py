"""Clean-room CELT decoder (RFC 6716 §4.3) — the Opus music path.

Decodes CELT-only Opus packets (TOC configs 16-31) natively: range
decoder, Laplace-coded coarse energy, bit allocation, PVQ/CWRS band
shapes, inverse MDCT synthesis, pitch post-filter and de-emphasis.
SILK and hybrid packets stay on the system libopus wrapper
(codecs/opus.py), mirroring how the reference treats opus decode as a
library concern (gst-plugins-base/ext/opus/gstopusdec.c:1).

Normative constants live in codecs/_celt_tables.py (RFC 6716 §6
tables, cross-checked against the system libopus binary).  The MDCT
runs as dense matmuls over the whole frame batch — the MXU shape this
framework uses for every transform codec (vorbis/mp3/aac).

Mono and stereo streams decode natively; SILK/hybrid packets raise
and callers fall back to libopus.

A copy of the JAX package's ``codecs/celt.py``: host numpy, float64,
the MDCT as numpy products and the post-filter through scipy's
``lfilter``; ``native/celt.py`` is its fast path.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from . import _celt_tables as T

BITRES = 3
MAX_FINE_BITS = 8
LOG_MAX_PSEUDO = 6
SPREAD_NONE, SPREAD_LIGHT, SPREAD_NORMAL, SPREAD_AGGRESSIVE = 0, 1, 2, 3
SHORT_MDCT = 120
OVERLAP = 120
MAX_LM = 3
COMBFILTER_MINPERIOD = 15
DECODE_BUFFER = 2048
PREEMPH = 0.8500061035  # 48 kHz de-emphasis coefficient


def _ilog(v: int) -> int:
    """EC_ILOG: index of the highest set bit + 1; 0 for v==0."""
    return v.bit_length()


# ---------------------------------------------------------------------------
# Range decoder (RFC 6716 §4.1, entdec.c)
# ---------------------------------------------------------------------------

_EC_CODE_BITS = 32
_EC_SYM_BITS = 8
_EC_CODE_TOP = 1 << 31
_EC_CODE_BOT = _EC_CODE_TOP >> _EC_SYM_BITS
_EC_CODE_EXTRA = (_EC_CODE_BITS - 2) % _EC_SYM_BITS + 1  # 7
_EC_SYM_MAX = 255
_EC_UINT_BITS = 8
_M32 = 0xFFFFFFFF


class RangeDecoder:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.storage = len(buf)
        self.offs = 0
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = _EC_CODE_BITS + 1 - (
            (_EC_CODE_BITS - _EC_CODE_EXTRA) // _EC_SYM_BITS) \
            * _EC_SYM_BITS
        self.error = 0
        self.rng = 1 << _EC_CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >>
                                   (_EC_SYM_BITS - _EC_CODE_EXTRA))
        self._normalize()

    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    def _normalize(self) -> None:
        while self.rng <= _EC_CODE_BOT:
            self.nbits_total += _EC_SYM_BITS
            self.rng = (self.rng << _EC_SYM_BITS) & _M32
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << _EC_SYM_BITS) | self.rem) >> (
                _EC_SYM_BITS - _EC_CODE_EXTRA)
            self.val = ((self.val << _EC_SYM_BITS)
                        + (_EC_SYM_MAX & ~sym)) & (_EC_CODE_TOP - 1)

    # -- symbol decoding ------------------------------------------------------
    def decode(self, ft: int) -> int:
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - min(s + 1, ft)

    def decode_bin(self, bits: int) -> int:
        self.ext = self.rng >> bits
        s = self.val // self.ext
        return (1 << bits) - min(s + 1, 1 << bits)

    def update(self, fl: int, fh: int, ft: int) -> None:
        if hasattr(self, "symlog"):
            self.symlog.append(("u", fl, fh, ft))
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    def dec_bit_logp(self, logp: int) -> int:
        if hasattr(self, "symlog"):
            self.symlog.append(("b", logp))
        r = self.rng
        d = self.val
        s = r >> logp
        ret = 1 if d < s else 0
        if hasattr(self, "symlog"):
            self.symlog[-1] = ("b", logp, ret)
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def dec_icdf(self, icdf, ftb: int) -> int:
        s = self.rng
        d = self.val
        r = s >> ftb
        ret = -1
        while True:
            ret += 1
            t = s
            s = r * icdf[ret]
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        if hasattr(self, "symlog"):
            self.symlog.append(("i", tuple(icdf[:ret + 1]), ret, ftb))
        self._normalize()
        return ret

    def dec_bits(self, bits: int) -> int:
        window = self.end_window
        available = self.nend_bits
        if available < bits:
            while available <= 32 - _EC_SYM_BITS:
                window |= self._read_byte_from_end() << available
                available += _EC_SYM_BITS
        ret = window & ((1 << bits) - 1)
        if hasattr(self, "symlog"):
            self.symlog.append(("raw", bits, ret))
        window >>= bits
        available -= bits
        self.end_window = window
        self.nend_bits = available
        self.nbits_total += bits
        return ret

    def dec_uint(self, ft: int) -> int:
        assert ft > 1
        ft -= 1
        ftb = _ilog(ft)
        if ftb > _EC_UINT_BITS:
            ftb -= _EC_UINT_BITS
            ft1 = (ft >> ftb) + 1
            s = self.decode(ft1)
            self.update(s, s + 1, ft1)
            t = (s << ftb) | self.dec_bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        ft += 1
        s = self.decode(ft)
        self.update(s, s + 1, ft)
        return s

    def tell(self) -> int:
        return self.nbits_total - _ilog(self.rng)

    def tell_frac(self) -> int:
        """1/8-bit-resolution tell (entcode.c ec_tell_frac): refine
        log2(rng) by three squarings of its 16-bit mantissa."""
        nbits = self.nbits_total << BITRES
        lg = _ilog(self.rng)
        r = self.rng >> (lg - 16)
        for _ in range(BITRES):
            r = (r * r) >> 15
            bit = r >> 16
            lg = (lg << 1) | bit
            r >>= bit
        return nbits - lg


# ---------------------------------------------------------------------------
# Laplace decoder (laplace.c)
# ---------------------------------------------------------------------------

def laplace_decode(dec: RangeDecoder, fs: int, decay: int) -> int:
    val = 0
    fl = 0
    fm = dec.decode_bin(15)
    if fm >= fs:
        val += 1
        fl = fs
        fs = (((32768 - 32 - fs) * (16384 - decay)) >> 15) + 1
        while fs > 1 and fm >= fl + 2 * fs:
            fs *= 2
            fl += fs
            fs = (((fs - 2) * decay) >> 15) + 1
            val += 1
        if fs <= 1:
            di = (fm - fl) >> 1
            val += di
            fl += 2 * di
        if fm < fl + fs:
            val = -val
        else:
            fl += fs
    dec.update(fl, min(fl + fs, 32768), 32768)
    return val


# ---------------------------------------------------------------------------
# CWRS — PVQ codeword enumeration (cwrs.c), exact big-int U/V
# ---------------------------------------------------------------------------

_U_CACHE = {}


def _U(n: int, k: int) -> int:
    """U(n,k): codewords of pyramid V(n,k) whose first nonzero is
    negative-excluded half (cwrs.c); symmetric in (n,k)."""
    if k <= 0:
        return 1 if k == 0 and n == 0 else (0 if k <= 0 else 0)
    if n <= 0:
        return 0
    if n < k:
        n, k = k, n
    key = (n, k)
    v = _U_CACHE.get(key)
    if v is not None:
        return v
    if k == 1:
        v = 1
    else:
        v = _U(n - 1, k) + _U(n, k - 1) + _U(n - 1, k - 1)
    _U_CACHE[key] = v
    return v


def pvq_v(n: int, k: int) -> int:
    """V(n,k): number of PVQ codewords (dim n, k unit pulses)."""
    if k == 0:
        return 1
    return _U(n, k) + _U(n, k + 1)


def cwrsi(n: int, k: int, i: int) -> List[int]:
    """Index -> pulse vector (cwrs.c cwrsi), exact enumeration."""
    y = []
    while n > 2:
        if k >= n:
            p = _U(n, k + 1)
            s = 1 if i >= p else 0
            if s:
                i -= p
            k0 = k
            q = _U(n, n)
            if q > i:
                k = n
                while True:
                    k -= 1
                    p = _U(k, n)
                    if p <= i:
                        break
            else:
                p = _U(n, k)
                while p > i:
                    k -= 1
                    p = _U(n, k)
            i -= p
            val = k0 - k
            y.append(-val if s else val)
        else:
            p = _U(k, n)
            q = _U(k + 1, n)
            if p <= i < q:
                i -= p
                y.append(0)
            else:
                s = 1 if i >= q else 0
                if s:
                    i -= q
                k0 = k
                while True:
                    k -= 1
                    p = _U(k, n)
                    if p <= i:
                        break
                i -= p
                val = k0 - k
                y.append(-val if s else val)
        n -= 1
    # n == 2
    p = 2 * k + 1
    s = 1 if i >= p else 0
    if s:
        i -= p
    k0 = k
    k = (i + 1) >> 1
    if k:
        i -= 2 * k - 1
    val = k0 - k
    y.append(-val if s else val)
    # n == 1
    s = 1 if i else 0
    y.append(-k if s else k)
    return y


def decode_pulses(dec: RangeDecoder, n: int, k: int) -> np.ndarray:
    from ..native.celt import get_lib
    lib = get_lib()
    if lib is None:
        idx = dec.dec_uint(pvq_v(n, k))
        return np.array(cwrsi(n, k, idx), np.float64)
    import ctypes
    idx = dec.dec_uint(int(lib.gtpu_celt_pvq_v(n, k)))
    y = np.zeros(n, np.int32)
    lib.gtpu_celt_cwrsi(n, k, idx,
                        y.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int32)))
    return y.astype(np.float64)


# ---------------------------------------------------------------------------
# Rate / allocation (rate.c)
# ---------------------------------------------------------------------------

def _sudiv(a: int, b: int) -> int:
    """C signed integer division (truncation toward zero) — Python's
    // floors, which differs for negative numerators (celt_sudiv)."""
    q = abs(a) // b
    return -q if a < 0 else q


def get_pulses(i: int) -> int:
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


def _cache_row(band: int, lm: int) -> List[int]:
    """Pulse-cache row for (band, LM); LM may be -1 (split level)."""
    width = T.EBANDS[band + 1] - T.EBANDS[band]
    n = (width << lm) if lm >= 0 else (width >> 1)
    return T.CACHE_BITS[T.CACHE_INDEX_BY_N[n]:]


def bits2pulses(band: int, lm: int, bits: int) -> int:
    cache = _cache_row(band, lm)
    lo, hi = 0, cache[0]
    bits -= 1
    for _ in range(LOG_MAX_PSEUDO):
        mid = (lo + hi + 1) >> 1
        if cache[mid] >= bits:
            hi = mid
        else:
            lo = mid
    lo_cost = -1 if lo == 0 else cache[lo]
    if bits - lo_cost <= cache[hi] - bits:
        return lo
    return hi


def pulses2bits(band: int, lm: int, pulses: int) -> int:
    if pulses == 0:
        return 0
    return _cache_row(band, lm)[pulses] + 1


LOG2_FRAC_TABLE = [0, 8, 13, 16, 19, 21, 23, 24, 26, 27, 28, 29, 30,
                   31, 32, 32, 33, 34, 34, 35, 36, 36, 37, 37]


def interp_bits2pulses(start, end, skip_start, bits1, bits2, thresh,
                       cap, total, skip_rsv, intensity_rsv,
                       dual_stereo_rsv, C, LM, dec):
    """rate.c interp_bits2pulses, decode side."""
    alloc_floor = C << BITRES
    stereo = 1 if C > 1 else 0
    logM = LM << BITRES
    ALLOC_STEPS = 6
    lo, hi = 0, 1 << ALLOC_STEPS
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum = 0
        done = False
        for j in range(end - 1, start - 1, -1):
            tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS)
            if tmp >= thresh[j] or done:
                done = True
                psum += min(tmp, cap[j])
            elif tmp >= alloc_floor:
                psum += alloc_floor
        if psum > total:
            hi = mid
        else:
            lo = mid
    psum = 0
    done = False
    bits = [0] * len(bits1)
    for j in range(end - 1, start - 1, -1):
        tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS)
        if tmp < thresh[j] and not done:
            if tmp >= alloc_floor:
                tmp = alloc_floor
            else:
                tmp = 0
        else:
            done = True
        tmp = min(tmp, cap[j])
        bits[j] = tmp
        psum += tmp

    intensity = 0
    dual_stereo = 0
    eb = T.EBANDS
    codedBands = end
    while True:
        j = codedBands - 1
        if j <= skip_start:
            total += skip_rsv
            break
        left = total - psum
        percoeff = left // (eb[codedBands] - eb[start])
        left -= (eb[codedBands] - eb[start]) * percoeff
        rem = max(left - (eb[j] - eb[start]), 0)
        band_width = eb[codedBands] - eb[j]
        band_bits = bits[j] + percoeff * band_width + rem
        if band_bits >= max(thresh[j], alloc_floor + (1 << BITRES)):
            if dec.dec_bit_logp(1):
                break
            psum += 1 << BITRES
            band_bits -= 1 << BITRES
        psum -= bits[j] + intensity_rsv
        if intensity_rsv > 0:
            intensity_rsv = LOG2_FRAC_TABLE[j - start]
        psum += intensity_rsv
        # "enough for a fine energy bit per channel": floor only
        if band_bits >= alloc_floor:
            psum += alloc_floor
            bits[j] = alloc_floor
        else:
            bits[j] = 0
        codedBands -= 1

    if intensity_rsv > 0:
        intensity = start + dec.dec_uint(codedBands + 1 - start)
    if intensity <= start:
        total += dual_stereo_rsv
        dual_stereo_rsv = 0
    if dual_stereo_rsv > 0:
        dual_stereo = dec.dec_bit_logp(1)

    left = total - psum
    percoeff = left // (eb[codedBands] - eb[start])
    left -= (eb[codedBands] - eb[start]) * percoeff
    for j in range(start, codedBands):
        bits[j] += percoeff * (eb[j + 1] - eb[j])
    for j in range(start, codedBands):
        tmp = min(left, eb[j + 1] - eb[j])
        bits[j] += tmp
        left -= tmp

    ebits = [0] * len(bits1)
    fine_priority = [0] * len(bits1)
    balance = 0
    FINE_OFFSET = 21
    for j in range(start, codedBands):
        N0 = eb[j + 1] - eb[j]
        N = N0 << LM
        bit = bits[j] + balance
        if N > 1:
            excess = max(bit - cap[j], 0)
            bits[j] = bit - excess
            den = C * N + (1 if (C == 2 and N > 2 and not dual_stereo
                                 and j < intensity) else 0)
            NClogN = den * (T.LOG_N[j] + logM)
            offset = (NClogN >> 1) - den * FINE_OFFSET
            if N == 2:
                offset += den << BITRES >> 2
            if bits[j] + offset < (den * 2) << BITRES:
                offset += NClogN >> 2
            elif bits[j] + offset < (den * 3) << BITRES:
                offset += NClogN >> 3
            ebits[j] = max(0, (bits[j] + offset + (den << (BITRES - 1))))
            ebits[j] = ebits[j] // (den << BITRES)
            if C * ebits[j] << BITRES > bits[j]:
                ebits[j] = bits[j] >> stereo >> BITRES
            ebits[j] = min(ebits[j], MAX_FINE_BITS)
            fine_priority[j] = 1 if (
                ebits[j] * (den << BITRES) >= bits[j] + offset) else 0
            bits[j] -= C * ebits[j] << BITRES
        else:
            excess = max(bit - (C << BITRES), 0)
            bits[j] = bit - excess
            ebits[j] = 0
            fine_priority[j] = 1
        if excess > 0:
            extra_fine = min(excess >> (stereo + BITRES),
                             MAX_FINE_BITS - ebits[j])
            ebits[j] += extra_fine
            extra_bits = extra_fine * C << BITRES
            fine_priority[j] = 1 if extra_bits >= excess - balance \
                else 0
            excess -= extra_bits
        balance = excess
    for j in range(codedBands, end):
        ebits[j] = bits[j] >> stereo >> BITRES
        bits[j] = 0
        fine_priority[j] = 1 if ebits[j] < 1 else 0
    return (bits, ebits, fine_priority, codedBands, balance,
            intensity, dual_stereo)


def clt_compute_allocation(start, end, offsets, cap, alloc_trim,
                           total, C, LM, dec):
    """rate.c clt_compute_allocation (decode side, mono C=1)."""
    eb = T.EBANDS
    total = max(total, 0)
    len_b = T.N_BANDS
    skip_start = start
    skip_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
    total -= skip_rsv
    intensity_rsv = dual_stereo_rsv = 0
    if C == 2:
        intensity_rsv = LOG2_FRAC_TABLE[end - start]
        if intensity_rsv > total:
            intensity_rsv = 0
        else:
            total -= intensity_rsv
            dual_stereo_rsv = (1 << BITRES) \
                if total >= (1 << BITRES) else 0
            total -= dual_stereo_rsv
    bits1 = [0] * len_b
    bits2 = [0] * len_b
    thresh = [0] * len_b
    trim_offset = [0] * len_b
    for j in range(start, end):
        N = eb[j + 1] - eb[j]
        thresh[j] = max(C << BITRES, (3 * N << LM << BITRES) >> 4)
        trim_offset[j] = C * N * (alloc_trim - 5 - LM) * (end - j - 1) \
            * (1 << (LM + BITRES)) >> 6
        if (N << LM) == 1:
            trim_offset[j] -= C << BITRES
    lo, hi = 1, 10
    while lo <= hi:
        mid = (lo + hi) >> 1
        psum = 0
        done = False
        for j in range(end - 1, start - 1, -1):
            N = eb[j + 1] - eb[j]
            bitsj = C * N * T.BAND_ALLOCATION[mid][j] << LM >> 2
            if bitsj > 0:
                bitsj = max(0, bitsj + trim_offset[j])
            bitsj += offsets[j]
            if bitsj >= thresh[j] or done:
                done = True
                psum += min(bitsj, cap[j])
            elif bitsj >= C << BITRES:
                psum += C << BITRES
        if psum > total:
            hi = mid - 1
        else:
            lo = mid + 1
    hi = lo
    lo = lo - 1
    for j in range(start, end):
        N = eb[j + 1] - eb[j]
        bits1j = C * N * T.BAND_ALLOCATION[lo][j] << LM >> 2
        bits2j = cap[j] if hi >= 11 else \
            C * N * T.BAND_ALLOCATION[hi][j] << LM >> 2
        if bits1j > 0:
            bits1j = max(0, bits1j + trim_offset[j])
        if bits2j > 0:
            bits2j = max(0, bits2j + trim_offset[j])
        if lo > 0:
            bits1j += offsets[j]
        bits2j += offsets[j]
        if offsets[j] > 0:
            skip_start = j
        bits2j = max(0, bits2j - bits1j)
        bits1[j] = bits1j
        bits2[j] = bits2j
    return interp_bits2pulses(start, end, skip_start, bits1, bits2,
                              thresh, cap, total, skip_rsv,
                              intensity_rsv, dual_stereo_rsv, C, LM,
                              dec)


# ---------------------------------------------------------------------------
# Energy envelope (quant_bands.c)
# ---------------------------------------------------------------------------

def unquant_coarse_energy(dec, start, end, oldE, intra, LM, C,
                          budget):
    """quant_bands.c unquant_coarse_energy (float build)."""
    prob = T.E_PROB_MODEL[LM][1 if intra else 0]
    if intra:
        coef, beta = 0.0, T.BETA_INTRA
    else:
        coef, beta = T.PRED_COEF[LM], T.BETA_COEF[LM]
    prev = [0.0] * C
    small_icdf = [2, 1, 0]
    for i in range(start, end):
        for c in range(C):
            tell = dec.tell()
            if budget - tell >= 15:
                pi = 2 * min(i, 20)
                qi = laplace_decode(dec, prob[pi] << 7,
                                    prob[pi + 1] << 6)
            elif budget - tell >= 2:
                qi = dec.dec_icdf(small_icdf, 2)
                qi = (qi >> 1) ^ -(qi & 1)
            elif budget - tell >= 1:
                qi = -dec.dec_bit_logp(1)
            else:
                qi = -1
            q = float(qi)
            idx = i + c * T.N_BANDS
            oldE[idx] = max(-9.0, oldE[idx])
            oldE[idx] = coef * oldE[idx] + prev[c] + q
            prev[c] = prev[c] + q - beta * q


def unquant_fine_energy(dec, start, end, oldE, fine_quant, C):
    for i in range(start, end):
        if fine_quant[i] <= 0:
            continue
        for c in range(C):
            q2 = dec.dec_bits(fine_quant[i])
            offset = (q2 + 0.5) * (1 << (14 - fine_quant[i])) \
                / 16384.0 - 0.5
            oldE[i + c * T.N_BANDS] += offset


def unquant_energy_finalise(dec, start, end, oldE, fine_quant,
                            fine_priority, bits_left, C):
    for prio in (0, 1):
        i = start
        while i < end and bits_left >= C:
            if fine_quant[i] >= MAX_FINE_BITS \
                    or fine_priority[i] != prio:
                i += 1
                continue
            for c in range(C):
                q2 = dec.dec_bits(1)
                offset = (q2 - 0.5) \
                    * (1 << (14 - fine_quant[i] - 1)) / 16384.0
                oldE[i + c * T.N_BANDS] += offset
                bits_left -= 1
            i += 1


def tf_decode(dec, start, end, is_transient, LM, storage_bits):
    """celt.c tf_decode."""
    budget = storage_bits
    tell = dec.tell()
    logp = 2 if is_transient else 4
    tf_select_rsv = 1 if (LM > 0 and tell + logp + 1 <= budget) else 0
    budget -= tf_select_rsv
    tf_changed = curr = 0
    tf_res = [0] * T.N_BANDS
    for i in range(start, end):
        if tell + logp <= budget:
            curr ^= dec.dec_bit_logp(logp)
            tell = dec.tell()
            tf_changed |= curr
        tf_res[i] = curr
        logp = 4 if is_transient else 5
    tf_select = 0
    tbl = T.TF_SELECT_TABLE[LM]
    base = 4 * (1 if is_transient else 0)
    if tf_select_rsv and \
            tbl[base + tf_changed] != tbl[base + 2 + tf_changed]:
        tf_select = dec.dec_bit_logp(1)
    for i in range(start, end):
        tf_res[i] = tbl[base + 2 * tf_select + tf_res[i]]
    return tf_res


# ---------------------------------------------------------------------------
# PVQ shape decoding (vq.c)
# ---------------------------------------------------------------------------

SPREAD_FACTOR = [15, 10, 5]


def exp_rotation1(X, length, stride, c, s):
    ms = -s
    for i in range(length - stride):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 + ms * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 + ms * x2


def exp_rotation(X, n, direction, stride, K, spread):
    if 2 * K >= n or spread == SPREAD_NONE:
        return
    factor = SPREAD_FACTOR[spread - 1]
    from ..native.celt import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        Xc = np.ascontiguousarray(X, np.float64)
        lib.gtpu_celt_exp_rotation(
            Xc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, direction, stride, K, factor)
        X[:] = Xc
        return
    gain = 1.0 * n / (n + factor * K)
    theta = 0.5 * gain * gain
    c = math.cos(0.5 * math.pi * theta)
    s = math.cos(0.5 * math.pi * (1.0 - theta))
    stride2 = 0
    if n >= 8 * stride:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride \
                + (stride >> 2) < n:
            stride2 += 1
    length = n // stride
    for i in range(stride):
        off = i * length
        seg = X[off:off + length]
        if direction < 0:
            if stride2:
                exp_rotation1(seg, length, stride2, s, c)
            exp_rotation1(seg, length, 1, c, s)
        else:
            exp_rotation1(seg, length, 1, c, -s)
            if stride2:
                exp_rotation1(seg, length, stride2, s, -c)
        X[off:off + length] = seg


def renormalise_vector(X, gain=1.0):
    E = 1e-15 + float(np.sum(X * X))
    X *= gain / math.sqrt(E)


def extract_collapse_mask(iy, n, B):
    if B <= 1:
        return 1
    N0 = n // B
    mask = 0
    for i in range(B):
        if np.any(iy[i * N0:(i + 1) * N0] != 0):
            mask |= 1 << i
    return mask


def alg_unquant(dec, X, n, K, spread, B, gain):
    iy = decode_pulses(dec, n, K)
    Ryy = float(np.sum(iy * iy))
    X[:] = iy * (gain / math.sqrt(Ryy))
    exp_rotation(X, n, -1, B, K, spread)
    return extract_collapse_mask(iy, n, B)


# ---------------------------------------------------------------------------
# Band splitting (bands.c)
# ---------------------------------------------------------------------------

def _frac_mul16(a, b):
    a = np.int16(a)
    b = np.int16(b)
    return int((16384 + int(a) * int(b)) >> 15)


def bitexact_cos(x):
    tmp = (4096 + x * x) >> 13
    x2 = tmp
    x2 = (32767 - x2) + _frac_mul16(
        x2, -7651 + _frac_mul16(x2, 8277 + _frac_mul16(-626, x2)))
    return 1 + x2


def bitexact_log2tan(isin, icos):
    lc = _ilog(icos)
    ls = _ilog(isin)
    icos <<= 15 - lc
    isin <<= 15 - ls
    return ((ls - lc) * (1 << 11)
            + _frac_mul16(isin, _frac_mul16(isin, -2597) + 7932)
            - _frac_mul16(icos, _frac_mul16(icos, -2597) + 7932))



_LCG_A = 1664525
_LCG_C = 1013904223


def _lcg_batch(seed: int, n: int):
    """n sequential celt_lcg_rand states after `seed` (exact uint32),
    as a numpy uint32 array plus the final state."""
    a = _LCG_A
    c = _LCG_C
    states = np.empty(n, np.uint32)
    s = seed
    for j in range(n):
        s = (a * s + c) & _M32
        states[j] = s
    return states, s


def celt_lcg_rand(seed):
    return (1664525 * seed + 1013904223) & _M32


def haar1(X, n0, stride):
    n0 >>= 1
    s = 0.70710678
    for i in range(stride):
        idx0 = stride * 2 * np.arange(n0) + i
        idx1 = idx0 + stride
        t0 = s * X[idx0]
        t1 = s * X[idx1]
        X[idx0] = t0 + t1
        X[idx1] = t0 - t1


ORDERY_TABLE = {2: [1, 0], 4: [3, 0, 2, 1],
                8: [7, 0, 4, 3, 6, 1, 5, 2],
                16: [15, 0, 8, 7, 12, 3, 11, 4,
                     14, 1, 9, 6, 13, 2, 10, 5]}


def deinterleave_hadamard(X, n0, stride, hadamard):
    N = n0 * stride
    tmp = np.empty(N, X.dtype)
    if hadamard:
        ordery = ORDERY_TABLE[stride]
        for i in range(stride):
            tmp[ordery[i] * n0:(ordery[i] + 1) * n0] = X[i::stride][:n0]
    else:
        for i in range(stride):
            tmp[i * n0:(i + 1) * n0] = X[i::stride][:n0]
    X[:N] = tmp


def interleave_hadamard(X, n0, stride, hadamard):
    N = n0 * stride
    tmp = np.empty(N, X.dtype)
    if hadamard:
        ordery = ORDERY_TABLE[stride]
        for i in range(stride):
            tmp[i::stride] = X[ordery[i] * n0:(ordery[i] + 1) * n0]
    else:
        for i in range(stride):
            tmp[i::stride] = X[i * n0:(i + 1) * n0]
    X[:N] = tmp


def compute_qn(N, b, offset, pulse_cap, stereo):
    EXP2_TABLE8 = [16384, 17866, 19483, 21247,
                   23170, 25267, 27554, 30048]
    N2 = 2 * N - 1
    if stereo and N == 2:
        N2 -= 1
    qb = _sudiv(b + N2 * offset, N2)
    qb = min(b - pulse_cap - (4 << BITRES), qb)
    qb = min(8 << BITRES, qb)
    if qb < (1 << BITRES >> 1):
        return 1
    qn = EXP2_TABLE8[qb & 0x7] >> (14 - (qb >> BITRES))
    return ((qn + 1) >> 1) << 1


QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16


class BandCtx:
    def __init__(self, dec, intensity, spread, tf_change, i,
                 remaining_bits, seed, disable_inv=False):
        self.dec = dec
        self.intensity = intensity
        self.spread = spread
        self.tf_change = tf_change
        self.i = i
        self.remaining_bits = remaining_bits
        self.seed = seed
        self.disable_inv = disable_inv
        self.theta_round = 0


def _isqrt32(v):
    return int(math.isqrt(v))


def compute_theta(ctx, N, b, B, B0, LM, stereo):
    """bands.c compute_theta, decode side.  Returns (itheta, imid,
    iside, delta, qalloc)."""
    dec = ctx.dec
    i = ctx.i
    pulse_cap = T.LOG_N[i] + LM * (1 << BITRES)
    offset = (pulse_cap >> 1) - (QTHETA_OFFSET_TWOPHASE
                                 if stereo and N == 2
                                 else QTHETA_OFFSET)
    qn = compute_qn(N, b, offset, pulse_cap, stereo)
    if stereo and i >= ctx.intensity:
        qn = 1
    itheta = 0
    tell = dec.tell_frac()
    if qn != 1:
        if stereo and N > 2:
            p0 = 3
            x0 = qn // 2
            ft = p0 * (x0 + 1) + x0
            fm = dec.decode(ft)
            if fm < (x0 + 1) * p0:
                itheta = fm // p0
                fl, fh = itheta * p0, itheta * p0 + p0
            else:
                itheta = x0 + 1 + (fm - (x0 + 1) * p0)
                fl = (x0 + 1) * p0 + (itheta - x0 - 1)
                fh = fl + 1
            dec.update(fl, fh, ft)
        elif B0 > 1 or stereo:
            itheta = dec.dec_uint(qn + 1)
        else:
            # triangular pdf
            half = qn >> 1
            ft = (half + 1) * (half + 1)
            fm = dec.decode(ft)
            if fm < (half * (half + 1)) >> 1:
                itheta = (_isqrt32(8 * fm + 1) - 1) >> 1
                fs = itheta + 1
                fl = (itheta * (itheta + 1)) >> 1
            else:
                itheta = (2 * (qn + 1)
                          - _isqrt32(8 * (ft - fm - 1) + 1)) >> 1
                fs = qn + 1 - itheta
                fl = ft - (((qn + 1 - itheta)
                            * (qn + 2 - itheta)) >> 1)
            dec.update(fl, fl + fs, ft)
        itheta = (itheta * 16384) // qn
    elif stereo:
        # side-inversion flag for collapsed-theta stereo bands
        if b > 2 << BITRES and ctx.remaining_bits > 2 << BITRES:
            inv = dec.dec_bit_logp(2)
        else:
            inv = 0
        if ctx.disable_inv:
            inv = 0
        itheta = 0
        qalloc = dec.tell_frac() - tell
        b -= qalloc
        return 0, 32767, 0, -16384, qalloc, b, inv
    else:
        itheta = 0
    qalloc = dec.tell_frac() - tell
    b -= qalloc
    if itheta == 0:
        imid, iside, delta = 32767, 0, -16384
    elif itheta == 16384:
        imid, iside, delta = 0, 32767, 16384
    else:
        imid = bitexact_cos(itheta)
        iside = bitexact_cos(16384 - itheta)
        delta = _frac_mul16((N - 1) << 7,
                            bitexact_log2tan(iside, imid))
    return itheta, imid, iside, delta, qalloc, b, 0


def quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill):
    """bands.c quant_partition, decode/resynth side (mono)."""
    dec = ctx.dec
    i = ctx.i
    cache = _cache_row(i, LM) if LM >= -1 else None
    B0 = B
    if LM != -1 and b > cache[cache[0]] + 12 and N > 2:
        N >>= 1
        LM -= 1
        if B == 1:
            fill = (fill & 1) | (fill << 1)
        B = (B + 1) >> 1
        itheta, imid, iside, delta, qalloc, b, _inv = compute_theta(
            ctx, N, b, B, B0, LM, 0)
        if B0 > 1 and (itheta & 0x3FFF):
            if itheta > 8192:
                delta -= delta >> (4 - LM)
            else:
                delta = min(0, delta + (N << BITRES >> (5 - LM)))
        if itheta == 0:
            fill &= (1 << B) - 1
        elif itheta == 16384:
            fill &= ((1 << B) - 1) << B
        mid = imid / 32768.0
        side = iside / 32768.0
        mbits = max(0, min(b, _sudiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        Y_off = N
        if mbits >= sbits:
            rebalance = ctx.remaining_bits
            cm = quant_partition(ctx, X[:N], N, mbits, B,
                                 lowband[:N] if lowband is not None
                                 else None, LM, gain * mid, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_partition(
                ctx, X[Y_off:Y_off + N], N, sbits, B,
                lowband[N:2 * N] if lowband is not None else None,
                LM, gain * side, fill >> B) << (B0 >> 1)
        else:
            rebalance = ctx.remaining_bits
            cm = quant_partition(
                ctx, X[Y_off:Y_off + N], N, sbits, B,
                lowband[N:2 * N] if lowband is not None else None,
                LM, gain * side, fill >> B) << (B0 >> 1)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, X[:N], N, mbits, B,
                                  lowband[:N] if lowband is not None
                                  else None, LM, gain * mid, fill)
        return cm

    # leaf: PVQ or folding
    q = bits2pulses(i, LM, b)
    curr_bits = pulses2bits(i, LM, q)
    ctx.remaining_bits -= curr_bits
    while ctx.remaining_bits < 0 and q > 0:
        ctx.remaining_bits += curr_bits
        q -= 1
        curr_bits = pulses2bits(i, LM, q)
        ctx.remaining_bits -= curr_bits
    if q != 0:
        K = get_pulses(q)
        return alg_unquant(dec, X, N, K, ctx.spread, B, gain)
    # no pulses: fold from lowband (or noise)
    cm_mask = (1 << B) - 1
    fill &= cm_mask
    if not fill:
        X[:] = 0.0
        return 0
    states, ctx.seed = _lcg_batch(ctx.seed, N)
    if lowband is None:
        # noise-fill from the decoder-synchronised LCG:
        # (opus_int32)seed >> 20 (arithmetic)
        X[:] = (states.astype(np.int32) >> 20).astype(np.float64)
        cm = cm_mask
    else:
        tmp = np.where(states & 0x8000, 1.0 / 256, -1.0 / 256)
        X[:] = lowband[:N] + tmp
        cm = fill
    renormalise_vector(X, gain)
    return cm


BIT_INTERLEAVE = [0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3]
BIT_DEINTERLEAVE = [0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
                    0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF]


def quant_band(ctx, X, N, b, B, lowband, LM, lowband_out, gain,
               lowband_scratch, fill):
    """bands.c quant_band (mono), decode/resynth side."""
    N0 = N
    N_B = N // B
    B0 = B
    longBlocks = 1 if B0 == 1 else 0
    tf_change = ctx.tf_change

    if N == 1:
        # one-sample band: sign bit
        dec = ctx.dec
        if ctx.remaining_bits >= 1 << BITRES:
            sign = dec.dec_bits(1)
            ctx.remaining_bits -= 1 << BITRES
        else:
            sign = 0
        X[0] = -1.0 if sign else 1.0
        if lowband_out is not None:
            lowband_out[0] = X[0]
        return 1

    recombine = tf_change if tf_change > 0 else 0
    if lowband_scratch is not None and lowband is not None and \
            (recombine or (N_B % 2 == 0 and tf_change < 0)
             or B0 > 1):
        lowband_scratch[:N] = lowband
        lowband = lowband_scratch

    for k in range(recombine):
        if lowband is not None:
            haar1(lowband, N >> k, 1 << k)
        fill = BIT_INTERLEAVE[fill & 0xF] \
            | BIT_INTERLEAVE[fill >> 4] << 2
    B >>= recombine
    N_B <<= recombine

    time_divide = 0
    while (N_B & 1) == 0 and tf_change < 0:
        if lowband is not None:
            haar1(lowband, N_B, B)
        fill |= fill << B
        B <<= 1
        N_B >>= 1
        time_divide += 1
        tf_change += 1
    B0 = B
    N_B0 = N_B

    if B0 > 1 and lowband is not None:
        deinterleave_hadamard(lowband, N_B >> recombine,
                              B0 << recombine, longBlocks)

    cm = quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill)

    # undo the sample reorganisation
    if B0 > 1:
        interleave_hadamard(X, N_B >> recombine, B0 << recombine,
                            longBlocks)
    N_B = N_B0
    B = B0
    for k in range(time_divide):
        B >>= 1
        N_B <<= 1
        cm |= cm >> B
        haar1(X, N_B, B)
    for k in range(recombine):
        cm = BIT_DEINTERLEAVE[cm & 0xF]
        haar1(X, N0 >> k, 1 << k)
    B <<= recombine

    if lowband_out is not None:
        n = math.sqrt(N0)
        lowband_out[:N0] = n * X[:N0]
    return cm & ((1 << B) - 1)


def stereo_merge(X, Y, mid, N):
    """bands.c stereo_merge (float): recover L/R from mid/side."""
    xp = mid * float(np.dot(Y[:N], X[:N]))
    side = float(np.dot(Y[:N], Y[:N]))
    El = mid * mid + side - 2 * xp
    Er = mid * mid + side + 2 * xp
    if Er < 6e-4 or El < 6e-4:
        Y[:N] = X[:N]
        return
    lgain = 1.0 / math.sqrt(El)
    rgain = 1.0 / math.sqrt(Er)
    left = mid * X[:N]
    r = Y[:N].copy()
    X[:N] = lgain * (left - r)
    Y[:N] = rgain * (left + r)


def quant_band_n1_stereo(ctx, X, Y, lowband_out):
    """bands.c quant_band_n1 for two channels: a sign bit each."""
    dec = ctx.dec
    for chan in (X, Y):
        if ctx.remaining_bits >= 1 << BITRES:
            sign = dec.dec_bits(1)
            ctx.remaining_bits -= 1 << BITRES
        else:
            sign = 0
        chan[0] = -1.0 if sign else 1.0
    if lowband_out is not None:
        lowband_out[0] = X[0]
    return 1


def quant_band_stereo(ctx, X, Y, N, b, B, lowband, LM, lowband_out,
                      lowband_scratch, fill):
    """bands.c quant_band_stereo, decode/resynth side."""
    dec = ctx.dec
    if N == 1:
        return quant_band_n1_stereo(ctx, X, Y, lowband_out)
    B0 = B
    itheta, imid, iside, delta, qalloc, b, inv = compute_theta(
        ctx, N, b, B, B0, LM, 1)
    if itheta == 0:
        fill &= (1 << B) - 1
    elif itheta == 16384:
        fill &= ((1 << B) - 1) << B
    mid = imid / 32768.0
    side = iside / 32768.0
    if N == 2:
        mbits = b
        sbits = (1 << BITRES) if (itheta != 0 and itheta != 16384) \
            else 0
        mbits -= sbits
        c = 1 if itheta > 8192 else 0
        ctx.remaining_bits -= qalloc + sbits
        x2, y2 = (Y, X) if c else (X, Y)
        sign = dec.dec_bits(1) if sbits else 0
        sign = 1 - 2 * sign
        cm = quant_partition(ctx, x2, N, mbits, B, lowband, LM, 1.0,
                             fill)
        y2[0] = -sign * x2[1]
        y2[1] = sign * x2[0]
        X[0] *= mid
        X[1] *= mid
        Y[0] *= side
        Y[1] *= side
        tmp = X[0]
        X[0] = tmp - Y[0]
        Y[0] = tmp + Y[0]
        tmp = X[1]
        X[1] = tmp - Y[1]
        Y[1] = tmp + Y[1]
    else:
        mbits = max(0, min(b, _sudiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_band(ctx, X, N, mbits, B, lowband, LM,
                            lowband_out, 1.0, lowband_scratch, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, Y, N, sbits, B, None, LM, None,
                             side, None, fill >> B)
        else:
            cm = quant_band(ctx, Y, N, sbits, B, None, LM, None,
                            side, None, fill >> B)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, X, N, mbits, B, lowband, LM,
                             lowband_out, 1.0, lowband_scratch, fill)
    if N != 2:
        stereo_merge(X, Y, mid, N)
    if inv:
        Y[:N] = -Y[:N]
    return cm


def quant_all_bands(dec, start, end, X_full, Y_full, pulses,
                    shortBlocks, spread, dual_stereo, intensity,
                    tf_res, total_bits, balance, LM, codedBands,
                    seed, disable_inv=False):
    """bands.c quant_all_bands, decode/resynth side (C=1 or 2)."""
    eb = T.EBANDS
    C = 1 if Y_full is None else 2
    M = 1 << LM
    B = M if shortBlocks else 1
    norm_offset = M * eb[start]
    norm_len = M * eb[T.N_BANDS - 1] - norm_offset
    norm = np.zeros(norm_len, np.float64)
    norm2 = np.zeros(norm_len, np.float64) if C == 2 else None
    lowband_scratch = np.zeros(M * (eb[T.N_BANDS] - eb[T.N_BANDS - 1]),
                               np.float64)
    collapse_masks = [0] * (T.N_BANDS * C)
    lowband_offset = 0
    update_lowband = True
    ctx = BandCtx(dec, intensity, spread, 0, start, 0, seed,
                  disable_inv)
    for i in range(start, end):
        ctx.i = i
        last = (i == end - 1)
        X = X_full[M * eb[i]:M * eb[i + 1]]
        Y = Y_full[M * eb[i]:M * eb[i + 1]] if C == 2 else None
        N = M * eb[i + 1] - M * eb[i]
        tell = dec.tell_frac()
        if i != start:
            balance -= tell
        remaining_bits = total_bits - tell - 1
        ctx.remaining_bits = remaining_bits
        if i <= codedBands - 1:
            curr_balance = _sudiv(balance,
                                  min(3, codedBands - i))
            b = max(0, min(16383,
                           min(remaining_bits + 1,
                               pulses[i] + curr_balance)))
        else:
            b = 0
        if (M * eb[i] - N >= M * eb[start] or i == start + 1) and \
                (update_lowband or lowband_offset == 0):
            lowband_offset = i
        if i == start + 1:
            # bands.c special_hybrid_folding: duplicate enough of the
            # first band's folding data to fold the (wider) second
            # band; copies nothing in CELT-only mode (start == 0)
            n1 = M * (eb[start + 1] - eb[start])
            n2 = M * (eb[start + 2] - eb[start + 1])
            if n2 > n1:
                norm[n1:n2] = norm[2 * n1 - n2:n1]
                if dual_stereo:
                    norm2[n1:n2] = norm2[2 * n1 - n2:n1]
        tf_change = tf_res[i]
        ctx.tf_change = tf_change
        effective_lowband = -1
        # with no fold source the band noise-fills: all fill bits set
        x_cm = y_cm = (1 << B) - 1
        if lowband_offset != 0 and (spread != SPREAD_AGGRESSIVE
                                    or B > 1 or tf_change < 0):
            x_cm = y_cm = 0
            effective_lowband = max(0, M * eb[lowband_offset]
                                    - norm_offset - N)
            fold_start = lowband_offset
            while True:
                fold_start -= 1
                if M * eb[fold_start] <= effective_lowband \
                        + norm_offset:
                    break
            fold_end = lowband_offset - 1
            while True:
                fold_end += 1
                if not (fold_end < i and M * eb[fold_end]
                        < effective_lowband + norm_offset + N):
                    break
            # bands.c uses do/while: the first fold band contributes
            # even when fold_start == fold_end
            for fi in range(fold_start, max(fold_end, fold_start + 1)):
                x_cm |= collapse_masks[fi * C + 0]
                y_cm |= collapse_masks[fi * C + C - 1]
        if dual_stereo and i == intensity:
            # back to mid/side coding: average the fold history
            dual_stereo = 0
            norm[:M * eb[i] - norm_offset] = 0.5 * (
                norm[:M * eb[i] - norm_offset]
                + norm2[:M * eb[i] - norm_offset])
        lowband = None
        if effective_lowband != -1:
            lowband = norm[effective_lowband:effective_lowband + N]
        lowband_out = None
        off = M * eb[i] - norm_offset
        if not last:
            lowband_out = norm[off:off + N]
        if C == 2 and dual_stereo:
            lowband2 = None
            if effective_lowband != -1:
                lowband2 = norm2[effective_lowband:
                                 effective_lowband + N]
            lowband2_out = None if last else norm2[off:off + N]
            x_cm = quant_band(ctx, X, N, b // 2, B, lowband, LM,
                              lowband_out, 1.0, lowband_scratch,
                              x_cm)
            y_cm = quant_band(ctx, Y, N, b // 2, B, lowband2, LM,
                              lowband2_out, 1.0, lowband_scratch,
                              y_cm)
        elif C == 2:
            x_cm = quant_band_stereo(ctx, X, Y, N, b, B, lowband, LM,
                                     lowband_out, lowband_scratch,
                                     x_cm | y_cm)
            y_cm = x_cm
        else:
            x_cm = quant_band(ctx, X, N, b, B, lowband, LM,
                              lowband_out, 1.0, lowband_scratch,
                              x_cm | y_cm)
            y_cm = x_cm
        collapse_masks[i * C + 0] = x_cm & 0xFF
        collapse_masks[i * C + C - 1] = y_cm & 0xFF
        balance += pulses[i] + tell
        update_lowband = b > (N << BITRES)
    return collapse_masks, ctx.seed


# ---------------------------------------------------------------------------
# Synthesis (bands.c denormalise_bands, celt_decoder.c celt_synthesis,
# mdct.c clt_mdct_backward)
# ---------------------------------------------------------------------------

def denormalise_bands(X, freq, bandLogE, start, end, M):
    eb = T.EBANDS
    freq[:M * eb[start]] = 0.0
    for i in range(start, end):
        j0, j1 = M * eb[i], M * eb[i + 1]
        lg = bandLogE[i] + T.E_MEANS[i]
        g = 2.0 ** min(32.0, lg)
        freq[j0:j1] = X[j0:j1] * g
    freq[M * eb[end]:] = 0.0


class _Mdct:
    """Inverse MDCT + low-overlap TDAC as one cached dense matrix per
    size — the MXU-shaped formulation of clt_mdct_backward.

    CELT's analysis window over the 2*N2 input is zero outside a
    centered span of N2+overlap samples: ramp-up `window`, flat ones,
    ramp-down reversed.  Each backward call therefore produces
    N2+overlap windowed samples: the first `overlap` OVERLAP-ADD into
    the previous call's pending tail, the rest are assignments."""

    _cache = {}

    @classmethod
    def _matrix(cls, N2: int, window: np.ndarray,
                overlap: int) -> np.ndarray:
        key = (N2, overlap)
        m = cls._cache.get(key)
        if m is None:
            n = np.arange(2 * N2)[:, None]
            k = np.arange(N2)[None, :]
            # y[n] = sum_k X[k] cos(pi/N2 (n + .5 + N2/2)(k + .5))
            y = np.cos(np.pi / N2 * (n + 0.5 + N2 / 2) * (k + 0.5))
            s = (N2 - overlap) // 2
            seg = y[s:s + N2 + overlap].copy()
            seg[:overlap] *= window[:, None]
            seg[N2:] *= window[::-1][:, None]
            m = seg
            cls._cache[key] = m
        return m

    @classmethod
    def backward(cls, spec: np.ndarray, out: np.ndarray,
                 window: np.ndarray, overlap: int) -> None:
        """spec: N2 coefficients; out: view of length N2 + overlap
        whose first `overlap` samples hold the previous call's
        pending windowed tail (TDAC overlap-add target)."""
        N2 = len(spec)
        m = cls._matrix(N2, window, overlap)
        y = m @ spec
        out[:overlap] += y[:overlap]
        out[overlap:N2 + overlap] = y[overlap:]


def comb_filter(buf, off, T0, T1, N, g0, g1, tapset0, tapset1,
                window, overlap):
    """celt.c comb_filter: pitch post-filter with parameter
    crossfade over the first `overlap` samples.  Runs IN PLACE on
    buf[off:off+N]; lagged taps read buf[off+i-T...], which for
    i >= T is this filter's own output (recursive comb, exactly as
    libopus filters out_syn in place)."""
    if g0 == 0.0 and g1 == 0.0:
        return
    from ..native.celt import get_lib
    _clib = get_lib()
    if _clib is not None and isinstance(buf, np.ndarray) \
            and buf.dtype == np.float64 \
            and buf.flags["C_CONTIGUOUS"]:
        import ctypes
        f64p = ctypes.POINTER(ctypes.c_double)
        g = T.POSTFILTER_GAINS
        g0r = np.asarray(g[tapset0], np.float64)
        g1r = np.asarray(g[tapset1], np.float64)
        w2 = np.asarray(window, np.float64) ** 2
        _clib.gtpu_celt_comb_filter(
            buf.ctypes.data_as(f64p), off, T0, T1, N,
            float(g0), float(g1), g0r.ctypes.data_as(f64p),
            g1r.ctypes.data_as(f64p), w2.ctypes.data_as(f64p),
            overlap, COMBFILTER_MINPERIOD)
        return
    g = T.POSTFILTER_GAINS
    g00, g01, g02 = (g0 * g[tapset0][k] for k in range(3))
    g10, g11, g12 = (g1 * g[tapset1][k] for k in range(3))
    T0 = max(T0, COMBFILTER_MINPERIOD)
    T1 = max(T1, COMBFILTER_MINPERIOD)
    ov = min(overlap, N)
    for i in range(ov):
        p = off + i
        f = window[i] * window[i]
        buf[p] = buf[p] \
            + (1 - f) * (g00 * buf[p - T0]
                         + g01 * (buf[p - T0 + 1] + buf[p - T0 - 1])
                         + g02 * (buf[p - T0 + 2] + buf[p - T0 - 2])) \
            + f * (g10 * buf[p - T1]
                   + g11 * (buf[p - T1 + 1] + buf[p - T1 - 1])
                   + g12 * (buf[p - T1 + 2] + buf[p - T1 - 2]))
    if g1 == 0.0:
        return
    # recursive comb, vectorized in blocks of T1-2: within a block no
    # output depends on another output of the same block (lag >= T1-2)
    L = T1 - 2
    s = ov
    while s < N:
        e = min(N, s + L)
        idx = np.arange(off + s, off + e)
        buf[idx] += g10 * buf[idx - T1] \
            + g11 * (buf[idx - T1 + 1] + buf[idx - T1 - 1]) \
            + g12 * (buf[idx - T1 + 2] + buf[idx - T1 - 2])
        s = e


def anti_collapse(Xc, collapse_masks, LM, C, size, start, end, logE,
                  prev1logE, prev2logE, pulses, seed):
    """bands.c anti_collapse (decode); Xc = per-channel spectra."""
    eb = T.EBANDS
    for i in range(start, end):
        N0 = eb[i + 1] - eb[i]
        depth = ((1 + pulses[i]) // N0) >> LM
        thresh = 0.5 * (2.0 ** (-0.125 * depth))
        sqrt_1 = 1.0 / math.sqrt(N0 << LM)
        for c in range(C):
            prev1 = prev1logE[c * T.N_BANDS + i]
            prev2 = prev2logE[c * T.N_BANDS + i]
            if C == 1:
                prev1 = max(prev1, prev1logE[T.N_BANDS + i])
                prev2 = max(prev2, prev2logE[T.N_BANDS + i])
            Ediff = max(0.0, logE[c * T.N_BANDS + i]
                        - min(prev1, prev2))
            r = 2.0 * (2.0 ** (-Ediff))
            if LM == 3:
                r *= 1.41421356
            r = min(thresh, r) * sqrt_1
            band = Xc[c][eb[i] << LM:eb[i + 1] << LM]
            renormalize = False
            for k in range(1 << LM):
                if not (collapse_masks[i * C + c] & (1 << k)):
                    renormalize = True
                    for j in range(N0):
                        seed = celt_lcg_rand(seed)
                        band[(j << LM) + k] = r if seed & 0x8000 \
                            else -r
            if renormalize:
                renormalise_vector(band, 1.0)
    return seed


# ---------------------------------------------------------------------------
# Frame decoder (celt_decoder.c celt_decode_with_ec, mono)
# ---------------------------------------------------------------------------

class CeltDecoder:
    """48 kHz mono/stereo CELT decoder with cross-frame state."""

    def __init__(self, channels: int = 1):
        assert channels in (1, 2)
        self.channels = channels
        self.window = np.array(
            [math.sin(0.5 * math.pi
                      * math.sin(0.5 * math.pi * (i + 0.5) / OVERLAP)
                      ** 2) for i in range(OVERLAP)], np.float64)
        self.reset()

    def reset(self):
        self.oldBandE = np.zeros(2 * T.N_BANDS)
        self.oldLogE = np.full(2 * T.N_BANDS, -28.0)
        self.oldLogE2 = np.full(2 * T.N_BANDS, -28.0)
        self.decode_mem = np.zeros((self.channels,
                                    DECODE_BUFFER + OVERLAP))
        self.preemph_mem = [0.0] * self.channels
        self.rng = 0
        self.postfilter_period = 0
        self.postfilter_gain = 0.0
        self.postfilter_tapset = 0
        self.postfilter_period_old = 0
        self.postfilter_gain_old = 0.0
        self.postfilter_tapset_old = 0

    def decode_frame(self, data: bytes, frame_size: int,
                     end_band: int = 21, start_band: int = 0,
                     rd: "RangeDecoder" = None) -> np.ndarray:
        """Decode one CELT frame of `frame_size` samples at 48 kHz.
        Returns float64 PCM in [-1, 1].

        For hybrid Opus (celt_decoder.c celt_decode_with_ec with a
        caller-supplied ec_dec): pass the range decoder already
        advanced past the SILK layer plus start_band=17; `data` must
        be the same buffer `rd` was created over (total_bits and the
        raw end-bits both derive from it)."""
        LM = {120: 0, 240: 1, 480: 2, 960: 3}[frame_size]
        M = 1 << LM
        N = frame_size
        C = self.channels
        start, end = start_band, end_band
        eb = T.EBANDS
        total_bits = len(data) * 8
        dec = rd if rd is not None else RangeDecoder(data)
        tell = dec.tell()

        silence = 0
        if tell >= total_bits:
            silence = 1
        elif tell == 1:
            silence = dec.dec_bit_logp(15)
        if silence:
            # all-zero spectrum; burn the remaining bits
            dec.nbits_total += total_bits - dec.tell()

        postfilter_pitch = 0
        postfilter_gain = 0.0
        postfilter_tapset = 0
        if not silence and start == 0 and tell + 16 <= total_bits:
            if dec.dec_bit_logp(1):
                octave = dec.dec_uint(6)
                postfilter_pitch = (16 << octave) \
                    + dec.dec_bits(4 + octave) - 1
                qg = dec.dec_bits(3)
                if dec.tell() + 2 <= total_bits:
                    postfilter_tapset = dec.dec_icdf(T.TAPSET_ICDF, 2)
                postfilter_gain = 0.09375 * (qg + 1)
            tell = dec.tell()

        is_transient = 0
        if not silence:
            if LM > 0 and tell + 3 <= total_bits:
                is_transient = dec.dec_bit_logp(3)
                tell = dec.tell()
            intra_ener = 0
            if tell + 3 <= total_bits:
                intra_ener = dec.dec_bit_logp(3)
        shortBlocks = M if is_transient else 0
        self.last_info = {"transient": is_transient,
                          "silence": silence,
                          "pf": (postfilter_pitch, postfilter_gain,
                                 postfilter_tapset)}

        X = np.zeros(M * eb[T.N_BANDS])
        Y = np.zeros(M * eb[T.N_BANDS]) if C == 2 else None
        pulses = [0] * T.N_BANDS
        fine_quant = [0] * T.N_BANDS
        anti_collapse_on = 0
        if not silence:
            unquant_coarse_energy(dec, start, end, self.oldBandE,
                                  intra_ener, LM, C, total_bits)
            tf_res = tf_decode(dec, start, end, is_transient, LM,
                               total_bits)
            tell = dec.tell()
            spread = SPREAD_NORMAL
            if tell + 4 <= total_bits:
                spread = dec.dec_icdf(T.SPREAD_ICDF, 5)
            cap = [(T.CACHE_CAPS[T.N_BANDS * (2 * LM + C - 1) + i]
                    + 64) * C * ((eb[i + 1] - eb[i]) << LM) >> 2
                   for i in range(T.N_BANDS)]
            offsets = [0] * T.N_BANDS
            dynalloc_logp = 6
            total_bits_frac = total_bits << BITRES
            tell_frac = dec.tell_frac()
            for i in range(start, end):
                width = C * (eb[i + 1] - eb[i]) << LM
                quanta = min(width << BITRES,
                             max(6 << BITRES, width))
                dynalloc_loop_logp = dynalloc_logp
                boost = 0
                while tell_frac + (dynalloc_loop_logp << BITRES) \
                        < total_bits_frac and boost < cap[i]:
                    flag = dec.dec_bit_logp(dynalloc_loop_logp)
                    tell_frac = dec.tell_frac()
                    if not flag:
                        break
                    boost += quanta
                    total_bits_frac -= quanta
                    dynalloc_loop_logp = 1
                offsets[i] = boost
                if boost > 0:
                    dynalloc_logp = max(2, dynalloc_logp - 1)
            alloc_trim = 5
            tell_frac = dec.tell_frac()
            if tell_frac + (6 << BITRES) <= total_bits_frac:
                alloc_trim = dec.dec_icdf(T.TRIM_ICDF, 7)
            bits = (len(data) * 8 << BITRES) - dec.tell_frac() - 1
            anti_collapse_rsv = (1 << BITRES) if (
                is_transient and LM >= 2
                and bits >= ((LM + 2) << BITRES)) else 0
            bits -= anti_collapse_rsv
            (pulses, fine_quant, fine_priority, codedBands, balance,
             intensity, dual_stereo) = clt_compute_allocation(
                start, end, offsets, cap, alloc_trim, bits, C, LM,
                dec)
            self.last_info.update(
                spread=spread, trim=alloc_trim, coded=codedBands,
                offsets=list(offsets), pulses=list(pulses),
                fine=list(fine_quant), intra=intra_ener,
                energies=[round(float(x), 2)
                          for x in self.oldBandE[:21]])
            unquant_fine_energy(dec, start, end, self.oldBandE,
                                fine_quant, C)
            collapse_masks, self.rng = quant_all_bands(
                dec, start, end, X, Y, pulses, shortBlocks, spread,
                dual_stereo, intensity, tf_res,
                (len(data) * 8 << BITRES) - anti_collapse_rsv,
                balance, LM, codedBands, self.rng)
            if anti_collapse_rsv > 0:
                anti_collapse_on = dec.dec_bits(1)
            unquant_energy_finalise(
                dec, start, end, self.oldBandE, fine_quant,
                fine_priority, len(data) * 8 - dec.tell(), C)
            if anti_collapse_on:
                self.rng = anti_collapse(
                    [X] if C == 1 else [X, Y], collapse_masks, LM, C,
                    N, start, end, self.oldBandE, self.oldLogE,
                    self.oldLogE2, pulses, self.rng)
        if silence:
            self.oldBandE[:] = -28.0

        # synthesis into the rolling decode buffers; the full OVERLAP
        # pending tail (windowed last samples of the previous frame's
        # final transform) shifts down with the history
        hist_off = DECODE_BUFFER - N
        if is_transient:
            B, NB = M, SHORT_MDCT
        else:
            B, NB = 1, SHORT_MDCT << LM
        for c in range(C):
            self.decode_mem[c, :DECODE_BUFFER - N + OVERLAP] = \
                self.decode_mem[c, N:DECODE_BUFFER + OVERLAP].copy()
            out = self.decode_mem[c, DECODE_BUFFER - N:]
            freq = np.zeros(N)
            spec = X if c == 0 else Y
            bandE = self.oldBandE[c * T.N_BANDS:(c + 1) * T.N_BANDS]
            denormalise_bands(spec, freq, bandE, start, end, M)
            for b in range(B):
                _Mdct.backward(freq[b::B], out[NB * b:NB * b + NB
                                               + OVERLAP],
                               self.window, OVERLAP)

        # pitch post-filter (with crossfade from last frame's params)
        for c in range(C):
            buf = self.decode_mem[c]
            comb_filter(buf, hist_off, self.postfilter_period_old,
                        self.postfilter_period, SHORT_MDCT,
                        self.postfilter_gain_old,
                        self.postfilter_gain,
                        self.postfilter_tapset_old,
                        self.postfilter_tapset, self.window, OVERLAP)
            if LM != 0:
                comb_filter(buf, hist_off + SHORT_MDCT,
                            self.postfilter_period, postfilter_pitch,
                            N - SHORT_MDCT, self.postfilter_gain,
                            postfilter_gain, self.postfilter_tapset,
                            postfilter_tapset, self.window, OVERLAP)
        self.postfilter_period_old = self.postfilter_period
        self.postfilter_gain_old = self.postfilter_gain
        self.postfilter_tapset_old = self.postfilter_tapset
        self.postfilter_period = postfilter_pitch
        self.postfilter_gain = postfilter_gain
        self.postfilter_tapset = postfilter_tapset
        if LM != 0:
            self.postfilter_period_old = self.postfilter_period
            self.postfilter_gain_old = self.postfilter_gain
            self.postfilter_tapset_old = self.postfilter_tapset

        # energy state rotation
        if not is_transient:
            self.oldLogE2[:] = self.oldLogE
            self.oldLogE[:] = self.oldBandE
        else:
            np.minimum(self.oldLogE, self.oldBandE, out=self.oldLogE)
        for i in list(range(0, start)) + list(range(end, T.N_BANDS)):
            for c in range(2):
                self.oldBandE[c * T.N_BANDS + i] = 0.0
                self.oldLogE[c * T.N_BANDS + i] = -28.0
                self.oldLogE2[c * T.N_BANDS + i] = -28.0
        self.rng = dec.rng & _M32

        # de-emphasis to PCM; (N,) mono or (N, 2) stereo.
        # y[n] = x[n] + PREEMPH*y[n-1]: same recurrence as the scalar
        # loop, evaluated by lfilter in float64
        from scipy.signal import lfilter
        pcm = np.empty((N, C))
        for c in range(C):
            sig = self.decode_mem[c, hist_off:hist_off + N]
            y, zf = lfilter([1.0], [1.0, -PREEMPH], sig,
                            zi=[PREEMPH * self.preemph_mem[c]])
            pcm[:, c] = y
            self.preemph_mem[c] = y[-1]
        pcm /= 32768.0
        return pcm[:, 0] if C == 1 else pcm


# ---------------------------------------------------------------------------
# Opus packet layer (RFC 6716 §3): TOC + frame packing for CELT modes
# ---------------------------------------------------------------------------

# TOC config -> (frame_size @48k, end_band) for CELT-only configs
CELT_CONFIGS = {}
for _g, _end in ((16, 13), (20, 17), (24, 19), (28, 21)):
    for _k, _fs in enumerate((120, 240, 480, 960)):
        CELT_CONFIGS[_g + _k] = (_fs, _end)


def parse_opus_packet(pkt: bytes):
    """Split an Opus packet into its frames (RFC 6716 §3.2).
    Returns (config, stereo, [frame bytes])."""
    if not pkt:
        raise ValueError("empty opus packet")
    toc = pkt[0]
    config = toc >> 3
    stereo = (toc >> 2) & 1
    code = toc & 3
    body = pkt[1:]

    def read_len(data, pos):
        b = data[pos]
        if b < 252:
            return b, pos + 1
        return b + data[pos + 1] * 4, pos + 2

    if code == 0:
        frames = [body]
    elif code == 1:
        half = len(body) // 2
        frames = [body[:half], body[half:half * 2]]
    elif code == 2:
        n1, off = read_len(body, 0)
        frames = [body[off:off + n1], body[off + n1:]]
    else:
        b0 = body[0]
        M = b0 & 0x3F
        padding = (b0 >> 6) & 1
        vbr = (b0 >> 7) & 1
        pos = 1
        pad = 0
        if padding:
            while True:
                p = body[pos]
                pos += 1
                if p == 255:
                    pad += 254
                else:
                    pad += p
                    break
        payload_end = len(body) - pad
        frames = []
        if vbr:
            lens = []
            for _ in range(M - 1):
                n, pos = read_len(body, pos)
                lens.append(n)
            for n in lens:
                frames.append(body[pos:pos + n])
                pos += n
            frames.append(body[pos:payload_end])
        else:
            per = (payload_end - pos) // M
            for k in range(M):
                frames.append(body[pos + k * per:pos + (k + 1) * per])
    return config, stereo, frames


class OpusCeltDecoder:
    """Decode CELT-only Opus packets (mono or stereo).  SILK/hybrid
    configs raise ValueError — callers fall back to libopus."""

    def __init__(self, channels: Optional[int] = None):
        self._celt = CeltDecoder(channels) if channels else None
        self._channels = channels

    def reset(self):
        if self._celt is not None:
            self._celt.reset()

    def decode(self, pkt: bytes) -> np.ndarray:
        """-> float64 PCM: (n,) mono, (n, 2) stereo."""
        config, stereo, frames = parse_opus_packet(pkt)
        if config not in CELT_CONFIGS:
            raise ValueError(f"not a CELT-only config: {config}")
        ch = 2 if stereo else 1
        if self._celt is None:
            self._celt = CeltDecoder(ch)
            self._channels = ch
        elif ch != self._channels:
            raise ValueError("mono/stereo switch mid-stream")
        frame_size, end_band = CELT_CONFIGS[config]
        out = [self._celt.decode_frame(f, frame_size, end_band)
               for f in frames]
        if out:
            return np.concatenate(out)
        return np.zeros((0, ch)) if ch == 2 else np.zeros(0)
