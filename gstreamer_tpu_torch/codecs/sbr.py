"""Spectral Band Replication (HE-AAC v1) — ISO/IEC 14496-3 §4.6.18.

Clean-room SBR decoder completing the clean-room AAC-LC core in
codecs/aac.py to HE-AAC v1.  The reference framework never decodes
AAC itself (gst-plugins-bad/ext/faad/gstfaad.c:1 wraps faad2,
gst-libav wraps libavcodec); this module implements the tool from
the public spec in the house style: bit-exact entropy decoding in
Python, the hot math — the 32-band analysis and 64-band synthesis
QMF filterbanks — as batched matmuls (one (slots, 64) x (64, bands)
complex product per frame each way, MXU-shaped like the AAC IMDCT).

Pipeline per channel per frame (spec section references):
  analysis QMF over the 1024-sample LC core output  (§4.6.18.4)
  frequency band tables from the header            (§4.6.18.3.2)
  time/frequency grid from sbr_grid                (§4.6.18.3.3)
  HF generation: patches + 2nd-order LPC chirp     (§4.6.18.6)
  HF adjustment: envelopes, noise, sinusoids       (§4.6.18.7)
  synthesis QMF -> 2048 samples at 2x rate         (§4.6.18.4.2)

Normative constants (QMF prototype, Huffman codebooks, noise
phasors, start-offset matrix) live in _sbr_tables.py.

PS (parametric stereo, HE-AAC v2) is NOT implemented: a PS
extension is detected and flagged (`ps_present`), and the SBR-only
decode is returned (mono), never silently half-rate audio.

A copy of the JAX package's ``codecs/sbr.py``: host numpy, the QMF
banks as numpy products.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from . import _sbr_tables as T

# amp_res -> Huffman table set + start-value bit widths
_ENV_TABLES = {
    # (coupled_ch1, amp_res): (t_codes, t_bits, f_codes, f_bits,
    #                          lav, start_bits)
    (False, 0): (T.T_HUFFMAN_ENV_1_5DB_CODES, T.T_HUFFMAN_ENV_1_5DB_BITS,
                 T.F_HUFFMAN_ENV_1_5DB_CODES, T.F_HUFFMAN_ENV_1_5DB_BITS,
                 60, 7),
    (False, 1): (T.T_HUFFMAN_ENV_3_0DB_CODES, T.T_HUFFMAN_ENV_3_0DB_BITS,
                 T.F_HUFFMAN_ENV_3_0DB_CODES, T.F_HUFFMAN_ENV_3_0DB_BITS,
                 31, 6),
    (True, 0): (T.T_HUFFMAN_ENV_BAL_1_5DB_CODES,
                T.T_HUFFMAN_ENV_BAL_1_5DB_BITS,
                T.F_HUFFMAN_ENV_BAL_1_5DB_CODES,
                T.F_HUFFMAN_ENV_BAL_1_5DB_BITS, 24, 6),
    (True, 1): (T.T_HUFFMAN_ENV_BAL_3_0DB_CODES,
                T.T_HUFFMAN_ENV_BAL_3_0DB_BITS,
                T.F_HUFFMAN_ENV_BAL_3_0DB_CODES,
                T.F_HUFFMAN_ENV_BAL_3_0DB_BITS, 12, 5),
}
_NOISE_TABLES = {
    False: (T.T_HUFFMAN_NOISE_3_0DB_CODES, T.T_HUFFMAN_NOISE_3_0DB_BITS,
            T.F_HUFFMAN_ENV_3_0DB_CODES, T.F_HUFFMAN_ENV_3_0DB_BITS,
            31, 5),
    True: (T.T_HUFFMAN_NOISE_BAL_3_0DB_CODES,
           T.T_HUFFMAN_NOISE_BAL_3_0DB_BITS,
           T.F_HUFFMAN_ENV_BAL_3_0DB_CODES,
           T.F_HUFFMAN_ENV_BAL_3_0DB_BITS, 12, 5),
}

FIXFIX, FIXVAR, VARFIX, VARVAR = range(4)
_LIM_GAINS = (0.70795, 1.0, 1.41254, 1e10)       # -3/0/+3/inf dB
_H_SMOOTH = (0.33333333333333, 0.30150283239582,
             0.21816949906249, 0.11516383427084,
             0.03183050093751)
_BW_TAB = (0.0, 0.75, 0.9, 0.98)
_NOISE_FLOOR_OFFSET = 6
_EPS = 1e-12


class _Huff:
    """Canonical (codes, lengths) decoder; symbol = index - lav."""

    def __init__(self, codes, bits, lav: int):
        self.map = {}
        for i, (c, b) in enumerate(zip(codes, bits)):
            self.map[(b, c)] = i - lav
        self.maxlen = max(bits)

    def decode(self, br) -> int:
        code = 0
        for ln in range(1, self.maxlen + 1):
            code = (code << 1) | br.read1()
            v = self.map.get((ln, code))
            if v is not None:
                return v
        raise ValueError("sbr: bad huffman code")


_HUFF_CACHE = {}


def _huff(key, codes, bits, lav) -> _Huff:
    h = _HUFF_CACHE.get(key)
    if h is None:
        h = _HUFF_CACHE[key] = _Huff(codes, bits, lav)
    return h


# ------------------------------------------------------------ QMF banks

_QMF_WIN = np.asarray(T.QMF_WINDOW_640, np.float64)
_QMF_WIN_DS = _QMF_WIN[::2] * 2.0                # 320-tap, 32-band
_NOISE = np.asarray(T.NOISE_TABLE, np.float64).reshape(512, 2)
_NOISE_C = _NOISE[:, 0] + 1j * _NOISE[:, 1]


def _exp_matrix(bands: int, sign: float = 1.0,
                offset: float = -1.0) -> np.ndarray:
    """Modulation exponentials E[k, n] =
    exp(sign * j*pi/(2*bands) * (k+0.5) * (2n + offset)),
    n = 0..2*bands-1 (§4.6.18.4.1 structure).  The absolute phase
    convention is calibrated against the normative decoder in the
    conformance tests; the synthesis is always the exact adjoint, so
    the low band reconstructs bit-identically regardless."""
    k = np.arange(bands)[:, None]
    n = np.arange(2 * bands)[None, :]
    return np.exp(sign * 1j * np.pi / (2.0 * bands) * (k + 0.5)
                  * (2 * n + offset))


_ANA32 = _exp_matrix(32)
_ANA64 = _exp_matrix(64)


class QmfAnalysis:
    """B-band complex analysis bank (§4.6.18.4.1 structure; B=64 for
    the SBR path over the 2x-interpolated core, B=32 for the
    downsampled self-tests).  The per-slot fold is host-side
    bookkeeping; the modulation is ONE (slots, 2B) x (2B, B)
    complex matmul per frame.  State: 10B-sample sliding window."""

    def __init__(self, bands: int = 64):
        self.bands = bands
        self.win = _QMF_WIN if bands == 64 else _QMF_WIN_DS
        self.mat = _ANA64 if bands == 64 else _ANA32
        self.x = np.zeros(10 * bands)

    def process(self, pcm: np.ndarray) -> np.ndarray:
        """(n_samples,) -> (n_slots, B) complex, n_slots = n//B."""
        B = self.bands
        n_slots = len(pcm) // B
        x = self.x
        u = np.empty((n_slots, 2 * B))
        # E(n + 2Bj) = E(n) * (-1)^j for E = exp(j*pi/(2B)*(k+.5)*
        # (2n-1)); the normative window table carries the matching
        # (-1)^j segment signs already, so the 5-segment polyphase
        # fold is a plain sum (the two alternations combine to +1)
        for s in range(n_slots):
            # x[0] = newest sample
            x = np.concatenate([pcm[s * B:(s + 1) * B][::-1],
                                x])[:10 * B]
            z = x * self.win
            u[s] = z.reshape(5, 2 * B).sum(axis=0)
        self.x = x
        return u @ self.mat.T

    def reset(self):
        self.x[:] = 0


class QmfAnalysis32(QmfAnalysis):
    def __init__(self):
        super().__init__(32)


class Upsampler2x:
    """Streaming 2x interpolator (overlap-save, FFT-based brick
    wall).  Replaces the normative 32-analysis/64-synthesis
    upsampling of the low band with an equivalent interpolation so
    the SBR path can run one self-consistent 64-band QMF pair."""

    MARGIN = 128

    def __init__(self):
        self.hist = np.zeros(2 * self.MARGIN)

    def process(self, pcm: np.ndarray) -> np.ndarray:
        """(n,) -> (2n,), delayed by MARGIN input samples."""
        m = self.MARGIN
        blk = np.concatenate([self.hist, pcm])
        n = len(blk)
        spec = np.fft.rfft(blk)
        up = np.fft.irfft(spec, 2 * n) * 2.0
        self.hist = blk[-2 * m:]
        # emit the central region: input range [m, m+len(pcm))
        return up[2 * m:2 * m + 2 * len(pcm)]

    def reset(self):
        self.hist[:] = 0


class QmfSynthesis:
    """Complex synthesis bank: the exact adjoint of the analysis
    structure (64-band for full-rate SBR output, 32-band for the
    downsampled self-test).  For each slot the subbands are
    demodulated (one matmul), windowed with the prototype, and
    overlap-added time-reversed; each output sample accumulates 10
    contributions (320-tap / hop 32, resp. 640/64)."""

    def __init__(self, bands: int = 64):
        self.bands = bands
        B = bands
        self.win = (_QMF_WIN if B == 64 else _QMF_WIN_DS)
        self.mat = _ANA64 if B == 64 else _ANA32
        self.taps = 10 * B
        self.acc = np.zeros(self.taps)
        # gain: the analysis+adjoint pair scales by the prototype's
        # energy; 1/sum(w^2) normalizes the chain to unity (verified
        # by the perfect-reconstruction tests)
        self.gain = 1.0 / np.dot(self.win, self.win)

    def process(self, X: np.ndarray) -> np.ndarray:
        """(n_slots, bands) complex -> (n_slots * bands,) float."""
        B = self.bands
        n_slots = X.shape[0]
        # demodulate: (slots, bands) x (bands, 2B) -> real part
        r_all = (X @ np.conj(self.mat)).real
        out = np.empty(n_slots * B)
        acc = self.acc
        nseg = 5
        for s in range(n_slots):
            r = r_all[s]
            # f[q] = w[q] * Re(sum_k X_k conj(E(q))); the window
            # table's built-in segment signs supply E's (-1)^segment
            # continuation, exactly as in the analysis fold
            f = self.win * np.tile(r, nseg)
            # adjoint scatter: f[q] contributes to sample t_m - q;
            # acc is ordered oldest..newest -> reversed overlap-add
            acc += f[::-1]
            # oldest B samples are now complete
            out[s * B:(s + 1) * B] = acc[:B] * self.gain
            acc = np.concatenate([acc[B:], np.zeros(B)])
        self.acc = acc
        return out

    def reset(self):
        self.acc[:] = 0


# ------------------------------------------------------- band tables

_FLT_MIN = 1.17549435e-38
_FLT_EPS = 1.1920929e-07
# my QMF power scale -> spec/int16-domain scale (calibrated against
# the system decoder's in-memory e_curr; see tests/test_sbr.py)
_ENERGY_SCALE = 1.0
_H_SMOOTH_COL = np.asarray(_H_SMOOTH)[:, None]
_SINE_PHI_RE = (1.0, 0.0, -1.0, 0.0)
_SINE_PHI_IM = (0.0, 1.0, 0.0, -1.0)
# test hook: when set, _hf_adjust reports its per-envelope arrays
# (e_orig/q_map/e_curr/gain/q_m/s_m) for parity checks against the
# system decoder's in-memory state (tests/sbr_oracle.py)
_DEBUG_TAP = None

def _make_bands(start: int, stop: int, num: int) -> List[int]:
    """Logarithmically spaced band widths (§4.6.18.3.2.1)."""
    base = (stop / start) ** (1.0 / num)
    prod = float(start)
    prev = start
    out = []
    for _ in range(num - 1):
        prod *= base
        cur = int(round(prod))
        out.append(cur - prev)
        prev = cur
    out.append(stop - prev)
    return out


def _fs_group(fs: int) -> int:
    if fs == 16000:
        return 0
    if fs == 22050:
        return 1
    if fs == 24000:
        return 2
    if fs == 32000:
        return 3
    if fs in (44100, 48000, 64000):
        return 4
    return 5


@dataclass
class SbrHeader:
    amp_res: int = 1
    start_freq: int = 5
    stop_freq: int = 0
    xover_band: int = 0
    freq_scale: int = 2
    alter_scale: int = 1
    noise_bands: int = 2
    limiter_bands: int = 2
    limiter_gains: int = 2
    interpol_freq: int = 1
    smoothing_mode: int = 1


@dataclass
class FreqTables:
    k0: int
    k2: int
    f_master: List[int]
    f_high: List[int]
    f_low: List[int]
    f_noise: List[int]
    f_lim: List[int]
    kx: int
    M: int
    patches: List[Tuple[int, int]]       # (start_subband, n_subbands)


def make_freq_tables(hdr: SbrHeader, sample_rate: int) -> FreqTables:
    """§4.6.18.3.2: master table and derived tables.  sample_rate is
    the SBR (output) rate = 2x the core rate.  Validated field-by-
    field against the system decoder's in-memory derived state
    (tests/sbr_oracle.py) across header configurations."""
    fs = sample_rate
    temp = 3000 if fs < 32000 else (4000 if fs < 64000 else 5000)
    start_min = ((temp << 7) + (fs >> 1)) // fs
    stop_min = ((temp << 8) + (fs >> 1)) // fs
    k0 = start_min + T.SBR_OFFSET[_fs_group(fs)][hdr.start_freq]
    if hdr.stop_freq < 14:
        dk = sorted(_make_bands(stop_min, 64, 13))
        k2 = stop_min + sum(dk[:hdr.stop_freq])
    elif hdr.stop_freq == 14:
        k2 = 2 * k0
    else:
        k2 = 3 * k0
    k2 = min(64, k2)
    if fs <= 32000:
        max_bands = 48
    elif fs == 44100:
        max_bands = 35
    else:
        max_bands = 32
    if k2 <= k0 or k2 - k0 > max_bands:
        raise ValueError(f"sbr: bad frequency range k0={k0} k2={k2}")

    if hdr.freq_scale == 0:
        dk = 2 if hdr.alter_scale else 1
        if dk == 2:
            num_bands = 2 * ((k2 - k0 + 2) // 4)
        else:
            num_bands = 2 * ((k2 - k0) // 2)
        if num_bands <= 0:
            raise ValueError("sbr: empty master table")
        f_master = [k0]
        for _ in range(num_bands):
            f_master.append(f_master[-1] + dk)
        # rounding compensation (§4.6.18.3.2.1): a positive remainder
        # widens the last band; a negative one narrows the first
        # band(s) by one subband each
        k2diff = k2 - k0 - num_bands * dk
        if k2diff < 0:
            for i in range(1, len(f_master)):
                f_master[i] -= 1
            if k2diff < -1:
                for i in range(2, len(f_master)):
                    f_master[i] -= 1
        elif k2diff:
            f_master[-1] += k2diff
    else:
        half_bands = (6, 5, 4)[hdr.freq_scale - 1]
        if k2 * 10000 > 22449 * k0:
            two_regions = True
            k1 = 2 * k0
        else:
            two_regions = False
            k1 = k2
        num_bands0 = 2 * int(round(half_bands * np.log2(k1 / k0)))
        if num_bands0 <= 0:
            raise ValueError("sbr: empty master table")
        vdk0 = sorted(_make_bands(k0, k1, num_bands0))
        if vdk0[0] <= 0:
            raise ValueError("sbr: bad band widths")
        vk0 = [k0]
        for w in vdk0:
            vk0.append(vk0[-1] + w)
        if two_regions:
            warp = 1.3 if hdr.alter_scale else 1.0
            num_bands1 = 2 * int(round(
                half_bands * np.log2(k2 / k1) / warp))
            vdk1 = sorted(_make_bands(k1, k2, num_bands1))
            if vdk1 and vdk0 and vdk1[0] < vdk0[-1]:
                # §4.6.18.3.2.1: lift the smallest second-region band
                # to at least the largest first-region band
                change = min(vdk0[-1] - vdk1[0],
                             (vdk1[-1] - vdk1[0]) // 2)
                vdk1[0] += change
                vdk1[-1] -= change
                vdk1 = sorted(vdk1)
            f_master = list(vk0)
            for w in vdk1:
                f_master.append(f_master[-1] + w)
        else:
            f_master = vk0

    n_master = len(f_master) - 1
    if hdr.xover_band >= n_master:
        raise ValueError("sbr: xover_band out of range")
    f_high = f_master[hdr.xover_band:]
    n_high = len(f_high) - 1
    kx = f_high[0]
    M = f_high[-1] - kx
    if kx > 32 or kx + M > 64:
        raise ValueError("sbr: invalid high band range")
    n_low = (n_high + 1) // 2
    odd = n_high & 1
    f_low = [f_high[0]] + [f_high[2 * k - odd]
                           for k in range(1, n_low + 1)]
    n_q = (max(1, int(round(hdr.noise_bands
                            * np.log2(k2 / kx)))) if kx < k2 else 1)
    n_q = min(n_q, 5)
    f_noise = [f_low[0]]
    temp_i = 0
    for k in range(1, n_q + 1):
        temp_i += (n_low - temp_i) // (n_q + 1 - k)
        f_noise.append(f_low[temp_i])

    patches = _make_patches(f_master, k0, kx, M, fs)
    f_lim = _make_lim_table(f_low, patches, kx, hdr.limiter_bands)
    return FreqTables(k0=k0, k2=k2, f_master=f_master, f_high=f_high,
                      f_low=f_low, f_noise=f_noise, f_lim=f_lim,
                      kx=kx, M=M, patches=patches)


def _make_patches(f_master, k0, kx, M, fs) -> List[Tuple[int, int]]:
    """§4.6.18.6.3 patch construction, including the normative drop
    of a trailing patch shorter than 3 subbands."""
    n_master = len(f_master) - 1
    msb = k0
    usb = kx
    patches: List[Tuple[int, int]] = []
    goal_sb = (2048000 + (fs >> 1)) // fs
    if goal_sb < kx + M:
        k = 0
        while f_master[k] < goal_sb:
            k += 1
    else:
        k = n_master
    if n_master == 0 or M == 0:
        return patches
    last = None
    while True:
        if (k, msb) == last:
            raise ValueError("sbr: patch construction does not converge")
        last = (k, msb)
        i = k
        sb = f_master[i]
        odd = (sb + k0) & 1
        while sb > k0 - 1 + msb - odd and i > 0:
            i -= 1
            sb = f_master[i]
            odd = (sb + k0) & 1
        n_sb = max(sb - usb, 0)
        start = k0 - odd - n_sb
        if n_sb > 0:
            patches.append((start, n_sb))
            usb = sb
            msb = sb
        else:
            msb = kx
        if f_master[k] - sb < 3:
            k = n_master
        if sb == kx + M:
            break
        if len(patches) > 6:
            raise ValueError("sbr: too many patches")
    if len(patches) > 1 and patches[-1][1] < 3:
        patches.pop()
    return patches


def _make_lim_table(f_low, patches, kx: int,
                    limiter_bands: int) -> List[int]:
    """§4.6.18.3.2.3 limiter-band table: union of the low-resolution
    borders and the patch borders, thinned so adjacent borders are at
    least 0.49/limiter_bands octaves apart — measured on ABSOLUTE
    subband indices, so the top border k2 itself can be thinned away
    (verified against the system decoder's in-memory f_tablelim);
    subbands above the surviving top border receive no gain."""
    if limiter_bands == 0:
        return [f_low[0], f_low[-1]]
    warped = 2.0 ** (0.49 / (1.2, 2.0, 3.0)[limiter_bands - 1])
    borders = [kx]
    for _start, n_sb in patches:
        borders.append(borders[-1] + n_sb)
    # every patch border (including the top) is protected from
    # thinning; only low-resolution borders may be dropped
    protected = set(borders)
    table = sorted(list(f_low) + borders[1:-1])
    n_lim = (len(f_low) - 1) + max(len(patches), 1) - 1
    out_i, in_i = 0, 1
    while out_i < n_lim and in_i < len(table):
        vin, vout = table[in_i], table[out_i]
        if vin >= vout * warped:
            out_i += 1
            table[out_i] = vin
            in_i += 1
        elif vin == vout or vin not in protected:
            in_i += 1
            n_lim -= 1
        elif vout not in protected:
            table[out_i] = vin
            in_i += 1
            n_lim -= 1
        else:
            out_i += 1
            table[out_i] = vin
            in_i += 1
    return table[:n_lim + 1]


# ---------------------------------------------------------- bitstream

@dataclass
class ChannelData:
    frame_class: int = FIXFIX
    num_env: int = 0
    t_env: List[int] = field(default_factory=list)
    freq_res: List[int] = field(default_factory=list)
    num_noise: int = 0
    t_q: List[int] = field(default_factory=list)
    pointer: int = 0
    l_a: int = -1
    e_a0: int = -1                       # 0 iff prev l_a == prev num_env
    df_env: List[int] = field(default_factory=list)
    df_noise: List[int] = field(default_factory=list)
    invf_mode: List[int] = field(default_factory=list)
    env_q: List[np.ndarray] = None       # num_env x (bands,) quantized
    noise_q: np.ndarray = None           # (num_noise, n_q)
    add_harmonic: List[int] = field(default_factory=list)
    amp_res: int = 1
    # persistent across frames:
    env_q_prev: Optional[np.ndarray] = None
    noise_q_prev: Optional[np.ndarray] = None
    freq_res_prev: int = 1
    bw_prev: Optional[np.ndarray] = None
    s_idx_prev: Optional[np.ndarray] = None   # s_indexmapped[0]
    g_temp: Optional[np.ndarray] = None       # (42, M) smoothing hist
    q_temp: Optional[np.ndarray] = None
    Y_prev: Optional[np.ndarray] = None       # (38, 64) complex
    t_env_last_prev: int = 16                 # prev frame t_env[-1]
    index_noise: int = 0
    index_sine: int = 0


class SbrDecoder:
    """One SBR element (SCE: 1 channel, CPE: 2 channels).

    Buffer conventions follow the spec (§4.6.18.5): the QMF window
    per frame holds 8 history + 32 new slots; HF generation and
    envelope adjustment cover window slots [2*t_env[0]+2,
    2*t_env[-1]+2), i.e. envelope time 0 sits 6 slots before the
    current frame's first new slot; the assembled Y is indexed from
    envelope time (Y[i] <-> window slot i+2), its tail [32:38)
    carried into the next frame's output."""

    def __init__(self, core_rate: int, n_ch: int):
        self.core_rate = core_rate
        self.rate = core_rate * 2
        self.n_ch = n_ch
        self.hdr: Optional[SbrHeader] = None
        self.freq: Optional[FreqTables] = None
        self.ch = [ChannelData() for _ in range(n_ch)]
        self.coupling = 0
        self.ps_present = False
        self.up = [Upsampler2x() for _ in range(n_ch)]
        self.ana = [QmfAnalysis(64) for _ in range(n_ch)]
        self.syn = [QmfSynthesis(64) for _ in range(n_ch)]
        self._Xlow_hist = [np.zeros((8, 64), np.complex128)
                           for _ in range(n_ch)]
        self._kx_prev = 0
        self._M_prev = 0
        self._reset = [True] * n_ch
        self._valid = False

    # -- parsing -----------------------------------------------------------
    def parse_payload(self, br, crc: bool) -> None:
        """sbr_extension_data (§4.4.2.8); br positioned after the
        extension_type nibble."""
        if crc:
            br.read(10)
        if br.read1():
            self._parse_header(br)
        if self.hdr is None:
            return
        if self.freq is None:
            self.freq = make_freq_tables(self.hdr, self.rate)
            for c in range(self.n_ch):
                cd = self.ch[c]
                cd.env_q_prev = None
                cd.noise_q_prev = None
                cd.bw_prev = None
                cd.s_idx_prev = None
                cd.g_temp = None
                cd.q_temp = None
                self._reset[c] = True
        if self.n_ch == 2:
            self._parse_cpe(br)
        else:
            self._parse_sce(br)
        self._valid = True

    def _parse_header(self, br) -> None:
        h = SbrHeader()
        h.amp_res = br.read1()
        h.start_freq = br.read(4)
        h.stop_freq = br.read(4)
        h.xover_band = br.read(3)
        br.read(2)                        # bs_reserved
        extra1 = br.read1()
        extra2 = br.read1()
        if extra1:
            h.freq_scale = br.read(2)
            h.alter_scale = br.read1()
            h.noise_bands = br.read(2)
        if extra2:
            h.limiter_bands = br.read(2)
            h.limiter_gains = br.read(2)
            h.interpol_freq = br.read1()
            h.smoothing_mode = br.read1()
        old = self.hdr
        if (old is None or (old.start_freq, old.stop_freq,
                            old.xover_band, old.freq_scale,
                            old.alter_scale, old.noise_bands)
                != (h.start_freq, h.stop_freq, h.xover_band,
                    h.freq_scale, h.alter_scale, h.noise_bands)):
            self.freq = None              # re-derive tables (reset)
        self.hdr = h

    def _parse_sce(self, br) -> None:
        if br.read1():
            br.read(4)
        self._grid(br, self.ch[0])
        self._dtdf(br, self.ch[0])
        self._invf(br, self.ch[0])
        self.coupling = 0
        self._envelope(br, self.ch[0], False)
        self._noise(br, self.ch[0], False)
        self._sinusoidal(br, self.ch[0])
        self._extended(br)

    def _parse_cpe(self, br) -> None:
        if br.read1():
            br.read(8)
        self.coupling = br.read1()
        c0, c1 = self.ch
        if self.coupling:
            self._grid(br, c0)
            self._copy_grid(c0, c1)
            self._dtdf(br, c0)
            self._dtdf(br, c1)
            self._invf(br, c0)
            c1.invf_mode = list(c0.invf_mode)
            self._envelope(br, c0, False)
            self._noise(br, c0, False)
            self._envelope(br, c1, True)
            self._noise(br, c1, True)
        else:
            self._grid(br, c0)
            self._grid(br, c1)
            self._dtdf(br, c0)
            self._dtdf(br, c1)
            self._invf(br, c0)
            self._invf(br, c1)
            self._envelope(br, c0, False)
            self._envelope(br, c1, False)
            self._noise(br, c0, False)
            self._noise(br, c1, False)
        self._sinusoidal(br, c0)
        self._sinusoidal(br, c1)
        self._extended(br)

    @staticmethod
    def _copy_grid(src: ChannelData, dst: ChannelData) -> None:
        # dst's own transient history feeds its e_a0 before overwrite
        dst.e_a0 = 0 if dst.l_a == dst.num_env and dst.num_env else -1
        dst.frame_class = src.frame_class
        dst.num_env = src.num_env
        dst.t_env = list(src.t_env)
        dst.freq_res = list(src.freq_res)
        dst.num_noise = src.num_noise
        dst.t_q = list(src.t_q)
        dst.pointer = src.pointer
        dst.l_a = src.l_a
        dst.amp_res = src.amp_res

    def _grid(self, br, cd: ChannelData) -> None:
        """sbr_grid (§4.6.18.3.3): envelope/noise time borders in SBR
        border units (16 per frame, 2 QMF slots each)."""
        # l_APrev: envelope 0 of THIS frame is a transient envelope
        # iff the previous frame's l_A pointed one past its last env
        cd.e_a0 = 0 if cd.l_a == cd.num_env and cd.num_env else -1
        cd.frame_class = br.read(2)
        if cd.frame_class == FIXFIX:
            cd.num_env = 1 << br.read(2)
            if cd.num_env > 4:
                raise ValueError("sbr: FIXFIX num_env > 4")
            fr = br.read1()
            cd.freq_res = [fr] * cd.num_env
            cd.t_env = [16 * i // cd.num_env
                        for i in range(cd.num_env + 1)]
            cd.pointer = 0
            cd.l_a = -1
        elif cd.frame_class == FIXVAR:
            var_bord = br.read(2)
            n_rel = br.read(2)
            cd.num_env = n_rel + 1
            rel = [2 * br.read(2) + 2 for _ in range(n_rel)]
            ptr_bits = int(np.ceil(np.log2(cd.num_env + 1)))
            cd.pointer = br.read(ptr_bits)
            cd.freq_res = [br.read1()
                           for _ in range(cd.num_env)][::-1]
            borders = [16 + var_bord]
            for r in rel:
                borders.append(borders[-1] - r)
            cd.t_env = [0] + borders[::-1]
            cd.l_a = (cd.num_env + 1 - cd.pointer
                      if cd.pointer > 0 else -1)
        elif cd.frame_class == VARFIX:
            var_bord = br.read(2)
            n_rel = br.read(2)
            cd.num_env = n_rel + 1
            rel = [2 * br.read(2) + 2 for _ in range(n_rel)]
            ptr_bits = int(np.ceil(np.log2(cd.num_env + 1)))
            cd.pointer = br.read(ptr_bits)
            cd.freq_res = [br.read1() for _ in range(cd.num_env)]
            borders = [var_bord]
            for r in rel:
                borders.append(borders[-1] + r)
            cd.t_env = borders + [16]
            cd.l_a = (cd.pointer - 1 if cd.pointer > 1 else -1)
        else:                             # VARVAR
            bord0 = br.read(2)
            bord1 = br.read(2)
            n_rel0 = br.read(2)
            n_rel1 = br.read(2)
            cd.num_env = n_rel0 + n_rel1 + 1
            rel0 = [2 * br.read(2) + 2 for _ in range(n_rel0)]
            rel1 = [2 * br.read(2) + 2 for _ in range(n_rel1)]
            ptr_bits = int(np.ceil(np.log2(cd.num_env + 1)))
            cd.pointer = br.read(ptr_bits)
            cd.freq_res = [br.read1() for _ in range(cd.num_env)]
            lead = [bord0]
            for r in rel0:
                lead.append(lead[-1] + r)
            trail = [16 + bord1]
            for r in rel1:
                trail.append(trail[-1] - r)
            cd.t_env = lead + trail[::-1]
            cd.l_a = (cd.num_env + 1 - cd.pointer
                      if cd.pointer > 0 else -1)
        if len(cd.t_env) != cd.num_env + 1 or cd.num_env < 1 \
                or cd.num_env > 5:
            raise ValueError("sbr: bad envelope grid")
        if any(b - a <= 0 for a, b in zip(cd.t_env, cd.t_env[1:])):
            raise ValueError("sbr: non-monotonic envelope borders")
        cd.num_noise = 2 if cd.num_env > 1 else 1
        cd.t_q = [cd.t_env[0]] * (cd.num_noise + 1)
        cd.t_q[-1] = cd.t_env[-1]
        if cd.num_noise > 1:
            # middle noise border (§4.6.18.3.3 Table 4.176)
            if cd.frame_class == FIXFIX:
                idx = cd.num_env // 2
            elif cd.frame_class == VARFIX:
                if cd.pointer == 0:
                    idx = 1
                elif cd.pointer == 1:
                    idx = cd.num_env - 1
                else:
                    idx = cd.pointer - 1
            else:                         # FIXVAR / VARVAR
                idx = cd.num_env - max(cd.pointer - 1, 1)
            cd.t_q[1] = cd.t_env[idx]

    def _dtdf(self, br, cd: ChannelData) -> None:
        cd.df_env = [br.read1() for _ in range(cd.num_env)]
        cd.df_noise = [br.read1() for _ in range(cd.num_noise)]

    def _invf(self, br, cd: ChannelData) -> None:
        n_q = len(self.freq.f_noise) - 1
        cd.invf_mode = [br.read(2) for _ in range(n_q)]

    def _n_bands(self, freq_res: int) -> int:
        return len(self.freq.f_high) - 1 if freq_res \
            else len(self.freq.f_low) - 1

    def _envelope(self, br, cd: ChannelData, balance: bool) -> None:
        cd.amp_res = self.hdr.amp_res
        if cd.num_env == 1 and cd.frame_class == FIXFIX:
            cd.amp_res = 0                # §4.6.18.3: forced 1.5 dB
        tc, tb, fc, fb, lav, start_bits = _ENV_TABLES[
            (balance, cd.amp_res)]
        th = _huff(("env_t", balance, cd.amp_res), tc, tb, lav)
        fh = _huff(("env_f", balance, cd.amp_res), fc, fb, lav)
        mult = 2 if balance else 1
        rows = []
        for e in range(cd.num_env):
            n = self._n_bands(cd.freq_res[e])
            row = np.zeros(n, np.int32)
            if cd.df_env[e] == 0:
                row[0] = br.read(start_bits) * mult
                for k in range(1, n):
                    row[k] = row[k - 1] + fh.decode(br) * mult
            else:
                prev = rows[e - 1] if e > 0 else cd.env_q_prev
                prev_res = (cd.freq_res[e - 1] if e > 0
                            else cd.freq_res_prev)
                if prev is None:
                    prev = np.zeros(self._n_bands(cd.freq_res[e]),
                                    np.int32)
                    prev_res = cd.freq_res[e]
                for k in range(n):
                    base = self._map_prev(prev, prev_res,
                                          cd.freq_res[e], k)
                    row[k] = base + th.decode(br) * mult
            rows.append(row)
        cd.env_q = rows
        cd.env_q_prev = rows[-1]
        cd.freq_res_prev = cd.freq_res[-1]

    def _map_prev(self, prev: np.ndarray, prev_res: int,
                  cur_res: int, k: int) -> int:
        """Delta-time across differing freq resolutions
        (§4.6.18.3.5)."""
        if prev_res == cur_res:
            if k < len(prev):
                return int(prev[k])
            return int(prev[-1])
        ft = self.freq
        if cur_res == 1:                  # high now, low before
            target = ft.f_high[k]
            for i in range(len(ft.f_low) - 1):
                if ft.f_low[i] <= target < ft.f_low[i + 1]:
                    return int(prev[min(i, len(prev) - 1)])
            return int(prev[-1])
        # low now, high before
        lo = ft.f_low[k]
        for i in range(len(ft.f_high) - 1):
            if ft.f_high[i] == lo:
                return int(prev[min(i, len(prev) - 1)])
        return int(prev[-1])

    def _noise(self, br, cd: ChannelData, balance: bool) -> None:
        tc, tb, fc, fb, lav, start_bits = _NOISE_TABLES[balance]
        th = _huff(("noise_t", balance), tc, tb, lav)
        fh = _huff(("noise_f", balance), fc, fb, lav)
        mult = 2 if balance else 1
        n_q = len(self.freq.f_noise) - 1
        rows = np.zeros((cd.num_noise, n_q), np.int32)
        for e in range(cd.num_noise):
            if cd.df_noise[e] == 0:
                rows[e][0] = br.read(5) * mult
                for k in range(1, n_q):
                    rows[e][k] = rows[e][k - 1] + fh.decode(br) * mult
            else:
                prev = (rows[e - 1] if e > 0 else cd.noise_q_prev)
                if prev is None:
                    prev = np.zeros(n_q, np.int32)
                for k in range(n_q):
                    p = prev[k] if k < len(prev) else prev[-1]
                    rows[e][k] = p + th.decode(br) * mult
        cd.noise_q = rows
        cd.noise_q_prev = rows[-1]

    def _sinusoidal(self, br, cd: ChannelData) -> None:
        cd.add_harmonic = []
        if br.read1():
            n_high = len(self.freq.f_high) - 1
            cd.add_harmonic = [br.read1() for _ in range(n_high)]

    def _extended(self, br) -> None:
        if not br.read1():
            return
        cnt = br.read(4)
        if cnt == 15:
            cnt += br.read(8)
        bits_left = 8 * cnt - 4
        while bits_left > 7:
            ext_id = br.read(2)
            bits_left -= 2
            if ext_id == 2:               # EXTENSION_ID_PS
                self.ps_present = True
            # skip payload conservatively
            skip = min(bits_left, bits_left - (bits_left % 8))
            br.read(max(skip, 0))
            bits_left = 0

    # -- dequantization (§4.6.18.3.5) --------------------------------------
    def _dequant_env(self, cd: ChannelData, e: int) -> np.ndarray:
        """E_orig for envelope e; for a coupled CPE the first channel
        carries the level and the second the balance."""
        a = 1.0 if cd.amp_res else 0.5
        if not self.coupling:
            q = cd.env_q[e].astype(np.float64)
            return 2.0 ** (q * a + 6.0)
        pan_off = 12.0 if cd.amp_res else 24.0
        ql = self.ch[0].env_q[e].astype(np.float64)
        qr = self.ch[1].env_q[e].astype(np.float64)
        level = 2.0 ** (ql * a + 7.0)
        pan = 2.0 ** ((pan_off - qr) * a)
        ch0 = level / (1.0 + pan)
        return ch0 * pan if cd is self.ch[1] else ch0

    def _dequant_noise(self, cd: ChannelData, e: int) -> np.ndarray:
        if not self.coupling:
            q = cd.noise_q[e].astype(np.float64)
            return 2.0 ** (_NOISE_FLOOR_OFFSET - q)
        ql = self.ch[0].noise_q[e].astype(np.float64)
        qr = self.ch[1].noise_q[e].astype(np.float64)
        level = 2.0 ** (_NOISE_FLOOR_OFFSET - ql + 1.0)
        pan = 2.0 ** (12.0 - qr)
        ch0 = level / (1.0 + pan)
        return ch0 * pan if cd is self.ch[1] else ch0

    # -- processing --------------------------------------------------------
    def process(self, core: np.ndarray) -> np.ndarray:
        """(1024, n_ch) core PCM -> (2048, n_ch) at 2x rate."""
        out = np.empty((2048, self.n_ch))
        for c in range(self.n_ch):
            out[:, c] = self._process_ch(core[:, c], c)
        if self._valid and self.freq is not None:
            self._kx_prev = self.freq.kx
            self._M_prev = self.freq.M
            for cd in self.ch:
                cd.t_env_last_prev = (cd.t_env[-1] if cd.t_env
                                      else 16)
        return out

    def _process_ch(self, pcm: np.ndarray, c: int) -> np.ndarray:
        s2 = self.up[c].process(pcm)                 # 2x interp
        Xnew = self.ana[c].process(s2)               # (32, 64)
        Xbuf = np.concatenate([self._Xlow_hist[c], Xnew])  # (40, 64)
        self._Xlow_hist[c] = Xbuf[-8:]
        if not self._valid or self.freq is None:
            # no SBR data yet: plain 2x upsampled core (same 6-slot
            # output alignment as the adjusted path)
            return self.syn[c].process(Xbuf[2:34])
        ft = self.freq
        cd = self.ch[c]
        if cd.num_env < 1:
            return self.syn[c].process(Xbuf[2:34])

        Xhigh = self._hf_generate(Xbuf, cd)          # (40, 64)
        Y = self._hf_adjust(Xhigh, cd, c)            # (38, 64)

        # output window (§4.6.18.5 x_gen): the tail of the previous
        # frame's Y covers slots before this frame's first envelope
        i_temp = max(2 * cd.t_env_last_prev - 32, 0)
        kx0, M0 = self._kx_prev or ft.kx, self._M_prev or ft.M
        X = np.zeros((32, 64), np.complex128)
        Y_prev = cd.Y_prev
        for i in range(min(i_temp, 32)):
            X[i, :kx0] = Xbuf[i + 2, :kx0]
            if Y_prev is not None and i + 32 < 38:
                X[i, kx0:kx0 + M0] = Y_prev[i + 32, kx0:kx0 + M0]
        lo = min(i_temp, 32)
        X[lo:, :ft.kx] = Xbuf[lo + 2:34, :ft.kx]
        X[lo:, ft.kx:ft.kx + ft.M] = Y[lo:32, ft.kx:ft.kx + ft.M]
        cd.Y_prev = Y
        return self.syn[c].process(X)

    # -- HF generation -----------------------------------------------------
    def _hf_generate(self, Xlow: np.ndarray,
                     cd: ChannelData) -> np.ndarray:
        """§4.6.18.6: per-patch copy-up with 2nd-order LPC chirp.
        Xlow is the 40-slot window; output filled over window slots
        [2*t_env[0]+2, 2*t_env[-1]+2)."""
        ft = self.freq
        n_q = len(ft.f_noise) - 1
        # chirp factors per noise band with inter-frame smoothing
        bw_new = np.array([_BW_TAB[m] for m in cd.invf_mode]
                          if cd.invf_mode else [0.0] * n_q)
        bw_prev = (cd.bw_prev if cd.bw_prev is not None
                   and len(cd.bw_prev) == n_q else np.zeros(n_q))
        bw = np.where(bw_new < bw_prev,
                      0.75 * bw_new + 0.25 * bw_prev,
                      0.90625 * bw_new + 0.09375 * bw_prev)
        bw = np.where(bw < 0.015625, 0.0, bw)
        cd.bw_prev = bw

        # 2nd-order covariance LPC per source subband (§4.6.18.6.2)
        x = Xlow[:, :32]
        x0 = x[2:]
        x1 = x[1:-1]
        x2 = x[:-2]
        phi01 = (x0 * np.conj(x1)).sum(axis=0)
        phi02 = (x0 * np.conj(x2)).sum(axis=0)
        phi11 = (np.abs(x1) ** 2).sum(axis=0)
        phi12 = (x1 * np.conj(x2)).sum(axis=0)
        phi22 = (np.abs(x2) ** 2).sum(axis=0)
        d = phi22 * phi11 - (np.abs(phi12) ** 2) / 1.000001
        a1 = np.where(np.abs(d) > _EPS,
                      (phi01 * phi12 - phi02 * phi11)
                      / np.where(np.abs(d) > _EPS, d, 1.0), 0.0)
        a0 = np.where(np.abs(phi11) > _EPS,
                      -(phi01 + a1 * np.conj(phi12))
                      / np.where(np.abs(phi11) > _EPS, phi11, 1.0),
                      0.0)
        bad = (np.abs(a0) >= 4) | (np.abs(a1) >= 4)
        a0 = np.where(bad, 0.0, a0)
        a1 = np.where(bad, 0.0, a1)

        lo = 2 * cd.t_env[0] + 2
        hi = 2 * cd.t_env[-1] + 2
        Xhigh = np.zeros((40, 64), np.complex128)
        k_high = ft.kx
        for start, n_sb in ft.patches:
            for i in range(n_sb):
                p = start + i
                if k_high >= 64 or p >= 32:
                    break
                gi = 0
                while gi < n_q - 1 and k_high >= ft.f_noise[gi + 1]:
                    gi += 1
                b = bw[gi] if n_q else 0.0
                Xhigh[lo:hi, k_high] = (x[lo:hi, p]
                                        + b * a0[p] * x[lo - 1:hi - 1, p]
                                        + b * b * a1[p]
                                        * x[lo - 2:hi - 2, p])
                k_high += 1
        return Xhigh

    # -- HF adjustment (§4.6.18.7) -----------------------------------------
    def _hf_adjust(self, Xhigh: np.ndarray, cd: ChannelData,
                   c: int) -> np.ndarray:
        ft = self.freq
        hdr = self.hdr
        kx, M = ft.kx, ft.M
        nenv = cd.num_env
        n_high = len(ft.f_high) - 1
        n_q = len(ft.f_noise) - 1
        e_a0, e_a1 = cd.e_a0, cd.l_a

        # ---- mapping: band-wise values onto the M subbands
        e_orig = np.zeros((nenv, M))
        q_map = np.zeros((nenv, M))
        s_idx = np.zeros((nenv + 1, M), bool)
        if cd.s_idx_prev is not None and len(cd.s_idx_prev) == M:
            s_idx[0] = cd.s_idx_prev
        s_map = np.zeros((nenv, M), bool)
        for e in range(nenv):
            table = ft.f_high if cd.freq_res[e] else ft.f_low
            vals = self._dequant_env(cd, e)
            for b in range(len(table) - 1):
                e_orig[e, table[b] - kx:table[b + 1] - kx] = vals[b]
            ne = (1 if cd.num_noise > 1
                  and cd.t_env[e] >= cd.t_q[1] else 0)
            nvals = self._dequant_noise(cd, ne)
            for b in range(n_q):
                q_map[e, ft.f_noise[b] - kx:
                      ft.f_noise[b + 1] - kx] = nvals[b]
            if cd.add_harmonic:
                for b in range(n_high):
                    mid = (ft.f_high[b] + ft.f_high[b + 1]) >> 1
                    s_idx[e + 1, mid - kx] = bool(
                        cd.add_harmonic[b]
                        and (e >= e_a1 or s_idx[0, mid - kx]))
            for b in range(len(table) - 1):
                lo, hi = table[b] - kx, table[b + 1] - kx
                s_map[e, lo:hi] = s_idx[e + 1, lo:hi].any()
        cd.s_idx_prev = s_idx[nenv].copy()

        # ---- current envelope energy (§4.6.18.7.2), spec units
        e_curr = np.zeros((nenv, M))
        for e in range(nenv):
            sl = slice(2 * cd.t_env[e] + 2, 2 * cd.t_env[e + 1] + 2)
            seg = np.abs(Xhigh[sl, kx:kx + M]) ** 2
            if hdr.interpol_freq:
                e_curr[e] = seg.mean(axis=0)
            else:
                table = ft.f_high if cd.freq_res[e] else ft.f_low
                for b in range(len(table) - 1):
                    lo, hi = table[b] - kx, table[b + 1] - kx
                    if hi > lo:
                        e_curr[e, lo:hi] = seg[:, lo:hi].mean()
        e_curr *= _ENERGY_SCALE

        # ---- gain calculation (§4.6.18.7.4-5), per limiter band;
        # subbands outside the limiter table keep zero gain
        gain = np.zeros((nenv, M))
        q_m = np.zeros((nenv, M))
        s_m = np.zeros((nenv, M))
        lim_gain = _LIM_GAINS[hdr.limiter_gains]
        for e in range(nenv):
            delta = 0.0 if (e == e_a0 or e == e_a1) else 1.0
            for k in range(len(ft.f_lim) - 1):
                lo = max(ft.f_lim[k] - kx, 0)
                hi = min(max(ft.f_lim[k + 1] - kx, 0), M)
                if hi <= lo:
                    continue
                sl = slice(lo, hi)
                eo, qm = e_orig[e, sl], q_map[e, sl]
                ec = e_curr[e, sl]
                temp = eo / (1.0 + qm)
                q_m[e, sl] = np.sqrt(temp * qm)
                s_m[e, sl] = np.sqrt(temp * s_idx[e + 1, sl])
                g = np.where(
                    s_map[e, sl],
                    np.sqrt(eo * qm / ((1.0 + ec) * (1.0 + qm))),
                    np.sqrt(eo / ((1.0 + ec) * (1.0 + qm * delta))))
                g = g + _FLT_MIN
                g_max = min(lim_gain * np.sqrt(
                    (_FLT_EPS + eo.sum()) / (_FLT_EPS + ec.sum())),
                    1e5)
                q_m[e, sl] = np.minimum(q_m[e, sl],
                                        q_m[e, sl] * g_max / g)
                g = np.minimum(g, g_max)
                accum = (ec * g * g + s_m[e, sl] ** 2
                         + (delta * (s_m[e, sl] == 0))
                         * q_m[e, sl] ** 2).sum()
                boost = min(np.sqrt((_FLT_EPS + eo.sum())
                                    / (_FLT_EPS + accum)),
                            1.58489319246)
                gain[e, sl] = g * boost
                q_m[e, sl] *= boost
                s_m[e, sl] *= boost

        # ---- assembly (§4.6.18.7.6): per-slot gain smoothing,
        # noise and sinusoid injection
        h_sl = 4 if hdr.smoothing_mode == 0 else 0
        if cd.g_temp is None or cd.g_temp.shape[1] != M:
            cd.g_temp = np.zeros((42, M))
            cd.q_temp = np.zeros((42, M))
            self._reset[c] = True
        g_temp, q_temp = cd.g_temp, cd.q_temp
        t0 = cd.t_env[0]
        if h_sl:
            if self._reset[c]:
                g_temp[2 * t0:2 * t0 + 4] = gain[0]
                q_temp[2 * t0:2 * t0 + 4] = q_m[0]
            else:
                src = 2 * cd.t_env_last_prev
                g_temp[2 * t0:2 * t0 + 4] = g_temp[src:src + 4].copy()
                q_temp[2 * t0:2 * t0 + 4] = q_temp[src:src + 4].copy()
        self._reset[c] = False
        for e in range(nenv):
            sl = slice(h_sl + 2 * cd.t_env[e],
                       h_sl + 2 * cd.t_env[e + 1])
            g_temp[sl] = gain[e]
            q_temp[sl] = q_m[e]

        inv_scale = 1.0 / np.sqrt(_ENERGY_SCALE)
        phi_sign = 1.0 - 2.0 * (kx & 1)
        alt = phi_sign * ((-1.0) ** np.arange(M))
        Y = np.zeros((38, 64), np.complex128)
        idx_n, idx_s = cd.index_noise, cd.index_sine
        for e in range(nenv):
            la = (e == e_a0 or e == e_a1)
            sm = s_m[e]
            has_sine = sm.any()
            for i in range(2 * cd.t_env[e], 2 * cd.t_env[e + 1]):
                if h_sl and not la:
                    g_filt = (g_temp[i + h_sl - 4:i + h_sl + 1][::-1]
                              * _H_SMOOTH_COL).sum(axis=0)
                    q_filt = (q_temp[i + h_sl - 4:i + h_sl + 1][::-1]
                              * _H_SMOOTH_COL).sum(axis=0)
                else:
                    g_filt = g_temp[i + h_sl]
                    q_filt = q_temp[i + h_sl]
                row = Xhigh[i + 2, kx:kx + M] * g_filt
                phase = (_SINE_PHI_RE[idx_s]
                         + 1j * _SINE_PHI_IM[idx_s] * alt)
                if la:
                    if has_sine:
                        row = row + sm * phase * inv_scale
                else:
                    noise_idx = (idx_n + 1 + np.arange(M)) & 0x1FF
                    w = _NOISE_C[noise_idx]
                    add = np.where(sm != 0.0, sm * phase,
                                   q_filt * w)
                    row = row + add * inv_scale
                    idx_n = (idx_n + M) & 0x1FF
                idx_s = (idx_s + 1) & 3
                Y[i, kx:kx + M] = row
        cd.index_noise, cd.index_sine = idx_n, idx_s
        if _DEBUG_TAP is not None:
            _DEBUG_TAP({"e_orig": e_orig, "q_map": q_map,
                        "e_curr": e_curr, "gain": gain,
                        "q_m": q_m, "s_m": s_m, "ch": c})
        return Y
