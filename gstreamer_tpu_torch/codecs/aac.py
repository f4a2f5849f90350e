"""Clean-room AAC-LC decoder (ISO/IEC 14496-3).

The reference framework decodes AAC through external libraries
(gst-plugins-bad/ext/faad/gstfaad.c:1 wraps faad2; gst-libav wraps
libavcodec) — the codec itself is not implemented there.  This module
implements the Low Complexity profile from the public spec in the
style of the other clean-room decoders here (codecs/mp3.py,
codecs/vorbis.py): bit-exact entropy decoding in Python, the
filterbank (IMDCT) as batched matmuls over numpy so the hot math is
one dense kernel per window size.

Supported: ADTS and raw (AudioSpecificConfig) streams, SCE/CPE/LFE
elements, window grouping, M/S and intensity stereo, PNS, TNS and
pulse data, and HE-AAC v1: SBR extension payloads in FIL elements
are decoded by the clean-room codecs/sbr.py (QMF filterbanks as
batched matmuls) producing 2x-rate output.  Not supported:
MAIN/LTP prediction, CCE coupling, and PS (HE-AAC v2) — a PS
extension is detected and flagged (`ps_present`), decoding SBR-only,
never silently wrong-rate audio.

Parity: >=60 dB vs the system libavcodec native decoder on
libavcodec-encoded streams (tests/test_aac.py, tests/aac_oracle.py).

A copy of the JAX package's ``codecs/aac.py`` (host numpy, the IMDCT as
numpy products) with one difference: a section codebook the standard
reserves (12) raises ``ValueError``, the decoders' error for a malformed
stream, where the JAX package's lookup raises ``KeyError`` (ROADMAP.md
section 3).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ._aac_tables import (NUM_SWB_1024, NUM_SWB_128, SF_BITS, SF_CODES,
                          SPEC_BITS, SPEC_CODES, SWB_OFFSET_1024,
                          SWB_OFFSET_128, TNS_MAX_BANDS_1024,
                          TNS_MAX_BANDS_128)

SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350]

# window sequences
ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3
# syntactic element ids (Table 4.71)
SCE, CPE, CCE, LFE, DSE, PCE, FIL, END = range(8)
# section codebooks
ZERO_HCB, NOISE_HCB, INTENSITY_HCB2, INTENSITY_HCB = 0, 13, 14, 15
ESC_HCB = 11
# FIL extension types (Table 4.51)
EXT_SBR_DATA, EXT_SBR_DATA_CRC = 0xD, 0xE


class EndOfData(Exception):
    pass


class Bits:
    """MSB-first bit reader."""

    __slots__ = ("d", "pos", "n")

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0
        self.n = len(data) * 8

    def read(self, nbits: int) -> int:
        p = self.pos
        if p + nbits > self.n:
            raise EndOfData
        self.pos = p + nbits
        v = 0
        while nbits > 0:
            byte = self.d[p >> 3]
            avail = 8 - (p & 7)
            take = min(avail, nbits)
            v = (v << take) | ((byte >> (avail - take))
                              & ((1 << take) - 1))
            p += take
            nbits -= take
        return v

    def read1(self) -> int:
        p = self.pos
        if p >= self.n:
            raise EndOfData
        self.pos = p + 1
        return (self.d[p >> 3] >> (7 - (p & 7))) & 1

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


class Huff:
    """Prefix-code decoder from explicit (code, length) tables."""

    def __init__(self, codes, lengths):
        self.map: Dict[Tuple[int, int], int] = {}
        self.maxlen = max(lengths)
        for sym, (c, ln) in enumerate(zip(codes, lengths)):
            self.map[(ln, c)] = sym

    def decode(self, br: Bits) -> int:
        acc = 0
        m = self.map
        for ln in range(1, self.maxlen + 1):
            acc = (acc << 1) | br.read1()
            s = m.get((ln, acc))
            if s is not None:
                return s
        raise ValueError("aac: bad huffman code")


_SF_HUFF = Huff(SF_CODES, SF_BITS)
_SPEC_HUFF = [Huff(SPEC_CODES[i], SPEC_BITS[i]) for i in range(11)]

# codebook configs: (dimension, modulus, offset, signed)
# ISO 14496-3 Table 4.151 / §4.6.3.3 index arithmetic
_CB_CFG = {
    1: (4, 3, -1, True), 2: (4, 3, -1, True),
    3: (4, 3, 0, False), 4: (4, 3, 0, False),
    5: (2, 9, -4, True), 6: (2, 9, -4, True),
    7: (2, 8, 0, False), 8: (2, 8, 0, False),
    9: (2, 13, 0, False), 10: (2, 13, 0, False),
    11: (2, 17, 0, False),
}


def _unpack_index(idx: int, dim: int, mod: int, off: int) -> List[int]:
    out = [0] * dim
    for k in range(dim - 1, -1, -1):
        out[k] = idx % mod + off
        idx //= mod
    return out


_IMDCT_MAT: Dict[int, np.ndarray] = {}
_WINDOWS: Dict[Tuple[int, int], np.ndarray] = {}


def _imdct_matrix(N: int) -> np.ndarray:
    m = _IMDCT_MAT.get(N)
    if m is None:
        n0 = (N / 2 + 1) / 2
        n = np.arange(N, dtype=np.float64)
        k = np.arange(N // 2, dtype=np.float64)
        m = (2.0 / N) * np.cos(
            (2.0 * np.pi / N) * np.outer(k + 0.5, n + n0))
        _IMDCT_MAT[N] = m
    return m


def _window(shape: int, N: int) -> np.ndarray:
    """Full N-point window: sine (shape 0) or KBD (shape 1),
    ISO 14496-3 §4.6.11.3."""
    w = _WINDOWS.get((shape, N))
    if w is None:
        if shape == 0:
            w = np.sin(np.pi / N * (np.arange(N) + 0.5))
        else:
            alpha = 4.0 if N == 2048 else 6.0
            half = N // 2
            j = np.arange(half + 1, dtype=np.float64)
            kern = np.i0(np.pi * alpha
                         * np.sqrt(1.0 - ((j - half / 2)
                                          / (half / 2)) ** 2))
            c = np.cumsum(kern)
            left = np.sqrt(c[:half] / c[-1])
            w = np.concatenate([left, left[::-1]])
        _WINDOWS[(shape, N)] = w
    return w


# decode-order -> canonical output-order permutation per
# channel_configuration (ISO 14496-3 Table 1.19: elements arrive
# center-first; output follows the usual FL FR FC [LFE] BL BR layout)
_CHAN_ORDER = {
    3: [1, 2, 0],
    4: [1, 2, 0, 3],
    5: [1, 2, 0, 3, 4],
    6: [1, 2, 0, 5, 3, 4],
    7: [1, 2, 0, 7, 5, 6, 3, 4],
}


class _ICS:
    """Per-channel individual channel stream state for one frame."""

    __slots__ = ("window_sequence", "window_shape", "max_sfb",
                 "num_groups", "group_len", "cb", "sf", "coef",
                 "tns", "num_swb", "offsets")


class AACDecoder:
    """Stateful raw_data_block decoder.

    sfi: sampling frequency index; channels inferred from the element
    sequence of the first frame."""

    def __init__(self, sfi: int, chan_config: int = 0):
        if not 0 <= sfi < 13:
            raise ValueError("aac: bad sampling frequency index")
        self.sfi = sfi
        self.rate = SAMPLE_RATES[sfi]
        self.chan_config = chan_config
        self._slots: Dict[Tuple[int, int], List[int]] = {}
        self._nch = 0
        self._overlap: List[np.ndarray] = []
        self._prev_shape: List[int] = []
        self._prev_seq: List[int] = []
        self._rng = np.random.default_rng(0x41414343)
        self._sbr: Dict[Tuple[int, int], object] = {}
        self._plain_up: Dict[int, object] = {}
        self._last_key: Optional[Tuple[Tuple[int, int], int]] = None
        self.sbr_present = False
        self.ps_present = False

    @property
    def output_rate(self) -> int:
        """PCM rate of decode_frame output: 2x the core rate once an
        SBR extension has been seen (HE-AAC), else the core rate."""
        return self.rate * 2 if self._sbr else self.rate

    # ------------------------------------------------------------ ics
    def _ics_info(self, br: Bits, ics: _ICS) -> None:
        br.read1()                              # ics_reserved_bit
        ics.window_sequence = br.read(2)
        ics.window_shape = br.read1()
        if ics.window_sequence == EIGHT_SHORT:
            ics.max_sfb = br.read(4)
            grouping = br.read(7)
            lens = [1]
            for b in range(6, -1, -1):
                if (grouping >> b) & 1:
                    lens[-1] += 1
                else:
                    lens.append(1)
            ics.num_groups = len(lens)
            ics.group_len = lens
            ics.num_swb = NUM_SWB_128[self.sfi]
            ics.offsets = SWB_OFFSET_128[self.sfi]
        else:
            ics.max_sfb = br.read(6)
            if br.read1():                       # predictor_data_present
                raise ValueError("aac: MAIN/LTP prediction unsupported")
            ics.num_groups = 1
            ics.group_len = [1]
            ics.num_swb = NUM_SWB_1024[self.sfi]
            ics.offsets = SWB_OFFSET_1024[self.sfi]
        if ics.max_sfb > ics.num_swb:
            raise ValueError("aac: max_sfb out of range")

    def _section_data(self, br: Bits, ics: _ICS) -> None:
        bits = 3 if ics.window_sequence == EIGHT_SHORT else 5
        esc = (1 << bits) - 1
        ics.cb = []
        for g in range(ics.num_groups):
            row = [ZERO_HCB] * ics.max_sfb
            k = 0
            while k < ics.max_sfb:
                cb = br.read(4)
                ln = 0
                while True:
                    inc = br.read(bits)
                    ln += inc
                    if inc != esc:
                        break
                if k + ln > ics.max_sfb:
                    raise ValueError("aac: section overflow")
                for i in range(k, k + ln):
                    row[i] = cb
                k += ln
            ics.cb.append(row)

    def _scale_factor_data(self, br: Bits, ics: _ICS,
                           global_gain: int) -> None:
        sf = global_gain
        noise_nrg = global_gain - 90
        is_pos = 0
        noise_first = True
        ics.sf = []
        for g in range(ics.num_groups):
            row = [0] * ics.max_sfb
            for sfb in range(ics.max_sfb):
                cb = ics.cb[g][sfb]
                if cb == ZERO_HCB:
                    continue
                if cb in (INTENSITY_HCB, INTENSITY_HCB2):
                    is_pos += _SF_HUFF.decode(br) - 60
                    row[sfb] = is_pos
                elif cb == NOISE_HCB:
                    if noise_first:
                        noise_nrg += br.read(9) - 256
                        noise_first = False
                    else:
                        noise_nrg += _SF_HUFF.decode(br) - 60
                    row[sfb] = noise_nrg
                else:
                    sf += _SF_HUFF.decode(br) - 60
                    row[sfb] = sf
            ics.sf.append(row)

    def _pulse_data(self, br: Bits) -> List[Tuple[int, int]]:
        npulse = br.read(2) + 1
        start_sfb = br.read(6)
        pulses = []
        for _ in range(npulse):
            pulses.append((br.read(5), br.read(4)))
        return [(start_sfb, pulses)]

    def _tns_data(self, br: Bits, ics: _ICS):
        short = ics.window_sequence == EIGHT_SHORT
        nwin = 8 if short else 1
        filt_bits = 1 if short else 2
        len_bits = 4 if short else 6
        ord_bits = 3 if short else 5
        tns = []
        for _ in range(nwin):
            n_filt = br.read(filt_bits)
            coef_res = br.read1() if n_filt else 0
            filts = []
            for _ in range(n_filt):
                length = br.read(len_bits)
                order = br.read(ord_bits)
                if order:
                    direction = br.read1()
                    compress = br.read1()
                    coef_bits = coef_res + 3 - compress
                    coefs = [br.read(coef_bits) for _ in range(order)]
                    filts.append((length, order, direction,
                                  coef_res, coef_bits, coefs))
                else:
                    filts.append((length, 0, 0, 0, 0, []))
            tns.append(filts)
        return tns

    def _spectral_data(self, br: Bits, ics: _ICS) -> np.ndarray:
        """-> quantized coefficients, shape (nwin, 1024 or 128)."""
        short = ics.window_sequence == EIGHT_SHORT
        nbins = 128 if short else 1024
        nwin = 8 if short else 1
        q = np.zeros((nwin, nbins), np.float64)
        win_base = 0
        for g in range(ics.num_groups):
            glen = ics.group_len[g]
            for sfb in range(ics.max_sfb):
                cb = ics.cb[g][sfb]
                lo = ics.offsets[sfb]
                hi = ics.offsets[sfb + 1]
                if cb == ZERO_HCB or cb >= NOISE_HCB:
                    continue
                if cb not in _CB_CFG:
                    raise ValueError(f"aac: reserved codebook {cb}")
                dim, mod, off, signed = _CB_CFG[cb]
                huff = _SPEC_HUFF[cb - 1]
                for w in range(glen):
                    row = q[win_base + w]
                    k = lo
                    while k < hi:
                        idx = huff.decode(br)
                        vals = _unpack_index(idx, dim, mod, off)
                        if not signed:
                            for i, v in enumerate(vals):
                                if v and br.read1():
                                    vals[i] = -v
                        if cb == ESC_HCB:
                            for i, v in enumerate(vals):
                                if abs(v) == 16:
                                    n = 0
                                    while br.read1():
                                        n += 1
                                    word = br.read(n + 4)
                                    mag = (1 << (n + 4)) + word
                                    vals[i] = mag if v > 0 else -mag
                        for v in vals:
                            row[k] = v
                            k += 1
            win_base += glen
        return q

    def _ics_stream(self, br: Bits, common_window: bool,
                    shared: Optional[_ICS]) -> Tuple[_ICS, np.ndarray]:
        ics = _ICS()
        global_gain = br.read(8)
        if common_window and shared is not None:
            for a in ("window_sequence", "window_shape", "max_sfb",
                      "num_groups", "group_len", "num_swb", "offsets"):
                setattr(ics, a, getattr(shared, a))
        else:
            self._ics_info(br, ics)
        self._section_data(br, ics)
        self._scale_factor_data(br, ics, global_gain)
        pulses = []
        if br.read1():                           # pulse_data_present
            if ics.window_sequence == EIGHT_SHORT:
                raise ValueError("aac: pulse data in short window")
            pulses = self._pulse_data(br)
        ics.tns = self._tns_data(br, ics) if br.read1() else None
        if br.read1():                           # gain_control_present
            raise ValueError("aac: SSR gain control unsupported")
        q = self._spectral_data(br, ics)
        for start_sfb, pl in pulses:
            k = ics.offsets[start_sfb]
            for offset, amp in pl:
                k += offset
                if q[0][k] > 0:
                    q[0][k] += amp
                else:
                    q[0][k] -= amp
        return ics, q

    # ----------------------------------------------------- reconstruction
    def _dequant(self, ics: _ICS, q: np.ndarray) -> np.ndarray:
        x = np.sign(q) * np.abs(q) ** (4.0 / 3.0)
        win_base = 0
        for g in range(ics.num_groups):
            for sfb in range(ics.max_sfb):
                cb = ics.cb[g][sfb]
                if cb == ZERO_HCB or cb >= NOISE_HCB:
                    continue
                gain = 2.0 ** (0.25 * (ics.sf[g][sfb] - 100))
                lo, hi = ics.offsets[sfb], ics.offsets[sfb + 1]
                for w in range(ics.group_len[g]):
                    x[win_base + w, lo:hi] *= gain
            win_base += ics.group_len[g]
        return x

    def _apply_pns(self, ics: _ICS, x: np.ndarray,
                   other: Optional[np.ndarray] = None,
                   correlate=None) -> None:
        """Fill NOISE_HCB bands with scaled random vectors
        (ISO 14496-3 §4.6.13)."""
        win_base = 0
        for g in range(ics.num_groups):
            for sfb in range(ics.max_sfb):
                if ics.cb[g][sfb] != NOISE_HCB:
                    continue
                nrg = 2.0 ** (0.25 * ics.sf[g][sfb])
                lo, hi = ics.offsets[sfb], ics.offsets[sfb + 1]
                for w in range(ics.group_len[g]):
                    v = self._rng.standard_normal(hi - lo)
                    # scaled so the band's TOTAL energy is nrg^2
                    v *= nrg / np.sqrt((v * v).sum() + 1e-30)
                    x[win_base + w, lo:hi] = v
            win_base += ics.group_len[g]

    def _apply_tns(self, ics: _ICS, x: np.ndarray) -> None:
        """All-pole TNS synthesis filtering (ISO 14496-3 §4.6.9)."""
        if ics.tns is None:
            return
        short = ics.window_sequence == EIGHT_SHORT
        tmb = (TNS_MAX_BANDS_128 if short
               else TNS_MAX_BANDS_1024)[self.sfi]
        mx = min(tmb, ics.max_sfb)
        for w, filts in enumerate(ics.tns):
            bottom = ics.num_swb
            for (length, order, direction, coef_res, coef_bits,
                 coefs) in filts:
                top = bottom
                bottom = max(top - length, 0)
                if order == 0:
                    continue
                # inverse-quantize reflection coefficients (§4.6.9.3)
                res_bits = coef_res + 3
                iqfac = ((1 << (res_bits - 1)) - 0.5) / (np.pi / 2)
                iqfac_m = ((1 << (res_bits - 1)) + 0.5) / (np.pi / 2)
                sign_bit = 1 << (coef_bits - 1)
                refl = []
                for c in coefs:
                    if c & sign_bit:
                        c -= 1 << coef_bits
                    refl.append(np.sin(c / (iqfac if c >= 0
                                            else iqfac_m)))
                # reflection -> direct-form LPC
                a = [1.0]
                for m in range(1, order + 1):
                    b = [a[i] + refl[m - 1] * a[m - i]
                         for i in range(1, m)]
                    a = [1.0] + b + [refl[m - 1]]
                lpc = a[1:]
                start = ics.offsets[min(bottom, mx)]
                end = ics.offsets[min(top, mx)]
                if start >= end:
                    continue
                row = x[w]
                if direction:
                    rng = range(end - 1, start - 1, -1)
                    step = 1
                else:
                    rng = range(start, end)
                    step = -1
                for n in rng:
                    acc = row[n]
                    for i in range(order):
                        m = n + step * (i + 1)
                        if direction:
                            if m >= end:
                                break
                        elif m < start:
                            break
                        acc -= lpc[i] * row[m]
                    row[n] = acc

    def _filterbank(self, ics: _ICS, x: np.ndarray,
                    ch: int) -> np.ndarray:
        """IMDCT + window + overlap-add -> 1024 output samples."""
        prev_shape = self._prev_shape[ch]
        shape = ics.window_shape
        seq = ics.window_sequence
        if seq == EIGHT_SHORT:
            t = x @ _imdct_matrix(256)           # (8, 256)
            wl_first = _window(prev_shape, 256)[:128]
            wl = _window(shape, 256)[:128]
            wr = _window(shape, 256)[128:]
            buf = np.zeros(2048)
            for w in range(8):
                seg = t[w].copy()
                seg[:128] *= wl_first if w == 0 else wl
                seg[128:] *= wr
                o = 448 + 128 * w
                buf[o:o + 256] += seg
        else:
            t = (x @ _imdct_matrix(2048))[0]     # (2048,)
            buf = t.copy()
            if seq == ONLY_LONG:
                buf[:1024] *= _window(prev_shape, 2048)[:1024]
                buf[1024:] *= _window(shape, 2048)[1024:]
            elif seq == LONG_START:
                buf[:1024] *= _window(prev_shape, 2048)[:1024]
                # 1024..1471 flat, short right slope, zeros
                buf[1472:1600] *= _window(shape, 256)[128:]
                buf[1600:] = 0.0
            else:                                # LONG_STOP
                buf[:448] = 0.0
                buf[448:576] *= _window(prev_shape, 256)[:128]
                buf[1024:] *= _window(shape, 2048)[1024:]
        out = buf[:1024] + self._overlap[ch]
        self._overlap[ch] = buf[1024:].copy()
        self._prev_shape[ch] = shape
        self._prev_seq[ch] = seq
        return out

    # ------------------------------------------------------------ elements
    def _alloc(self, key: Tuple[int, int], n: int) -> List[int]:
        slots = self._slots.get(key)
        if slots is None:
            slots = list(range(self._nch, self._nch + n))
            self._slots[key] = slots
            self._nch += n
            for _ in range(n):
                self._overlap.append(np.zeros(1024))
                self._prev_shape.append(0)
                self._prev_seq.append(ONLY_LONG)
        return slots

    def _decode_sce(self, br: Bits, out: Dict[int, np.ndarray],
                    elem: int) -> None:
        tag = br.read(4)
        (ch,) = self._alloc((elem, tag), 1)
        self._last_key = ((elem, tag), 1)
        ics, q = self._ics_stream(br, False, None)
        x = self._dequant(ics, q)
        self._apply_pns(ics, x)
        self._apply_tns(ics, x)
        out[ch] = self._filterbank(ics, x, ch)

    def _decode_cpe(self, br: Bits, out: Dict[int, np.ndarray]) -> None:
        tag = br.read(4)
        chl, chr = self._alloc((CPE, tag), 2)
        self._last_key = ((CPE, tag), 2)
        common = br.read1()
        ms_mask = 0
        ms_used = None
        shared = None
        if common:
            shared = _ICS()
            self._ics_info(br, shared)
            ms_mask = br.read(2)
            if ms_mask == 1:
                ms_used = [[br.read1()
                            for _ in range(shared.max_sfb)]
                           for _ in range(shared.num_groups)]
        ics_l, ql = self._ics_stream(br, common, shared)
        ics_r, qr = self._ics_stream(br, common, shared)
        xl = self._dequant(ics_l, ql)
        xr = self._dequant(ics_r, qr)
        if common:
            self._stereo(ics_l, ics_r, xl, xr, ms_mask, ms_used)
        self._apply_pns(ics_l, xl)
        self._apply_pns(ics_r, xr)
        self._apply_tns(ics_l, xl)
        self._apply_tns(ics_r, xr)
        out[chl] = self._filterbank(ics_l, xl, chl)
        out[chr] = self._filterbank(ics_r, xr, chr)

    def _stereo(self, ics_l: _ICS, ics_r: _ICS, xl, xr,
                ms_mask: int, ms_used) -> None:
        """M/S and intensity stereo (ISO 14496-3 §4.6.8)."""
        win_base = 0
        for g in range(ics_r.num_groups):
            for sfb in range(ics_r.max_sfb):
                cb_r = ics_r.cb[g][sfb]
                lo, hi = ics_r.offsets[sfb], ics_r.offsets[sfb + 1]
                ms = (ms_mask == 2
                      or (ms_mask == 1 and ms_used[g][sfb]))
                if cb_r in (INTENSITY_HCB, INTENSITY_HCB2):
                    invert = (cb_r == INTENSITY_HCB2)
                    if ms_mask == 1 and ms_used[g][sfb]:
                        invert = not invert
                    scale = 0.5 ** (0.25 * ics_r.sf[g][sfb])
                    if invert:
                        scale = -scale
                    for w in range(ics_r.group_len[g]):
                        r = win_base + w
                        xr[r, lo:hi] = xl[r, lo:hi] * scale
                elif ms and cb_r != NOISE_HCB \
                        and ics_l.cb[g][sfb] != NOISE_HCB:
                    for w in range(ics_r.group_len[g]):
                        r = win_base + w
                        m = xl[r, lo:hi].copy()
                        s = xr[r, lo:hi].copy()
                        xl[r, lo:hi] = m + s
                        xr[r, lo:hi] = m - s
            win_base += ics_r.group_len[g]

    def _skip_dse(self, br: Bits) -> None:
        br.read(4)
        align = br.read1()
        cnt = br.read(8)
        if cnt == 255:
            cnt += br.read(8)
        if align:
            br.align()
        br.read(8 * cnt)

    def _skip_pce(self, br: Bits) -> None:
        br.read(4)                               # instance
        br.read(2)                               # object type
        br.read(4)                               # sfi
        nf = br.read(4)
        nb = br.read(4)
        ns = br.read(4)
        nl = br.read(2)
        na = br.read(3)
        nv = br.read(4)
        if br.read1():
            br.read(4)                           # mono mixdown
        if br.read1():
            br.read(4)                           # stereo mixdown
        if br.read1():
            br.read(3)                           # matrix mixdown
        br.read(5 * (nf + ns))
        br.read(4 * (nb + nl + na))
        br.read(5 * nv)
        br.align()
        br.read(8 * br.read(8))                  # comment field

    def _read_fil(self, br: Bits) -> None:
        """FIL element: SBR extension payloads (EXT_SBR_DATA,
        Table 4.51) are routed to the SBR decoder of the preceding
        SCE/CPE; everything else is skipped."""
        cnt = br.read(4)
        if cnt == 15:
            cnt += br.read(8) - 1
        if cnt == 0:
            return
        bits_left = 8 * cnt
        ext = br.read(4)
        bits_left -= 4
        if ext in (EXT_SBR_DATA, EXT_SBR_DATA_CRC) \
                and self._last_key is not None:
            payload = bytearray()
            acc = nb = 0
            for _ in range(bits_left):
                acc = (acc << 1) | br.read1()
                nb += 1
                if nb == 8:
                    payload.append(acc)
                    acc = nb = 0
            if nb:
                payload.append(acc << (8 - nb))
            key, n_ch = self._last_key
            dec = self._sbr.get(key)
            if dec is None:
                from .sbr import SbrDecoder
                dec = SbrDecoder(self.rate, n_ch)
                self._sbr[key] = dec
            try:
                dec.parse_payload(Bits(bytes(payload)),
                                  crc=(ext == EXT_SBR_DATA_CRC))
                self.sbr_present = True
                self.ps_present |= dec.ps_present
            except (EndOfData, ValueError, IndexError):
                pass                       # keep the LC core output
        else:
            br.read(bits_left)

    def decode_frame(self, br: Bits) -> np.ndarray:
        """One raw_data_block -> (1024, nch) float64 in [-1, 1]."""
        out: Dict[int, np.ndarray] = {}
        while True:
            elem = br.read(3)
            if elem == END:
                break
            if elem in (SCE, LFE):
                self._decode_sce(br, out, elem)
            elif elem == CPE:
                self._decode_cpe(br, out)
            elif elem == DSE:
                self._skip_dse(br)
            elif elem == PCE:
                self._skip_pce(br)
            elif elem == FIL:
                self._read_fil(br)
            else:
                raise ValueError(f"aac: element {elem} unsupported")
        nch = max(self._nch, 1)
        frame = np.zeros((1024, nch))
        for ch, pcm in out.items():
            frame[:, ch] = pcm
        if self._sbr:
            # HE-AAC: SBR upsamples each element's channels to 2x;
            # channels without SBR data are plainly interpolated so
            # all channels share the output rate
            up = np.zeros((2048, nch))
            covered = set()
            for key, dec in self._sbr.items():
                chans = self._slots.get(key, [])
                if not chans:
                    continue
                up[:, chans] = dec.process(frame[:, chans])
                covered.update(chans)
            if len(covered) < nch:
                from .sbr import Upsampler2x
                for ch in range(nch):
                    if ch in covered:
                        continue
                    u = self._plain_up.get(ch)
                    if u is None:
                        u = self._plain_up[ch] = Upsampler2x()
                    up[:, ch] = u.process(frame[:, ch])
            frame = up
        self._end_bitpos = br.pos - 3
        perm = _CHAN_ORDER.get(self.chan_config)
        if perm is not None and len(perm) == nch:
            frame = frame[:, perm]
        return frame / 32768.0


# --------------------------------------------------------------- streams

def parse_adts_header(data: bytes, pos: int = 0
                      ) -> Optional[Tuple[int, int, int, int, int]]:
    """-> (frame_length, sfi, channel_config, profile, header_len)."""
    if pos + 7 > len(data):
        return None
    if data[pos] != 0xFF or (data[pos + 1] & 0xF6) != 0xF0:
        return None
    prot_absent = data[pos + 1] & 1
    profile = data[pos + 2] >> 6
    sfi = (data[pos + 2] >> 2) & 0xF
    cc = ((data[pos + 2] & 1) << 2) | (data[pos + 3] >> 6)
    flen = (((data[pos + 3] & 0x3) << 11) | (data[pos + 4] << 3)
            | (data[pos + 5] >> 5))
    hlen = 7 if prot_absent else 9
    if flen < hlen:
        return None
    return flen, sfi, cc, profile, hlen


def decode_adts(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Whole ADTS stream -> (float (n, ch) in [-1,1], rate, ch)."""
    pos = 0
    dec = None
    frames = []
    while pos + 7 <= len(data):
        hdr = parse_adts_header(data, pos)
        if hdr is None:
            pos += 1
            continue
        flen, sfi, cc, _profile, hlen = hdr
        if pos + flen > len(data):
            break
        if dec is None:
            dec = AACDecoder(sfi, cc)
        br = Bits(data[pos + hlen:pos + flen])
        try:
            frames.append(dec.decode_frame(br))
        except (EndOfData, ValueError):
            pass
        pos += flen
    if dec is None or not frames:
        raise ValueError("aac: no ADTS frames")
    nch = max(f.shape[1] for f in frames)
    frames = [np.pad(f, ((0, 0), (0, nch - f.shape[1])))
              if f.shape[1] < nch else f for f in frames]
    rate = dec.rate
    if dec.sbr_present:
        rate *= 2
        frames = _fix_mixed_rate(frames)
    return np.concatenate(frames, axis=0), rate, nch


def _fix_mixed_rate(frames: List[np.ndarray]) -> List[np.ndarray]:
    """Upsample any 1024-sample frames decoded before the first SBR
    payload appeared so the stream is uniformly 2x."""
    from .sbr import Upsampler2x
    ups: Dict[int, Upsampler2x] = {}
    out = []
    for f in frames:
        if f.shape[0] == 1024:
            g = np.empty((2048, f.shape[1]))
            for c in range(f.shape[1]):
                u = ups.get(c)
                if u is None:
                    u = ups[c] = Upsampler2x()
                g[:, c] = u.process(f[:, c])
            out.append(g)
        else:
            out.append(f)
    return out


def parse_audio_specific_config(asc: bytes) -> Tuple[int, int, int]:
    """-> (object_type, sfi, channel_config); frame length must be
    1024 (ISO 14496-3 §1.6.2.1)."""
    br = Bits(asc)
    aot = br.read(5)
    if aot == 31:
        aot = 32 + br.read(6)
    sfi = br.read(4)
    if sfi == 15:
        br.read(24)
        raise ValueError("aac: explicit sample rate unsupported")
    cc = br.read(4)
    if aot not in (2,):                          # AAC-LC only
        # 5/29 = SBR/PS signalling around an LC core: the core
        # config precedes the extension, so LC decode still applies
        if aot not in (5, 29):
            raise ValueError(f"aac: object type {aot} unsupported")
    return aot, sfi, cc


def decode_raw(asc: bytes, packets: List[bytes]
               ) -> Tuple[np.ndarray, int, int]:
    """Raw AAC access units (mp4/mkv style) with an
    AudioSpecificConfig -> (float (n, ch), rate, ch)."""
    _aot, sfi, cc = parse_audio_specific_config(asc)
    dec = AACDecoder(sfi, cc)
    frames = []
    for pkt in packets:
        try:
            frames.append(dec.decode_frame(Bits(pkt)))
        except (EndOfData, ValueError):
            pass
    if not frames:
        raise ValueError("aac: no decodable packets")
    nch = max(f.shape[1] for f in frames)
    frames = [np.pad(f, ((0, 0), (0, nch - f.shape[1])))
              if f.shape[1] < nch else f for f in frames]
    rate = SAMPLE_RATES[sfi]
    if dec.sbr_present:
        frames = _fix_mixed_rate(frames)
        rate *= 2
    return np.concatenate(frames, axis=0), rate, nch
