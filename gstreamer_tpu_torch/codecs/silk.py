"""Clean-room SILK decoder (RFC 6716 §4.2) — the Opus speech path.

Decodes SILK-only Opus packets (TOC configs 0-11, NB/MB/WB at
10-60 ms) natively: range-decoded indices (frame type, gains, NLSF
two-stage VQ, pitch lags/contours, LTP filters), shell-coded
excitation, and the full fixed-point synthesis chain (NLSF→LPC with
bandwidth expansion, LTP + LPC filters, gain scaling).  Together with
codecs/celt.py this completes native Opus decode; hybrid packets
remain on libopus.

The arithmetic follows the normative fixed-point exactly (the SILK
layer is bit-exact by construction), so output parity with libopus is
exact when the API sample rate equals the SILK internal rate; the
48 kHz path adds the normative polyphase resampler.

Normative tables live in codecs/_silk_tables.py (RFC 6716 §6,
cross-checked against the system libopus binary).  Reference element:
gst-plugins-base/ext/opus/gstopusdec.c:1 wraps libopus for all of
this; the clean-room implementation is this framework's.

A copy of the JAX package's ``codecs/silk.py``: host numpy and Python
integers; ``native/silk.py`` is its fast path.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import _silk_tables as T
from .celt import RangeDecoder

# -- fixed-point helpers (macros from SILK's Inlines.h / SigProc_FIX.h) -----

I32MIN, I32MAX = -(1 << 31), (1 << 31) - 1


def SAT16(x: int) -> int:
    return -32768 if x < -32768 else (32767 if x > 32767 else x)


def SAT32(x: int) -> int:
    return I32MIN if x < I32MIN else (I32MAX if x > I32MAX else x)


def wrap32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


def SMULWB(a: int, b: int) -> int:
    """(a32 * (opus_int16)b) >> 16"""
    b16 = ((b & 0xFFFF) ^ 0x8000) - 0x8000
    return wrap32((a * b16) >> 16)


def SMULWW(a: int, b: int) -> int:
    return wrap32((a * b) >> 16)


def SMULBB(a: int, b: int) -> int:
    a16 = ((a & 0xFFFF) ^ 0x8000) - 0x8000
    b16 = ((b & 0xFFFF) ^ 0x8000) - 0x8000
    return wrap32(a16 * b16)


def SMULWT(a: int, b: int) -> int:
    return wrap32((a * (b >> 16)) >> 16)


def SMLAWB(a: int, b: int, c: int) -> int:
    return wrap32(a + SMULWB(b, c))


def SMLABB(a: int, b: int, c: int) -> int:
    return wrap32(a + SMULBB(b, c))


def RSHIFT_ROUND(a: int, n: int) -> int:
    if n == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (n - 1)) + 1) >> 1


def LSHIFT_SAT32(a: int, n: int) -> int:
    return SAT32(a << n)


def silk_CLZ32(x: int) -> int:
    x &= 0xFFFFFFFF
    return 32 - x.bit_length() if x else 32


def silk_log2lin(in_log_q7: int) -> int:
    """log2lin.c: 2^(inLog_Q7/128) with the SILK polynomial frac."""
    if in_log_q7 < 0:
        return 0
    if in_log_q7 >= 3967:
        return I32MAX
    out = 1 << (in_log_q7 >> 7)
    frac_q7 = in_log_q7 & 0x7F
    if in_log_q7 < 2048:
        out = wrap32(out + ((out * SMLAWB(
            frac_q7, SMULBB(frac_q7, 128 - frac_q7), -174)) >> 7))
    else:
        out = wrap32(out + ((out >> 7) * SMLAWB(
            frac_q7, SMULBB(frac_q7, 128 - frac_q7), -174)))
    return out


def silk_INVERSE32_varQ(b32: int, q_res: int) -> int:
    """Inlines.h silk_INVERSE32_varQ: approximate 1/b32."""
    b_headrm = silk_CLZ32(abs(b32)) - 1
    b32_nrm = wrap32(b32 << b_headrm)
    b32_inv = ((0x7FFFFFFF >> 2) // (b32_nrm >> 16))
    result = wrap32(b32_inv << 16)
    err_q32 = wrap32((((1 << 29) - SMULWB(b32_nrm, b32_inv)) << 3))
    result = SMLAWW(result, err_q32, b32_inv)
    lshift = 61 - b_headrm - q_res
    if lshift <= 0:
        return LSHIFT_SAT32(result, -lshift)
    if lshift < 32:
        return result >> lshift
    return 0


def SMLAWW(a: int, b: int, c: int) -> int:
    return wrap32(a + ((b * c) >> 16))


def silk_DIV32_varQ(a32: int, b32: int, q_res: int) -> int:
    """Inlines.h silk_DIV32_varQ."""
    a_headrm = silk_CLZ32(abs(a32)) - 1
    a32_nrm = wrap32(a32 << a_headrm)
    b_headrm = silk_CLZ32(abs(b32)) - 1
    b32_nrm = wrap32(b32 << b_headrm)
    b32_inv = (0x7FFFFFFF >> 2) // (b32_nrm >> 16)
    result = SMULWB(a32_nrm, b32_inv)
    a32_nrm = wrap32(a32_nrm - wrap32(
        wrap32((SMMUL(b32_nrm, result)) << 3)))
    result = SMLAWB(result, a32_nrm, b32_inv)
    lshift = 29 + a_headrm - b_headrm - q_res
    if lshift < 0:
        return LSHIFT_SAT32(result, -lshift)
    if lshift < 32:
        return result >> lshift
    return 0


def SMMUL(a: int, b: int) -> int:
    return wrap32((a * b) >> 32)


# -- constants ----------------------------------------------------------------

TYPE_NO_VOICE_ACTIVITY = 0
TYPE_UNVOICED = 1
TYPE_VOICED = 2
MAX_LPC_ORDER = 16
NLSF_QUANT_MAX_AMPLITUDE = 4
SHELL_CODEC_FRAME_LENGTH = 16
MAX_PULSES = 16
LTP_ORDER = 5
CODE_INDEPENDENTLY = 0
CODE_INDEPENDENTLY_NO_LTP_SCALING = 1
CODE_CONDITIONALLY = 2
PITCH_EST_MIN_LAG_MS = 2
PITCH_EST_MAX_LAG_MS = 18


class SideInfo:
    """Decoded per-frame indices (silk's SideInfoIndices)."""

    def __init__(self):
        self.signal_type = 0
        self.quant_offset = 0
        self.gains_indices = [0, 0, 0, 0]
        self.nlsf_indices = [0] * (MAX_LPC_ORDER + 1)
        self.lag_index = 0
        self.contour_index = 0
        self.per_index = 0
        self.ltp_indices = [0, 0, 0, 0]
        self.ltp_scale_index = 0
        self.nlsf_interp_q2 = 4
        self.seed = 0


class SilkChannelDecoder:
    """Per-channel SILK decoder state (silk_decoder_state)."""

    def __init__(self):
        self.fs_khz = 0
        self.nb_subfr = 4
        self.frame_length = 0
        self.subfr_length = 0
        self.ltp_mem_length = 0
        self.lpc_order = 16
        self.prev_gain_q16 = 65536
        self.exc_q14 = np.zeros(320, np.int64)
        self.s_lpc_q14_buf = np.zeros(MAX_LPC_ORDER, np.int64)
        self.out_buf = np.zeros(480, np.int64)   # ltp_mem + latest
        self.lag_prev = 100
        self.last_gain_index = 10
        self.prev_signal_type = 0
        self.first_frame_after_reset = True
        self.prev_nlsf_q15 = np.zeros(MAX_LPC_ORDER, np.int64)
        self.vad_flags = [0] * 3
        self.lbrr_flag = 0
        self.lbrr_flags = [0] * 3
        self.n_frames_decoded = 0

    def set_fs(self, fs_khz: int, nb_subfr: int):
        self.fs_khz = fs_khz
        self.nb_subfr = nb_subfr
        self.subfr_length = 5 * fs_khz
        self.frame_length = self.subfr_length * nb_subfr
        self.ltp_mem_length = 20 * fs_khz
        self.lpc_order = 16 if fs_khz == 16 else 10
        self.out_buf = np.zeros(self.ltp_mem_length
                                + 2 * self.subfr_length, np.int64)
        self.exc_q14 = np.zeros(self.frame_length, np.int64)
        self.prev_nlsf_q15[:] = 0
        self.lag_prev = 100
        self.last_gain_index = 10
        self.prev_signal_type = 0
        self.first_frame_after_reset = True
        self.prev_gain_q16 = 65536
        self.s_lpc_q14_buf[:] = 0


# ---------------------------------------------------------------------------
# Index decoding (silk/decode_indices.c)
# ---------------------------------------------------------------------------

def decode_indices(st: SilkChannelDecoder, rd: RangeDecoder,
                   frame_index: int, decode_lbrr: bool,
                   cond_coding: int) -> SideInfo:
    ix = SideInfo()
    # frame type
    if decode_lbrr or st.vad_flags[frame_index]:
        v = rd.dec_icdf(T.TYPE_OFFSET_VAD_ICDF, 8) + 2
    else:
        v = rd.dec_icdf(T.TYPE_OFFSET_NO_VAD_ICDF, 8)
    ix.signal_type = v >> 1
    ix.quant_offset = v & 1

    # gains
    if cond_coding == CODE_CONDITIONALLY:
        ix.gains_indices[0] = rd.dec_icdf(T.DELTA_GAIN_ICDF, 8)
    else:
        ix.gains_indices[0] = rd.dec_icdf(
            T.GAIN_ICDF[ix.signal_type], 8) << 3
        ix.gains_indices[0] += rd.dec_icdf(T.UNIFORM8_ICDF, 8)
    for i in range(1, st.nb_subfr):
        ix.gains_indices[i] = rd.dec_icdf(T.DELTA_GAIN_ICDF, 8)

    # NLSF
    cb = T.NLSF_CB_WB if st.lpc_order == 16 else T.NLSF_CB_NB_MB
    ix.nlsf_indices[0] = rd.dec_icdf(
        cb["cb1_icdf"][ix.signal_type >> 1], 8)
    ec_ix, _pred = nlsf_unpack(cb, ix.nlsf_indices[0])
    for i in range(cb["order"]):
        v = rd.dec_icdf(cb["ec_icdf"][ec_ix[i] // 9], 8)
        if v == 0:
            v -= rd.dec_icdf(T.NLSF_EXT_ICDF, 8)
        elif v == 2 * NLSF_QUANT_MAX_AMPLITUDE:
            v += rd.dec_icdf(T.NLSF_EXT_ICDF, 8)
        ix.nlsf_indices[i + 1] = v - NLSF_QUANT_MAX_AMPLITUDE
    if st.nb_subfr == 4:
        ix.nlsf_interp_q2 = rd.dec_icdf(T.NLSF_INTERP_ICDF, 8)
    else:
        ix.nlsf_interp_q2 = 4

    if ix.signal_type == TYPE_VOICED:
        # pitch lag
        decode_abs = True
        if cond_coding == CODE_CONDITIONALLY \
                and st.prev_signal_type == TYPE_VOICED:
            delta = rd.dec_icdf(T.PITCH_DELTA_ICDF, 8)
            if delta > 0:
                ix.lag_index = st.prev_lag_index + delta - 9
                decode_abs = False
        if decode_abs:
            low_icdf = {8: T.UNIFORM4_ICDF, 12: T.UNIFORM6_ICDF,
                        16: T.UNIFORM8_ICDF}[st.fs_khz]
            ix.lag_index = rd.dec_icdf(T.PITCH_LAG_ICDF, 8) \
                * (st.fs_khz >> 1) + rd.dec_icdf(low_icdf, 8)
        st.prev_lag_index = ix.lag_index
        if st.fs_khz == 8:
            ctab = (T.PITCH_CONTOUR_NB_ICDF if st.nb_subfr == 4
                    else T.PITCH_CONTOUR_10MS_NB_ICDF)
        else:
            ctab = (T.PITCH_CONTOUR_ICDF if st.nb_subfr == 4
                    else T.PITCH_CONTOUR_10MS_ICDF)
        ix.contour_index = rd.dec_icdf(ctab, 8)
        # LTP gains
        ix.per_index = rd.dec_icdf(T.LTP_PER_INDEX_ICDF, 8)
        for k in range(st.nb_subfr):
            ix.ltp_indices[k] = rd.dec_icdf(
                T.LTP_GAIN_ICDF[ix.per_index], 8)
        if cond_coding == CODE_INDEPENDENTLY:
            ix.ltp_scale_index = rd.dec_icdf(T.LTPSCALE_ICDF, 8)
        else:
            ix.ltp_scale_index = 0
    ix.seed = rd.dec_icdf(T.UNIFORM4_ICDF, 8)
    return ix


def nlsf_unpack(cb, cb1_index: int):
    """silk/NLSF_unpack.c: per-coefficient entropy table index and
    backward predictor selection."""
    order = cb["order"]
    sel_row = cb["ec_sel"][cb1_index]
    ec_ix = [0] * order
    pred_q8 = [0] * order
    for i in range(0, order, 2):
        entry = sel_row[i >> 1]
        ec_ix[i] = ((entry >> 1) & 7) * 9
        pred_q8[i] = cb["pred_q8"][i + (entry & 1) * (order - 1)]
        if i + 1 < order:
            ec_ix[i + 1] = ((entry >> 5) & 7) * 9
            pred_q8[i + 1] = cb["pred_q8"][
                i + 1 + ((entry >> 4) & 1) * (order - 1)]
    return ec_ix, pred_q8


# ---------------------------------------------------------------------------
# Pulse decoding (silk/decode_pulses.c, shell_coder.c, code_signs.c)
# ---------------------------------------------------------------------------

_SHELL_TABLES = [T.SHELL_TABLE0, T.SHELL_TABLE1, T.SHELL_TABLE2,
                 T.SHELL_TABLE3]


def _decode_split(rd: RangeDecoder, p: int, table) -> Tuple[int, int]:
    if p > 0:
        a = rd.dec_icdf(table[T.SHELL_OFFSETS[p]:], 8)
        return a, p - a
    return 0, 0


def shell_decoder(rd: RangeDecoder, total: int) -> List[int]:
    p3 = _decode_split(rd, total, T.SHELL_TABLE3)
    out = [0] * 16
    for i2, p2v in enumerate(p3):
        p2 = _decode_split(rd, p2v, T.SHELL_TABLE2)
        for i1, p1v in enumerate(p2):
            p1 = _decode_split(rd, p1v, T.SHELL_TABLE1)
            for i0, p0v in enumerate(p1):
                a, b = _decode_split(rd, p0v, T.SHELL_TABLE0)
                base = i2 * 8 + i1 * 4 + i0 * 2
                out[base] = a
                out[base + 1] = b
    return out


def decode_pulses(rd: RangeDecoder, signal_type: int,
                  quant_offset: int, frame_length: int) -> np.ndarray:
    """silk/decode_pulses.c -> pulses array (int, +/-)."""
    rate_level = rd.dec_icdf(
        T.RATE_LEVELS_ICDF[signal_type >> 1], 8)
    n_blocks = frame_length // SHELL_CODEC_FRAME_LENGTH
    if n_blocks * SHELL_CODEC_FRAME_LENGTH < frame_length:
        n_blocks += 1      # 10 ms MB: 120 samples, 8 blocks
    sum_pulses = [0] * n_blocks
    n_lshifts = [0] * n_blocks
    for i in range(n_blocks):
        n_lshifts[i] = 0
        sum_pulses[i] = rd.dec_icdf(
            T.PULSES_PER_BLOCK_ICDF[rate_level], 8)
        while sum_pulses[i] == MAX_PULSES + 1:
            n_lshifts[i] += 1
            table = T.PULSES_PER_BLOCK_ICDF[9]
            if n_lshifts[i] == 10:
                table = table[1:]       # no more-than-max escape
            sum_pulses[i] = rd.dec_icdf(table, 8)
    pulses = np.zeros(n_blocks * SHELL_CODEC_FRAME_LENGTH, np.int64)
    for i in range(n_blocks):
        if sum_pulses[i] > 0:
            block = shell_decoder(rd, sum_pulses[i])
            pulses[i * 16:(i + 1) * 16] = block
    # LSBs
    for i in range(n_blocks):
        if n_lshifts[i] > 0:
            nls = n_lshifts[i]
            for j in range(SHELL_CODEC_FRAME_LENGTH):
                v = int(pulses[i * 16 + j])
                for _ in range(nls):
                    v = (v << 1) | rd.dec_icdf(T.LSB_ICDF, 8)
                pulses[i * 16 + j] = v
            sum_pulses[i] |= nls << 5
    # signs (silk/code_signs.c)
    base = 7 * (quant_offset + (signal_type << 1))
    for i in range(n_blocks):
        if sum_pulses[i] > 0:
            icdf = [T.SIGN_ICDF[base + min(sum_pulses[i] & 0x1F, 6)],
                    0]
            for j in range(SHELL_CODEC_FRAME_LENGTH):
                if pulses[i * 16 + j] > 0:
                    if rd.dec_icdf(icdf, 8) == 0:
                        pulses[i * 16 + j] = -pulses[i * 16 + j]
    return pulses[:frame_length]


# ---------------------------------------------------------------------------
# Top-level packet decode (silk/dec_API.c silk_Decode), bitstream side
# ---------------------------------------------------------------------------

# TOC config -> (fs_khz, frame_ms) for SILK-only configs 0-11
SILK_CONFIGS = {}
for _g, _fs in ((0, 8), (4, 12), (8, 16)):
    for _k, _ms in enumerate((10, 20, 40, 60)):
        SILK_CONFIGS[_g + _k] = (_fs, _ms)


class SilkDecoder:
    """SILK decoder for one Opus stream (mono or stereo)."""

    def __init__(self, channels: int = 1):
        self.channels = channels
        self.ch = [SilkChannelDecoder() for _ in range(channels)]
        self.stereo_pred_q13 = [0, 0]
        self.prev_decode_only_middle = 0
        # silk_Decode-level buffering (stereo_dec_state sMid/sSide and
        # the interpolated predictor memory)
        self._smid = [0, 0]
        self._sside = [0, 0]
        self._pred_prev_q13 = [0, 0]

    def _header_flags(self, rd: RangeDecoder, n_frames: int):
        for c in range(self.channels):
            st = self.ch[c]
            for i in range(n_frames):
                st.vad_flags[i] = rd.dec_bit_logp(1)
            st.lbrr_flag = rd.dec_bit_logp(1)
            st.lbrr_flags = [0] * n_frames

    def _lbrr_flags(self, rd: RangeDecoder, n_frames: int):
        for c in range(self.channels):
            st = self.ch[c]
            if st.lbrr_flag:
                if n_frames == 1:
                    st.lbrr_flags[0] = 1
                else:
                    tab = (T.LBRR_FLAGS_2_ICDF if n_frames == 2
                           else T.LBRR_FLAGS_3_ICDF)
                    sym = rd.dec_icdf(tab, 8) + 1
                    for i in range(n_frames):
                        st.lbrr_flags[i] = (sym >> i) & 1

    def _decode_lbrr(self, rd: RangeDecoder, n_frames: int,
                     synth: bool = False):
        """Decode LBRR frames — discarded on the normal path (bit
        sync only), synthesized when FEC-decoding a lost packet
        (dec_API.c lostFlag == FLAG_DECODE_LBRR)."""
        out = []
        for i in range(n_frames):
            mid_only = 0
            pred = None
            frame_x = [None] * self.channels
            for c in range(self.channels):
                st = self.ch[c]
                if not st.lbrr_flags[i]:
                    if synth:
                        frame_x[c] = np.zeros(st.frame_length,
                                              np.int64)
                    continue
                if self.channels == 2 and c == 0:
                    pred = decode_stereo_pred(rd)
                    if self.ch[1].lbrr_flags[i] == 0:
                        mid_only = rd.dec_icdf(
                            T.STEREO_ONLY_CODE_MID_ICDF, 8)
                cond = (CODE_CONDITIONALLY
                        if i > 0 and st.lbrr_flags[i - 1]
                        else CODE_INDEPENDENTLY)
                ix = decode_indices(st, rd, i, True, cond)
                pulses = decode_pulses(rd, ix.signal_type,
                                       ix.quant_offset,
                                       st.frame_length)
                if synth:
                    frame_x[c] = decode_frame_synth(st, ix, pulses,
                                                    cond)
            if synth:
                out.append((frame_x, pred, mid_only))
        return out

    def decode_frame_bitstream(self, rd: RangeDecoder,
                               fs_khz: int, frame_ms: int):
        """Range-decode every symbol of one SILK Opus frame; returns
        the list of (channel, SideInfo, pulses, stereo_pred, cond)
        decoded (synthesis is layered on top)."""
        out = []
        self._walk_packet(rd, fs_khz, frame_ms, rows=out)
        return out

    def decode_packet(self, rd: RangeDecoder, fs_khz: int,
                      frame_ms: int) -> np.ndarray:
        """dec_API.c silk_Decode (normal path): full decode to PCM at
        the SILK internal rate.  Returns (n_samples, channels) int
        array; includes the 2-sample mid/side delay buffering, so the
        stream is delayed one sample like libopus's internal path."""
        return self._walk_packet(rd, fs_khz, frame_ms, synth=True)

    def decode_packet_fec(self, rd: RangeDecoder, fs_khz: int,
                          frame_ms: int) -> "Optional[np.ndarray]":
        """dec_API.c silk_Decode with lostFlag=FLAG_DECODE_LBRR:
        recover a LOST packet from the LBRR (low-bitrate redundancy)
        frames carried by the FOLLOWING packet.  Returns PCM at the
        internal rate, or None when the packet has no LBRR data."""
        n_frames = 1 if frame_ms <= 20 else frame_ms // 20
        nb_subfr = 2 if frame_ms == 10 else 4
        for st in self.ch:
            if st.fs_khz != fs_khz or st.nb_subfr != nb_subfr:
                st.set_fs(fs_khz, nb_subfr)
            st.n_frames_decoded = 0
        self._header_flags(rd, n_frames)
        self._lbrr_flags(rd, n_frames)
        if not any(any(st.lbrr_flags[:n_frames]) for st in self.ch):
            return None
        frames = self._decode_lbrr(rd, n_frames, synth=True)
        pcm = [[] for _ in range(self.channels)]
        for frame_x, pred, mid_only in frames:
            if self.channels == 2:
                if frame_x[1] is None or mid_only:
                    frame_x[1] = np.zeros(len(frame_x[0]), np.int64)
                l, r = self._stereo_ms_to_lr(frame_x[0], frame_x[1],
                                             pred or [0, 0])
                pcm[0].append(l)
                pcm[1].append(r)
            else:
                n = len(frame_x[0])
                x = np.concatenate(
                    [np.asarray(self._smid, np.int64), frame_x[0]])
                self._smid = [int(x[n]), int(x[n + 1])]
                pcm[0].append(x[1:1 + n])
        return np.stack([np.concatenate(c) for c in pcm], 1)

    def _walk_packet(self, rd: RangeDecoder, fs_khz: int,
                     frame_ms: int, rows=None, synth: bool = False):
        n_frames = 1 if frame_ms <= 20 else frame_ms // 20
        nb_subfr = 2 if frame_ms == 10 else 4
        for st in self.ch:
            if st.fs_khz != fs_khz or st.nb_subfr != nb_subfr:
                st.set_fs(fs_khz, nb_subfr)
            st.n_frames_decoded = 0
        self._header_flags(rd, n_frames)
        self._lbrr_flags(rd, n_frames)
        self._decode_lbrr(rd, n_frames)
        pcm = [[] for _ in range(self.channels)]
        for i in range(n_frames):
            mid_only = 0      # lives across the channel loop: set while
            pred = None       # decoding mid (c==0), tested for side (c==1)
            frame_x = [None] * self.channels
            for c in range(self.channels):
                st = self.ch[c]
                if self.channels == 2 and c == 0:
                    pred = decode_stereo_pred(rd)
                    if self.ch[1].vad_flags[i] == 0:
                        mid_only = rd.dec_icdf(
                            T.STEREO_ONLY_CODE_MID_ICDF, 8)
                    # first coded side frame after mid-only: reset side
                    if mid_only == 0 and self.prev_decode_only_middle:
                        side = self.ch[1]
                        side.out_buf[:] = 0
                        side.s_lpc_q14_buf[:] = 0
                        side.lag_prev = 100
                        side.last_gain_index = 10
                        side.prev_signal_type = 0
                        side.first_frame_after_reset = True
                if self.channels == 2 and c == 1 and mid_only:
                    frame_x[c] = np.zeros(st.frame_length, np.int64)
                    continue
                if i == 0:
                    cond = CODE_INDEPENDENTLY
                elif c > 0 and self.prev_decode_only_middle:
                    cond = CODE_INDEPENDENTLY_NO_LTP_SCALING
                else:
                    cond = CODE_CONDITIONALLY
                ix = decode_indices(st, rd, i, False, cond)
                pulses = decode_pulses(rd, ix.signal_type,
                                       ix.quant_offset,
                                       st.frame_length)
                st.n_frames_decoded += 1
                st.prev_signal_type = ix.signal_type
                if rows is not None:
                    rows.append((c, ix, pulses, pred, cond))
                if synth:
                    frame_x[c] = decode_frame_synth(st, ix, pulses,
                                                    cond)
            if self.channels == 2:
                self.prev_decode_only_middle = mid_only
            if synth:
                if self.channels == 2:
                    l, r = self._stereo_ms_to_lr(frame_x[0],
                                                 frame_x[1], pred)
                    pcm[0].append(l)
                    pcm[1].append(r)
                else:
                    n = len(frame_x[0])
                    x = np.concatenate(
                        [np.asarray(self._smid, np.int64), frame_x[0]])
                    self._smid = [int(x[n]), int(x[n + 1])]
                    pcm[0].append(x[1:1 + n])
        if synth:
            return np.stack([np.concatenate(chn) for chn in pcm], 1)
        return None

    def _stereo_ms_to_lr(self, mid, side, pred_q13):
        """silk/stereo_MS_to_LR.c: predict side from mid, unmix."""
        st0 = self.ch[0]
        fs_khz = st0.fs_khz
        n = len(mid)
        x1 = np.concatenate([np.asarray(self._smid, np.int64), mid])
        x2 = np.concatenate([np.asarray(self._sside, np.int64), side])
        self._smid = [int(x1[n]), int(x1[n + 1])]
        self._sside = [int(x2[n]), int(x2[n + 1])]
        pred0 = self._pred_prev_q13[0]
        pred1 = self._pred_prev_q13[1]
        denom_q16 = (1 << 16) // (8 * fs_khz)     # STEREO_INTERP_LEN 8ms
        delta0 = RSHIFT_ROUND(
            SMULBB(pred_q13[0] - self._pred_prev_q13[0], denom_q16), 16)
        delta1 = RSHIFT_ROUND(
            SMULBB(pred_q13[1] - self._pred_prev_q13[1], denom_q16), 16)
        interp_len = 8 * fs_khz
        for i in range(n):
            if i < interp_len:
                pred0 += delta0
                pred1 += delta1
            elif i == interp_len:
                pred0 = pred_q13[0]
                pred1 = pred_q13[1]
            s = wrap32((int(x1[i]) + int(x1[i + 2])
                        + 2 * int(x1[i + 1])) << 9)
            s = SMLAWB(wrap32(int(x2[i + 1]) << 8), s, pred0)
            s = SMLAWB(s, wrap32(int(x1[i + 1]) << 11), pred1)
            x2[i + 1] = SAT16(RSHIFT_ROUND(s, 8))
        self._pred_prev_q13[0] = pred_q13[0]
        self._pred_prev_q13[1] = pred_q13[1]
        left = np.empty(n, np.int64)
        right = np.empty(n, np.int64)
        for i in range(n):
            sm = int(x1[i + 1]) + int(x2[i + 1])
            df = int(x1[i + 1]) - int(x2[i + 1])
            left[i] = SAT16(sm)
            right[i] = SAT16(df)
        return left, right


def decode_stereo_pred(rd: RangeDecoder):
    """silk/stereo_decode_pred.c: two interpolated weights."""
    n = rd.dec_icdf(T.STEREO_PRED_JOINT_ICDF, 8)
    ix = [[0, 0, 0], [0, 0, 0]]
    ix[0][2] = n // 5
    ix[1][2] = n % 5
    for c in range(2):
        ix[c][0] = rd.dec_icdf(T.UNIFORM3_ICDF, 8)
        ix[c][1] = rd.dec_icdf(T.UNIFORM5_ICDF, 8)
    pred_q13 = [0, 0]
    for c in range(2):
        ix[c][0] += 3 * ix[c][2]
        low = T.STEREO_PRED_QUANT_Q13[ix[c][0]]
        step = SMULWB(T.STEREO_PRED_QUANT_Q13[ix[c][0] + 1] - low,
                      6554)
        pred_q13[c] = low + step * (2 * ix[c][1] + 1)
    pred_q13[0] -= pred_q13[1]
    return pred_q13


# ---------------------------------------------------------------------------
# Synthesis — fixed-point decode to PCM (silk/decode_parameters.c,
# decode_core.c, decode_frame.c, NLSF_decode.c, NLSF2A.c, gain_quant.c)
# ---------------------------------------------------------------------------

def cdiv(a: int, b: int) -> int:
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def ADD_SAT32(a: int, b: int) -> int:
    return SAT32(a + b)


def silk_RAND(seed: int) -> int:
    return wrap32(907633515 + wrap32(seed * 196314165))


def gains_dequant(ind, prev_ind: int, conditional: bool, nb_subfr: int):
    """silk/gain_quant.c silk_gains_dequant -> (gains_Q16, prev_ind)."""
    gains = [0] * nb_subfr
    for k in range(nb_subfr):
        if k == 0 and not conditional:
            prev_ind = max(ind[k], prev_ind - 16)
        else:
            ind_tmp = ind[k] - 4                 # MIN_DELTA_GAIN_QUANT
            dbl_thr = 2 * 36 - 64 + prev_ind     # MAX_DELTA_GAIN_QUANT
            if ind_tmp > dbl_thr:
                prev_ind += (ind_tmp << 1) - dbl_thr
            else:
                prev_ind += ind_tmp
        prev_ind = min(max(prev_ind, 0), 63)
        gains[k] = silk_log2lin(
            min(SMULWB(0x1D1C71, prev_ind) + 2090, 3967))
    return gains, prev_ind


def nlsf_residual_dequant(indices, pred_q8, quant_step_q16, order):
    """silk/NLSF_decode.c silk_NLSF_residual_dequant."""
    out = [0] * order
    out_q10 = 0
    for i in range(order - 1, -1, -1):
        pred_q10 = SMULBB(out_q10, pred_q8[i]) >> 8
        out_q10 = indices[i] << 10
        if out_q10 > 0:
            out_q10 -= 102                       # NLSF_QUANT_LEVEL_ADJ Q10
        elif out_q10 < 0:
            out_q10 += 102
        out_q10 = SMLAWB(pred_q10, out_q10, quant_step_q16)
        out[i] = out_q10
    return out


def nlsf_stabilize(nlsf, delta_min, order):
    """silk/NLSF_stabilize.c: enforce minimum distances in place."""
    for _ in range(20):
        min_diff = nlsf[0] - delta_min[0]
        idx = 0
        for i in range(1, order):
            d = nlsf[i] - (nlsf[i - 1] + delta_min[i])
            if d < min_diff:
                min_diff = d
                idx = i
        d = (1 << 15) - (nlsf[order - 1] + delta_min[order])
        if d < min_diff:
            min_diff = d
            idx = order
        if min_diff >= 0:
            return
        if idx == 0:
            nlsf[0] = delta_min[0]
        elif idx == order:
            nlsf[order - 1] = (1 << 15) - delta_min[order]
        else:
            min_center = delta_min[idx] >> 1
            for k in range(idx):
                min_center += delta_min[k]
            max_center = (1 << 15) - (delta_min[idx] >> 1)
            for k in range(order, idx, -1):
                max_center -= delta_min[k]
            center = RSHIFT_ROUND(nlsf[idx - 1] + nlsf[idx], 1)
            center = min(max(center, min_center), max_center)
            nlsf[idx - 1] = center - (delta_min[idx] >> 1)
            nlsf[idx] = nlsf[idx - 1] + delta_min[idx]
    # fallback: sort and clamp
    nlsf.sort()
    nlsf[0] = max(nlsf[0], delta_min[0])
    for i in range(1, order):
        nlsf[i] = max(nlsf[i], SAT16(nlsf[i - 1] + delta_min[i]))
    nlsf[order - 1] = min(nlsf[order - 1], (1 << 15) - delta_min[order])
    for i in range(order - 2, -1, -1):
        nlsf[i] = min(nlsf[i], nlsf[i + 1] - delta_min[i + 1])


def nlsf_decode(indices, cb):
    """silk/NLSF_decode.c silk_NLSF_decode -> NLSF_Q15 list."""
    order = cb["order"]
    ec_ix, pred_q8 = nlsf_unpack(cb, indices[0])
    res_q10 = nlsf_residual_dequant(indices[1:1 + order], pred_q8,
                                    cb["quant_step_q16"], order)
    base = indices[0] * order
    row = cb["cb1_q8"][indices[0]]     # stored as 32 rows of `order`
    nlsf = []
    for i in range(order):
        v = cdiv(res_q10[i] << 14, cb["cb1_wght_q9"][base + i]) \
            + (row[i] << 7)
        nlsf.append(min(max(v, 0), 32767))
    nlsf_stabilize(nlsf, cb["delta_min_q15"], order)
    return nlsf


def _nlsf2a_find_poly(clsf, dd):
    """silk/NLSF2A.c silk_NLSF2A_find_poly (QA=16)."""
    out = [0] * (dd + 1)
    out[0] = 1 << 16
    out[1] = -clsf[0]
    for k in range(1, dd):
        ftmp = clsf[k]          # caller passes the even/odd-strided slice
        out[k + 1] = wrap32((out[k - 1] << 1)
                            - RSHIFT_ROUND(ftmp * out[k], 16))
        for n in range(k, 1, -1):
            out[n] = wrap32(out[n] + out[n - 2]
                            - RSHIFT_ROUND(ftmp * out[n - 1], 16))
        out[1] -= ftmp
    return out


def bwexpander_32(ar, d, chirp_q16):
    """silk/bwexpander_32.c: scale AR coefs by decaying chirp."""
    chirp_minus_one = chirp_q16 - 65536
    for i in range(d - 1):
        ar[i] = SMULWW(chirp_q16, ar[i])
        chirp_q16 += RSHIFT_ROUND(chirp_q16 * chirp_minus_one, 16)
    ar[d - 1] = SMULWW(chirp_q16, ar[d - 1])


def lpc_fit(a_qa, d, qout=12, qin=17):
    """silk/LPC_fit.c: fit QA coefs into int16 Q12 with bw expansion."""
    a_q12 = [0] * d
    for it in range(10):
        maxabs = -1
        idx = 0
        for k in range(d):
            v = abs(a_qa[k])
            if v > maxabs:
                maxabs = v
                idx = k
        maxabs = (maxabs + (1 << (qin - qout - 1))) >> (qin - qout)
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            chirp_q16 = 65536 - cdiv(
                (maxabs - 32767) << 14,
                (maxabs * (idx + 1)) >> 2)
            bwexpander_32(a_qa, d, chirp_q16)
        else:
            break
    else:
        it = 10
    if it == 10:
        for k in range(d):
            a_q12[k] = SAT16(RSHIFT_ROUND(a_qa[k], qin - qout))
            a_qa[k] = a_q12[k] << (qin - qout)
    else:
        for k in range(d):
            a_q12[k] = RSHIFT_ROUND(a_qa[k], qin - qout)
    return a_q12


def SUB_SAT32(a: int, b: int) -> int:
    return SAT32(a - b)


def lpc_inverse_pred_gain(a_q12, order):
    """silk/LPC_inv_pred_gain.c: Q30 inverse prediction gain, 0 if
    unstable (QA=24 internal precision)."""
    QA = 24
    A_LIMIT = 16773022                # FIX_CONST(0.99975, 24)
    a = [q << (QA - 12) for q in a_q12[:order]]
    if sum(a_q12[:order]) >= 4096:
        return 0
    inv_gain_q30 = 1 << 30
    for k in range(order - 1, 0, -1):
        if a[k] > A_LIMIT or a[k] < -A_LIMIT:
            return 0
        rc_q31 = wrap32(-(a[k] << (31 - QA)))
        rc_mult1_q30 = wrap32((1 << 30) - SMMUL(rc_q31, rc_q31))
        inv_gain_q30 = wrap32(SMMUL(inv_gain_q30, rc_mult1_q30) << 2)
        if inv_gain_q30 < 107374:     # FIX_CONST(1/1e4, 30)
            return 0
        mult2q = 32 - silk_CLZ32(abs(rc_mult1_q30))
        rc_mult2 = silk_INVERSE32_varQ(rc_mult1_q30, mult2q + 30)
        for n in range((k + 1) >> 1):
            tmp1 = a[n]
            tmp2 = a[k - n - 1]
            t64 = RSHIFT_ROUND(
                SUB_SAT32(tmp1, RSHIFT_ROUND(tmp2 * rc_q31, 31))
                * rc_mult2, mult2q)
            if t64 > I32MAX or t64 < I32MIN:
                return 0
            a[n] = t64
            t64 = RSHIFT_ROUND(
                SUB_SAT32(tmp2, RSHIFT_ROUND(tmp1 * rc_q31, 31))
                * rc_mult2, mult2q)
            if t64 > I32MAX or t64 < I32MIN:
                return 0
            a[k - n - 1] = t64
    if a[0] > A_LIMIT or a[0] < -A_LIMIT:
        return 0
    rc_q31 = wrap32(-(a[0] << (31 - QA)))
    rc_mult1_q30 = wrap32((1 << 30) - SMMUL(rc_q31, rc_q31))
    inv_gain_q30 = wrap32(SMMUL(inv_gain_q30, rc_mult1_q30) << 2)
    if inv_gain_q30 < 107374:
        return 0
    return inv_gain_q30


def nlsf2a(nlsf, d):
    """silk/NLSF2A.c: NLSF_Q15 -> AR coefs a_Q12 (list of int).
    Dispatches to the native shim when built; nlsf2a_py is the
    bit-exact specification."""
    from ..native.silk import get_lib
    lib = get_lib()
    if lib is None:
        return nlsf2a_py(nlsf, d)
    import ctypes
    i32 = np.int32
    i32p = ctypes.POINTER(ctypes.c_int32)
    if not hasattr(nlsf2a, "_tabs"):
        nlsf2a._tabs = (
            np.ascontiguousarray(T.LSF_COS_TAB_Q12, i32),
            np.ascontiguousarray(T.NLSF2A_ORDER16, i32),
            np.ascontiguousarray(T.NLSF2A_ORDER10, i32))
    cos_tab, o16, o10 = nlsf2a._tabs
    ordering = o16 if d == 16 else o10
    nl = np.ascontiguousarray(nlsf, i32)
    out = np.zeros(d, i32)
    lib.gtpu_silk_nlsf2a(
        nl.ctypes.data_as(i32p), d, cos_tab.ctypes.data_as(i32p),
        ordering.ctypes.data_as(i32p), out.ctypes.data_as(i32p))
    return [int(v) for v in out]


def nlsf2a_py(nlsf, d):
    """Pure-Python NLSF2A (the executable specification)."""
    ordering = (T.NLSF2A_ORDER16 if d == 16 else T.NLSF2A_ORDER10)
    clsf = [0] * d
    for k in range(d):
        f_int = nlsf[k] >> 8
        f_frac = nlsf[k] - (f_int << 8)
        cos_val = T.LSF_COS_TAB_Q12[f_int]
        delta = T.LSF_COS_TAB_Q12[f_int + 1] - cos_val
        clsf[ordering[k]] = RSHIFT_ROUND(
            (cos_val << 8) + delta * f_frac, 20 - 16)   # QA=16
    dd = d >> 1
    p = _nlsf2a_find_poly(clsf[0::2], dd)
    q = _nlsf2a_find_poly(clsf[1::2], dd)
    a32_qa1 = [0] * d
    for k in range(dd):
        ptmp = p[k + 1] + p[k]
        qtmp = q[k + 1] - q[k]
        a32_qa1[k] = wrap32(-qtmp - ptmp)
        a32_qa1[d - k - 1] = wrap32(qtmp - ptmp)
    a_q12 = lpc_fit(a32_qa1, d)
    i = 0
    while lpc_inverse_pred_gain(a_q12, d) == 0 and i < 16:
        # near-unstable: progressively stronger bandwidth expansion
        bwexpander_32(a32_qa1, d, 65536 - (2 << i))
        for k in range(d):
            a_q12[k] = RSHIFT_ROUND(a32_qa1[k], 17 - 12)
        i += 1
    return a_q12


def decode_pitch(lag_index, contour_index, fs_khz, nb_subfr):
    """silk/decode_pitch.c -> pitch lags per subframe."""
    if fs_khz == 8:
        cb = (T.CB_LAGS_STAGE2 if nb_subfr == 4
              else T.CB_LAGS_STAGE2_10MS)
    else:
        cb = (T.CB_LAGS_STAGE3 if nb_subfr == 4
              else T.CB_LAGS_STAGE3_10MS)
    min_lag = PITCH_EST_MIN_LAG_MS * fs_khz
    max_lag = PITCH_EST_MAX_LAG_MS * fs_khz
    lag = min_lag + lag_index
    return [min(max(lag + cb[k][contour_index], min_lag), max_lag)
            for k in range(nb_subfr)]


class DecoderControl:
    """silk_decoder_control: per-frame synthesis parameters."""

    def __init__(self):
        self.gains_q16 = [0, 0, 0, 0]
        self.pred_coef_q12 = [[0] * MAX_LPC_ORDER, [0] * MAX_LPC_ORDER]
        self.ltp_coef_q14 = [0] * (LTP_ORDER * 4)
        self.pitch_lags = [0, 0, 0, 0]
        self.ltp_scale_q14 = 0


def decode_parameters(st: SilkChannelDecoder, ix: SideInfo,
                      cond_coding: int) -> DecoderControl:
    """silk/decode_parameters.c."""
    ctl = DecoderControl()
    ctl.gains_q16, st.last_gain_index = gains_dequant(
        ix.gains_indices, st.last_gain_index,
        cond_coding == CODE_CONDITIONALLY, st.nb_subfr)
    cb = T.NLSF_CB_WB if st.lpc_order == 16 else T.NLSF_CB_NB_MB
    nlsf = nlsf_decode(ix.nlsf_indices, cb)
    ctl.pred_coef_q12[1] = nlsf2a(nlsf, st.lpc_order)
    if st.first_frame_after_reset:
        ix.nlsf_interp_q2 = 4
    if ix.nlsf_interp_q2 < 4:
        nlsf0 = [int(st.prev_nlsf_q15[i])
                 + ((ix.nlsf_interp_q2
                     * (nlsf[i] - int(st.prev_nlsf_q15[i]))) >> 2)
                 for i in range(st.lpc_order)]
        ctl.pred_coef_q12[0] = nlsf2a(nlsf0, st.lpc_order)
    else:
        ctl.pred_coef_q12[0] = list(ctl.pred_coef_q12[1])
    for i in range(st.lpc_order):
        st.prev_nlsf_q15[i] = nlsf[i]
    if ix.signal_type == TYPE_VOICED:
        ctl.pitch_lags = decode_pitch(ix.lag_index, ix.contour_index,
                                      st.fs_khz, st.nb_subfr)
        cbk = T.LTP_GAIN_VQ[ix.per_index]
        for k in range(st.nb_subfr):
            row = cbk[ix.ltp_indices[k]]
            for i in range(LTP_ORDER):
                ctl.ltp_coef_q14[k * LTP_ORDER + i] = row[i] << 7
        ctl.ltp_scale_q14 = T.LTPSCALES_Q14[ix.ltp_scale_index]
    else:
        ctl.pitch_lags = [0] * st.nb_subfr
        ctl.ltp_coef_q14 = [0] * (LTP_ORDER * st.nb_subfr)
        ix.per_index = 0
        ctl.ltp_scale_q14 = 0
    return ctl


def lpc_analysis_filter(inp, b_q12, length, order):
    """silk/LPC_analysis_filter.c: whitening FIR -> list (head zeroed)."""
    out = [0] * length
    for ix in range(order, length):
        acc = 0
        for j in range(order):
            acc = wrap32(acc + SMULBB(int(inp[ix - 1 - j]), b_q12[j]))
        acc = wrap32((int(inp[ix]) << 12) - acc)
        out[ix] = SAT16(RSHIFT_ROUND(acc, 12))
    return out


def decode_core(st: SilkChannelDecoder, ix: SideInfo,
                ctl: DecoderControl, pulses) -> np.ndarray:
    """silk/decode_core.c: excitation + LTP + LPC synthesis -> int16.
    Dispatches to the native shim (native/gtpu_silk.cpp) when built;
    decode_core_py below is the bit-exact specification."""
    from ..native.silk import get_lib
    lib = get_lib()
    if lib is None:
        return decode_core_py(st, ix, ctl, pulses)
    import ctypes
    i32 = np.int32
    i32p = ctypes.POINTER(ctypes.c_int32)
    pulses_a = np.ascontiguousarray(pulses, i32)
    gains = np.ascontiguousarray(ctl.gains_q16, i32)
    pred = np.zeros((2, MAX_LPC_ORDER), i32)
    for h in range(2):
        row = ctl.pred_coef_q12[h]
        pred[h, :len(row)] = row
    ltpc = np.ascontiguousarray(ctl.ltp_coef_q14, i32)
    lags = np.ascontiguousarray(ctl.pitch_lags, i32)
    exc = np.zeros(st.frame_length, i32)
    s_lpc = np.ascontiguousarray(st.s_lpc_q14_buf, i32)
    out_hist = np.ascontiguousarray(st.out_buf, i32)
    scratch = np.zeros(st.ltp_mem_length + st.frame_length, i32)
    xq = np.zeros(st.frame_length, i32)

    def P(a):
        return a.ctypes.data_as(i32p)

    offset_q10 = T.QUANT_OFFSETS_Q10[ix.signal_type >> 1][
        ix.quant_offset]
    st.prev_gain_q16 = lib.gtpu_silk_decode_core(
        P(pulses_a), st.frame_length, st.subfr_length, st.nb_subfr,
        st.ltp_mem_length, st.lpc_order, ix.signal_type,
        ix.quant_offset, ix.seed, ix.nlsf_interp_q2,
        P(gains), P(pred), P(ltpc), P(lags),
        ctl.ltp_scale_q14, st.prev_gain_q16, offset_q10,
        P(exc), P(s_lpc), P(out_hist), P(scratch), P(xq))
    st.s_lpc_q14_buf[:] = s_lpc
    st.exc_q14[:st.frame_length] = exc
    return xq.astype(np.int64)


def decode_core_py(st: SilkChannelDecoder, ix: SideInfo,
                   ctl: DecoderControl, pulses) -> np.ndarray:
    """Pure-Python decode_core (the executable specification)."""
    xq = np.zeros(st.frame_length, np.int64)
    s_ltp = [0] * st.ltp_mem_length
    s_ltp_q15 = [0] * (st.ltp_mem_length + st.frame_length)
    offset_q10 = T.QUANT_OFFSETS_Q10[ix.signal_type >> 1][ix.quant_offset]
    interp_flag = 1 if ix.nlsf_interp_q2 < 4 else 0
    rand_seed = ix.seed
    exc = st.exc_q14
    for i in range(st.frame_length):
        rand_seed = silk_RAND(rand_seed)
        v = int(pulses[i]) << 14
        if v > 0:
            v -= 80 << 4                        # QUANT_LEVEL_ADJUST
        elif v < 0:
            v += 80 << 4
        v += offset_q10 << 4
        if rand_seed < 0:
            v = -v
        exc[i] = v
        rand_seed = wrap32(rand_seed + int(pulses[i]))
    s_lpc = [int(x) for x in st.s_lpc_q14_buf] + [0] * st.subfr_length
    ltp_buf_idx = st.ltp_mem_length
    signal_type = ix.signal_type
    pexc = 0
    pxq = 0
    for k in range(st.nb_subfr):
        a_q12 = ctl.pred_coef_q12[k >> 1]
        b_q14 = ctl.ltp_coef_q14[k * LTP_ORDER:(k + 1) * LTP_ORDER]
        gain_q10 = ctl.gains_q16[k] >> 6
        inv_gain_q31 = silk_INVERSE32_varQ(ctl.gains_q16[k], 47)
        if ctl.gains_q16[k] != st.prev_gain_q16:
            gain_adj_q16 = silk_DIV32_varQ(st.prev_gain_q16,
                                           ctl.gains_q16[k], 16)
            for i in range(MAX_LPC_ORDER):
                s_lpc[i] = SMULWW(gain_adj_q16, s_lpc[i])
        else:
            gain_adj_q16 = 1 << 16
        st.prev_gain_q16 = ctl.gains_q16[k]
        if signal_type == TYPE_VOICED:
            lag = ctl.pitch_lags[k]
            if k == 0 or (k == 2 and interp_flag):
                start_idx = (st.ltp_mem_length - lag
                             - st.lpc_order - LTP_ORDER // 2)
                if k == 2:
                    st.out_buf[st.ltp_mem_length:
                               st.ltp_mem_length
                               + 2 * st.subfr_length] = xq[
                        :2 * st.subfr_length]
                flt = lpc_analysis_filter(
                    st.out_buf[start_idx + k * st.subfr_length:],
                    a_q12, st.ltp_mem_length - start_idx,
                    st.lpc_order)
                s_ltp[start_idx:st.ltp_mem_length] = flt
                if k == 0:
                    inv_gain_q31 = wrap32(
                        SMULWB(inv_gain_q31, ctl.ltp_scale_q14) << 2)
                for i in range(lag + LTP_ORDER // 2):
                    s_ltp_q15[ltp_buf_idx - i - 1] = SMULWB(
                        inv_gain_q31,
                        s_ltp[st.ltp_mem_length - i - 1])
            else:
                if gain_adj_q16 != 1 << 16:
                    for i in range(lag + LTP_ORDER // 2):
                        s_ltp_q15[ltp_buf_idx - i - 1] = SMULWW(
                            gain_adj_q16,
                            s_ltp_q15[ltp_buf_idx - i - 1])
        # long-term prediction
        if signal_type == TYPE_VOICED:
            pres = [0] * st.subfr_length
            plag = ltp_buf_idx - lag + LTP_ORDER // 2
            for i in range(st.subfr_length):
                pred_q13 = 2
                for j in range(LTP_ORDER):
                    pred_q13 = SMLAWB(pred_q13,
                                      s_ltp_q15[plag - j], b_q14[j])
                plag += 1
                pres[i] = ADD_SAT32(int(exc[pexc + i]),
                                    wrap32(pred_q13 << 1))
                s_ltp_q15[ltp_buf_idx] = wrap32(pres[i] << 1)
                ltp_buf_idx += 1
        else:
            pres = [int(exc[pexc + i]) for i in range(st.subfr_length)]
        order = st.lpc_order
        for i in range(st.subfr_length):
            pred_q10 = order >> 1
            base = MAX_LPC_ORDER + i
            for j in range(order):
                pred_q10 = SMLAWB(pred_q10, s_lpc[base - 1 - j],
                                  a_q12[j])
            s_lpc[base] = ADD_SAT32(pres[i],
                                    LSHIFT_SAT32(pred_q10, 4))
            xq[pxq + i] = SAT16(RSHIFT_ROUND(
                SMULWW(s_lpc[base], gain_q10), 8))
        s_lpc[:MAX_LPC_ORDER] = s_lpc[st.subfr_length:
                                      st.subfr_length + MAX_LPC_ORDER]
        pexc += st.subfr_length
        pxq += st.subfr_length
    for i in range(MAX_LPC_ORDER):
        st.s_lpc_q14_buf[i] = s_lpc[i]
    return xq


def decode_frame_synth(st: SilkChannelDecoder, ix: SideInfo,
                       pulses, cond_coding: int) -> np.ndarray:
    """silk/decode_frame.c (normal path): parameters + core + state."""
    ctl = decode_parameters(st, ix, cond_coding)
    xq = decode_core(st, ix, ctl, pulses)
    # update output history: keep the last ltp_mem_length samples
    mv = st.ltp_mem_length - st.frame_length
    if mv > 0:
        st.out_buf[:mv] = st.out_buf[st.frame_length:st.ltp_mem_length]
    st.out_buf[mv:mv + st.frame_length] = xq
    st.lag_prev = ctl.pitch_lags[st.nb_subfr - 1]
    st.prev_signal_type = ix.signal_type
    st.first_frame_after_reset = False
    return xq


# ---------------------------------------------------------------------------
# Resampler to the API rate (silk/resampler.c — IIR+FIR upsampler used
# for every SILK internal rate -> 48 kHz; 2x HQ wrapper for 24 kHz)
# ---------------------------------------------------------------------------

def _up2_hq(s_iir, inp):
    """silk/resampler_private_up2_HQ.c: 2x upsample, three all-pass
    sections per phase; state s_iir is 6 Q10 ints, updated in place."""
    h0 = T.RESAMPLER_UP2_HQ_0
    h1 = T.RESAMPLER_UP2_HQ_1
    out = [0] * (2 * len(inp))
    for k, v in enumerate(inp):
        in32 = int(v) << 10
        y = wrap32(in32 - s_iir[0])
        x = SMULWB(y, h0[0])
        o1 = wrap32(s_iir[0] + x)
        s_iir[0] = wrap32(in32 + x)
        y = wrap32(o1 - s_iir[1])
        x = SMULWB(y, h0[1])
        o2 = wrap32(s_iir[1] + x)
        s_iir[1] = wrap32(o1 + x)
        y = wrap32(o2 - s_iir[2])
        x = SMLAWB(y, y, h0[2])
        o1 = wrap32(s_iir[2] + x)
        s_iir[2] = wrap32(o2 + x)
        out[2 * k] = SAT16(RSHIFT_ROUND(o1, 10))
        y = wrap32(in32 - s_iir[3])
        x = SMULWB(y, h1[0])
        o1 = wrap32(s_iir[3] + x)
        s_iir[3] = wrap32(in32 + x)
        y = wrap32(o1 - s_iir[4])
        x = SMULWB(y, h1[1])
        o2 = wrap32(s_iir[4] + x)
        s_iir[4] = wrap32(o1 + x)
        y = wrap32(o2 - s_iir[5])
        x = SMLAWB(y, y, h1[2])
        o1 = wrap32(s_iir[5] + x)
        s_iir[5] = wrap32(o2 + x)
        out[2 * k + 1] = SAT16(RSHIFT_ROUND(o1, 10))
    return out


class SilkResampler:
    """silk/resampler.c state: internal-rate int16 -> API-rate int16.

    Supports the decoder-side upsampling paths (8/12/16 -> 24/48 and
    equal rates).  The IIR_FIR path 2x-upsamples with the HQ all-pass
    pair then interpolates with the 12-phase fractional FIR."""

    ORDER_FIR = 8
    # resampler.c delay_matrix_dec, decoder paths to 48 kHz, in input
    # samples (verified against libopus output alignment)
    INPUT_DELAY = {(8000, 48000): 0, (12000, 48000): 4,
                   (16000, 48000): 7}

    def __init__(self, fs_in_hz: int, fs_out_hz: int,
                 match_latency: bool = True):
        self.fs_in = fs_in_hz
        self.fs_out = fs_out_hz
        self.s_iir = [0] * 6
        self.s_fir = [0] * self.ORDER_FIR
        d = (self.INPUT_DELAY.get((fs_in_hz, fs_out_hz), 0)
             if match_latency else 0)
        self._hold = [0] * d
        self._delay = d
        if fs_in_hz == fs_out_hz:
            self.mode = "copy"
        else:
            assert fs_out_hz > fs_in_hz, "decoder only upsamples"
            self.mode = "iir_fir"
            inv = ((fs_in_hz << 15) // fs_out_hz) << 2
            while SMULWW(inv, fs_out_hz) < (fs_in_hz << 1):
                inv += 1                      # round the ratio up
            self.inv_ratio_q16 = inv

    def process(self, inp) -> np.ndarray:
        if self._delay:
            seq = self._hold + [int(x) for x in inp]
            self._hold = seq[len(seq) - self._delay:]
            inp = seq[:len(seq) - self._delay]
        if self.mode == "copy":
            return np.asarray(inp, np.int64)
        out = self._process_native(inp)
        if out is not None:
            return out
        buf = list(self.s_fir) + _up2_hq(self.s_iir, inp)
        n2 = 2 * len(inp)
        self.s_fir = buf[n2:n2 + self.ORDER_FIR]
        out = []
        fir = T.RESAMPLER_FRAC_FIR_12
        idx = 0
        max_idx = len(inp) << 17
        inc = self.inv_ratio_q16
        while idx < max_idx:
            ti = SMULWB(idx & 0xFFFF, 12)
            p = idx >> 16
            a = fir[ti]
            b = fir[11 - ti]
            acc = (buf[p] * a[0] + buf[p + 1] * a[1]
                   + buf[p + 2] * a[2] + buf[p + 3] * a[3]
                   + buf[p + 4] * b[3] + buf[p + 5] * b[2]
                   + buf[p + 6] * b[1] + buf[p + 7] * b[0])
            out.append(SAT16(RSHIFT_ROUND(wrap32(acc), 15)))
            idx += inc
        return np.asarray(out, np.int64)

    def _process_native(self, inp) -> "Optional[np.ndarray]":
        """native/gtpu_silk.cpp resampler (bit-exact with the Python
        loop above, which remains the specification)."""
        from ..native.silk import get_lib
        lib = get_lib()
        if lib is None or not len(inp):
            return None
        import ctypes
        i32 = np.int32
        i32p = ctypes.POINTER(ctypes.c_int32)
        if not hasattr(self, "_c_state"):
            self._c_state = (
                np.zeros(6, i32), np.zeros(8, i32),
                np.ascontiguousarray(
                    np.asarray(T.RESAMPLER_FRAC_FIR_12,
                               np.int16).reshape(-1)),
                np.ascontiguousarray(T.RESAMPLER_UP2_HQ_0, i32),
                np.ascontiguousarray(T.RESAMPLER_UP2_HQ_1, i32))
            self._c_state[0][:] = self.s_iir
            self._c_state[1][:] = self.s_fir
        s_iir, s_fir, fir, hq0, hq1 = self._c_state
        x = np.ascontiguousarray(inp, i32)
        n = len(x)
        scratch = np.zeros(8 + 2 * n, i32)
        out = np.zeros(8 * n + 16, i32)   # up to 6x (8k->48k)

        def P(a):
            return a.ctypes.data_as(i32p)

        n_out = lib.gtpu_silk_resample_iirfir(
            P(s_iir), P(s_fir),
            fir.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            P(hq0), P(hq1), self.inv_ratio_q16,
            P(x), n, P(scratch), P(out))
        # mirror back for mixed native/python use
        self.s_iir = [int(v) for v in s_iir]
        self.s_fir = [int(v) for v in s_fir]
        return out[:n_out].astype(np.int64)
