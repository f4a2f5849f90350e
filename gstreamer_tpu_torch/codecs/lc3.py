"""Clean-room LC3 (Low Complexity Communication Codec) re-spec.

LC3 is the Bluetooth LE-Audio codec defined by ETSI TS 103 634.  The
reference wraps Google's liblc3
(`subprojects/gst-plugins-bad/ext/lc3/gstlc3enc.c:1`,
`gstlc3dec.c:1`); no copy of that library (or any other LC3
implementation) exists in this environment, so — unlike the
oracle-checked Opus/AAC/MP3 paths — this codec is a **clean-room
re-spec of the LC3 architecture**, not a bit-compatible
implementation.  It keeps every structural property that defines LC3:

* frame durations 10 ms / 7.5 ms at 8/16/24/32/48 kHz
  (``NF = rate * duration``, 60..480 MDCT lines — gstlc3common.h:31),
* **exactly ``frame-bytes`` bytes per channel per frame** for any
  byte budget in [20, 400] (gstlc3common.h:33), enforced by a
  global-gain rate loop against an exact arithmetic-coder ``tell()``,
* MDCT analysis → spectral noise shaping (16 coded scale factors)
  → temporal noise shaping (quantized-lattice LPC over the upper
  spectrum) → global-gain quantization → context-adaptive
  arithmetic coding → residual refinement bits → noise filling,
* packet-loss concealment (damped spectral repetition).

The entropy layer is the RFC 6716-style range coder pair
(``codecs/entenc.py`` + ``codecs/celt.py:RangeDecoder``): arithmetic
symbols from the front of the frame, raw residual bits from the back,
with an exact, side-symmetric ``tell()``.

Validated by roundtrip tests (tests/test_lc3.py): exact frame sizes
across the full [20, 400]-byte range, >30 dB SNR on tonal material at
typical LE-Audio rates, and PLC behavior.

A copy of the JAX package's ``codecs/lc3.py`` (host numpy, its
dtypes kept: the frames are the JAX package's bytes).  Its decoder
takes the port's ``codecs/celt.py:RangeDecoder``.  The noise level
is estimated from the bins zeroed before the budget loop truncates
the spectrum, as in the JAX package; it is copied so, since a fix
would change the bytes (ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .entenc import RangeEncoder
from .celt import RangeDecoder

SAMPLE_RATES = (8000, 16000, 24000, 32000, 48000)
FRAME_DURATIONS_US = (10000, 7500)
MIN_FRAME_BYTES, MAX_FRAME_BYTES = 20, 400

_SNS_POINTS = 16
_TNS_ORDER = 8
_RESERVE_BITS = 8          # ec finalization slack
_RES_ROUNDS = 4            # residual refinement passes


def frame_samples(rate: int, frame_duration_us: int) -> int:
    nf = rate * frame_duration_us // 1_000_000
    if nf * 1_000_000 != rate * frame_duration_us:
        raise ValueError("non-integral frame length")
    return nf


def default_frame_bytes(frame_duration_us: int) -> int:
    """~96 kbit/s per channel (a typical LE-Audio broadcast setting)."""
    return max(MIN_FRAME_BYTES,
               min(MAX_FRAME_BYTES, 96000 * frame_duration_us
                   // 1_000_000 // 8))


# ---------------------------------------------------------------------------
# Shared trace-level tables (cached per NF)
# ---------------------------------------------------------------------------

_BASIS: Dict[int, np.ndarray] = {}
_EDGES: Dict[int, np.ndarray] = {}


def _mdct_basis(nf: int) -> np.ndarray:
    """Orthonormal sine-windowed MDCT basis (Princen–Bradley TDAC):
    B[k, n] = sqrt(2/N) * w[n] * cos(pi/N (n + 0.5 + N/2)(k + 0.5)).
    Forward X = B @ x(2N); inverse y(2N) = B.T @ X with overlap-add."""
    b = _BASIS.get(nf)
    if b is None:
        n = np.arange(2 * nf)
        k = np.arange(nf)[:, None]
        w = np.sin(np.pi / (2 * nf) * (n + 0.5))
        b = np.sqrt(2.0 / nf) * w * np.cos(
            np.pi / nf * (n + 0.5 + nf / 2.0) * (k + 0.5))
        _BASIS[nf] = b
    return b


def _band_edges(nf: int) -> np.ndarray:
    """Near-logarithmic partition of the NF spectral lines into
    NB = min(64, NF) bands (the spec's I_fs tables re-derived as a
    deterministic warped scale; fine bands at DC, wide at the top)."""
    e = _EDGES.get(nf)
    if e is None:
        nb = min(64, nf)
        x = np.exp(np.linspace(0.0, np.log(nf / 6.0 + 1.0), nb + 1)) - 1.0
        x = x / x[-1] * nf
        edges = np.round(x).astype(np.int64)
        edges[0] = 0
        edges[nb] = nf
        for i in range(1, nb + 1):           # min width 1, forward
            edges[i] = max(edges[i], edges[i - 1] + 1)
        for i in range(nb, 0, -1):           # clamp back below NF
            edges[i - 1] = min(edges[i - 1], edges[i] - 1)
        e = edges
        _EDGES[nf] = e
    return e


def _sns_groups(nb: int) -> Tuple[np.ndarray, np.ndarray]:
    """16 control-point grouping of the NB bands + group centers."""
    bounds = np.linspace(0, nb, _SNS_POINTS + 1).round().astype(int)
    centers = (bounds[:-1] + bounds[1:] - 1) / 2.0
    return bounds, centers


# ---------------------------------------------------------------------------
# Adaptive binary model over the range coder
# ---------------------------------------------------------------------------

class _Bit:
    __slots__ = ("c0", "c1")

    def __init__(self):
        self.c0 = 1
        self.c1 = 1

    def enc(self, rc: RangeEncoder, bit: int) -> None:
        ft = self.c0 + self.c1
        if bit:
            rc.encode(self.c0, ft, ft)
        else:
            rc.encode(0, self.c0, ft)
        self._upd(bit)

    def dec(self, rc: RangeDecoder) -> int:
        ft = self.c0 + self.c1
        s = rc.decode(ft)
        bit = 1 if s >= self.c0 else 0
        if bit:
            rc.update(self.c0, ft, ft)
        else:
            rc.update(0, self.c0, ft)
        self._upd(bit)
        return bit

    def _upd(self, bit: int) -> None:
        if bit:
            self.c1 += 2
        else:
            self.c0 += 2
        if self.c0 + self.c1 > 128:
            self.c0 = (self.c0 + 1) >> 1
            self.c1 = (self.c1 + 1) >> 1


class _Models:
    """Per-frame adaptive model set (identical init on both sides)."""

    def __init__(self):
        self.zero = [_Bit(), _Bit(), _Bit()]     # ctx: nonzeros in last 2
        self.mag = [_Bit() for _ in range(20)]   # Elias-gamma prefix
        self.sf_sign = _Bit()
        self.sf_cont = [_Bit() for _ in range(8)]


# TNS reflection-coefficient prior: 15 levels (idx-7 in [-7, 7]),
# peaked at 0.  icdf convention: icdf[s] = ft - cumulative(s+1), ftb=7.
_TNS_ICDF = [121, 113, 104, 94, 82, 68, 52, 35,
             21, 12, 7, 4, 2, 1, 0]
_TNS_FTB = 7


def _levinson(r: np.ndarray, order: int) -> Tuple[np.ndarray, float]:
    """Levinson-Durbin: autocorr -> reflection coeffs, prediction err."""
    a = np.zeros(order + 1)
    a[0] = 1.0
    err = r[0]
    rc = np.zeros(order)
    for i in range(1, order + 1):
        if err <= 0:
            break
        acc = r[i] + np.dot(a[1:i], r[1:i][::-1])
        k = -acc / err
        rc[i - 1] = k
        a[1:i + 1] = a[1:i + 1] + k * np.concatenate(
            (a[1:i][::-1], [1.0]))
        err *= (1.0 - k * k)
    return rc, err


def _rc_to_lpc(rc: np.ndarray) -> np.ndarray:
    a = np.zeros(len(rc) + 1)
    a[0] = 1.0
    for i, k in enumerate(rc, start=1):
        a[1:i + 1] = a[1:i + 1] + k * np.concatenate(
            (a[1:i][::-1], [1.0]))
    return a


class _Lc3Common:
    def __init__(self, rate: int, frame_duration_us: int,
                 frame_bytes: int):
        if rate not in SAMPLE_RATES:
            raise ValueError("unsupported rate %r" % (rate,))
        if frame_duration_us not in FRAME_DURATIONS_US:
            raise ValueError("unsupported duration %r"
                             % (frame_duration_us,))
        if not MIN_FRAME_BYTES <= frame_bytes <= MAX_FRAME_BYTES:
            raise ValueError("frame_bytes out of [20, 400]")
        self.rate = rate
        self.frame_duration_us = frame_duration_us
        self.frame_bytes = frame_bytes
        self.nf = frame_samples(rate, frame_duration_us)
        self.basis = _mdct_basis(self.nf)
        self.edges = _band_edges(self.nf)
        self.nb = len(self.edges) - 1
        self.bounds, self.centers = _sns_groups(self.nb)
        # per-bin band membership
        self.band_of = np.searchsorted(self.edges, np.arange(self.nf),
                                       side="right") - 1
        self.tns_start = self.nf // 8
        self.nf_start = self.nf // 4
        self.budget_bits = 8 * frame_bytes
        # TNS side cost ~4.4 bits/coef; skip it on starved budgets
        self.tns_enabled = frame_bytes >= 40

    def _gains_from_sf(self, sf_q: np.ndarray) -> np.ndarray:
        sf_band = np.interp(np.arange(self.nb), self.centers, sf_q)
        return np.exp2(sf_band)[self.band_of]


def _gg_of(gg_ind: int) -> float:
    return 2.0 ** ((gg_ind - 96) / 8.0)


class Lc3ChannelEncoder(_Lc3Common):
    """Single-channel LC3 encoder; encode_frame consumes exactly NF
    int16 samples and returns exactly frame_bytes bytes."""

    def __init__(self, rate, frame_duration_us, frame_bytes):
        super().__init__(rate, frame_duration_us, frame_bytes)
        self._prev = np.zeros(self.nf)

    # -- analysis -------------------------------------------------------------
    def _analyze(self, pcm: np.ndarray):
        x2n = np.concatenate((self._prev, pcm))
        self._prev = pcm.astype(np.float64)
        spec = self.basis @ x2n
        # SNS scale factors from band log-energies
        eb = np.add.reduceat(spec * spec, self.edges[:-1])
        eb = eb / np.diff(self.edges) + 1e-9
        loge = 0.5 * np.log2(eb)
        loge = np.convolve(np.pad(loge, 2, mode="edge"),
                           np.array([1, 2, 3, 2, 1]) / 9.0,
                           mode="valid")
        sf16 = np.array([loge[self.bounds[i]:self.bounds[i + 1]].mean()
                         for i in range(_SNS_POINTS)])
        sf16 = 0.85 * (sf16 - sf16.mean())
        sf_idx = np.clip(np.round(sf16 * 2), -32, 31).astype(int)
        sf_q = sf_idx / 2.0
        gains = self._gains_from_sf(sf_q)
        xs = spec / gains
        # TNS over the upper spectrum
        tns_on = 0
        tns_idx = np.zeros(_TNS_ORDER, int)
        if self.tns_enabled:
            reg = xs[self.tns_start:]
            if len(reg) > 4 * _TNS_ORDER:
                r = np.array([np.dot(reg[:len(reg) - i], reg[i:])
                              for i in range(_TNS_ORDER + 1)])
                if r[0] > 0:
                    rc, err = _levinson(r, _TNS_ORDER)
                    if err > 0 and r[0] / err > 2.0:
                        tns_on = 1
                        tns_idx = np.clip(
                            np.round(np.arcsin(np.clip(rc, -1, 1))
                                     * (8.0 / (np.pi / 2))),
                            -7, 7).astype(int)
        if tns_on:
            rc_q = np.sin(tns_idx * (np.pi / 2) / 8.0)
            a = _rc_to_lpc(rc_q)
            reg = xs[self.tns_start:].copy()
            filt = np.convolve(reg, a)[:len(reg)]
            xs = xs.copy()
            xs[self.tns_start:] = filt
        return xs, sf_idx, tns_on, tns_idx

    # -- coding ---------------------------------------------------------------
    def _encode_main(self, xs, sf_idx, tns_on, tns_idx, gg_ind):
        gg = _gg_of(gg_ind)
        t = xs / gg
        q = (np.sign(t) * np.floor(np.abs(t) + 0.375)).astype(np.int64)
        np.clip(q, -(1 << 20), 1 << 20, out=q)
        nz = np.nonzero(q)[0]
        lastnz = int(nz[-1]) + 1 if len(nz) else 0

        rc = RangeEncoder(self.frame_bytes)
        m = _Models()
        rc.enc_uint(lastnz, self.nf + 1)
        rc.enc_uint(gg_ind, 256)
        # SNS: absolute first index, then signed deltas
        rc.enc_uint(int(sf_idx[0]) + 32, 64)
        for i in range(1, _SNS_POINTS):
            d = int(sf_idx[i] - sf_idx[i - 1])
            self._enc_signed(rc, m, d)
        if self.tns_enabled:
            rc.enc_bit_logp(tns_on, 2)
            if tns_on:
                for i in range(_TNS_ORDER):
                    rc.enc_icdf(int(tns_idx[i]) + 7, _TNS_ICDF,
                                _TNS_FTB)
        # noise level from zeroed bins in the noise-fill region
        reg = np.arange(self.nf_start, max(self.nf_start, lastnz))
        zmask = reg[q[reg] == 0] if len(reg) else reg
        lvl = float(np.mean(np.abs(t[zmask]))) if len(zmask) else 0.0
        nf_idx = int(np.clip(round(lvl * 8), 0, 7))
        rc.enc_uint(nf_idx, 8)
        # spectrum (context = nonzero density of the last two coded)
        hist = 0
        for k in range(lastnz):
            ctx = min(2, hist)
            v = int(q[k])
            if v == 0:
                m.zero[ctx].enc(rc, 0)
                hist = 1 if hist >= 2 else 0
                continue
            m.zero[ctx].enc(rc, 1)
            hist = 2 if hist >= 1 else 1
            rc.enc_bit_logp(1 if v < 0 else 0, 1)
            mag = abs(v) - 1
            nbits = (mag + 1).bit_length() - 1
            for i in range(nbits):
                m.mag[min(i, 19)].enc(rc, 1)
            m.mag[min(nbits, 19)].enc(rc, 0)
            if nbits:
                body = (mag + 1) - (1 << nbits)
                for i in range(nbits - 1, -1, -1):
                    rc.enc_bit_logp((body >> i) & 1, 1)
            if rc.tell() > self.budget_bits:
                # overflow truncation: the decoder's mirrored break
                # leaves the tail zero, so zero it here too to keep
                # the residual loop in sync
                q[k + 1:] = 0
                break
        return rc, q, t, lastnz

    @staticmethod
    def _enc_signed(rc: RangeEncoder, m: _Models, d: int) -> None:
        mag = abs(d)
        for i in range(mag):
            m.sf_cont[min(i, 7)].enc(rc, 1)
        m.sf_cont[min(mag, 7)].enc(rc, 0)
        if mag:
            m.sf_sign.enc(rc, 1 if d < 0 else 0)

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        pcm = np.asarray(pcm, np.float64)
        if pcm.shape != (self.nf,):
            raise ValueError("expected %d samples" % self.nf)
        xs, sf_idx, tns_on, tns_idx = self._analyze(pcm)
        limit = self.budget_bits - _RESERVE_BITS
        # never search below the clip-safe gain (|t| <= 2^20)
        xmax = float(np.max(np.abs(xs))) if xs.size else 0.0
        lo = 0
        if xmax > 0:
            lo = max(0, min(255, int(np.ceil(
                8.0 * (np.log2(xmax) - 20.0) + 96.0))))
        hi = 255
        best = None
        while lo < hi:                      # smallest fitting gg_ind
            mid = (lo + hi) // 2
            rc, q, t, lastnz = self._encode_main(
                xs, sf_idx, tns_on, tns_idx, mid)
            if rc.tell() <= limit and not rc.error:
                best = mid
                hi = mid
            else:
                lo = mid + 1
        gg_ind = best if best is not None else 255
        rc, q, t, lastnz = self._encode_main(
            xs, sf_idx, tns_on, tns_idx, gg_ind)
        while (rc.tell() > limit or rc.error) and gg_ind < 255:
            gg_ind += 4
            rc, q, t, lastnz = self._encode_main(
                xs, sf_idx, tns_on, tns_idx, min(gg_ind, 255))
        # residual refinement bits (raw, from the back)
        nres = max(0, limit - rc.tell())
        used = 0
        qr = q.astype(np.float64)
        delta = 0.25
        for _ in range(_RES_ROUNDS):
            if used >= nres:
                break
            for k in range(lastnz):
                if used >= nres:
                    break
                if q[k] != 0:
                    bit = 1 if t[k] > qr[k] else 0
                    rc.enc_bits(bit, 1)
                    qr[k] += delta if bit else -delta
                    used += 1
            delta *= 0.5
        out = rc.done()
        if rc.error:
            raise RuntimeError("lc3: ec overflow (internal)")
        return out


class Lc3ChannelDecoder(_Lc3Common):
    def __init__(self, rate, frame_duration_us, frame_bytes):
        super().__init__(rate, frame_duration_us, frame_bytes)
        self._tail = np.zeros(self.nf)
        self._last_spec = np.zeros(self.nf)
        self._losses = 0
        self._lcg = 0x12345

    def _rand_sign(self) -> float:
        self._lcg = (self._lcg * 1103515245 + 12345) & 0x7FFFFFFF
        return 1.0 if (self._lcg >> 16) & 1 else -1.0

    def decode_frame(self, data: Optional[bytes]) -> np.ndarray:
        if data is None:
            return self._conceal()
        if len(data) != self.frame_bytes:
            raise ValueError("expected %d bytes" % self.frame_bytes)
        try:
            spec = self._decode_spec(bytes(data))
        except Exception:
            return self._conceal()
        self._last_spec = spec
        self._losses = 0
        return self._synth(spec)

    def _decode_spec(self, data: bytes) -> np.ndarray:
        rc = RangeDecoder(data)
        m = _Models()
        lastnz = rc.dec_uint(self.nf + 1)
        gg_ind = rc.dec_uint(256)
        sf_idx = np.zeros(_SNS_POINTS, int)
        sf_idx[0] = rc.dec_uint(64) - 32
        for i in range(1, _SNS_POINTS):
            sf_idx[i] = sf_idx[i - 1] + self._dec_signed(rc, m)
        tns_on = 0
        tns_idx = np.zeros(_TNS_ORDER, int)
        if self.tns_enabled:
            tns_on = rc.dec_bit_logp(2)
            if tns_on:
                for i in range(_TNS_ORDER):
                    tns_idx[i] = rc.dec_icdf(_TNS_ICDF, _TNS_FTB) - 7
        nf_idx = rc.dec_uint(8)
        gg = _gg_of(gg_ind)
        q = np.zeros(self.nf, np.int64)
        hist = 0
        for k in range(lastnz):
            ctx = min(2, hist)
            if not m.zero[ctx].dec(rc):
                hist = (1 if hist >= 2 else 0)
                continue
            hist = (2 if hist >= 1 else 1)
            neg = rc.dec_bit_logp(1)
            nbits = 0
            while m.mag[min(nbits, 19)].dec(rc):
                nbits += 1
                if nbits > 24:
                    raise ValueError("corrupt magnitude")
            body = 0
            for _ in range(nbits):
                body = (body << 1) | rc.dec_bit_logp(1)
            mag = ((1 << nbits) + body) - 1 if nbits else 0
            q[k] = -(mag + 1) if neg else (mag + 1)
            if rc.tell() > self.budget_bits:
                break
        # residual refinement (exact mirror of the encoder loop)
        limit = self.budget_bits - _RESERVE_BITS
        nres = max(0, limit - rc.tell())
        used = 0
        qr = q.astype(np.float64)
        delta = 0.25
        for _ in range(_RES_ROUNDS):
            if used >= nres:
                break
            for k in range(lastnz):
                if used >= nres:
                    break
                if q[k] != 0:
                    bit = rc.dec_bits(1)
                    qr[k] += delta if bit else -delta
                    used += 1
            delta *= 0.5
        # noise filling on zeroed bins in the region
        if nf_idx and lastnz > self.nf_start:
            amp = nf_idx / 8.0
            for k in range(self.nf_start, lastnz):
                if q[k] == 0:
                    qr[k] = amp * self._rand_sign()
        xs = qr * gg
        if tns_on:
            rc_q = np.sin(tns_idx * (np.pi / 2) / 8.0)
            a = _rc_to_lpc(rc_q)
            reg = xs[self.tns_start:]
            out = np.empty_like(reg)
            for n in range(len(reg)):
                acc = reg[n]
                for i in range(1, min(n, _TNS_ORDER) + 1):
                    acc -= a[i] * out[n - i]
                out[n] = acc
            xs[self.tns_start:] = out
        sf_q = sf_idx / 2.0
        return xs * self._gains_from_sf(sf_q)

    @staticmethod
    def _dec_signed(rc: RangeDecoder, m: _Models) -> int:
        mag = 0
        while m.sf_cont[min(mag, 7)].dec(rc):
            mag += 1
            if mag > 64:
                raise ValueError("corrupt sf delta")
        if mag and m.sf_sign.dec(rc):
            return -mag
        return mag

    def _synth(self, spec: np.ndarray) -> np.ndarray:
        y = self.basis.T @ spec
        out = y[:self.nf] + self._tail
        self._tail = y[self.nf:]
        return np.clip(np.round(out), -32768, 32767).astype(np.int16)

    def _conceal(self) -> np.ndarray:
        self._losses += 1
        if self._losses > 6:
            spec = np.zeros(self.nf)
        else:
            damp = 0.85 ** self._losses
            spec = self._last_spec * damp
            if self._losses >= 2:
                spec = spec * np.array(
                    [self._rand_sign() for _ in range(self.nf)])
        self._last_spec = spec
        return self._synth(spec)


class Lc3Encoder:
    """Multichannel frame encoder: (NF, channels) int16 ->
    channels * frame_bytes bytes (per-channel frames back to back,
    matching gstlc3enc.c:323-326)."""

    def __init__(self, rate: int, channels: int,
                 frame_duration_us: int = 10000,
                 frame_bytes: Optional[int] = None):
        fb = frame_bytes or default_frame_bytes(frame_duration_us)
        self.channels = channels
        self.frame_bytes = fb
        self.chans = [Lc3ChannelEncoder(rate, frame_duration_us, fb)
                      for _ in range(channels)]
        self.nf = self.chans[0].nf

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        pcm = np.asarray(pcm)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        return b"".join(self.chans[c].encode_frame(pcm[:, c])
                        for c in range(self.channels))


class Lc3Decoder:
    def __init__(self, rate: int, channels: int,
                 frame_duration_us: int = 10000,
                 frame_bytes: Optional[int] = None):
        fb = frame_bytes or default_frame_bytes(frame_duration_us)
        self.channels = channels
        self.frame_bytes = fb
        self.chans = [Lc3ChannelDecoder(rate, frame_duration_us, fb)
                      for _ in range(channels)]
        self.nf = self.chans[0].nf

    def decode_frame(self, data: Optional[bytes]) -> np.ndarray:
        if data is None:
            outs = [c.decode_frame(None) for c in self.chans]
        else:
            fb = self.frame_bytes
            outs = [self.chans[c].decode_frame(data[c * fb:(c + 1) * fb])
                    for c in range(self.channels)]
        return np.stack(outs, axis=1)
