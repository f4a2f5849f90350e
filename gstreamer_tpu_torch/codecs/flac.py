"""Native FLAC codec — lossless audio, from scratch.

Implements the public FLAC format specification (RFC 9639; the
reference ships it via ext/flac/gstflacenc.c / gstflacdec.c over
libFLAC — this is a clean-room implementation of the same format):

Decoder (complete for the raw-integer feature set):
* STREAMINFO and metadata-block walk;
* frame headers: all blocksize/sample-rate/bps codes, UTF-8 coded
  frame/sample numbers, CRC-8 (poly 0x07) verification;
* subframes: CONSTANT, VERBATIM, FIXED orders 0-4, LPC orders 1-32
  (qlp precision + signed shift), wasted bits;
* Rice residual methods 0/1 (4/5-bit parameters) with escape-raw
  partitions, any partition order;
* stereo decorrelation: left/side, right/side, mid/side (+1 bps side);
* frame CRC-16 (poly 0x8005) verification.

Encoder (valid subset, what libFLAC calls "fixed" mode):
* fixed 4096 blocksize, independent channels, 8/16/24/32 bps;
* per-subframe best of CONSTANT / FIXED order 0-4 / VERBATIM by exact
  bit cost, Rice parameter chosen per partition (order 0);
* STREAMINFO with MD5 of the interleaved little-endian samples.

Every bit of the encoder's output round-trips bit-exactly through the
decoder, whose CRC checks are independent of the writer.

A copy of the JAX package's ``codecs/flac.py`` (host numpy and
Python integers); ``native/flac.py`` is its fast path.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Tuple

import numpy as np

def _md5_raw_bytes(samples: np.ndarray, nbytes: int) -> bytes:
    """Interleaved little-endian sample bytes for the STREAMINFO MD5
    (vectorized)."""
    flat = samples.astype(np.int64).ravel()
    mask = (1 << (8 * nbytes)) - 1
    v = (flat & mask).astype(np.uint64)
    if nbytes == 1:
        return v.astype("<u1").tobytes()
    if nbytes == 2:
        return v.astype("<u2").tobytes()
    if nbytes == 4:
        return v.astype("<u4").tobytes()
    b4 = v.astype("<u4").view(np.uint8).reshape(-1, 4)
    return np.ascontiguousarray(b4[:, :3]).tobytes()


FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCKSIZE_CODES = {192: 0b0001, 576: 0b0010, 1152: 0b0011,
                    2304: 0b0100, 4608: 0b0101, 256: 0b1000,
                    512: 0b1001, 1024: 0b1010, 2048: 0b1011,
                    4096: 0b1100, 8192: 0b1101, 16384: 0b1110,
                    32768: 0b1111}
_SAMPLE_RATES = {0b0001: 88200, 0b0010: 176400, 0b0011: 192000,
                 0b0100: 8000, 0b0101: 16000, 0b0110: 22050,
                 0b0111: 24000, 0b1000: 32000, 0b1001: 44100,
                 0b1010: 48000, 0b1011: 96000}
_BPS_CODES = {8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101, 24: 0b110,
              32: 0b111}
_BPS_FROM_CODE = {v: k for k, v in _BPS_CODES.items()}


# ---------------------------------------------------------------------------
# CRCs (FLAC spec: CRC-8 poly x^8+x^2+x+1 = 0x07, init 0;
# CRC-16 poly x^16+x^15+x^2+1 = 0x8005, init 0)
# ---------------------------------------------------------------------------

def _make_crc8_table():
    tab = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        tab.append(c)
    return tab


def _make_crc16_table():
    tab = []
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 \
                else (c << 1) & 0xFFFF
        tab.append(c)
    return tab


_CRC8 = _make_crc8_table()
_CRC16 = _make_crc16_table()


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


# ---------------------------------------------------------------------------
# Fast MSB-first bit IO
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self._acc = 0
        self._nbits = 0
        self._out = bytearray()

    def write(self, value: int, n: int):
        if n <= 0:
            return
        self._acc = (self._acc << n) | (value & ((1 << n) - 1))
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_unary(self, q: int):
        # q zeros then a one
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def bits_written(self) -> int:
        return len(self._out) * 8 + self._nbits

    def get_bytes(self) -> bytes:
        self.align()
        return bytes(self._out)


class _BitReader:
    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def read(self, n: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        end = pos + n
        if end > len(data) * 8:
            raise ValueError("flac: bitstream underrun")
        while n > 0:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, n)
            shift = avail - take
            v = (v << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
            n -= take
        self.pos = pos
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        data = self.data
        pos = self.pos
        total = len(data) * 8
        q = 0
        while True:
            if pos >= total:
                raise ValueError("flac: bitstream underrun (unary)")
            byte = data[pos >> 3]
            rem = 8 - (pos & 7)
            window = byte & ((1 << rem) - 1)
            if window == 0:
                q += rem
                pos += rem
                continue
            lead = rem - window.bit_length()
            q += lead
            pos += lead + 1
            self.pos = pos
            return q

    def align(self):
        self.pos = (self.pos + 7) & ~7


# ---------------------------------------------------------------------------
# UTF-8-style coded numbers (frame header)
# ---------------------------------------------------------------------------

def _write_utf8(bw: _BitWriter, v: int):
    if v < 0x80:
        bw.write(v, 8)
        return
    for n_extra, lead, span in ((1, 0xC0, 11), (2, 0xE0, 16),
                                (3, 0xF0, 21), (4, 0xF8, 26),
                                (5, 0xFC, 31), (6, 0xFE, 36)):
        if v < (1 << span):
            bw.write(lead | (v >> (6 * n_extra)), 8)
            for k in range(n_extra - 1, -1, -1):
                bw.write(0x80 | ((v >> (6 * k)) & 0x3F), 8)
            return
    raise ValueError("flac: coded number too large")


def _read_utf8(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    for mask, lead, cnt in ((0xE0, 0xC0, 1), (0xF0, 0xE0, 2),
                            (0xF8, 0xF0, 3), (0xFC, 0xF8, 4),
                            (0xFE, 0xFC, 5), (0xFF, 0xFE, 6)):
        if (b0 & mask) == lead:
            v = b0 & (0xFF >> (cnt + 2))
            n = cnt
            break
    else:
        raise ValueError("flac: invalid coded number")
    for _ in range(n):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("flac: invalid coded number continuation")
        v = (v << 6) | (b & 0x3F)
    return v


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class StreamInfo:
    def __init__(self):
        self.min_blocksize = self.max_blocksize = 0
        self.sample_rate = 0
        self.channels = 0
        self.bps = 0
        self.total_samples = 0
        self.md5 = b"\0" * 16


def parse_stream_header(data: bytes) -> Tuple[StreamInfo, int]:
    """Parse 'fLaC' + metadata blocks -> (StreamInfo, frame_offset)."""
    if data[:4] != b"fLaC":
        raise ValueError("flac: bad stream marker")
    pos = 4
    si = None
    while True:
        hdr = data[pos:pos + 4]
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:
            si = StreamInfo()
            br = _BitReader(body)
            si.min_blocksize = br.read(16)
            si.max_blocksize = br.read(16)
            br.read(24)            # min framesize
            br.read(24)            # max framesize
            si.sample_rate = br.read(20)
            si.channels = br.read(3) + 1
            si.bps = br.read(5) + 1
            si.total_samples = br.read(36)
            si.md5 = body[18:34]
        pos += 4 + size
        if last:
            break
    if si is None:
        raise ValueError("flac: no STREAMINFO")
    return si, pos


def _decode_residual(br: _BitReader, blocksize: int, order: int
                     ) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read(4)
    npart = 1 << po
    if blocksize % npart:
        raise ValueError("flac: bad partition order")
    out = np.empty(blocksize - order, np.int64)
    idx = 0
    for p in range(npart):
        n = blocksize // npart - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            raw = br.read(5)
            for i in range(n):
                out[idx + i] = br.read_signed(raw) if raw else 0
        else:
            for i in range(n):
                q = br.read_unary()
                v = (q << param) | (br.read(param) if param else 0)
                out[idx + i] = (v >> 1) ^ -(v & 1)
        idx += n
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int
                     ) -> np.ndarray:
    if br.read(1):
        raise ValueError("flac: subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1
        while br.read(1) == 0:
            wasted += 1
    bps -= wasted

    if stype == 0:                               # CONSTANT
        v = br.read_signed(bps)
        out = np.full(blocksize, v, np.int64)
    elif stype == 1:                             # VERBATIM
        out = np.array([br.read_signed(bps) for _ in range(blocksize)],
                       np.int64)
    elif 8 <= stype <= 12:                       # FIXED order 0-4
        order = stype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        c = FIXED_COEFFS[order]
        s = out
        if order == 0:
            s[:] = res
        else:
            for n in range(order, blocksize):
                acc = res[n - order]
                for i, ci in enumerate(c):
                    acc += ci * s[n - 1 - i]
                s[n] = acc
    elif stype >= 32:                            # LPC
        order = stype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("flac: invalid qlp precision")
        shift = br.read_signed(5)
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        for n in range(order, blocksize):
            acc = 0
            for i in range(order):
                acc += coefs[i] * int(out[n - 1 - i])
            out[n] = res[n - order] + (acc >> shift)
    else:
        raise ValueError(f"flac: reserved subframe type {stype}")
    if wasted:
        out = out << wasted
    return out


def decode_frame(data: bytes, pos: int, si: StreamInfo
                 ) -> Tuple[np.ndarray, int]:
    """Decode one frame at byte offset pos -> ((n, ch) int array,
    next byte offset)."""
    br = _BitReader(data, pos * 8)
    start = pos
    sync = br.read(14)
    if sync != 0x3FFE:
        raise ValueError("flac: bad frame sync")
    if br.read(1):
        raise ValueError("flac: reserved bit set")
    br.read(1)                     # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    bps_code = br.read(3)
    if br.read(1):
        raise ValueError("flac: reserved bit set")
    _read_utf8(br)                 # frame/sample number

    if bs_code == 0:
        raise ValueError("flac: reserved blocksize code")
    elif bs_code == 1:
        blocksize = 192
    elif 2 <= bs_code <= 5:
        blocksize = 576 << (bs_code - 2)
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = 256 << (bs_code - 8)

    if sr_code == 0:
        pass                        # from streaminfo
    elif sr_code in _SAMPLE_RATES:
        pass
    elif sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    elif sr_code == 15:
        raise ValueError("flac: invalid sample rate code")

    bps = si.bps if bps_code == 0 else _BPS_FROM_CODE[bps_code]

    hdr_end = (br.pos + 7) // 8
    expect = br.read(8)
    if crc8(data[start:hdr_end]) != expect:
        raise ValueError("flac: frame header CRC mismatch")

    if ch_code <= 7:
        nch = ch_code + 1
        chans = [_decode_subframe(br, blocksize, bps)
                 for _ in range(nch)]
    elif ch_code == 8:             # left/side
        left = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        chans = [left, left - side]
    elif ch_code == 9:             # right/side
        side = _decode_subframe(br, blocksize, bps + 1)
        right = _decode_subframe(br, blocksize, bps)
        chans = [right + side, right]
    elif ch_code == 10:            # mid/side
        mid = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        m2 = (mid << 1) | (side & 1)
        chans = [(m2 + side) >> 1, (m2 - side) >> 1]
    else:
        raise ValueError("flac: reserved channel assignment")

    br.align()
    frame_end = br.pos // 8
    expect16 = br.read(16)
    if crc16(data[start:frame_end]) != expect16:
        raise ValueError("flac: frame CRC16 mismatch")
    return np.stack(chans, axis=-1), br.pos // 8


def decode(data: bytes) -> Tuple[np.ndarray, StreamInfo]:
    """Decode a whole stream -> ((n, channels) int array, info)."""
    si, pos = parse_stream_header(data)
    frames = []
    total = 0
    while pos < len(data) - 2:
        samples, pos = decode_frame(data, pos, si)
        frames.append(samples)
        total += len(samples)
        if si.total_samples and total >= si.total_samples:
            break
    out = (np.concatenate(frames) if frames
           else np.zeros((0, si.channels), np.int64))
    if si.total_samples:
        out = out[:si.total_samples]
    return out, si


# ---------------------------------------------------------------------------
# Encoder (fixed-predictor subset)
# ---------------------------------------------------------------------------

def _rice_cost(res: np.ndarray, k: int) -> int:
    v = (res.astype(np.int64) << 1) ^ (res >> 63)
    return int((v >> k).sum()) + len(res) * (1 + k)


def _best_rice_param(res: np.ndarray) -> Tuple[int, int]:
    best_k, best_c = 0, _rice_cost(res, 0)
    for k in range(1, 15):
        c = _rice_cost(res, k)
        if c < best_c:
            best_k, best_c = k, c
    return best_k, best_c


def _write_rice(bw: _BitWriter, res: np.ndarray, k: int):
    v = (res.astype(np.int64) << 1) ^ (res >> 63)
    for u in v:
        u = int(u)
        bw.write_unary(u >> k)
        if k:
            bw.write(u, k)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int):
    n = len(x)
    x = x.astype(np.int64)
    if np.all(x == x[0]):                       # CONSTANT
        bw.write(0, 1)
        bw.write(0, 6)
        bw.write(0, 1)
        bw.write(int(x[0]), bps)
        return
    # pick the fixed order with the best exact cost
    best = None
    for order in range(5):
        if n <= order:
            break
        res = _fixed_residual(x, order)
        k, cost = _best_rice_param(res)
        total = order * bps + 2 + 4 + 4 + cost
        if best is None or total < best[0]:
            best = (total, order, res, k)
    verbatim_cost = n * bps
    if best is None or best[0] >= verbatim_cost:
        bw.write(0, 1)
        bw.write(1, 6)                          # VERBATIM
        bw.write(0, 1)
        for v in x:
            bw.write(int(v), bps)
        return
    _, order, res, k = best
    bw.write(0, 1)
    bw.write(8 + order, 6)                      # FIXED
    bw.write(0, 1)                              # no wasted bits
    for v in x[:order]:
        bw.write(int(v), bps)
    bw.write(0, 2)                              # residual method 0
    bw.write(0, 4)                              # partition order 0
    bw.write(k, 4)
    _write_rice(bw, res, k)


def encode_streaminfo(n: int, sample_rate: int, nch: int, bps: int,
                      blocksize: int, md5_digest: bytes) -> bytes:
    """'fLaC' + a last STREAMINFO metadata block (n=0, md5=zeros is
    the legal unseekable-stream form)."""
    head = _BitWriter()
    head.write(0x664C6143, 32)                 # fLaC
    head.write(1, 1)                           # last metadata block
    head.write(0, 7)                           # STREAMINFO
    head.write(34, 24)
    head.write(blocksize, 16)
    head.write(blocksize, 16)
    head.write(0, 24)
    head.write(0, 24)
    head.write(sample_rate, 20)
    head.write(nch - 1, 3)
    head.write(bps - 1, 5)
    head.write(n, 36)
    return head.get_bytes() + md5_digest


def encode_frame(block: np.ndarray, fi: int, sample_rate: int,
                 bps: int, blocksize: int) -> bytes:
    """One complete FLAC frame (header+subframes+CRC16) for block
    number fi of a fixed-blocksize stream."""
    bs, nch = block.shape
    bw = _BitWriter()
    bw.write(0x3FFE, 14)
    bw.write(0, 1)
    bw.write(0, 1)                          # fixed blocksize stream
    bs_code = _BLOCKSIZE_CODES.get(bs)
    if bs_code is None:
        bs_code = 0b0111                    # 16-bit blocksize-1
    bw.write(bs_code, 4)
    sr_code = {v: k for k, v in _SAMPLE_RATES.items()}.get(
        sample_rate, 0)
    bw.write(sr_code, 4)
    bw.write(nch - 1, 4)                    # independent channels
    bw.write(_BPS_CODES.get(bps, 0), 3)
    bw.write(0, 1)
    _write_utf8(bw, fi)
    if bs_code == 0b0111:
        bw.write(bs - 1, 16)
    hdr = bw.get_bytes()                    # byte-aligned here
    bw2 = _BitWriter()
    bw2._out = bytearray(hdr)
    bw2.write(crc8(hdr), 8)
    for c in range(nch):
        _encode_subframe(bw2, block[:, c], bps)
    body = bw2.get_bytes()                  # align to byte
    return body + struct.pack(">H", crc16(body))


def encode(samples: np.ndarray, sample_rate: int, bps: int = 16,
           blocksize: int = 4096) -> bytes:
    """(n, channels) ints -> FLAC stream bytes."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, nch = samples.shape
    if not 1 <= nch <= 8:
        raise ValueError("flac: 1-8 channels")

    # MD5 over interleaved little-endian samples (spec: unencoded data)
    nbytes = (bps + 7) // 8
    md5 = hashlib.md5()
    md5.update(_md5_raw_bytes(samples, nbytes))

    out = bytearray(encode_streaminfo(n, sample_rate, nch, bps,
                                      blocksize, md5.digest()))
    for fi, lo in enumerate(range(0, n, blocksize)):
        out += encode_frame(samples[lo:lo + blocksize].astype(np.int64),
                            fi, sample_rate, bps, blocksize)
    return bytes(out)
