"""Clean-room Vorbis I decoder.

Written from the public Vorbis I specification (Xiph.Org,
"Vorbis I specification"); NOT a port of libvorbis.  The reference
GStreamer element (gst-plugins-base/ext/vorbis/gstvorbisdec.c) is a
thin wrapper around libvorbis — this framework instead decodes
natively so the synthesis filterbank can run on device.

TPU-first structure: all per-packet bitstream work (huffman, floor,
residue) is host-side and inherently serial, but the FLOP-heavy stage
— the IMDCT synthesis filterbank — is factored out as a single batched
matrix multiply per blocksize group (`imdct_matrix` below): packets'
spectra are stacked (B, n/2) and multiplied with a precomputed
(n/2, n) cosine basis, which is exactly the MXU-shaped formulation
(`decode_packets` → `_imdct_batch`).  Windowing + overlap-add are a
vectorized epilogue.

Parity: tests/test_vorbis.py checks PCM against libvorbisfile decodes
of libvorbisenc-generated streams (tests/audio_oracle.py) at >=60 dB
SNR — float synthesis differs only in rounding/filterbank order.

A copy of the JAX package's ``codecs/vorbis.py``: host numpy, float32,
the IMDCT as numpy products.  Ogg pages come from the port's
``elements/ogg.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


class EndOfPacket(Exception):
    pass


class BitReader:
    """Vorbis packs bits LSB-first within bytes (spec §2)."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                      # bit position
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.nbits:
            self.pos = self.nbits
            raise EndOfPacket
        v = 0
        p = self.pos
        data = self.data
        got = 0
        while got < n:
            byte = data[p >> 3]
            bit_off = p & 7
            take = min(8 - bit_off, n - got)
            v |= ((byte >> bit_off) & ((1 << take) - 1)) << got
            got += take
            p += take
        self.pos = p
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_bit(self) -> int:
        if self.pos >= self.nbits:
            raise EndOfPacket
        b = (self.data[self.pos >> 3] >> (self.pos & 7)) & 1
        self.pos += 1
        return b


def ilog(x: int) -> int:
    """Spec §9.2.1: number of bits needed; ilog(0)=0, ilog(negative)=0."""
    if x <= 0:
        return 0
    return x.bit_length()


def float32_unpack(x: int) -> float:
    """Spec §9.2.2."""
    mantissa = x & 0x1FFFFF
    sign = x & 0x80000000
    exponent = (x & 0x7FE00000) >> 21
    if sign:
        mantissa = -mantissa
    return mantissa * (2.0 ** (exponent - 788))


def lookup1_values(entries: int, dim: int) -> int:
    """Spec §9.2.3: greatest integer with value**dim <= entries."""
    v = int(entries ** (1.0 / dim))
    while (v + 1) ** dim <= entries:
        v += 1
    while v ** dim > entries:
        v -= 1
    return v


# --------------------------------------------------------------- codebook

class Codebook:
    """One codebook: huffman lengths -> canonical codewords (spec §3.2),
    optional VQ lookup table (lookup types 1 and 2)."""

    def __init__(self, br: BitReader):
        if br.read(24) != 0x564342:
            raise ValueError("vorbis: codebook sync lost")
        self.dimensions = br.read(16)
        self.entries = br.read(24)
        lengths = [-1] * self.entries
        if br.read_bit():                           # ordered
            current_entry = 0
            current_length = br.read(5) + 1
            while current_entry < self.entries:
                number = br.read(ilog(self.entries - current_entry))
                for i in range(number):
                    lengths[current_entry + i] = current_length
                current_entry += number
                current_length += 1
                if current_entry > self.entries:
                    raise ValueError("vorbis: ordered codebook overflow")
        else:
            sparse = br.read_bit()
            for i in range(self.entries):
                if sparse:
                    if br.read_bit():
                        lengths[i] = br.read(5) + 1
                else:
                    lengths[i] = br.read(5) + 1
        self.lengths = lengths
        self._assign_codewords()

        self.lookup_type = br.read(4)
        self.vq: Optional[np.ndarray] = None
        if self.lookup_type in (1, 2):
            minimum = float32_unpack(br.read(32))
            delta = float32_unpack(br.read(32))
            value_bits = br.read(4) + 1
            sequence_p = br.read_bit()
            if self.lookup_type == 1:
                count = lookup1_values(self.entries, self.dimensions)
            else:
                count = self.entries * self.dimensions
            mults = [br.read(value_bits) for _ in range(count)]
            dim = self.dimensions
            table = np.zeros((self.entries, dim), np.float64)
            if self.lookup_type == 1:
                l1v = count
                for e in range(self.entries):
                    last = 0.0
                    idiv = 1
                    for d in range(dim):
                        off = (e // idiv) % l1v
                        v = mults[off] * delta + minimum + last
                        if sequence_p:
                            last = v
                        table[e, d] = v
                        idiv *= l1v
            else:
                for e in range(self.entries):
                    last = 0.0
                    for d in range(dim):
                        v = mults[e * dim + d] * delta + minimum + last
                        if sequence_p:
                            last = v
                        table[e, d] = v
            self.vq = table.astype(np.float32)
        elif self.lookup_type != 0:
            raise ValueError("vorbis: reserved codebook lookup type")

    def _assign_codewords(self) -> None:
        """Canonical Vorbis codeword assignment (spec §3.2.1): each used
        entry, in entry order, takes the lowest available codeword of
        its length.  `self.table` maps (length, msb_first_code) -> entry."""
        table: Dict[Tuple[int, int], int] = {}
        available = [0] * 33
        first = True
        for e, l in enumerate(self.lengths):
            if l <= 0:
                continue
            if l > 32:
                raise ValueError("vorbis: codeword too long")
            if first:
                # the first used entry takes the all-zeros codeword of
                # its length; its sibling branch at every depth 1..l
                # becomes the next available codeword there
                code32 = 0
                first = False
                for i in range(1, l + 1):
                    available[i] = 1 << (32 - i)
            else:
                z = l
                while z > 0 and not available[z]:
                    z -= 1
                if z == 0:
                    raise ValueError("vorbis: over-subscribed codebook")
                code32 = available[z]
                available[z] = 0
                for y in range(l, z, -1):
                    available[y] = code32 + (1 << (32 - y))
            table[(l, code32 >> (32 - l))] = e
        # a single-entry codebook (one used entry) is legal: spec says
        # it decodes with a single read of one bit (value ignored)
        used = [l for l in self.lengths if l > 0]
        self.single = (len(used) == 1)
        if self.single and used[0] != 1:
            # spec errata: single-entry books use 1 bit regardless
            e = next(i for i, l in enumerate(self.lengths) if l > 0)
            table = {(1, 0): e, (1, 1): e}
        self.table = table
        self.maxlen = max(used) if used else 0

    def decode_scalar(self, br: BitReader) -> int:
        code = 0
        table = self.table
        for length in range(1, self.maxlen + 1):
            code = (code << 1) | br.read_bit()
            e = table.get((length, code))
            if e is not None:
                return e
        raise ValueError("vorbis: invalid huffman code")

    def decode_vq(self, br: BitReader) -> np.ndarray:
        if self.vq is None:
            raise ValueError("vorbis: scalar codebook used in VQ context")
        return self.vq[self.decode_scalar(br)]


# ------------------------------------------------------------------ floor

# floor1 Y values index an inverse-dB amplitude table (spec §10.1):
# geometric from 1.0649863e-07 (Y=0) to 1.0 (Y=255); the closed form
# reproduces the spec's 256 published constants to float32 rounding
_LN_LO = math.log(1.0649863e-07)
INVERSE_DB_TABLE = np.exp(
    _LN_LO * (255 - np.arange(256)) / 255.0).astype(np.float32)

_FLOOR1_RANGES = [256, 128, 86, 64]


class Floor0:
    """Floor type 0 — LSP curve (spec §6).  Rare in practice (encoders
    emit floor 1); implemented for completeness."""

    def __init__(self, br: BitReader):
        self.order = br.read(8)
        self.rate = br.read(16)
        self.bark_map_size = br.read(16)
        self.amplitude_bits = br.read(6)
        self.amplitude_offset = br.read(8)
        self.num_books = br.read(4) + 1
        self.books = [br.read(8) for _ in range(self.num_books)]
        if self.order == 0 or self.rate == 0 or self.bark_map_size == 0:
            raise ValueError("vorbis: bad floor0 header")
        self._maps: Dict[int, np.ndarray] = {}

    def _bark_map(self, n: int) -> np.ndarray:
        m = self._maps.get(n)
        if m is None:
            def bark(x):
                return (13.1 * np.arctan(0.00074 * x)
                        + 2.24 * np.arctan(1.85e-8 * x * x)
                        + 1e-4 * x)
            i = np.arange(n)
            f = bark(0.5 * self.rate * i / n) * (
                self.bark_map_size / bark(0.5 * self.rate))
            m = np.minimum(self.bark_map_size - 1,
                           np.floor(f)).astype(np.int64)
            self._maps[n] = m
        return m

    def decode(self, br: BitReader, codebooks: List[Codebook],
               n2: int) -> Optional[np.ndarray]:
        amplitude = br.read(self.amplitude_bits)
        if amplitude <= 0:
            return None
        booknumber = br.read(ilog(self.num_books))
        if booknumber >= self.num_books:
            raise EndOfPacket
        book = codebooks[self.books[booknumber]]
        coeffs: List[float] = []
        last = 0.0
        while len(coeffs) < self.order:
            vec = book.decode_vq(br)
            coeffs.extend(float(v) + last for v in vec)
            last = coeffs[-1]
        coeffs = np.array(coeffs[:self.order], np.float64)

        m = self._bark_map(n2)
        omega = np.pi * m / self.bark_map_size
        cosw = np.cos(omega)
        cosc = np.cos(coeffs)
        if self.order % 2:
            podd = cosc[1::2]
            peven = cosc[0::2]
            p = (1 - cosw ** 2) * np.prod(
                4 * (podd[:, None] - cosw) ** 2, axis=0)
            q = 0.25 * np.prod(
                4 * (peven[:, None] - cosw) ** 2, axis=0)
        else:
            podd = cosc[1::2]
            peven = cosc[0::2]
            p = (1 - cosw) / 2 * np.prod(
                4 * (podd[:, None] - cosw) ** 2, axis=0)
            q = (1 + cosw) / 2 * np.prod(
                4 * (peven[:, None] - cosw) ** 2, axis=0)
        denom = np.sqrt(np.maximum(p + q, 1e-300))
        amp_max = (1 << self.amplitude_bits) - 1
        lin = np.exp(0.11512925 * (
            amplitude * self.amplitude_offset / (amp_max * denom)
            - self.amplitude_offset))
        return lin.astype(np.float32)


class Floor1:
    """Floor type 1 — piecewise-linear log-amplitude curve (spec §7)."""

    def __init__(self, br: BitReader, codebooks: List[Codebook]):
        self.partitions = br.read(5)
        self.partition_class_list = [br.read(4)
                                     for _ in range(self.partitions)]
        maxclass = max(self.partition_class_list, default=-1)
        self.class_dimensions = []
        self.class_subclasses = []
        self.class_masterbooks = []
        self.subclass_books = []
        for _ in range(maxclass + 1):
            dim = br.read(3) + 1
            sub = br.read(2)
            self.class_dimensions.append(dim)
            self.class_subclasses.append(sub)
            self.class_masterbooks.append(br.read(8) if sub else -1)
            self.subclass_books.append(
                [br.read(8) - 1 for _ in range(1 << sub)])
        self.multiplier = br.read(2) + 1
        rangebits = br.read(4)
        x_list = [0, 1 << rangebits]
        for i in range(self.partitions):
            cls = self.partition_class_list[i]
            for _ in range(self.class_dimensions[cls]):
                x_list.append(br.read(rangebits))
        if len(set(x_list)) != len(x_list):
            raise ValueError("vorbis: floor1 duplicate X positions")
        self.x_list = x_list
        # sort order (indices into x_list ordered by X value)
        self.sort_order = sorted(range(len(x_list)),
                                 key=lambda i: x_list[i])
        # low/high neighbors per spec §9.2.4/9.2.5 (among indices < i)
        self.low_nb = [0] * len(x_list)
        self.high_nb = [0] * len(x_list)
        for i in range(2, len(x_list)):
            lo, hi = 0, 1
            for j in range(i):
                if x_list[lo] < x_list[j] < x_list[i]:
                    lo = j
                if x_list[i] < x_list[j] < x_list[hi]:
                    hi = j
            self.low_nb[i], self.high_nb[i] = lo, hi

    def decode(self, br: BitReader, codebooks: List[Codebook]
               ) -> Optional[Tuple[List[int], List[bool]]]:
        """-> (final_Y, step2_flags) or None when unused."""
        if not br.read_bit():
            return None
        rng = _FLOOR1_RANGES[self.multiplier - 1]
        ybits = ilog(rng - 1)
        y = [br.read(ybits), br.read(ybits)]
        for i in range(self.partitions):
            cls = self.partition_class_list[i]
            cdim = self.class_dimensions[cls]
            cbits = self.class_subclasses[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = codebooks[self.class_masterbooks[cls]
                                 ].decode_scalar(br)
            for _ in range(cdim):
                book = self.subclass_books[cls][cval & csub]
                cval >>= cbits
                y.append(codebooks[book].decode_scalar(br)
                         if book >= 0 else 0)
        return self._amplitude(y, rng)

    def _amplitude(self, y: List[int], rng: int
                   ) -> Tuple[List[int], List[bool]]:
        """Spec §7.2.3 step 2: absolute Y values + step2 flags, folded
        into final list where unused points carry the predicted value
        (so render skips them naturally via the flags)."""
        n = len(self.x_list)
        final = [0] * n
        flags = [False] * n
        final[0], final[1] = y[0], y[1]
        flags[0] = flags[1] = True
        for i in range(2, n):
            lo, hi = self.low_nb[i], self.high_nb[i]
            pred = _render_point(self.x_list[lo], final[lo],
                                 self.x_list[hi], final[hi],
                                 self.x_list[i])
            val = y[i]
            highroom = rng - pred
            lowroom = pred
            room = 2 * min(highroom, lowroom)
            if val:
                flags[lo] = flags[hi] = flags[i] = True
                if val >= room:
                    if highroom > lowroom:
                        final[i] = val - lowroom + pred
                    else:
                        final[i] = pred - val + highroom - 1
                else:
                    if val & 1:
                        final[i] = pred - (val + 1) // 2
                    else:
                        final[i] = pred + val // 2
            else:
                flags[i] = False
                final[i] = pred
        return final, flags

    def synthesize(self, final_y: List[int], flags: List[bool],
                   n2: int) -> np.ndarray:
        """Spec §7.2.4: render lines through the flagged points into
        a linear-amplitude floor curve of length n2."""
        rng = _FLOOR1_RANGES[self.multiplier - 1]
        out = np.zeros(n2, np.float32)
        mult = self.multiplier
        hx = 0
        lx = 0
        ly = min(max(final_y[self.sort_order[0]], 0), rng - 1) * mult
        hy = ly
        for idx in self.sort_order[1:]:
            if not flags[idx]:
                continue
            hx = self.x_list[idx]
            hy = min(max(final_y[idx], 0), rng - 1) * mult
            _render_line(lx, ly, hx, hy, out)
            lx, ly = hx, hy
        if hx < n2:
            out[min(hx, n2):] = INVERSE_DB_TABLE[min(hy, 255)]
        return out


def _render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0: int, y0: int, x1: int, y1: int,
                 v: np.ndarray) -> None:
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    base = abs(dy) // adx * (1 if dy >= 0 else -1)   # trunc toward 0
    sy = base - 1 if dy < 0 else base + 1
    ady -= abs(base) * adx
    n = len(v)
    if x0 >= n:
        return
    y = y0
    v[x0] = INVERSE_DB_TABLE[min(max(y, 0), 255)]
    err = 0
    for x in range(x0 + 1, min(x1, n)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = INVERSE_DB_TABLE[min(max(y, 0), 255)]


# ---------------------------------------------------------------- residue

class Residue:
    """Residue types 0/1/2 (spec §8)."""

    def __init__(self, rtype: int, br: BitReader):
        self.type = rtype
        self.begin = br.read(24)
        self.end = br.read(24)
        self.partition_size = br.read(24) + 1
        self.classifications = br.read(6) + 1
        self.classbook = br.read(8)
        cascades = []
        for _ in range(self.classifications):
            low = br.read(3)
            high = br.read(5) if br.read_bit() else 0
            cascades.append(high * 8 + low)
        self.cascades = cascades
        self.books = []
        for c in range(self.classifications):
            row = []
            for bit in range(8):
                row.append(br.read(8) if cascades[c] & (1 << bit)
                           else -1)
            self.books.append(row)

    def decode(self, br: BitReader, codebooks: List[Codebook],
               do_not_decode: List[bool], n2: int) -> np.ndarray:
        """-> (ch, n2) float32 residue vectors."""
        ch = len(do_not_decode)
        if self.type == 2:
            out = np.zeros(ch * n2, np.float32)
            if not all(do_not_decode):
                self._decode_vectors(br, codebooks, [out],
                                     [False], ch * n2)
            return np.ascontiguousarray(
                out.reshape(n2, ch).T)
        vecs = [np.zeros(n2, np.float32) for _ in range(ch)]
        self._decode_vectors(br, codebooks, vecs, do_not_decode, n2)
        return np.stack(vecs) if vecs else np.zeros((0, n2), np.float32)

    def _decode_vectors(self, br: BitReader, codebooks, vecs,
                        do_not_decode, vec_len: int) -> None:
        begin = min(self.begin, vec_len)
        end = min(self.end, vec_len)
        n = end - begin
        if n <= 0:
            return
        psize = self.partition_size
        parts = n // psize
        classbook = codebooks[self.classbook]
        cpc = classbook.dimensions                  # classwords/codeword
        nclass = self.classifications
        ch = len(vecs)
        classifs = [[0] * (parts + cpc) for _ in range(ch)]
        try:
            for p in range(8):
                pcount = 0
                while pcount < parts:
                    if p == 0:
                        for j in range(ch):
                            if do_not_decode[j]:
                                continue
                            temp = classbook.decode_scalar(br)
                            for i in range(cpc - 1, -1, -1):
                                classifs[j][pcount + i] = temp % nclass
                                temp //= nclass
                    for _ in range(cpc):
                        if pcount >= parts:
                            break
                        for j in range(ch):
                            if do_not_decode[j]:
                                continue
                            vq = classifs[j][pcount]
                            if not (self.cascades[vq] & (1 << p)):
                                continue
                            book = codebooks[self.books[vq][p]]
                            off = begin + pcount * psize
                            if self.type == 0:
                                self._part0(br, book, vecs[j], off,
                                            psize)
                            else:
                                self._part1(br, book, vecs[j], off,
                                            psize)
                        pcount += 1
        except EndOfPacket:
            return                                   # spec: zeros remain

    @staticmethod
    def _part0(br, book, v, off, psize):
        dim = book.dimensions
        step = psize // dim
        for k in range(step):
            vec = book.decode_vq(br)
            v[off + k:off + k + dim * step:step] += vec

    @staticmethod
    def _part1(br, book, v, off, psize):
        dim = book.dimensions
        k = 0
        while k < psize:
            vec = book.decode_vq(br)
            v[off + k:off + k + dim] += vec
            k += dim


# ----------------------------------------------------------- setup/decoder

class Mapping:
    def __init__(self, br: BitReader, channels: int,
                 floor_count: int, residue_count: int):
        if br.read(16) != 0:
            raise ValueError("vorbis: nonzero mapping type")
        self.submaps = br.read(4) + 1 if br.read_bit() else 1
        self.coupling: List[Tuple[int, int]] = []
        if br.read_bit():
            steps = br.read(8) + 1
            bits = ilog(channels - 1)
            for _ in range(steps):
                mag = br.read(bits)
                ang = br.read(bits)
                if mag == ang or mag >= channels or ang >= channels:
                    raise ValueError("vorbis: bad coupling step")
                self.coupling.append((mag, ang))
        if br.read(2) != 0:
            raise ValueError("vorbis: mapping reserved bits")
        if self.submaps > 1:
            self.mux = [br.read(4) for _ in range(channels)]
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            br.read(8)                                # unused time cfg
            f = br.read(8)
            r = br.read(8)
            if f >= floor_count or r >= residue_count:
                raise ValueError("vorbis: mapping index out of range")
            self.submap_floor.append(f)
            self.submap_residue.append(r)


class Mode:
    def __init__(self, br: BitReader, mapping_count: int):
        self.blockflag = br.read_bit()
        if br.read(16) != 0 or br.read(16) != 0:
            raise ValueError("vorbis: nonzero window/transform type")
        self.mapping = br.read(8)
        if self.mapping >= mapping_count:
            raise ValueError("vorbis: mode mapping out of range")


def imdct_matrix(n: int) -> np.ndarray:
    """(n/2, n) cosine basis: y = X @ M  (spec §1.3.2 / MDCT inverse,
    angle = pi/(2n) * (2j+1+n/2) * (2k+1)).  The whole synthesis
    filterbank as one MXU matmul."""
    j = np.arange(n)[None, :]
    k = np.arange(n // 2)[:, None]
    return np.cos(np.pi / (2 * n) * (2 * j + 1 + n // 2)
                  * (2 * k + 1)).astype(np.float32)


def vorbis_window(n: int) -> np.ndarray:
    """Full n-point slope: sin(pi/2 * sin^2((i+0.5)/n * pi)) over the
    left half; callers assemble lapped shapes from this."""
    i = np.arange(n) + 0.5
    return np.sin(0.5 * np.pi
                  * np.sin(i / n * np.pi) ** 2).astype(np.float32)


class VorbisDecoder:
    """Stateful packet decoder.  Feed the three header packets, then
    audio packets; `decode_packets` batches the IMDCT per blocksize."""

    def __init__(self, ident: bytes, setup: bytes,
                 comment: Optional[bytes] = None):
        self._parse_ident(ident)
        self._parse_setup(setup)
        self.comments: Dict[str, List[str]] = {}
        self.vendor = ""
        if comment is not None:
            try:
                self._parse_comment(comment)
            except (EndOfPacket, ValueError, UnicodeDecodeError):
                pass
        self._imdct: Dict[int, np.ndarray] = {}
        self._halfwin: Dict[int, np.ndarray] = {}
        self.reset()

    def reset(self) -> None:
        self._lap: Optional[np.ndarray] = None
        self._prev_n = 0

    # ----------------------------------------------------------- headers
    def _parse_ident(self, pkt: bytes) -> None:
        if pkt[:7] != b"\x01vorbis":
            raise ValueError("vorbis: bad identification header")
        br = BitReader(pkt[7:])
        if br.read(32) != 0:
            raise ValueError("vorbis: unsupported version")
        self.channels = br.read(8)
        self.rate = br.read(32)
        self.bitrate_maximum = br.read_signed(32)
        self.bitrate_nominal = br.read_signed(32)
        self.bitrate_minimum = br.read_signed(32)
        self.blocksize0 = 1 << br.read(4)
        self.blocksize1 = 1 << br.read(4)
        if (self.channels == 0 or self.rate == 0
                or self.blocksize0 > self.blocksize1
                or not 64 <= self.blocksize0 <= 8192
                or not 64 <= self.blocksize1 <= 8192
                or not br.read_bit()):
            raise ValueError("vorbis: bad identification header")

    def _parse_comment(self, pkt: bytes) -> None:
        if pkt[:7] != b"\x03vorbis":
            raise ValueError("vorbis: bad comment header")
        import struct
        pos = 7
        (vlen,) = struct.unpack_from("<I", pkt, pos)
        pos += 4
        self.vendor = pkt[pos:pos + vlen].decode("utf-8", "replace")
        pos += vlen
        (count,) = struct.unpack_from("<I", pkt, pos)
        pos += 4
        for _ in range(count):
            (ln,) = struct.unpack_from("<I", pkt, pos)
            pos += 4
            item = pkt[pos:pos + ln].decode("utf-8", "replace")
            pos += ln
            if "=" in item:
                k, v = item.split("=", 1)
                self.comments.setdefault(k.upper(), []).append(v)

    def _parse_setup(self, pkt: bytes) -> None:
        if pkt[:7] != b"\x05vorbis":
            raise ValueError("vorbis: bad setup header")
        br = BitReader(pkt[7:])
        self.codebooks = [Codebook(br) for _ in range(br.read(8) + 1)]
        for _ in range(br.read(6) + 1):              # time transforms
            if br.read(16) != 0:
                raise ValueError("vorbis: nonzero time transform")
        self.floors: List[object] = []
        for _ in range(br.read(6) + 1):
            ftype = br.read(16)
            if ftype == 0:
                self.floors.append(Floor0(br))
            elif ftype == 1:
                self.floors.append(Floor1(br, self.codebooks))
            else:
                raise ValueError("vorbis: unknown floor type")
        self.residues: List[Residue] = []
        for _ in range(br.read(6) + 1):
            rtype = br.read(16)
            if rtype not in (0, 1, 2):
                raise ValueError("vorbis: unknown residue type")
            self.residues.append(Residue(rtype, br))
        self.mappings = [Mapping(br, self.channels, len(self.floors),
                                 len(self.residues))
                         for _ in range(br.read(6) + 1)]
        self.modes = [Mode(br, len(self.mappings))
                      for _ in range(br.read(6) + 1)]
        if not br.read_bit():
            raise ValueError("vorbis: setup framing bit unset")

    # ------------------------------------------------------------ packets
    def _decode_spectrum(self, pkt: bytes
                         ) -> Optional[Tuple[np.ndarray, int, int, int]]:
        """-> (spectra (ch, n/2), n, prev_flag, next_flag) or None."""
        br = BitReader(pkt)
        try:
            if br.read_bit():
                return None                          # not an audio packet
            mode = self.modes[br.read(ilog(len(self.modes) - 1))]
        except EndOfPacket:
            return None
        n = self.blocksize1 if mode.blockflag else self.blocksize0
        prev_flag = next_flag = 1
        if mode.blockflag:
            try:
                prev_flag = br.read_bit()
                next_flag = br.read_bit()
            except EndOfPacket:
                return None
        n2 = n // 2
        mapping = self.mappings[mode.mapping]
        ch = self.channels

        floor_out: List[Optional[np.ndarray]] = [None] * ch
        floor1_y: List[Optional[Tuple[List[int], List[bool]]]] = \
            [None] * ch
        no_residue = [False] * ch
        for c in range(ch):
            fl = self.floors[mapping.submap_floor[mapping.mux[c]]]
            try:
                if isinstance(fl, Floor1):
                    y = fl.decode(br, self.codebooks)
                    floor1_y[c] = y
                    no_residue[c] = y is None
                else:
                    curve = fl.decode(br, self.codebooks, n2)
                    floor_out[c] = curve
                    no_residue[c] = curve is None
            except EndOfPacket:
                no_residue[c] = True
        for mag, ang in mapping.coupling:
            if not (no_residue[mag] and no_residue[ang]):
                no_residue[mag] = no_residue[ang] = False

        residue_vecs = np.zeros((ch, n2), np.float32)
        for s in range(mapping.submaps):
            idx = [c for c in range(ch) if mapping.mux[c] == s]
            if not idx:
                continue
            dnd = [no_residue[c] for c in idx]
            res = self.residues[mapping.submap_residue[s]]
            try:
                out = res.decode(br, self.codebooks, dnd, n2)
            except EndOfPacket:
                out = np.zeros((len(idx), n2), np.float32)
            for k, c in enumerate(idx):
                residue_vecs[c] = out[k]

        # inverse coupling (spec §4.3.5), reverse order
        for mag, ang in reversed(mapping.coupling):
            m = residue_vecs[mag].copy()
            a = residue_vecs[ang].copy()
            pos_m = m > 0
            pos_a = a > 0
            new_m = np.where(pos_m,
                             np.where(pos_a, m, m + a),
                             np.where(pos_a, m, m - a))
            new_a = np.where(pos_m,
                             np.where(pos_a, m - a, m),
                             np.where(pos_a, m + a, m))
            residue_vecs[mag] = new_m
            residue_vecs[ang] = new_a

        # floor curve synthesis * residue (dot product, spec §4.3.6)
        spectra = np.zeros((ch, n2), np.float32)
        for c in range(ch):
            fl = self.floors[mapping.submap_floor[mapping.mux[c]]]
            if isinstance(fl, Floor1):
                if floor1_y[c] is not None:
                    fy, fflags = floor1_y[c]
                    curve = fl.synthesize(fy, fflags, n2)
                    spectra[c] = curve * residue_vecs[c]
            else:
                if floor_out[c] is not None:
                    spectra[c] = floor_out[c] * residue_vecs[c]
        return spectra, n, prev_flag, next_flag

    def _window(self, n: int, prev_flag: int, next_flag: int
                ) -> np.ndarray:
        n0 = self.blocksize0
        w = np.ones(n, np.float32)
        half = self._halfwin
        if n not in half:
            half[n] = vorbis_window(n)               # n-point left slope
        if n0 not in half:
            half[n0] = vorbis_window(n0)
        long_left = half[n]
        short = half[n0]
        if prev_flag:
            w[:n // 2] = long_left[:n // 2]
        else:
            w[:n // 4 - n0 // 4] = 0.0
            w[n // 4 - n0 // 4:n // 4 + n0 // 4] = short[:n0 // 2]
        if next_flag:
            w[n // 2:] = long_left[n // 2:]
        else:
            w[3 * n // 4 + n0 // 4:] = 0.0
            w[3 * n // 4 - n0 // 4:3 * n // 4 + n0 // 4] = \
                short[n0 // 2:]
        return w

    def _imdct_mat(self, n: int) -> np.ndarray:
        m = self._imdct.get(n)
        if m is None:
            m = imdct_matrix(n)
            self._imdct[n] = m
        return m

    def decode_packet(self, pkt: bytes) -> np.ndarray:
        """-> (returned_samples, ch) float32 (may be empty)."""
        out = self.decode_packets([pkt])
        return out

    def decode_packets(self, packets: List[bytes]) -> np.ndarray:
        """Decode a run of audio packets.  Bitstream stages run per
        packet on host; IMDCTs are batched into one matmul per
        blocksize (the TPU-shaped formulation), then windowing and
        overlap-add run vectorized."""
        metas = []
        for pkt in packets:
            r = self._decode_spectrum(pkt)
            if r is not None:
                metas.append(r)
        if not metas:
            return np.zeros((0, self.channels), np.float32)

        # batch IMDCT per blocksize: stack (B*ch, n/2) @ (n/2, n)
        by_n: Dict[int, List[int]] = {}
        for i, (_, n, _, _) in enumerate(metas):
            by_n.setdefault(n, []).append(i)
        timedom: List[Optional[np.ndarray]] = [None] * len(metas)
        for n, idxs in by_n.items():
            stack = np.concatenate([metas[i][0] for i in idxs], axis=0)
            td = stack @ self._imdct_mat(n)          # (B*ch, n)
            ch = self.channels
            for k, i in enumerate(idxs):
                timedom[i] = td[k * ch:(k + 1) * ch]

        outs = []
        for i, (_, n, pf, nf) in enumerate(metas):
            w = self._window(n, pf, nf)
            cur = timedom[i] * w[None, :]
            outs.append(self._overlap_add(cur, n))
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, self.channels), np.float32))

    def _overlap_add(self, cur: np.ndarray, n: int) -> np.ndarray:
        """Lap the windowed block against the saved right half; emit
        samples up to the new window center (spec §1.3.2: data returned
        spans previous center .. current center)."""
        ch = self.channels
        if self._lap is None:
            self._lap = np.ascontiguousarray(cur[:, n // 2:])
            self._prev_n = n
            return np.zeros((0, ch), np.float32)
        prev_n = self._prev_n
        d = prev_n // 4 - n // 4                     # cur start vs lap
        new_center = prev_n // 4 + n // 4
        lp = self._lap.shape[1]
        width = max(lp, d + n)
        buf = np.zeros((ch, width), np.float32)
        buf[:, :lp] += self._lap
        if d >= 0:
            buf[:, d:d + n] += cur
        else:
            buf[:, :d + n] += cur[:, -d:]
        out = buf[:, :new_center]
        self._lap = np.ascontiguousarray(buf[:, new_center:d + n])
        self._prev_n = n
        return np.ascontiguousarray(out.T)


def decode_ogg(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Whole Ogg/Vorbis stream -> (float32 (n, ch), rate, channels),
    trimmed to the final granule position."""
    from ..elements.ogg import parse_ogg_pages

    pages = parse_ogg_pages(data)
    streams: Dict[int, List[bytes]] = {}
    granules: Dict[int, int] = {}
    for serial, granule, pkts in pages:
        streams.setdefault(serial, []).extend(pkts)
        if granule >= 0:
            granules[serial] = granule
    packets = None
    last_granule = -1
    for serial, pkts in streams.items():
        if pkts and pkts[0].startswith(b"\x01vorbis"):
            packets = pkts
            last_granule = granules.get(serial, -1)
            break
    if packets is None or len(packets) < 3:
        raise ValueError("vorbis: no vorbis BOS packet")
    dec = VorbisDecoder(packets[0], packets[2], packets[1])
    pcm = dec.decode_packets(packets[3:])
    if 0 <= last_granule < len(pcm):
        pcm = pcm[:last_granule]
    return pcm, dec.rate, dec.channels
