"""Clean-room range *encoder* matching the RFC 6716 §4.1 entropy coder.

The symmetric decoder already exists (``codecs/celt.py:RangeDecoder``,
built for the native Opus decode path).  This module adds the encode
side with the same conventions — arithmetic-coded symbols grow from the
front of the buffer, raw bits from the back — so any codec built on the
pair gets an exact ``tell()`` on both sides (the property LC3-style
byte-budgeted frames need for their rate loop and residual-bit fill).

Re-specified from the published RFC 6716 reference text (entenc.c
semantics); verified in tests/test_lc3.py by randomized
encode→decode parity against the existing RangeDecoder.

A copy of the JAX package's ``codecs/entenc.py`` (host Python).
"""

from __future__ import annotations

_EC_CODE_BITS = 32
_EC_SYM_BITS = 8
_EC_CODE_TOP = 1 << 31
_EC_CODE_BOT = _EC_CODE_TOP >> _EC_SYM_BITS
_EC_CODE_SHIFT = _EC_CODE_BITS - _EC_SYM_BITS - 1  # 23
_EC_SYM_MAX = (1 << _EC_SYM_BITS) - 1
_EC_UINT_BITS = 8
_EC_WINDOW_SIZE = 32
_M32 = 0xFFFFFFFF


def _ilog(v: int) -> int:
    return v.bit_length()


class RangeEncoder:
    """Byte-budgeted range encoder; ``done()`` returns exactly
    ``size`` bytes (zero-padded in the middle gap, as the decoder's
    front/back pointers never meet the pad)."""

    def __init__(self, size: int):
        self.storage = size
        self.buf = bytearray(size)
        self.offs = 0            # front bytes written (arithmetic)
        self.end_offs = 0        # back bytes written (raw bits)
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = _EC_CODE_BITS + 1
        self.val = 0
        self.rng = _EC_CODE_TOP
        self.rem = -1
        self.ext = 0
        self.error = 0

    # -- byte IO --------------------------------------------------------------
    def _write_byte(self, b: int) -> None:
        if self.offs + self.end_offs >= self.storage:
            self.error = 1
            return
        self.buf[self.offs] = b & 0xFF
        self.offs += 1

    def _write_byte_at_end(self, b: int) -> None:
        if self.offs + self.end_offs >= self.storage:
            self.error = 1
            return
        self.end_offs += 1
        self.buf[self.storage - self.end_offs] = b & 0xFF

    def _carry_out(self, c: int) -> None:
        if c != _EC_SYM_MAX:
            carry = c >> _EC_SYM_BITS
            if self.rem >= 0:
                self._write_byte(self.rem + carry)
            while self.ext > 0:
                self._write_byte((_EC_SYM_MAX + carry) & _EC_SYM_MAX)
                self.ext -= 1
            self.rem = c & _EC_SYM_MAX
        else:
            self.ext += 1

    def _normalize(self) -> None:
        while self.rng <= _EC_CODE_BOT:
            self._carry_out(self.val >> _EC_CODE_SHIFT)
            self.val = (self.val << _EC_SYM_BITS) & (_EC_CODE_TOP - 1)
            self.rng = (self.rng << _EC_SYM_BITS) & _M32
            self.nbits_total += _EC_SYM_BITS

    # -- symbol encoding ------------------------------------------------------
    def encode(self, fl: int, fh: int, ft: int) -> None:
        r = self.rng // ft
        if fl > 0:
            self.val += self.rng - r * (ft - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (ft - fh)
        self._normalize()

    def encode_bin(self, fl: int, fh: int, bits: int) -> None:
        r = self.rng >> bits
        if fl > 0:
            self.val += self.rng - r * ((1 << bits) - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * ((1 << bits) - fh)
        self._normalize()

    def enc_bit_logp(self, bit: int, logp: int) -> None:
        r = self.rng
        s = r >> logp
        r -= s
        if bit:
            # bit==1 occupies the bottom interval in the decoder's
            # inverted-val convention (dec_bit_logp: ret=1 iff val < s)
            self.val += r
        self.rng = s if bit else r
        self._normalize()

    def enc_icdf(self, s: int, icdf, ftb: int) -> None:
        r = self.rng >> ftb
        if s > 0:
            self.val += self.rng - r * icdf[s - 1]
            self.rng = r * (icdf[s - 1] - icdf[s])
        else:
            self.rng -= r * icdf[s]
        self._normalize()

    def enc_bits(self, fl: int, bits: int) -> None:
        assert bits > 0
        window = self.end_window
        used = self.nend_bits
        if used + bits > _EC_WINDOW_SIZE:
            while used >= _EC_SYM_BITS:
                self._write_byte_at_end(window & _EC_SYM_MAX)
                window >>= _EC_SYM_BITS
                used -= _EC_SYM_BITS
        window |= (fl & ((1 << bits) - 1)) << used
        used += bits
        self.end_window = window
        self.nend_bits = used
        self.nbits_total += bits

    def enc_uint(self, fl: int, ft: int) -> None:
        assert ft > 1
        ft -= 1
        ftb = _ilog(ft)
        if ftb > _EC_UINT_BITS:
            ftb -= _EC_UINT_BITS
            ft1 = (ft >> ftb) + 1
            fl1 = fl >> ftb
            self.encode(fl1, fl1 + 1, ft1)
            self.enc_bits(fl & ((1 << ftb) - 1), ftb)
        else:
            self.encode(fl, fl + 1, ft + 1)

    def tell(self) -> int:
        return self.nbits_total - _ilog(self.rng)

    # -- finalization ---------------------------------------------------------
    def done(self) -> bytes:
        l = _EC_CODE_BITS - _ilog(self.rng)
        msk = (_EC_CODE_TOP - 1) >> l
        end = (self.val + msk) & ~msk
        if (end | msk) >= self.val + self.rng:
            l += 1
            msk >>= 1
            end = (self.val + msk) & ~msk
        while l > 0:
            self._carry_out(end >> _EC_CODE_SHIFT)
            end = (end << _EC_SYM_BITS) & (_EC_CODE_TOP - 1)
            l -= _EC_SYM_BITS
        if self.rem >= 0 or self.ext > 0:
            self._carry_out(0)
        window = self.end_window
        used = self.nend_bits
        while used >= _EC_SYM_BITS:
            self._write_byte_at_end(window & _EC_SYM_MAX)
            window >>= _EC_SYM_BITS
            used -= _EC_SYM_BITS
        if not self.error and used > 0:
            if self.end_offs >= self.storage:
                self.error = 1
            else:
                l = -l
                if self.offs + self.end_offs >= self.storage and l < used:
                    window &= (1 << l) - 1 if l > 0 else 0
                    self.error = 1
                self.buf[self.storage - self.end_offs - 1] |= window & 0xFF
        return bytes(self.buf)
