"""Bitstream helpers — GstByteReader/Writer, GstBitReader/Writer,
GstFlowCombiner equivalents.

Reference: subprojects/gstreamer/libs/gst/base/gstbytereader.c (1301),
gstbytewriter.c, gstbitreader.c, gstbitwriter.c, gstflowcombiner.c
(:355 — combine per-pad flow returns: NOT_LINKED only if all are,
OK wins over EOS, errors propagate).

A copy of the JAX package's ``core/bitstream.py`` (host only).
"""

from __future__ import annotations

import struct
from typing import List, Optional

from .buffer import FlowReturn


class ByteReader:
    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def skip(self, n: int) -> bool:
        if self.remaining() < n:
            return False
        self.pos += n
        return True

    def _get(self, fmt: str, size: int):
        if self.remaining() < size:
            return None
        v = struct.unpack_from(fmt, self.data, self.pos)[0]
        self.pos += size
        return v

    def get_uint8(self): return self._get("B", 1)
    def get_uint16_le(self): return self._get("<H", 2)
    def get_uint16_be(self): return self._get(">H", 2)
    def get_uint24_le(self):
        if self.remaining() < 3:
            return None
        b = self.data[self.pos:self.pos + 3]
        self.pos += 3
        return b[0] | (b[1] << 8) | (b[2] << 16)
    def get_uint32_le(self): return self._get("<I", 4)
    def get_uint32_be(self): return self._get(">I", 4)
    def get_uint64_le(self): return self._get("<Q", 8)
    def get_uint64_be(self): return self._get(">Q", 8)
    def get_float32_le(self): return self._get("<f", 4)
    def get_float64_le(self): return self._get("<d", 8)

    def get_data(self, n: int) -> Optional[bytes]:
        if self.remaining() < n:
            return None
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def peek_data(self, n: int) -> Optional[bytes]:
        if self.remaining() < n:
            return None
        return self.data[self.pos:self.pos + n]

    def masked_scan_uint32(self, mask: int, pattern: int,
                           offset: int = 0, size: Optional[int] = None
                           ) -> int:
        """gst_byte_reader_masked_scan_uint32: find a 32-bit BE pattern."""
        end = len(self.data) if size is None else min(
            len(self.data), self.pos + offset + size)
        i = self.pos + offset
        while i + 4 <= end:
            v = struct.unpack_from(">I", self.data, i)[0]
            if (v & mask) == pattern:
                return i - self.pos
            i += 1
        return -1


class ByteWriter:
    def __init__(self):
        self._parts: List[bytes] = []

    def put_uint8(self, v): self._parts.append(struct.pack("B", v & 0xFF))
    def put_uint16_le(self, v): self._parts.append(struct.pack("<H", v & 0xFFFF))
    def put_uint16_be(self, v): self._parts.append(struct.pack(">H", v & 0xFFFF))
    def put_uint32_le(self, v): self._parts.append(struct.pack("<I", v & 0xFFFFFFFF))
    def put_uint32_be(self, v): self._parts.append(struct.pack(">I", v & 0xFFFFFFFF))
    def put_uint64_le(self, v): self._parts.append(struct.pack("<Q", v & (2**64 - 1)))
    def put_float32_le(self, v): self._parts.append(struct.pack("<f", v))
    def put_float64_le(self, v): self._parts.append(struct.pack("<d", v))
    def put_data(self, d: bytes): self._parts.append(bytes(d))

    def reset_and_get_data(self) -> bytes:
        out = b"".join(self._parts)
        self._parts = []
        return out

    @property
    def size(self) -> int:
        return sum(len(p) for p in self._parts)


class BitReader:
    """MSB-first bit reader (gstbitreader.c)."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.bit = 0

    def remaining(self) -> int:
        return len(self.data) * 8 - self.bit

    def get_bits(self, n: int) -> Optional[int]:
        if self.remaining() < n or n > 64:
            return None
        v = 0
        for _ in range(n):
            byte = self.data[self.bit >> 3]
            v = (v << 1) | ((byte >> (7 - (self.bit & 7))) & 1)
            self.bit += 1
        return v

    def skip(self, n: int) -> bool:
        if self.remaining() < n:
            return False
        self.bit += n
        return True

    def skip_to_byte(self) -> bool:
        self.bit = (self.bit + 7) & ~7
        return self.bit <= len(self.data) * 8


class BitWriter:
    """MSB-first bit writer (gstbitwriter.c)."""

    def __init__(self):
        self._bits: List[int] = []

    def put_bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def align_bytes(self, trailing_bit: int = 0):
        while len(self._bits) % 8:
            self._bits.append(trailing_bit & 1)

    def get_data(self) -> bytes:
        bits = self._bits + [0] * ((-len(self._bits)) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)


class FlowCombiner:
    """gst_flow_combiner_update_flow (gstflowcombiner.c:355 semantics):
    - any non-success (error/flushing) return propagates immediately
    - NOT_LINKED only when every pad reports NOT_LINKED
    - EOS only when every pad reports EOS
    - otherwise OK."""

    def __init__(self):
        self._flows: dict = {}

    def update_flow(self, pad, ret: str) -> str:
        self._flows[pad] = ret
        vals = list(self._flows.values())
        for v in vals:
            if v not in (FlowReturn.OK, FlowReturn.EOS,
                         FlowReturn.NOT_LINKED):
                return v
        if all(v == FlowReturn.NOT_LINKED for v in vals):
            return FlowReturn.NOT_LINKED
        if all(v in (FlowReturn.EOS, FlowReturn.NOT_LINKED) for v in vals):
            return FlowReturn.EOS
        return FlowReturn.OK

    def remove_pad(self, pad):
        self._flows.pop(pad, None)

    def reset(self):
        self._flows.clear()
