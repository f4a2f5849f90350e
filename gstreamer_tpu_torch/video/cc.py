"""Closed-caption utilities (CEA-608/708 packetization).

Port of gst-plugins-bad/gst/closedcaption/ccutils.c:
* the CDP framerate table (:36-45) and CDP packet writer/parser
  (convert_cea708_cc_data_to_cdp :70-196 — 0x9669 magic, fps idx,
  flags, sequence counter, optional 0x71 timecode section, 0x72
  ccdata section padded with (0xfa,0,0) triplets to max_cc_count,
  0x74 footer + 2's-complement checksum);
* pair-level conversions from gstccconverter.c: raw 608 <-> s334-1a
  (field byte 0x80/0x00, :686-720) and raw 608 <-> cc_data (cc_valid
  | cc_type marker 0xfc/0xfd, :805-840).

A copy of the JAX package's ``video/cc.py`` (host code: bytes in,
bytes out; the line-21 waveform helpers take and give numpy rows).
"""

from __future__ import annotations

from typing import Optional, Tuple

# (fps_idx, fps_n, fps_d, max_cc_count, max_cea608_count)
CDP_FPS_TABLE = (
    (0x1F, 24000, 1001, 25, 22),
    (0x2F, 24, 1, 25, 22),
    (0x3F, 25, 1, 24, 22),
    (0x4F, 30000, 1001, 20, 18),
    (0x5F, 30, 1, 20, 18),
    (0x6F, 50, 1, 12, 11),
    (0x7F, 60000, 1001, 10, 9),
    (0x8F, 60, 1, 10, 9),
)


def cdp_fps_entry(fps_n: int, fps_d: int):
    for e in CDP_FPS_TABLE:
        if e[1] == fps_n and e[2] == fps_d:
            return e
    return None


def cdp_fps_entry_from_id(idx: int):
    for e in CDP_FPS_TABLE:
        if e[0] == idx:
            return e
    return None


def cea608_raw_to_s334_1a(raw: bytes, field: int = 0) -> bytes:
    """(byte pairs) -> (field, b1, b2) triplets; max 3 pairs."""
    n = min(len(raw) // 2, 3)
    out = bytearray()
    for i in range(n):
        out.append(0x80 if field == 0 else 0x00)
        out += raw[i * 2:i * 2 + 2]
    return bytes(out)


def cea608_s334_1a_to_raw(s334: bytes, field: int = 0) -> bytes:
    out = bytearray()
    for i in range(len(s334) // 3):
        f = 0 if s334[i * 3] & 0x80 else 1
        if f == field:
            out += s334[i * 3 + 1:i * 3 + 3]
    return bytes(out)


def cea608_raw_to_cc_data(raw: bytes, field: int = 0) -> bytes:
    """608 pairs -> 708 cc_data triplets (cc_valid=1, cc_type=field)."""
    n = min(len(raw) // 2, 3)
    out = bytearray()
    for i in range(n):
        out.append(0xFC if field == 0 else 0xFD)
        out += raw[i * 2:i * 2 + 2]
    return bytes(out)


def cc_data_to_cea608_raw(cc_data: bytes, field: int = 0) -> bytes:
    want = 0xFC if field == 0 else 0xFD
    out = bytearray()
    for i in range(len(cc_data) // 3):
        if cc_data[i * 3] == want:
            out += cc_data[i * 3 + 1:i * 3 + 3]
    return bytes(out)


def cc_data_to_s334_1a(cc_data: bytes) -> bytes:
    """ccconverter :982: 0xfc/0xfd -> 0x80/0x00 field bytes (608
    triplets only)."""
    out = bytearray()
    for i in range(len(cc_data) // 3):
        b = cc_data[i * 3]
        if b in (0xFC, 0xFD):
            out.append(0x80 if b == 0xFC else 0x00)
            out += cc_data[i * 3 + 1:i * 3 + 3]
    return bytes(out)


def s334_1a_to_cc_data(s334: bytes) -> bytes:
    out = bytearray()
    for i in range(len(s334) // 3):
        out.append(0xFC if s334[i * 3] & 0x80 else 0xFD)
        out += s334[i * 3 + 1:i * 3 + 3]
    return bytes(out)


def cc_data_to_cdp(cc_data: bytes, seq: int, fps_n: int, fps_d: int,
                   tc: Optional[tuple] = None) -> bytes:
    """convert_cea708_cc_data_to_cdp (ccutils.c:70)."""
    entry = cdp_fps_entry(fps_n, fps_d)
    if entry is None:
        raise ValueError(f"cdp: unsupported framerate {fps_n}/{fps_d}")
    fps_idx, _, _, max_cc, _ = entry
    if len(cc_data) // 3 > max_cc:
        cc_data = cc_data[:3 * max_cc]
    out = bytearray()
    out += (0x9669).to_bytes(2, "big")
    out.append(0)                        # length patched at the end
    out.append(fps_idx)
    flags = 0x02 | 0x01 | 0x40           # service_active|reserved|ccdata
    if tc is not None:
        flags |= 0x80
    out.append(flags)
    out += (seq & 0xFFFF).to_bytes(2, "big")
    if tc is not None:
        h, m, s, f = tc
        out.append(0x71)
        out.append(0xC0 | ((h // 10) & 0x3) << 4 | (h % 10))
        out.append(0x80 | ((m // 10) & 0x7) << 4 | (m % 10))
        out.append(((s // 10) & 0x7) << 4 | (s % 10))
        out.append(((f // 10) & 0x3) << 4 | (f % 10))
    out.append(0x72)
    out.append(0xE0 | max_cc)
    out += cc_data
    pad = max_cc - len(cc_data) // 3
    out += b"\xfa\x00\x00" * pad
    out.append(0x74)
    out += (seq & 0xFFFF).to_bytes(2, "big")
    out.append(0)                        # checksum placeholder
    out[2] = len(out)
    checksum = (256 - sum(out) % 256) & 0xFF
    out[-1] = checksum
    return bytes(out)


def cdp_to_cc_data(cdp: bytes) -> Tuple[bytes, Optional[tuple], int]:
    """-> (cc_data, timecode|None, fps_idx); checksum verified."""
    if len(cdp) < 10 or cdp[0] != 0x96 or cdp[1] != 0x69:
        raise ValueError("cdp: bad magic")
    length = cdp[2]
    if length > len(cdp):
        raise ValueError("cdp: truncated")
    if sum(cdp[:length]) % 256 != 0:
        raise ValueError("cdp: checksum mismatch")
    fps_idx = cdp[3]
    flags = cdp[4]
    pos = 7
    tc = None
    if flags & 0x80 and cdp[pos] == 0x71:
        b1, b2, b3, b4 = cdp[pos + 1:pos + 5]
        tc = (((b1 >> 4) & 3) * 10 + (b1 & 0xF),
              ((b2 >> 4) & 7) * 10 + (b2 & 0xF),
              ((b3 >> 4) & 7) * 10 + (b3 & 0xF),
              ((b4 >> 4) & 3) * 10 + (b4 & 0xF))
        pos += 5
    cc_data = b""
    if flags & 0x40 and pos < length and cdp[pos] == 0x72:
        cc_count = cdp[pos + 1] & 0x1F
        cc_data = cdp[pos + 2:pos + 2 + cc_count * 3]
        # drop padding triplets
        trip = [cc_data[i:i + 3] for i in range(0, len(cc_data), 3)]
        while trip and trip[-1][0] == 0xFA:
            trip.pop()
        cc_data = b"".join(trip)
    return cc_data, tc, fps_idx


# ---------------------------------------------------------------------------
# line 21 waveform (gstline21enc.c / gstline21dec.c via zvbi's
# io-sim/bit_slicer; reduced NRZ sampling model — see module docstring
# of elements/closedcaption.py)
# ---------------------------------------------------------------------------

_L21_CELLS = 27          # 7 run-in + 3 start (001) + 16 data + 1 pad
_L21_LOW = 16
_L21_HIGH = 126


def line21_encode_line(width: int, pair: bytes):
    """One field's byte pair -> a luma scan line (length `width`)."""
    import numpy as np
    line = np.full(width, _L21_LOW, np.uint8)
    cell = width / _L21_CELLS
    bits = []
    bits += [1, 0, 1, 0, 1, 0, 1]        # clock run-in
    bits += [0, 0, 1]                    # start bits
    for byte in pair[:2]:
        bits += [(byte >> k) & 1 for k in range(8)]   # LSB first
    for i, b in enumerate(bits):
        if b:
            a = int(i * cell)
            z = int((i + 1) * cell)
            line[a:max(z, a + 1)] = _L21_HIGH
    return line


def line21_decode_line(line) -> Optional[bytes]:
    """Sample cell centers -> byte pair (None when no run-in)."""
    import numpy as np
    line = np.asarray(line)
    width = line.shape[0]
    cell = width / _L21_CELLS
    thresh = (_L21_LOW + _L21_HIGH) // 2
    bits = [1 if line[min(int((i + 0.5) * cell), width - 1)] > thresh
            else 0 for i in range(_L21_CELLS)]
    if bits[:7] != [1, 0, 1, 0, 1, 0, 1] or bits[7:10] != [0, 0, 1]:
        return None
    b1 = sum(bits[10 + k] << k for k in range(8))
    b2 = sum(bits[18 + k] << k for k in range(8))
    return bytes([b1, b2])
