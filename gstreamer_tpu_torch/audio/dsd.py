"""DSD (Direct Stream Digital) audio support — gstdsd.c equivalent.

Reference: gst-plugins-base/gst-libs/gst/audio/gstdsd.c — DSD formats
are grouping words (U8/U16/U32, LE word variants store the bytes
time-reversed within the word), interleaved or planar layouts, with an
optional per-byte bit reversal (gst_dsd_convert :965; index math
documented at :693-737).  DSD rates are counted in bytes/s per channel;
silence is the 0x69 alternating pattern (gstdsd.h:93).

The conversion here is the vectorized (numpy) equivalent of the
reference's per-byte loops.

A copy of the JAX package's ``audio/dsd.py``: DSD stays host bytes (a
byte gather), byte for byte the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

DSD_SILENCE_PATTERN_BYTE = 0x69

FORMATS = ("U8", "U16LE", "U16BE", "U32LE", "U32BE")
_WIDTH = {"U8": 1, "U16LE": 2, "U16BE": 2, "U32LE": 4, "U32BE": 4}
_IS_LE = {"U8": False, "U16LE": True, "U16BE": False,
          "U32LE": True, "U32BE": False}

# byte_bit_reversal_table (gstdsd.c:60)
BIT_REVERSE = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def dsd_rate_44x(multiplier: int) -> int:
    """GST_DSD_MAKE_DSD_RATE_44x: bytes per channel per second."""
    return 44100 * multiplier * 64 // 8


def dsd_rate_48x(multiplier: int) -> int:
    return 48000 * multiplier * 64 // 8


def format_width(fmt: str) -> int:
    return _WIDTH[fmt]


def format_is_le(fmt: str) -> bool:
    return _IS_LE[fmt]


@dataclass
class DsdInfo:
    """gst_dsd_info (format/rate/channels/layout/reversed-bytes)."""
    format: str = "U8"
    rate: int = dsd_rate_44x(1)
    channels: int = 2
    layout: str = "interleaved"        # interleaved | non-interleaved
    reversed_bytes: bool = False

    def to_caps_structure(self):
        from ..core.structure import Structure
        return Structure("audio/x-dsd", {
            "format": self.format, "rate": self.rate,
            "channels": self.channels, "layout": self.layout,
            "reversed-bytes": self.reversed_bytes})

    @classmethod
    def from_caps_structure(cls, s) -> "DsdInfo":
        return cls(format=s.fields.get("format", "U8"),
                   rate=s.fields.get("rate", dsd_rate_44x(1)),
                   channels=s.fields.get("channels", 2),
                   layout=s.fields.get("layout", "interleaved"),
                   reversed_bytes=s.fields.get("reversed-bytes", False))


def _positions_interleaved(n: int, fmt: str, channels: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """byte index -> (channel, time-position) for interleaved data."""
    w = _WIDTH[fmt]
    idx = np.arange(n, dtype=np.int64)
    word = idx // w
    off = idx % w
    if _IS_LE[fmt]:
        off = w - 1 - off
    ch = word % channels
    pos = (idx // (w * channels)) * w + off
    return ch, pos


def _index_interleaved(ch, pos, fmt: str, channels: int) -> np.ndarray:
    w = _WIDTH[fmt]
    wi = (pos // w) * channels + ch
    wo = pos % w
    if _IS_LE[fmt]:
        wo = w - 1 - wo
    return wi * w + wo


def dsd_convert(data: np.ndarray, in_format: str, out_format: str,
                channels: int, in_layout: str = "interleaved",
                out_layout: str = "interleaved",
                reverse_byte_bits: bool = False) -> np.ndarray:
    """gst_dsd_convert (vectorized).  `data`: flat uint8; planar layouts
    use equal contiguous planes (plane k at offset k*plane_size)."""
    data = np.asarray(data, np.uint8).reshape(-1)
    n = data.size
    plane = n // channels
    out = np.empty(n, np.uint8)

    if in_layout == "interleaved":
        def src_index(ch, pos):
            return _index_interleaved(ch, pos, in_format, channels)
    else:
        iw = _WIDTH[in_format]

        def src_index(ch, pos):
            wo = pos % iw
            if _IS_LE[in_format]:
                wo = iw - 1 - wo
            return ch * plane + (pos // iw) * iw + wo

    if out_layout == "interleaved":
        ch, pos = _positions_interleaved(n, out_format, channels)
    else:
        ow = _WIDTH[out_format]
        idx = np.arange(n, dtype=np.int64)
        ch = idx // plane
        rel = idx % plane
        off = rel % ow
        if _IS_LE[out_format]:
            off = ow - 1 - off
        pos = (rel // ow) * ow + off

    src = data[src_index(ch, pos)]
    out[:] = BIT_REVERSE[src] if reverse_byte_bits else src
    return out
