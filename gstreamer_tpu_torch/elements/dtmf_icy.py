"""dtmfsrc + icydemux + the remaining thin audioparsers
(aacparse, amrparse, dcaparse).

* dtmfsrc (gst-plugins-good/gst/dtmf/gstdtmfsrc.c): dual-sine DTMF
  tones — the 16-key 697/770/852/941 x 1209/1336/1477/1633 Hz table
  (:114-131), amplitude (sin(f1)+sin(f2))/2 * 10^(-volume/20) * 32767
  truncated to int16 (:591-602), 8 kHz mono.  The reference is driven
  by custom upstream "dtmf-event" events; the batch adaptation plays a
  `tones` property string (e.g. "123#*A"), `tone-duration` /
  `inter-tone-gap` ms apart — same synthesis math.
* icydemux (gst-plugins-good/gst/icydemux/): strips ICY metadata
  blocks every `metaint` bytes ("StreamTitle='...';" -> tag message).
* aacparse: ADTS 0xFFF sync, frame length from header bits
  (gstaacparse.c:394-397), next-header confirmation;
* amrparse: AMR-NB/WB magic + per-mode frame sizes
  (gstamrparse.c:64-67), 50 fps;
* dcaparse: DTS core 0x7FFE8001 sync with 14-bit variants rejected,
  frame size from FSIZE bits.

A copy of the JAX package's ``elements/dtmf_icy.py``. Its ``aacparse`` is
the port's ``audioparsers.AacParse``; this module defines no second class
of that name.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..core.baseparse import BaseParse
from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SourceElement,
                            register_element)
from .audioparsers import (AacParse, _ParserBase,  # noqa: F401
                           adts_frame_len)

DTMF_KEYS = {
    "0": (941, 1336), "1": (697, 1209), "2": (697, 1336),
    "3": (697, 1477), "4": (770, 1209), "5": (770, 1336),
    "6": (770, 1477), "7": (852, 1209), "8": (852, 1336),
    "9": (852, 1477), "*": (941, 1209), "#": (941, 1477),
    "A": (697, 1633), "B": (770, 1633), "C": (852, 1633),
    "D": (941, 1633),
}


def generate_dtmf(key: str, n_samples: int, sample_rate: int,
                  volume_db: int = 0, start_sample: int = 0
                  ) -> np.ndarray:
    """Exact tone math of gst_dtmf_src_generate_tone (:561-604)."""
    f1, f2 = DTMF_KEYS[key]
    i = np.arange(start_sample, start_sample + n_samples,
                  dtype=np.float64)
    t = i / sample_rate
    amp = (np.sin(2 * math.pi * f1 * t)
           + np.sin(2 * math.pi * f2 * t)) / 2.0
    amp *= 10.0 ** (-volume_db / 20.0)
    return np.trunc(amp * 32767).astype(np.int16)


@register_element
class DtmfSrc(SourceElement):
    FACTORY = "dtmfsrc"
    DESCRIPTION = "Generates DTMF tones"
    PAD_TEMPLATES = [PadTemplate(
        "src", PadDirection.SRC,
        "audio/x-raw, format=S16LE, rate=8000, channels=1, "
        "layout=interleaved")]
    PROPERTIES = {
        "tones": (str, "", "key sequence to play, e.g. '123#*A'"),
        "tone-duration": (int, 250, "per-tone ms"),
        "inter-tone-gap": (int, 100, "silence between tones (ms)"),
        "volume": (int, 0, "attenuation in dBm0 (0-36)"),
    }

    RATE = 8000

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._pos = 0

    def get_caps(self, filter=None):
        caps = self.src_pads()[0].template_caps
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        tones = [c for c in self.props["tones"].upper()
                 if c in DTMF_KEYS]
        if self._pos >= len(tones):
            return None
        key = tones[self._pos]
        n_tone = self.RATE * self.props["tone-duration"] // 1000
        n_gap = self.RATE * self.props["inter-tone-gap"] // 1000
        tone = generate_dtmf(key, n_tone, self.RATE,
                             self.props["volume"])
        chunk = np.concatenate([tone, np.zeros(n_gap, np.int16)])
        period = n_tone + n_gap
        pts = self._pos * period * 1_000_000_000 // self.RATE
        self._pos += 1
        return Buffer(data=chunk[:, None], batch=1, pts=pts,
                      duration=len(chunk) * 1_000_000_000
                      // self.RATE)


@register_element
class IcyDemux(SourceElement):
    """icydemux (pull-mode collapse): de-interleave ICY metadata from
    a captured stream; `metaint` mirrors the icy-metaint caps field."""
    FACTORY = "icydemux"
    DESCRIPTION = "Read and output ICY tags while demuxing the contents"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "captured ICY stream path"),
        "metaint": (int, 0, "bytes between metadata blocks"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._payload = None
        self._titles: List[str] = []
        self._done = False

    def _load(self):
        if self._payload is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        metaint = self.props["metaint"]
        if metaint <= 0:
            self._payload = data
            return
        out = bytearray()
        pos = 0
        while pos < len(data):
            out += data[pos:pos + metaint]
            pos += metaint
            if pos >= len(data):
                break
            mlen = data[pos] * 16
            meta = data[pos + 1:pos + 1 + mlen].rstrip(b"\0")
            pos += 1 + mlen
            text = meta.decode("utf-8", "replace")
            if "StreamTitle='" in text:
                title = text.split("StreamTitle='", 1)[1]
                title = title.split("';", 1)[0]
                if title:
                    self._titles.append(title)
        self._payload = bytes(out)

    def get_caps(self, filter=None):
        try:
            self._load()
        except OSError:
            return Caps.any()
        from ..utils.typefind import type_find_data
        try:
            res = type_find_data(self._payload[:4096])
            mime = res[0] if isinstance(res, tuple) else res
            caps = Caps.from_string(mime) if mime else Caps.any()
        except Exception:
            caps = Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._done = False
        if self._titles:
            root = self
            while getattr(root, "parent", None) is not None:
                root = root.parent
            if hasattr(root, "bus"):
                from ..core.pipeline import Message
                for t in self._titles:
                    root.bus.post(Message("tag", self.name,
                                          {"title": [t]}))

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._done:
            return None
        self._done = True
        return Buffer(data=np.frombuffer(self._payload, np.uint8),
                      batch=1)


# ---------------------------------------------------------------------------
# thin parsers
# ---------------------------------------------------------------------------

# gstamrparse.c:64-67
_AMR_NB_SIZES = [12, 13, 15, 17, 19, 20, 26, 31, 5, 0, 0, 0, 0, 0, 0, 0]
_AMR_WB_SIZES = [17, 23, 32, 36, 40, 46, 50, 58, 60, 5, -1, -1, -1, -1,
                 0, 0]


@register_element
class AmrParse(_ParserBase):
    FACTORY = "amrparse"
    DESCRIPTION = "Adaptive Multi-Rate audio parser"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "audio/AMR, rate=8000, channels=1; "
                    "audio/AMR-WB, rate=16000, channels=1"),
    ]
    _SRC_CAPS = ("audio/AMR, rate=8000, channels=1; "
                 "audio/AMR-WB, rate=16000, channels=1")

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(6)
        self._wide = None

    def start(self):
        super().start()
        self._wide = None

    def handle_frame(self, view) -> Tuple[int, int]:
        b = bytes(view[:9])
        if self._wide is None:
            if b.startswith(b"#!AMR-WB\n"):
                self._wide = True
                self.set_frame_rate(50, 1)       # 50 fps hard-coded
                return 0, 9
            if b.startswith(b"#!AMR\n"):
                self._wide = False
                self.set_frame_rate(50, 1)
                return 0, 6
            return 0, 1
        mode = (b[0] >> 3) & 0xF
        sizes = _AMR_WB_SIZES if self._wide else _AMR_NB_SIZES
        block = sizes[mode]
        if block <= 0:
            return 0, 1
        size = block + 1
        if len(view) < size:
            return 0, 0
        return size, 0


@register_element
class DcaParse(_ParserBase):
    FACTORY = "dcaparse"
    DESCRIPTION = "DTS Coherent Acoustics audio stream parser"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-dts, framed=true"),
    ]
    _SRC_CAPS = "audio/x-dts, framed=true"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(16)

    @staticmethod
    def _frame_size(b: bytes) -> Optional[int]:
        if b[:4] != b"\x7f\xfe\x80\x01":
            return None
        # FSIZE: 14 bits starting at bit 46 (byte 5 low 2 bits +
        # byte 6 + byte 7 high 4), value is size-1
        fsize = (((b[5] & 0x03) << 12) | (b[6] << 4)
                 | (b[7] >> 4)) + 1
        return fsize if fsize >= 96 else None

    def handle_frame(self, view) -> Tuple[int, int]:
        size = self._frame_size(bytes(view[:16]))
        if size is None:
            return 0, 1
        if len(view) < size + 4:
            if len(view) < size:
                return 0, 0
            return size, 0
        if self._frame_size(bytes(view[size:size + 16])) is None:
            return 0, 1
        return size, 0
