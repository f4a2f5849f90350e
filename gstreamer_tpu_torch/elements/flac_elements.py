"""flacenc / flacdec — FLAC lossless audio elements.

The reference wraps libFLAC (gst-plugins-good/ext/flac/gstflacenc.c /
gstflacdec.c); here the from-scratch codec in codecs/flac.py provides
the format and native/gtpu_flac.cpp the fast path (bit-identical,
auto-fallback to Python).

Collapsed pull/sink style like wavparse/wavenc:
* flacenc = encoder + filesink: accumulates the stream's samples and
  writes one FLAC file at EOS (STREAMINFO needs the final MD5/total).
* flacdec = filesrc + decoder: decodes the file up front (native path
  ~200x realtime) and streams raw audio buffers out.

A port of the JAX package's ``elements/flac_elements.py``: flacdec gives
host arrays that the pipeline stages on its device; flacenc copies each
tick's samples to the host (``host_array``) to write them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)

_SINK_CAPS = ("audio/x-raw, format={ S8, S16LE, S24LE, S32LE }, "
              "rate=[1,655350], channels=[1,8], layout=interleaved")

_FMT_BPS = {"S8": 8, "S16LE": 16, "S24LE": 24, "S32LE": 32}
_BPS_FMT = {8: "S8", 16: "S16LE", 24: "S24LE", 32: "S32LE"}


@register_element
class FlacEnc(SinkElement):
    FACTORY = "flacenc"
    DESCRIPTION = "Encodes audio with the FLAC lossless audio encoder"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, _SINK_CAPS)]
    PROPERTIES = {
        "location": (str, "out.flac", "output path"),
        "blocksize": (int, 4096, "frame blocksize"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._chunks: List[np.ndarray] = []
        self._info: Optional[AudioInfo] = None

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def start(self):
        self._chunks = []

    def render(self, buf: Buffer) -> str:
        x = host_array(buf.data)
        if x.ndim == 1:
            x = x[:, None]
        self._chunks.append(np.asarray(x, np.int64))
        return "ok"

    def stop(self):
        if self._info is None or not self._chunks:
            return
        samples = np.concatenate(self._chunks, axis=0)
        bps = _FMT_BPS[self._info.format]
        from ..native import flac as nflac
        blob = nflac.encode(samples, self._info.rate, bps=bps,
                            blocksize=self.props["blocksize"])
        if blob is None:
            from ..codecs import flac as pyflac
            blob = pyflac.encode(samples, self._info.rate, bps=bps,
                                 blocksize=self.props["blocksize"])
        with open(self.props["location"], "wb") as f:
            f.write(blob)
        self._chunks = []


@register_element
class FlacDec(SourceElement):
    FACTORY = "flacdec"
    DESCRIPTION = "Decodes FLAC lossless audio streams"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, _SINK_CAPS)]
    PROPERTIES = {
        "location": (str, "", "flac file path"),
        "blocksize": (int, 4096, "frames per output buffer"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._samples = None
        self._pos = 0

    def _load(self):
        if self._samples is not None:
            return
        with open(self.props["location"], "rb") as f:
            data = f.read()
        from ..native import flac as nflac
        res = nflac.decode(data)
        if res is not None:
            samples, rate, ch, bps = res
        else:
            from ..codecs import flac as pyflac
            samples, si = pyflac.decode(data)
            rate, ch, bps = si.sample_rate, si.channels, si.bps
        fmt = _BPS_FMT.get(bps)
        if fmt is None:
            raise ValueError(f"flacdec: unsupported bps {bps}")
        dt = {"S8": np.int8, "S16LE": np.int16, "S24LE": np.int32,
              "S32LE": np.int32}[fmt]
        self._samples = samples.astype(dt)
        self._ainfo = AudioInfo(format=fmt, rate=rate, channels=ch)

    def get_caps(self, filter=None):
        if self.props["location"]:
            try:
                self._load()
            except (OSError, ValueError):
                return Caps.any()
        caps = (Caps([self._ainfo.to_caps_structure()])
                if self._samples is not None else Caps.any())
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def duration_ns(self):
        try:
            self._load()
            return len(self._samples) * 1_000_000_000 \
                // self._ainfo.rate
        except (OSError, ValueError):
            return None

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._pos >= len(self._samples):
            return None
        take = self.props["blocksize"]
        chunk = self._samples[self._pos:self._pos + take]
        rate = self._ainfo.rate
        pts = self._pos * 1_000_000_000 // rate
        self._pos += len(chunk)
        return Buffer(data=chunk, batch=1, pts=pts,
                      duration=len(chunk) * 1_000_000_000 // rate)
