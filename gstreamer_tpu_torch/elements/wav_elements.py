"""WAV file elements: wavparse-style reading and wavenc-style writing.

References: gst-plugins-good/gst/wavparse/gstwavparse.c,
gst-plugins-good/gst/wavenc/gstwavenc.c.  RIFF parsing is host-side;
sample payloads go straight to device arrays.

Format tags (gst_riff_create_audio_caps, gst-libs/gst/riff/
riff-media.c): 0x0001 PCM, 0x0003 IEEE float, 0x0006 A-law ->
audio/x-alaw, 0x0007 mu-law -> audio/x-mulaw, 0x0002 MS ADPCM ->
audio/x-adpcm layout=microsoft, 0x0011 DVI/IMA ADPCM ->
audio/x-adpcm layout=dvi (block_align from the fmt chunk).  wavenc
writes the matching tag plus a `fact` chunk with the sample count for
the compressed formats (gstwavenc.c write_fact_chunk).

A port of the JAX package's ``elements/wav_elements.py``.  wavparse reads
host arrays that the pipeline stages to its device as any source's (the
ADPCM blocks stay host bytes for adpcmdec); wavenc copies each tick's
samples to the host to write them.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..audio import format as afmt
from ..audio.info import AudioInfo
from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)
from ..core.structure import Structure
from .audio_elements import AUDIO_CAPS

_WAV_SRC_CAPS = (AUDIO_CAPS
                 + "; audio/x-mulaw; audio/x-alaw; audio/x-adpcm")


def parse_wav_header(path: str) -> dict:
    """Returns {kind, info|None, rate, channels, block_align,
    avg_bps, offset, size}."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path!r} is not a WAV file")
        rate = channels = bits = 0
        audio_fmt = 1
        block_align = avg_bps = 0
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                raise ValueError("no data chunk")
            cid, csz = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            if cid == b"fmt ":
                fmt_data = f.read(csz + (csz & 1))
                (audio_fmt, channels, rate, avg_bps,
                 block_align) = struct.unpack("<HHIIH", fmt_data[:14])
                bits = struct.unpack("<H", fmt_data[14:16])[0]
            elif cid == b"data":
                offset = f.tell()
                hdr = {"rate": rate, "channels": channels,
                       "block_align": block_align,
                       "avg_bps": avg_bps, "offset": offset,
                       "size": csz, "info": None}
                if audio_fmt in (1, 3):
                    hdr["kind"] = "pcm"
                    hdr["info"] = _wav_info(audio_fmt, bits, rate,
                                            channels)
                elif audio_fmt == 6:
                    hdr["kind"] = "alaw"
                elif audio_fmt == 7:
                    hdr["kind"] = "mulaw"
                elif audio_fmt == 0x11:
                    hdr["kind"] = "adpcm-dvi"
                elif audio_fmt == 0x02:
                    hdr["kind"] = "adpcm-ms"
                else:
                    raise ValueError(
                        "wavparse: unsupported format tag 0x%04x"
                        % audio_fmt)
                return hdr
            else:
                f.seek(csz + (csz & 1), 1)


def _wav_info(audio_fmt, bits, rate, channels) -> AudioInfo:
    if audio_fmt == 3:
        fmt = "F32LE" if bits == 32 else "F64LE"
    else:
        fmt = {8: "U8", 16: "S16LE", 24: "S24LE", 32: "S32LE"}[bits]
    return AudioInfo(format=fmt, rate=rate, channels=channels)


@register_element
class WavParse(SourceElement):
    """wavparse (source-style: location property, like filesrc !
    wavparse collapsed — the pull-mode reference behavior)."""
    FACTORY = "wavparse"
    DESCRIPTION = "Parse a .wav file into raw audio"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 _WAV_SRC_CAPS)]
    PROPERTIES = {
        "location": (str, "", "wav file path"),
        "blocksize": (int, 4096, "frames per buffer"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._hdr: Optional[dict] = None
        self._pos = 0

    def _caps_for_header(self) -> Caps:
        h = self._hdr
        if h["kind"] == "pcm":
            return Caps([h["info"].to_caps_structure()])
        if h["kind"] in ("mulaw", "alaw"):
            return Caps([Structure("audio/x-" + h["kind"],
                                   {"rate": h["rate"],
                                    "channels": h["channels"]})])
        layout = "dvi" if h["kind"] == "adpcm-dvi" else "microsoft"
        return Caps([Structure("audio/x-adpcm", {
            "layout": layout, "rate": h["rate"],
            "channels": h["channels"],
            "block_align": h["block_align"]})])

    def get_caps(self, filter=None):
        if self._hdr is None and self.props["location"]:
            try:
                self._hdr = parse_wav_header(self.props["location"])
            except (OSError, ValueError):
                return Caps.any()
        caps = self._caps_for_header() if self._hdr else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._hdr = parse_wav_header(self.props["location"])
        self._file = open(self.props["location"], "rb")
        self._file.seek(self._hdr["offset"])
        self._pos = 0

    def stop(self):
        if getattr(self, "_file", None):
            self._file.close()
            self._file = None

    def do_seek(self, segment) -> bool:
        h = self._hdr
        if h["kind"] != "pcm":
            # byte position from avg_bps (gstwavparse.c bps seeking)
            bps = h["avg_bps"] or (h["rate"] * h["channels"])
            byte = segment.start * bps // 1_000_000_000
            if h["block_align"]:
                byte -= byte % h["block_align"]
            self._pos = byte
            self._file.seek(h["offset"] + byte)
            return True
        info = h["info"]
        pos = segment.start * info.rate // 1_000_000_000
        self._pos = pos
        self._file.seek(h["offset"] + pos * info.bpf)
        return True

    def create(self, n_frames: int) -> Optional[Buffer]:
        h = self._hdr
        if h["kind"] == "pcm":
            return self._create_pcm(n_frames)
        if h["kind"] in ("mulaw", "alaw"):
            return self._create_law(n_frames)
        return self._create_adpcm(n_frames)

    def _remaining(self) -> int:
        return (h := self._hdr)["offset"] + h["size"] \
            - self._file.tell()

    def _create_pcm(self, n_frames: int) -> Optional[Buffer]:
        info = self._hdr["info"]
        want = self.props["blocksize"] * max(1, n_frames)
        raw = self._file.read(
            min(want * info.bpf, max(0, self._remaining())))
        if not raw:
            return None
        n = len(raw) // info.bpf
        samples = afmt.from_bytes(
            info.finfo, np.frombuffer(raw[:n * info.bpf], np.uint8),
            info.channels)
        pts = self._pos * 1_000_000_000 // info.rate
        self._pos += n
        return Buffer(data=samples, pts=pts,
                      duration=n * 1_000_000_000 // info.rate)

    def _create_law(self, n_frames: int) -> Optional[Buffer]:
        h = self._hdr
        ch = h["channels"]
        want = self.props["blocksize"] * max(1, n_frames) * ch
        raw = self._file.read(min(want, max(0, self._remaining())))
        if not raw:
            return None
        n = len(raw) // ch
        samples = np.frombuffer(raw[:n * ch],
                                np.uint8).reshape(n, ch)
        pts = self._pos * 1_000_000_000 // h["rate"]
        self._pos += n
        return Buffer(data=samples, pts=pts,
                      duration=n * 1_000_000_000 // h["rate"])

    def _create_adpcm(self, n_frames: int) -> Optional[Buffer]:
        h = self._hdr
        ba = h["block_align"] or 1024
        nblocks = max(1, (self.props["blocksize"] * max(1, n_frames))
                      // ba)
        raw = self._file.read(
            min(nblocks * ba, max(0, self._remaining())))
        if not raw:
            return None
        bps = h["avg_bps"] or (h["rate"] * h["channels"] // 2)
        pts = self._pos * 1_000_000_000 // bps
        self._pos += len(raw)
        blocks = [np.frombuffer(raw[i:i + ba], np.uint8)
                  for i in range(0, len(raw), ba)]
        return Buffer(data=blocks if len(blocks) > 1 else blocks[0],
                      pts=pts, batch=len(blocks),
                      duration=len(raw) * 1_000_000_000 // bps)


@register_element
class WavEnc(SinkElement):
    """wavenc + filesink collapsed: write incoming audio as .wav."""
    FACTORY = "wavenc"
    DESCRIPTION = "Encode raw audio into WAV"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 _WAV_SRC_CAPS)]
    PROPERTIES = {"location": (str, "out.wav", "output path")}

    _HEADER_SPACE = 64          # room for fmt (+fact) before data

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._file = None
        self._bytes = 0
        self._samples = 0

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        self._kind = {"audio/x-mulaw": "mulaw",
                      "audio/x-alaw": "alaw",
                      "audio/x-adpcm": "adpcm"}.get(s.name, "pcm")
        if self._kind == "pcm":
            self._info = AudioInfo.from_caps_structure(s)
        else:
            self._rate = s["rate"]
            self._channels = s["channels"]
            self._block_align = s.get("block_align") or 0
            self._layout = s.get("layout") or "dvi"

    def start(self):
        self._file = open(self.props["location"], "wb")
        self._bytes = 0
        self._samples = 0
        self._data_at = None

    def render(self, buf: Buffer) -> str:
        if self._file.tell() == 0:
            # reserve header space now that caps are known
            self._file.write(b"\x00" * self._header_size())
        if self._kind == "pcm":
            raw = afmt.to_bytes(self._info.finfo, buf.data)
            self._file.write(raw.tobytes())
            self._bytes += raw.size
            return FlowReturn.OK
        blobs = buf.data if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            self._file.write(raw)
            self._bytes += len(raw)
            if self._kind == "adpcm":
                ba = self._block_align or len(raw)
                spb = (len(raw) - 4 * self._channels) * 2 \
                    // self._channels + 1
                self._samples += spb
            else:
                self._samples += len(raw) // self._channels
        return FlowReturn.OK

    def _header_size(self) -> int:
        # PCM: classic 44-byte header (fmt 16); compressed: fmt 18
        # (cbSize=0) + fact chunk (gstwavenc.c write_fact_chunk)
        if self._kind == "pcm":
            return 12 + 24 + 8
        return 12 + 26 + 12 + 8

    def stop(self):
        if self._file is None:
            return
        if self._kind == "pcm":
            info = self._info
            f = info.finfo
            tag = 3 if f.is_float else 1
            rate, ch = info.rate, info.channels
            ba, bits = info.bpf, f.width
            avg = rate * info.bpf
            hdr = b"fmt " + struct.pack("<IHHIIHH", 16, tag, ch, rate,
                                        avg, ba, bits)
            hdr += b"data" + struct.pack("<I", self._bytes)
            self._file.seek(0)
            self._file.write(
                b"RIFF" + struct.pack("<I", 4 + len(hdr) + self._bytes)
                + b"WAVE" + hdr)
            self._file.close()
            self._file = None
            return
        else:
            rate, ch = self._rate, self._channels
            if self._kind == "adpcm":
                tag = 0x11 if self._layout == "dvi" else 0x02
                ba = self._block_align or 1024
                spb = (ba - 4 * ch) * 2 // ch + 1
                avg = rate * ba // max(1, spb)
                bits = 4
            else:
                tag = 7 if self._kind == "mulaw" else 6
                ba, bits = ch, 8
                avg = rate * ch
        hdr = b"fmt " + struct.pack("<IHHIIHHH", 18, tag, ch, rate,
                                    avg, ba, bits, 0)
        if self._kind != "pcm":
            hdr += b"fact" + struct.pack("<II", 4, self._samples)
        hdr += b"data" + struct.pack("<I", self._bytes)
        self._file.seek(0)
        self._file.write(b"RIFF"
                         + struct.pack("<I", 4 + len(hdr) + self._bytes)
                         + b"WAVE" + hdr)
        self._file.close()
        self._file = None
