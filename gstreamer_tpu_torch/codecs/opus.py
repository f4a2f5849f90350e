"""Opus codec via the system libopus, plus Ogg-Opus (RFC 7845) framing.

The reference's opusdec/opusenc
(gst-plugins-base/ext/opus/gstopusdec.c:1, gstopusenc.c:1) are thin
wrappers around libopus — the codec itself is not reimplemented there
either.  This module is the same architecture: ctypes bindings to the
system libopus for the packet codec, with the Ogg encapsulation
(OpusHead/OpusTags headers, pre-skip and output-gain handling,
granulepos trimming — RFC 7845 §5) implemented natively here.

Degrades gracefully: `available()` is False when libopus is absent and
the elements report a missing-plugin style error.

A copy of the JAX package's ``codecs/opus.py`` (host numpy; ctypes to
the system libopus).  The Ogg pages come from the port's
``elements/ogg.py``.  ``ROUTES`` counts the packets
``HybridOpusDecoder.decode`` takes by route (``celt``, ``silk``,
``hybrid``, ``libopus``), over every decoder of the process; set its
values to 0 to count one run.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import numpy as np

_lib = None
_tried = False

OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE = 4002

# packets decoded by each route of HybridOpusDecoder.decode
ROUTES = {"celt": 0, "silk": 0, "hybrid": 0, "libopus": 0}


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for name in ("libopus.so.0", "libopus.so"):
        try:
            _lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if _lib is not None:
        _lib.opus_decoder_create.restype = ctypes.c_void_p
        _lib.opus_encoder_create.restype = ctypes.c_void_p
    return _lib


def available() -> bool:
    return _get() is not None


class OpusDecoder:
    """Packet decoder at 48 kHz float output."""

    def __init__(self, channels: int):
        lib = _get()
        if lib is None:
            raise RuntimeError("opus: system libopus not available")
        err = ctypes.c_int()
        self._lib = lib
        self.channels = channels
        self._dec = ctypes.c_void_p(lib.opus_decoder_create(
            48000, channels, ctypes.byref(err)))
        if err.value != 0:
            raise RuntimeError(f"opus: decoder_create failed {err.value}")
        self._buf = np.empty((5760, channels), np.float32)

    def decode(self, packet: bytes,
               fec: bool = False) -> np.ndarray:
        got = self._lib.opus_decode_float(
            self._dec, packet, len(packet),
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            5760, 1 if fec else 0)
        if got < 0:
            raise ValueError(f"opus: decode error {got}")
        return self._buf[:got].copy()

    def __del__(self):
        try:
            self._lib.opus_decoder_destroy(self._dec)
        except Exception:
            pass


class _Redundancy(Exception):
    """Hybrid/SILK packet carries a redundant transition CELT frame."""


class HybridOpusDecoder:
    """Stream decoder preferring the clean-room CELT and SILK paths.

    CELT-only packets (TOC configs 16-31, mono or stereo) decode
    natively through codecs/celt.py — bit-parity with libopus float
    output (<1e-6, see tests/test_celt.py).  SILK-only packets
    (configs 0-11) decode through codecs/silk.py — bit-exact int16
    parity with libopus including the resampler to 48 kHz (see
    tests/test_silk.py).  Hybrid packets (configs 12-15) decode
    natively too: SILK WB plus CELT bands 17-21 sharing the packet's
    range coder (<1e-6 float parity, tests/test_silk.py).  Packets
    carrying a redundant transition CELT frame, and channel-count
    mismatches, switch the stream to libopus permanently (the switch
    behaves like a decoder reset, exactly as a real receiver joining
    mid-stream).  Disable with GTPU_NATIVE_CELT=0 /
    GTPU_NATIVE_SILK=0."""

    def __init__(self, channels: int):
        import os
        self.channels = channels
        self._native = None
        self._silk = None            # (SilkDecoder, [SilkResampler])
        self._silk_rate = 0
        self._hybrid = None          # (SilkDecoder, resamplers, Celt)
        self._libdec: Optional[OpusDecoder] = None
        self._use_native = (
            channels in (1, 2)
            and os.environ.get("GTPU_NATIVE_CELT", "1") != "0")
        self._use_native_silk = (
            channels in (1, 2)
            and os.environ.get("GTPU_NATIVE_SILK", "1") != "0")

    def _decode_silk(self, packet: bytes) -> np.ndarray:
        from .celt import RangeDecoder, parse_opus_packet
        from .silk import SILK_CONFIGS, SilkDecoder, SilkResampler
        config = packet[0] >> 3
        fs_khz, frame_ms = SILK_CONFIGS[config]
        if self._silk is None or self._silk_rate != fs_khz:
            # internal-rate switch resets the decoder, like libopus
            self._silk = (SilkDecoder(self.channels),
                          [SilkResampler(fs_khz * 1000, 48000)
                           for _ in range(self.channels)])
            self._silk_rate = fs_khz
        dec, resamplers = self._silk
        _, _, frames = parse_opus_packet(packet)
        outs = []
        for fr in frames:
            rd = RangeDecoder(fr)
            pcm = dec.decode_packet(rd, fs_khz, frame_ms)
            outs.append(np.stack(
                [resamplers[c].process(pcm[:, c])
                 for c in range(self.channels)], 1))
        out = np.concatenate(outs).astype(np.float32) / 32768.0
        return out

    def _decode_hybrid(self, packet: bytes) -> np.ndarray:
        """Hybrid packets (configs 12-15): SILK WB + CELT bands 17-21
        sharing one range coder (opus_decoder.c opus_decode_frame).
        Raises _Redundancy when the packet carries a redundant CELT
        frame (mode-transition packets) — caller falls back."""
        from .celt import CeltDecoder, RangeDecoder, parse_opus_packet
        from .silk import SilkDecoder, SilkResampler
        config = packet[0] >> 3
        frame_ms = 10 if config in (12, 14) else 20
        end_band = 19 if config in (12, 13) else 21
        if self._hybrid is None:
            self._hybrid = (
                SilkDecoder(self.channels),
                [SilkResampler(16000, 48000)
                 for _ in range(self.channels)],
                CeltDecoder(self.channels))
        dec, resamplers, celt = self._hybrid
        _, _, frames = parse_opus_packet(packet)
        outs = []
        for fr in frames:
            rd = RangeDecoder(fr)
            pcm = dec.decode_packet(rd, 16, frame_ms)
            silk48 = np.stack(
                [resamplers[c].process(pcm[:, c])
                 for c in range(self.channels)],
                1).astype(np.float32) / 32768.0
            redundancy = 0
            if rd.tell() + 37 <= len(fr) * 8:
                redundancy = rd.dec_bit_logp(12)
            if redundancy:
                raise _Redundancy()
            cf = celt.decode_frame(fr, frame_ms * 48, end_band,
                                   17, rd)
            cf = cf[:, None] if cf.ndim == 1 else cf
            outs.append(silk48 + cf.astype(np.float32))
        return np.concatenate(outs)

    def decode_fec(self, packet: bytes) -> Optional[np.ndarray]:
        """Recover the PREVIOUS (lost) packet from this packet's
        LBRR data (opus_decode(..., decode_fec=1)).  Native SILK
        paths are bit-exact vs libopus; returns None when the packet
        carries no redundancy (callers then use decode_plc)."""
        if not packet:
            return None
        config = packet[0] >> 3
        stereo = (packet[0] >> 2) & 1
        from .silk import SILK_CONFIGS
        if (self._use_native_silk and config in SILK_CONFIGS
                and stereo == (self.channels == 2)):
            from .celt import RangeDecoder, parse_opus_packet
            from .silk import SilkDecoder, SilkResampler
            fs_khz, frame_ms = SILK_CONFIGS[config]
            if self._silk is None or self._silk_rate != fs_khz:
                self._silk = (SilkDecoder(self.channels),
                              [SilkResampler(fs_khz * 1000, 48000)
                               for _ in range(self.channels)])
                self._silk_rate = fs_khz
            dec, resamplers = self._silk
            _, _, frames = parse_opus_packet(packet)
            rd = RangeDecoder(frames[0])
            pcm = dec.decode_packet_fec(rd, fs_khz, frame_ms)
            if pcm is None:
                return None
            out = np.stack(
                [resamplers[c].process(pcm[:, c])
                 for c in range(self.channels)],
                1).astype(np.float32) / 32768.0
            self._last_out = out
            return out
        if self._libdec is None:
            self._libdec = OpusDecoder(self.channels)
        return self._libdec.decode(packet, fec=True)

    def decode_plc(self, frame_size: int = 960) -> np.ndarray:
        """Conceal a lost packet with no available redundancy.
        Reduction: a decaying repeat of the last output (the
        reference opusdec gets libopus's LPC extrapolation; this
        keeps energy continuity without the codec-state model)."""
        last = getattr(self, "_last_out", None)
        if last is None or not len(last):
            return np.zeros((frame_size, self.channels), np.float32)
        reps = int(np.ceil(frame_size / len(last)))
        out = np.tile(last, (reps, 1))[:frame_size]
        env = (0.9 ** (np.arange(frame_size)
                       / max(len(last), 1))).astype(np.float32)
        out = out * env[:, None]
        self._last_out = out * 0.5
        return out

    def decode(self, packet: bytes) -> np.ndarray:
        if packet:
            config = packet[0] >> 3
            stereo = (packet[0] >> 2) & 1
            from .celt import CELT_CONFIGS
            from .silk import SILK_CONFIGS
            if (self._use_native and config in CELT_CONFIGS
                    and stereo == (self.channels == 2)):
                from .celt import OpusCeltDecoder
                if self._native is None:
                    self._native = OpusCeltDecoder(self.channels)
                out = self._native.decode(packet)
                ROUTES["celt"] += 1
                out = out.astype(np.float32)
                return out[:, None] if out.ndim == 1 else out
            if (self._use_native_silk and config in SILK_CONFIGS
                    and stereo == (self.channels == 2)):
                out = self._decode_silk(packet)
                ROUTES["silk"] += 1
                self._last_out = out
                return out
            if (self._use_native and self._use_native_silk
                    and 12 <= config <= 15
                    and stereo == (self.channels == 2)):
                try:
                    out = self._decode_hybrid(packet)
                    ROUTES["hybrid"] += 1
                    return out
                except _Redundancy:
                    pass   # transition packet: hand stream to libopus
            self._use_native = False
            self._use_native_silk = False
        if self._libdec is None:
            self._libdec = OpusDecoder(self.channels)
        out = self._libdec.decode(packet)
        ROUTES["libopus"] += 1
        return out


class OpusEncoder:
    def __init__(self, channels: int, bitrate: int = 64000,
                 frame_size: int = 960):
        lib = _get()
        if lib is None:
            raise RuntimeError("opus: system libopus not available")
        err = ctypes.c_int()
        self._lib = lib
        self.channels = channels
        self.frame_size = frame_size
        self._enc = ctypes.c_void_p(lib.opus_encoder_create(
            48000, channels, OPUS_APPLICATION_AUDIO, ctypes.byref(err)))
        if err.value != 0:
            raise RuntimeError(f"opus: encoder_create failed {err.value}")
        lib.opus_encoder_ctl(self._enc, _OPUS_SET_BITRATE,
                             ctypes.c_int(bitrate))
        self._out = ctypes.create_string_buffer(4000)

    def encode(self, frame16: np.ndarray) -> bytes:
        frame16 = np.ascontiguousarray(frame16, np.int16)
        got = self._lib.opus_encode(
            self._enc,
            frame16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            self.frame_size, self._out, 4000)
        if got < 0:
            raise ValueError(f"opus: encode error {got}")
        return self._out.raw[:got]

    def __del__(self):
        try:
            self._lib.opus_encoder_destroy(self._enc)
        except Exception:
            pass


# ------------------------------------------------------- Ogg-Opus framing

def opus_head(channels: int, pre_skip: int, input_rate: int,
              gain_q8: int = 0) -> bytes:
    """RFC 7845 §5.1 identification header (mapping family 0)."""
    return (b"OpusHead" + struct.pack("<BBHIhB", 1, channels,
                                      pre_skip, input_rate,
                                      gain_q8, 0))


def parse_opus_head(pkt: bytes) -> Tuple[int, int, int, float]:
    """-> (channels, pre_skip, input_rate, gain_linear)."""
    if not pkt.startswith(b"OpusHead") or len(pkt) < 19:
        raise ValueError("opus: bad OpusHead")
    ver, ch, pre_skip, rate, gain_q8, family = struct.unpack_from(
        "<BBHIhB", pkt, 8)
    if ver >> 4 != 0:
        raise ValueError("opus: unsupported OpusHead version")
    if family != 0:
        raise ValueError("opus: only mapping family 0 supported")
    return ch, pre_skip, rate, 10.0 ** (gain_q8 / (20.0 * 256.0))


def encode_ogg(samples: np.ndarray, rate: int = 48000,
               bitrate: int = 64000, serial: int = 0x6F707573) -> bytes:
    """int16/float (n, ch) 48 kHz -> Ogg-Opus bytes (RFC 7845 layout)."""
    from ..elements.ogg import ogg_page

    samples = np.atleast_2d(np.asarray(samples))
    if samples.shape[0] < samples.shape[1]:
        samples = samples.T
    if samples.dtype != np.int16:
        samples = np.clip(np.round(np.asarray(samples, np.float64)
                                   * 32767.0), -32768, 32767
                          ).astype(np.int16)
    if rate != 48000:
        raise ValueError("opus: encoder input must be 48 kHz")
    n, ch = samples.shape
    enc = OpusEncoder(ch, bitrate)
    fs = enc.frame_size
    # pre-skip = encoder lookahead (OPUS_GET_LOOKAHEAD = 4027)
    look = ctypes.c_int(312)
    enc._lib.opus_encoder_ctl(enc._enc, 4027, ctypes.byref(look))
    pre_skip = int(look.value)
    # the encoder itself delays output by pre_skip samples; append
    # zeros to flush the tail and round up to whole frames
    pad = (-(n + pre_skip)) % fs
    padded = np.concatenate(
        [samples, np.zeros((pre_skip + pad, ch), np.int16)], axis=0)
    vendor = b"gstreamer_tpu"
    pages = [ogg_page([opus_head(ch, pre_skip, rate)], serial, 0, 0,
                      bos=True),
             ogg_page([b"OpusTags"
                       + struct.pack("<I", len(vendor)) + vendor
                       + struct.pack("<I", 0)], serial, 1, 0)]
    seq = 2
    total = 0
    nframes = len(padded) // fs
    end_granule = pre_skip + n
    for i in range(nframes):
        pkt = enc.encode(padded[i * fs:(i + 1) * fs])
        total += fs
        last = i == nframes - 1
        pages.append(ogg_page([pkt], serial, seq,
                              min(total, end_granule) if last
                              else total, eos=last))
        seq += 1
    return b"".join(pages)


def decode_ogg(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Ogg-Opus bytes -> (float32 (n, ch) @48 kHz, rate=48000, ch);
    honors pre-skip, output gain, and end trimming (RFC 7845 §4.4)."""
    from ..elements.ogg import parse_ogg_pages

    pages = parse_ogg_pages(data)
    streams = {}
    granules = {}
    for serial, granule, pkts in pages:
        streams.setdefault(serial, []).extend(pkts)
        if granule >= 0:
            granules[serial] = granule
    packets = None
    last_granule = -1
    for serial, pkts in streams.items():
        if pkts and pkts[0].startswith(b"OpusHead"):
            packets = pkts
            last_granule = granules.get(serial, -1)
            break
    if packets is None:
        raise ValueError("opus: no OpusHead BOS packet")
    ch, pre_skip, in_rate, gain = parse_opus_head(packets[0])
    audio = packets[1:]
    if audio and audio[0].startswith(b"OpusTags"):
        audio = audio[1:]
    dec = HybridOpusDecoder(ch)
    chunks = [dec.decode(p) for p in audio]
    pcm = (np.concatenate(chunks, axis=0) if chunks
           else np.zeros((0, ch), np.float32))
    if gain != 1.0:
        pcm = pcm * np.float32(gain)
    end = last_granule if last_granule >= 0 else len(pcm)
    pcm = pcm[pre_skip:end]
    return pcm, 48000, ch
