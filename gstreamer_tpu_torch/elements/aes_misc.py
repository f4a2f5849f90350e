"""aesenc / aesdec (gst-plugins-bad/ext/aes/gstaesenc.c,
gstaesdec.c — OpenSSL EVP wrappers, same architecture here via
ctypes libcrypto) and tonegeneratesrc (ext/spandsp reduced: dual-tone
telephony generator).

AES buffers: with serialize-iv (the reference default) each output
buffer is `IV || ciphertext` (PKCS#7 padded); aesdec strips and
unpads.  Supported ciphers: aes-128-cbc and aes-256-cbc.

A port of the JAX package's ``elements/aes_misc.py``: aesenc and aesdec
take their source's host bytes (``HOST_INPUT``) and give host bytes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SourceElement,
                            TransformElement, register_element)

_crypto = None
_tried = False


def _get_crypto():
    global _crypto, _tried
    if _tried:
        return _crypto
    _tried = True
    for name in ("libcrypto.so.3", "libcrypto.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        for f in ("EVP_CIPHER_CTX_new", "EVP_aes_128_cbc",
                  "EVP_aes_256_cbc"):
            getattr(lib, f).restype = ctypes.c_void_p
        _crypto = lib
        return _crypto
    return None


def aes_available() -> bool:
    return _get_crypto() is not None


def _evp(data: bytes, key: bytes, iv: bytes, encrypt: bool) -> bytes:
    lib = _get_crypto()
    if lib is None:
        raise RuntimeError("aes: libcrypto not available")
    cipher = ctypes.c_void_p(
        lib.EVP_aes_128_cbc() if len(key) == 16
        else lib.EVP_aes_256_cbc())
    ctx = ctypes.c_void_p(lib.EVP_CIPHER_CTX_new())
    try:
        init = (lib.EVP_EncryptInit_ex if encrypt
                else lib.EVP_DecryptInit_ex)
        if init(ctx, cipher, None, key, iv) != 1:
            raise ValueError("aes: init failed")
        out = ctypes.create_string_buffer(len(data) + 32)
        outl = ctypes.c_int()
        upd = (lib.EVP_EncryptUpdate if encrypt
               else lib.EVP_DecryptUpdate)
        if upd(ctx, out, ctypes.byref(outl), data, len(data)) != 1:
            raise ValueError("aes: update failed")
        n = outl.value
        fin = (lib.EVP_EncryptFinal_ex if encrypt
               else lib.EVP_DecryptFinal_ex)
        tail = ctypes.c_int()
        if fin(ctx, ctypes.byref(out, n), ctypes.byref(tail)) != 1:
            raise ValueError("aes: final failed (bad key/padding?)")
        return out.raw[:n + tail.value]
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


class _AesBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC,
                    "application/octet-stream"),
    ]
    PROPERTIES = {
        "key": (str, "", "hex key (16 or 32 bytes)"),
        "iv": (str, "", "hex IV (16 bytes)"),
        "serialize-iv": (bool, True, "prefix each buffer with the IV"),
    }

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/octet-stream")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass

    def _key(self) -> bytes:
        k = bytes.fromhex(self.props["key"])
        if len(k) not in (16, 32):
            raise ValueError("aes: key must be 16 or 32 bytes hex")
        return k

    def _iv(self) -> bytes:
        v = bytes.fromhex(self.props["iv"]) if self.props["iv"] \
            else b"\x00" * 16
        if len(v) != 16:
            raise ValueError("aes: IV must be 16 bytes hex")
        return v


@register_element
class AesEnc(_AesBase):
    FACTORY = "aesenc"
    DESCRIPTION = "AES buffer encryption (aes-128/256-cbc)"

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        data = buf.data
        leaves = data if isinstance(data, (list, tuple)) else [data]
        raw = b"".join(host_array(x).tobytes() for x in leaves)
        iv = self._iv()
        ct = _evp(raw, self._key(), iv, encrypt=True)
        if self.props["serialize-iv"]:
            ct = iv + ct
        return buf.with_(data=np.frombuffer(ct, np.uint8), batch=1)


@register_element
class AesDec(_AesBase):
    FACTORY = "aesdec"
    DESCRIPTION = "AES buffer decryption (aes-128/256-cbc)"

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        data = buf.data
        leaves = data if isinstance(data, (list, tuple)) else [data]
        raw = b"".join(host_array(x).tobytes() for x in leaves)
        if self.props["serialize-iv"]:
            iv, raw = raw[:16], raw[16:]
        else:
            iv = self._iv()
        pt = _evp(raw, self._key(), iv, encrypt=False)
        return buf.with_(data=np.frombuffer(pt, np.uint8), batch=1)


@register_element
class ToneGenerateSrc(SourceElement):
    """tonegeneratesrc (ext/spandsp/gsttonegeneratesrc.c reduced):
    dual-frequency telephony tones with on/off cadence."""
    FACTORY = "tonegeneratesrc"
    DESCRIPTION = "Telephony tone generator"
    PAD_TEMPLATES = [PadTemplate(
        "src", PadDirection.SRC,
        "audio/x-raw, format=S16LE, rate=8000, channels=1, "
        "layout=interleaved")]
    PROPERTIES = {
        "freq": (int, 425, "first tone frequency (Hz)"),
        "freq2": (int, 0, "second tone frequency (Hz, 0=off)"),
        "volume": (int, -6, "level in dBm0"),
        "on-time": (int, 1000, "tone on duration (ms)"),
        "off-time": (int, 1000, "silence duration (ms)"),
        "samplesperbuffer": (int, 1024, ""),
        "num-buffers": (int, 10, ""),
    }
    RATE = 8000

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._pos = 0
        self._emitted = 0

    def start(self):
        self._pos = 0
        self._emitted = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._emitted >= self.props["num-buffers"]:
            return None
        n = self.props["samplesperbuffer"]
        t = (np.arange(n) + self._pos) / self.RATE
        amp = 32767.0 * (10.0 ** (self.props["volume"] / 20.0))
        sig = np.sin(2 * np.pi * self.props["freq"] * t)
        if self.props["freq2"]:
            sig = 0.5 * (sig + np.sin(
                2 * np.pi * self.props["freq2"] * t))
        period_ms = self.props["on-time"] + self.props["off-time"]
        if self.props["off-time"] > 0:
            ms = (t * 1000.0) % period_ms
            sig = np.where(ms < self.props["on-time"], sig, 0.0)
        pcm = np.clip(np.round(sig * amp), -32768,
                      32767).astype(np.int16)[:, None]
        pts = self._pos * 1_000_000_000 // self.RATE
        self._pos += n
        self._emitted += 1
        return Buffer(data=pcm, batch=1, pts=pts,
                      duration=n * 1_000_000_000 // self.RATE)
