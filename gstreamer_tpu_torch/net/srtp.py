"""SRTP (RFC 3711) — AES_CM_128_HMAC_SHA1_80 protect/unprotect.

Clean-room implementation of the Secure RTP profile negotiated by
DTLS-SRTP (net/dtls.py): the AES-CM key-derivation function (§4.3),
AES counter-mode packet encryption (§4.1.1), and HMAC-SHA1-80
authentication over packet||ROC (§4.2).  The reference's srtpenc/
srtpdec (gst-plugins-bad/ext/srtp/gstsrtpenc.c:1, gstsrtpdec.c:1)
wrap libsrtp; here only the AES block primitive comes from the system
libcrypto (EVP AES-128-ECB), everything above it is implemented from
the RFC.

srtpenc / srtpdec elements operate on the framework's list-of-packets
RTP buffers.

A copy of the JAX package's ``net/srtp.py``: the same keys, keystream and
packets, byte for byte.  The keystream is XORed over the packet in numpy
(the JAX package XORs byte by byte in Python, the same bytes).  Packets
stay host bytes (``host_array``); both elements set ``HOST_INPUT``.
"""

from __future__ import annotations

import ctypes
import hmac
import struct
from hashlib import sha1
from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

_crypto = None


def _aes_ecb(key: bytes, blocks: bytes) -> bytes:
    """AES-128-ECB over a multiple of 16 bytes (EVP primitive)."""
    global _crypto
    if _crypto is None:
        _crypto = ctypes.CDLL("libcrypto.so.3")
        _crypto.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
        _crypto.EVP_aes_128_ecb.restype = ctypes.c_void_p
    c = _crypto
    ctx = ctypes.c_void_p(c.EVP_CIPHER_CTX_new())
    try:
        c.EVP_EncryptInit_ex(ctx, ctypes.c_void_p(c.EVP_aes_128_ecb()),
                             None, key, None)
        c.EVP_CIPHER_CTX_set_padding(ctx, 0)
        out = ctypes.create_string_buffer(len(blocks) + 16)
        n = ctypes.c_int()
        c.EVP_EncryptUpdate(ctx, out, ctypes.byref(n), blocks,
                            len(blocks))
        return out.raw[:n.value]
    finally:
        c.EVP_CIPHER_CTX_free(ctx)


def _aes_cm_keystream(key: bytes, iv_int: int, n_bytes: int) -> bytes:
    """AES-CM keystream: AES(key, IV+0), AES(key, IV+1), ... (§4.1.1);
    IV is the 128-bit counter start."""
    nblocks = (n_bytes + 15) // 16
    counters = b"".join(
        ((iv_int + i) & ((1 << 128) - 1)).to_bytes(16, "big")
        for i in range(nblocks))
    return _aes_ecb(key, counters)[:n_bytes]


def _xor(data: bytes, ks: bytes) -> bytes:
    """`data` XOR the keystream `ks` (as long as `data`)."""
    return np.bitwise_xor(np.frombuffer(data, np.uint8),
                          np.frombuffer(ks, np.uint8)).tobytes()


def srtp_kdf(master_key: bytes, master_salt: bytes, label: int,
             n: int) -> bytes:
    """Key derivation (§4.3.1, kdr=0): x = label<<48 XOR master_salt,
    keystream from counter x<<16."""
    salt_int = int.from_bytes(master_salt, "big")     # 112 bits
    x = salt_int ^ (label << 48)
    return _aes_cm_keystream(master_key, x << 16, n)


def _rtp_header_len(pkt: bytes) -> int:
    """Unencrypted RTP header length (§3.1): fixed 12 + CSRCs, plus
    the RFC 8285 header-extension block when the X bit is set — RFC
    3711 excludes the extension from encryption (it is authenticated
    but sent in the clear, like the reference's libsrtp)."""
    hdr = 12 + 4 * (pkt[0] & 0x0F)
    if pkt[0] & 0x10 and len(pkt) >= hdr + 4:         # X bit
        ext_words = struct.unpack(">H", pkt[hdr + 2:hdr + 4])[0]
        hdr += 4 + 4 * ext_words
    return min(hdr, len(pkt))


class SrtpSession:
    """One direction of an SRTP session (one master key/salt)."""

    AUTH_TAG_LEN = 10                                 # SHA1-80

    def __init__(self, master_key: bytes, master_salt: bytes):
        if len(master_key) != 16 or len(master_salt) != 14:
            raise ValueError("srtp: AES_CM_128 needs 16+14 byte keys")
        self.enc_key = srtp_kdf(master_key, master_salt, 0, 16)
        self.auth_key = srtp_kdf(master_key, master_salt, 1, 20)
        self.salt = srtp_kdf(master_key, master_salt, 2, 14)
        self._roc: Dict[int, int] = {}                # ssrc -> rollover
        self._last_seq: Dict[int, int] = {}

    # -- index tracking (§3.3.1) ------------------------------------------
    def _index(self, ssrc: int, seq: int, update: bool) -> int:
        roc = self._roc.get(ssrc, 0)
        last = self._last_seq.get(ssrc)
        if last is not None:
            delta = (seq - last) & 0xFFFF
            if delta < 0x8000:
                if seq < last:
                    roc += 1                          # wrapped forward
            elif seq > last:
                roc -= 1                              # reordered across wrap
        if update:
            if last is None or ((seq - last) & 0xFFFF) < 0x8000:
                self._roc[ssrc] = roc
                self._last_seq[ssrc] = seq
        return (roc << 16) | seq

    def _keystream_iv(self, ssrc: int, index: int) -> int:
        salt_int = int.from_bytes(self.salt, "big")   # 112 bits
        return ((salt_int << 16)
                ^ (ssrc << 64) ^ (index << 16))

    # -- packet transforms -------------------------------------------------
    def protect(self, pkt: bytes) -> bytes:
        """RTP packet -> SRTP packet (encrypt payload, append tag)."""
        if len(pkt) < 12:
            raise ValueError("srtp: short RTP packet")
        ssrc = struct.unpack(">I", pkt[8:12])[0]
        seq = struct.unpack(">H", pkt[2:4])[0]
        index = self._index(ssrc, seq, update=True)
        hdr_len = _rtp_header_len(pkt)
        ks = _aes_cm_keystream(self.enc_key,
                               self._keystream_iv(ssrc, index),
                               len(pkt) - hdr_len)
        out = pkt[:hdr_len] + _xor(pkt[hdr_len:], ks)
        roc = index >> 16
        tag = hmac.new(self.auth_key,
                       out + struct.pack(">I", roc), sha1).digest()
        return out + tag[:self.AUTH_TAG_LEN]

    def unprotect(self, pkt: bytes) -> Optional[bytes]:
        """SRTP packet -> RTP packet, None when auth fails."""
        if len(pkt) < 12 + self.AUTH_TAG_LEN:
            return None
        body, tag = pkt[:-self.AUTH_TAG_LEN], pkt[-self.AUTH_TAG_LEN:]
        ssrc = struct.unpack(">I", body[8:12])[0]
        seq = struct.unpack(">H", body[2:4])[0]
        index = self._index(ssrc, seq, update=False)
        roc = index >> 16
        want = hmac.new(self.auth_key,
                        body + struct.pack(">I", roc), sha1).digest()
        if not hmac.compare_digest(tag, want[:self.AUTH_TAG_LEN]):
            return None
        self._index(ssrc, seq, update=True)
        hdr_len = _rtp_header_len(body)
        ks = _aes_cm_keystream(self.enc_key,
                               self._keystream_iv(ssrc, index),
                               len(body) - hdr_len)
        return body[:hdr_len] + _xor(body[hdr_len:], ks)


def _key_of(props) -> SrtpSession:
    key = props["key"]
    if isinstance(key, str):
        key = bytes.fromhex(key)
    if len(key) != 30:
        raise ValueError("srtp: key property wants 30 bytes "
                         "(16 key + 14 salt), hex-encoded")
    return SrtpSession(key[:16], key[16:])


class _SrtpBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PROPERTIES = {"key": (str, "", "master key||salt (60 hex chars)")}

    def start(self):
        self._session = _key_of(self.props) if self.props["key"] else None

    def set_session(self, session: SrtpSession) -> None:
        """Programmatic keying (the DTLS-SRTP path)."""
        self._session = session

    def _packets(self, buf) -> List[bytes]:
        data = buf.data if isinstance(buf.data, list) else [buf.data]
        return [b if isinstance(b, (bytes, bytearray))
                else host_array(b).tobytes() for b in data]


@register_element
class SrtpEnc(_SrtpBase):
    FACTORY = "srtpenc"
    DESCRIPTION = "SRTP encoder"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-srtp"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-srtp"
                               if direction == PadDirection.SINK
                               else "application/x-rtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None or self._session is None:
            return buf
        return buf.with_(data=[self._session.protect(p)
                               for p in self._packets(buf)])


@register_element
class SrtpDec(_SrtpBase):
    FACTORY = "srtpdec"
    DESCRIPTION = "SRTP decoder"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-srtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string("application/x-rtp"
                               if direction == PadDirection.SINK
                               else "application/x-srtp")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None or self._session is None:
            return buf
        out = [self._session.unprotect(p) for p in self._packets(buf)]
        good = [p for p in out if p is not None]
        if not good:
            return None
        return buf.with_(data=good)
