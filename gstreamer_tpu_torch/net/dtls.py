"""DTLS agent for DTLS-SRTP keying (RFC 5764).

The reference's dtls plugin (gst-plugins-bad/ext/dtls/gstdtlsagent.c,
gstdtlsconnection.c) wraps OpenSSL; this module is the same
architecture via ctypes: a self-signed certificate per agent, DTLS
handshake over memory BIOs (the transport pumps packets), the
use_srtp extension negotiating SRTP_AES128_CM_SHA1_80, and
SSL_export_keying_material("EXTRACTOR-dtls_srtp") producing the SRTP
master keys/salts.  The SRTP cipher itself is the clean-room
implementation in net/srtp.py.

Degrades gracefully when libssl is absent (`available()`).

A copy of the JAX package's ``net/dtls.py``. Host code only: each agent
makes a fresh key and certificate, so two runs (and the two packages)
agree on the wire, not in bytes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

_libs = None
_tried = False

SSL_ERROR_WANT_READ = 2
SSL_VERIFY_PEER = 1
SSL_CTRL_SET_MTU = 17
SSL_OP_NO_QUERY_MTU = 0x1000
MBSTRING_ASC = 0x1001
SRTP_PROFILE = b"SRTP_AES128_CM_SHA1_80"
EXPORTER_LABEL = b"EXTRACTOR-dtls_srtp"
# RFC 5764 §4.2: 2 x (128-bit key + 112-bit salt)
KEY_LEN, SALT_LEN = 16, 14


def _get():
    global _libs, _tried
    if _tried:
        return _libs
    _tried = True
    try:
        ssl = ctypes.CDLL("libssl.so.3")
        crypto = ctypes.CDLL("libcrypto.so.3")
    except OSError:
        try:
            ssl = ctypes.CDLL("libssl.so")
            crypto = ctypes.CDLL("libcrypto.so")
        except OSError:
            _libs = None
            return None
    for name in ("DTLS_method", "SSL_CTX_new", "SSL_new", "BIO_new",
                 "BIO_s_mem", "EVP_sha256"):
        getattr(ssl if name.startswith(("SSL", "DTLS")) else crypto,
                name).restype = ctypes.c_void_p
    for name in ("EVP_PKEY_Q_keygen", "X509_new",
                 "X509_get_serialNumber", "X509_getm_notBefore",
                 "X509_getm_notAfter", "X509_get_subject_name",
                 "X509_gmtime_adj", "EVP_CIPHER_CTX_new",
                 "EVP_aes_128_ecb"):
        getattr(crypto, name).restype = ctypes.c_void_p
    ssl.SSL_CTX_new.argtypes = [ctypes.c_void_p]
    ssl.SSL_new.argtypes = [ctypes.c_void_p]
    crypto.BIO_new.argtypes = [ctypes.c_void_p]
    _libs = (ssl, crypto)
    return _libs


def available() -> bool:
    return _get() is not None


class DtlsAgent:
    """Per-endpoint certificate + key (gstdtlsagent.c)."""

    def __init__(self):
        libs = _get()
        if libs is None:
            raise RuntimeError("dtls: libssl not available")
        self._ssl, self._crypto = libs
        c = self._crypto
        self.pkey = ctypes.c_void_p(c.EVP_PKEY_Q_keygen(
            None, None, b"EC", b"P-256"))
        if not self.pkey:
            raise RuntimeError("dtls: keygen failed")
        x = ctypes.c_void_p(c.X509_new())
        c.X509_set_version(x, 2)
        c.ASN1_INTEGER_set(
            ctypes.c_void_p(c.X509_get_serialNumber(x)), 1)
        c.X509_gmtime_adj(ctypes.c_void_p(c.X509_getm_notBefore(x)), 0)
        c.X509_gmtime_adj(ctypes.c_void_p(c.X509_getm_notAfter(x)),
                          86400 * 365)
        c.X509_set_pubkey(x, self.pkey)
        name = ctypes.c_void_p(c.X509_get_subject_name(x))
        c.X509_NAME_add_entry_by_txt(name, b"CN", MBSTRING_ASC,
                                     b"gstreamer-tpu", -1, -1, 0)
        c.X509_set_issuer_name(x, name)
        if not c.X509_sign(x, self.pkey,
                           ctypes.c_void_p(c.EVP_sha256())):
            raise RuntimeError("dtls: cert sign failed")
        self.cert = x

    def fingerprint(self) -> str:
        """SDP a=fingerprint value: sha-256 colon-hex digest."""
        c = self._crypto
        buf = ctypes.create_string_buffer(64)
        ln = ctypes.c_uint()
        c.X509_digest(self.cert, ctypes.c_void_p(c.EVP_sha256()),
                      buf, ctypes.byref(ln))
        raw = buf.raw[:ln.value]
        return "sha-256 " + ":".join(f"{b:02X}" for b in raw)

    def connection(self, is_client: bool) -> "DtlsConnection":
        return DtlsConnection(self, is_client)


# retain verify callbacks (ctypes lifetime)
_VERIFY_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p)
_always_ok = _VERIFY_CB(lambda ok, store: 1)


class DtlsConnection:
    """One DTLS association over memory BIOs (gstdtlsconnection.c):
    the owner shuttles datagrams between `take_outgoing()` /
    `feed_incoming()` and the wire."""

    def __init__(self, agent: DtlsAgent, is_client: bool):
        s, c = agent._ssl, agent._crypto
        self._sslmod, self._crypto = s, c
        self.is_client = is_client
        self.agent = agent
        ctx = ctypes.c_void_p(s.SSL_CTX_new(
            ctypes.c_void_p(s.DTLS_method())))
        if not ctx:
            raise RuntimeError("dtls: SSL_CTX_new failed")
        self._ctx = ctx
        s.SSL_CTX_use_certificate(ctx, agent.cert)
        s.SSL_CTX_use_PrivateKey(ctx, agent.pkey)
        if s.SSL_CTX_set_tlsext_use_srtp(ctx, SRTP_PROFILE):
            raise RuntimeError("dtls: use_srtp rejected")
        s.SSL_CTX_set_verify(ctx, SSL_VERIFY_PEER, _always_ok)
        self._conn = ctypes.c_void_p(s.SSL_new(ctx))
        self._rbio = ctypes.c_void_p(c.BIO_new(
            ctypes.c_void_p(c.BIO_s_mem())))
        self._wbio = ctypes.c_void_p(c.BIO_new(
            ctypes.c_void_p(c.BIO_s_mem())))
        s.SSL_set_bio(self._conn, self._rbio, self._wbio)
        s.SSL_set_options(self._conn, SSL_OP_NO_QUERY_MTU)
        s.SSL_ctrl(self._conn, SSL_CTRL_SET_MTU, 1200, None)
        if is_client:
            s.SSL_set_connect_state(self._conn)
        else:
            s.SSL_set_accept_state(self._conn)
        self.complete = False

    # -- packet pump -------------------------------------------------------
    def pump(self) -> None:
        s = self._sslmod
        if self.complete:
            return
        ret = s.SSL_do_handshake(self._conn)
        if ret == 1:
            self.complete = True
        else:
            err = s.SSL_get_error(self._conn, ret)
            if err != SSL_ERROR_WANT_READ:
                raise RuntimeError(f"dtls: handshake error {err}")

    def take_outgoing(self) -> bytes:
        c = self._crypto
        out = b""
        buf = ctypes.create_string_buffer(4096)
        while True:
            n = c.BIO_read(self._wbio, buf, 4096)
            if n <= 0:
                break
            out += buf.raw[:n]
        return out

    def feed_incoming(self, data: bytes) -> None:
        self._crypto.BIO_write(self._rbio, data, len(data))
        self.pump()

    # -- application data (SSL_read/SSL_write over the BIO pair) -----------
    def write_app(self, data: bytes) -> None:
        """Encrypt application bytes; records appear in take_outgoing()
        (gstdtlsconnection.c gst_dtls_connection_send analog)."""
        if not self.complete:
            raise RuntimeError("dtls: handshake not complete")
        self._sslmod.SSL_write(self._conn, data, len(data))

    def read_app(self, maxlen: int = 65536) -> bytes:
        """Drain decrypted application bytes fed via feed_incoming()."""
        s = self._sslmod
        buf = ctypes.create_string_buffer(maxlen)
        out = b""
        while True:
            n = s.SSL_read(self._conn, buf, maxlen)
            if n <= 0:
                break
            out += buf.raw[:n]
        return out

    def peer_fingerprint(self) -> Optional[str]:
        """SHA-256 digest of the certificate the peer actually
        presented, in SDP a=fingerprint form ("sha-256 AB:CD:…"), or
        None when no peer certificate is available.  Callers compare
        this against the signalled a=fingerprint (RFC 8122 / RFC 5763
        §5) — the reference dtls plugin does the same check in
        gstdtlsconnection.c."""
        s, c = self._sslmod, self._crypto
        s.SSL_get1_peer_certificate.restype = ctypes.c_void_p
        x = ctypes.c_void_p(s.SSL_get1_peer_certificate(self._conn))
        if not x:
            return None
        try:
            buf = ctypes.create_string_buffer(64)
            ln = ctypes.c_uint()
            c.X509_digest(x, ctypes.c_void_p(c.EVP_sha256()),
                          buf, ctypes.byref(ln))
            raw = buf.raw[:ln.value]
            return "sha-256 " + ":".join(f"{b:02X}" for b in raw)
        finally:
            c.X509_free(x)

    # -- SRTP keying (RFC 5764 §4.2) ---------------------------------------
    def export_srtp_keys(self) -> Tuple[bytes, bytes, bytes, bytes]:
        """-> (client_key, server_key, client_salt, server_salt)."""
        if not self.complete:
            raise RuntimeError("dtls: handshake not complete")
        s = self._sslmod
        total = 2 * (KEY_LEN + SALT_LEN)
        buf = ctypes.create_string_buffer(total)
        if s.SSL_export_keying_material(
                self._conn, buf, total, EXPORTER_LABEL,
                len(EXPORTER_LABEL), None, 0, 0) != 1:
            raise RuntimeError("dtls: keying material export failed")
        m = buf.raw
        ck = m[:KEY_LEN]
        sk = m[KEY_LEN:2 * KEY_LEN]
        cs = m[2 * KEY_LEN:2 * KEY_LEN + SALT_LEN]
        ss = m[2 * KEY_LEN + SALT_LEN:]
        return ck, sk, cs, ss

    def srtp_send_recv_keys(self):
        """-> ((send_key, send_salt), (recv_key, recv_salt)) for this
        endpoint: the DTLS client writes with the client key."""
        ck, sk, cs, ss = self.export_srtp_keys()
        if self.is_client:
            return (ck, cs), (sk, ss)
        return (sk, ss), (ck, cs)

    def selected_srtp_profile(self) -> Optional[str]:
        s = self._sslmod
        s.SSL_get_selected_srtp_profile.restype = ctypes.c_void_p
        p = s.SSL_get_selected_srtp_profile(self._conn)
        if not p:
            return None

        class _Prof(ctypes.Structure):
            _fields_ = [("name", ctypes.c_char_p),
                        ("id", ctypes.c_ulong)]
        return ctypes.cast(p, ctypes.POINTER(_Prof)
                           ).contents.name.decode()


def handshake_pair(agent_a: DtlsAgent, agent_b: DtlsAgent,
                   max_rounds: int = 20
                   ) -> Tuple[DtlsConnection, DtlsConnection]:
    """In-process handshake (loopback pump) — test/bootstrap helper."""
    cli = agent_a.connection(is_client=True)
    srv = agent_b.connection(is_client=False)
    cli.pump()
    for _ in range(max_rounds):
        if cli.complete and srv.complete:
            break
        out = cli.take_outgoing()
        if out:
            srv.feed_incoming(out)
        out = srv.take_outgoing()
        if out:
            cli.feed_incoming(out)
    if not (cli.complete and srv.complete):
        raise RuntimeError("dtls: loopback handshake did not complete")
    return cli, srv
