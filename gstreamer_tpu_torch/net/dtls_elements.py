"""Standalone DTLS / DTLS-SRTP elements.

Clean-room analogs of gst-plugins-bad/ext/dtls/:
* dtlsenc (gstdtlsenc.c) / dtlsdec (gstdtlsdec.c): one DTLS
  association shared between an enc and a dec via `connection-id`
  (the reference pairs them the same way through
  gst_dtls_dec_fetch_connection).  The enc encrypts the application
  byte stream into DTLS records and also emits the association's
  pending handshake flights; the dec feeds wire records into the
  association and emits decrypted application data.
* dtlssrtpenc (gstdtlssrtpenc.c) / dtlssrtpdec (gstdtlssrtpdec.c):
  the RTP-flavored pair — once the shared association completes,
  RTP packets are SRTP-protected/unprotected with the RFC 5764
  exported keying material (net/srtp.py, same as webrtcbin).
* dtlssrtpdemux (gstdtlssrtpdemux.c): RFC 5764 §5.1.2 first-byte
  routing — 20..63 DTLS, 128..191 RTP/RTCP.

The handshake itself is the memory-BIO association from net/dtls.py
(gstdtlsconnection.c analog); elements shuttle datagrams, transports
carry them.

A copy of the JAX package's ``net/dtls_elements.py``. Records and packets
stay host bytes (``host_array``); every element sets ``HOST_INPUT``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadPresence, PadTemplate,
                            TransformElement, register_element)
from . import dtls


# connection-id -> shared DtlsConnection (gst_dtls_dec_fetch_connection
# keeps the same process-wide table keyed by the id string).  Entries
# are refcounted: each element acquires once (first _conn() after
# start) and releases in stop(), so restarting a pipeline with the
# same connection-id gets a fresh association instead of silently
# reusing the completed one.
_CONNECTIONS: Dict[str, "dtls.DtlsConnection"] = {}
_AGENTS: Dict[str, "dtls.DtlsAgent"] = {}
_ROLES: Dict[str, bool] = {}
_REFS: Dict[str, int] = {}


def _get_connection(conn_id: str, is_client: bool, acquire: bool = False):
    if conn_id not in _CONNECTIONS:
        agent = _AGENTS.setdefault(conn_id, dtls.DtlsAgent())
        _CONNECTIONS[conn_id] = agent.connection(is_client=is_client)
        _ROLES[conn_id] = is_client
        if is_client:
            _CONNECTIONS[conn_id].pump()         # first flight
    elif _ROLES.get(conn_id) != is_client:
        raise ValueError(
            "dtls connection-id %r already exists with is-client=%s; "
            "a paired element must request the same role"
            % (conn_id, _ROLES.get(conn_id)))
    if acquire:
        _REFS[conn_id] = _REFS.get(conn_id, 0) + 1
    return _CONNECTIONS[conn_id]


def _release_connection(conn_id: str) -> None:
    refs = _REFS.get(conn_id, 0) - 1
    if refs > 0:
        _REFS[conn_id] = refs
        return
    for table in (_CONNECTIONS, _AGENTS, _ROLES, _REFS):
        table.pop(conn_id, None)


def _blobs(buf: Buffer) -> List[bytes]:
    d = buf.data
    if isinstance(d, (list, tuple)):
        return [bytes(x) if isinstance(x, (bytes, bytearray))
                else host_array(x).ravel().astype(np.uint8).tobytes()
                for x in d]
    arr = host_array(d)
    if arr.ndim > 1:
        return [bytes(r.tobytes()) for r in arr]
    return [arr.ravel().astype(np.uint8).tobytes()]


class _DtlsBase(TransformElement):
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PROPERTIES = {
        "connection-id": (str, "", "pairs enc+dec on one association"),
        "is-client": (bool, True, "DTLS role of this association"),
    }

    def _conn(self):
        cid = self.props["connection-id"] or self.name
        acquire = getattr(self, "_acquired_cid", None) != cid
        conn = _get_connection(cid, self.props["is-client"],
                               acquire=acquire)
        if acquire:
            self._acquired_cid = cid
        return conn

    def stop(self):
        cid = getattr(self, "_acquired_cid", None)
        if cid is not None:
            _release_connection(cid)
            self._acquired_cid = None

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.from_string(self._OUT_CAPS
                               if direction == PadDirection.SINK
                               else self._IN_CAPS)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        pass


@register_element
class DtlsEnc(_DtlsBase):
    """dtlsenc (gstdtlsenc.c): application bytes -> DTLS records,
    interleaved with the association's pending handshake flights."""
    FACTORY = "dtlsenc"
    DESCRIPTION = "DTLS encoder"
    _IN_CAPS = "ANY"
    _OUT_CAPS = "application/x-dtls"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, "application/x-dtls"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._plain_queue: List[bytes] = []

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = Caps.from_string("application/x-dtls")
        else:
            res = Caps.any()
        if filter is not None:
            res = res.intersect(filter) if not res.is_any else filter
        return res

    def start(self):
        self._plain_queue = []
        self._conn()                             # client: queue flight 1

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        conn = self._conn()
        if buf is not None:
            self._plain_queue.extend(_blobs(buf))
        if conn.complete:
            while self._plain_queue:
                conn.write_app(self._plain_queue.pop(0))
        out = conn.take_outgoing()
        if not out:
            return None
        tmpl = buf if buf is not None else Buffer(
            data=np.zeros(0, np.uint8))
        return tmpl.with_(data=[out], batch=1)


@register_element
class DtlsDec(_DtlsBase):
    """dtlsdec (gstdtlsdec.c): wire records -> decrypted application
    bytes; handshake responses surface on the paired dtlsenc."""
    FACTORY = "dtlsdec"
    DESCRIPTION = "DTLS decoder"
    _IN_CAPS = "application/x-dtls"
    _OUT_CAPS = "ANY"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-dtls"),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = Caps.any()
            if filter is not None and not getattr(filter, "_any",
                                                  False):
                return filter
            return Caps.from_string("application/octet-stream")
        res = Caps.from_string("application/x-dtls")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        conn = self._conn()
        for rec in _blobs(buf):
            conn.feed_incoming(rec)
        plain = conn.read_app() if conn.complete else b""
        if not plain:
            return None
        return buf.with_(data=np.frombuffer(plain, np.uint8), batch=1)


@register_element
class DtlsSrtpEnc(_DtlsBase):
    """dtlssrtpenc (gstdtlssrtpenc.c): RTP in -> SRTP out once the
    shared association exported keys; handshake flights interleave on
    the same src pad (RFC 5764 multiplexing)."""
    FACTORY = "dtlssrtpenc"
    DESCRIPTION = "DTLS-SRTP encoder"
    _IN_CAPS = "application/x-rtp"
    _OUT_CAPS = "application/x-srtp"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-srtp"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._srtp = None
        self._rtp_queue: List[bytes] = []

    def start(self):
        self._srtp = None
        self._rtp_queue = []
        self._conn()

    def _ensure_keys(self, conn) -> None:
        if self._srtp is None and conn.complete:
            from .srtp import SrtpSession
            (sk, ss), _ = conn.srtp_send_recv_keys()
            self._srtp = SrtpSession(sk, ss)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        conn = self._conn()
        self._ensure_keys(conn)
        if buf is not None:
            self._rtp_queue.extend(_blobs(buf))
        out: List[bytes] = []
        hs = conn.take_outgoing()
        if hs:
            out.append(hs)
        if self._srtp is not None:
            while self._rtp_queue:
                out.append(self._srtp.protect(self._rtp_queue.pop(0)))
        if not out:
            return None
        tmpl = buf if buf is not None else Buffer(
            data=np.zeros(0, np.uint8))
        return tmpl.with_(data=out, batch=len(out))


@register_element
class DtlsSrtpDec(_DtlsBase):
    """dtlssrtpdec (gstdtlssrtpdec.c): RFC 5764 wire mux in -> DTLS
    records feed the association, SRTP packets decrypt to RTP."""
    FACTORY = "dtlssrtpdec"
    DESCRIPTION = "DTLS-SRTP decoder"
    _IN_CAPS = "application/x-srtp"
    _OUT_CAPS = "application/x-rtp"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-srtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._srtp = None

    def start(self):
        self._srtp = None

    def _ensure_keys(self, conn) -> None:
        if self._srtp is None and conn.complete:
            from .srtp import SrtpSession
            _, (rk, rs) = conn.srtp_send_recv_keys()
            self._srtp = SrtpSession(rk, rs)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        conn = self._conn()
        out: List[bytes] = []
        for pkt in _blobs(buf):
            if not pkt:
                continue
            b0 = pkt[0]
            if 20 <= b0 <= 63:                   # DTLS record(s)
                conn.feed_incoming(pkt)
            elif 128 <= b0 <= 191:               # SRTP
                self._ensure_keys(conn)
                if self._srtp is not None:
                    plain = self._srtp.unprotect(pkt)
                    if plain is not None:
                        out.append(plain)
        self._ensure_keys(conn)
        if not out:
            return None
        return buf.with_(data=out, batch=len(out))


@register_element
class DtlsSrtpDemux(TransformElement):
    """dtlssrtpdemux (gstdtlssrtpdemux.c): first-byte routing per
    RFC 5764 §5.1.2 — DTLS records to the `dtls_src` pad, RTP/RTCP to
    the `rtp_src` pad."""
    FACTORY = "dtlssrtpdemux"
    DESCRIPTION = "DTLS SRTP demultiplexer"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("rtp_src", PadDirection.SRC, "application/x-rtp",
                    PadPresence.REQUEST),
        PadTemplate("dtls_src", PadDirection.SRC,
                    "application/x-dtls", PadPresence.REQUEST),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.last_dtls: List[bytes] = []

    def transform_caps(self, direction, caps, filter=None):
        res = Caps.any()
        if filter is not None:
            res = filter
        return res

    def fixate_caps(self, direction, caps, othercaps):
        if getattr(othercaps, "_any", False):
            return Caps.from_string("application/x-rtp")
        return othercaps.fixate()

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        return buf

    def route_outputs(self, buf: Buffer) -> Dict[str, Buffer]:
        rtp: List[bytes] = []
        dtls_recs: List[bytes] = []
        for pkt in _blobs(buf):
            if not pkt:
                continue
            if 20 <= pkt[0] <= 63:               # RFC 5764 §5.1.2
                dtls_recs.append(pkt)
            elif 128 <= pkt[0] <= 191:
                rtp.append(pkt)
        self.last_dtls = dtls_recs
        out: Dict[str, Buffer] = {}
        for pad in self.src_pads():
            if pad.name.startswith("dtls") and dtls_recs:
                out[pad.name] = buf.with_(data=dtls_recs,
                                          batch=len(dtls_recs))
            elif not pad.name.startswith("dtls") and rtp:
                out[pad.name] = buf.with_(data=rtp, batch=len(rtp))
        return out
