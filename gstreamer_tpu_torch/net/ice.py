"""ICE/STUN — clean-room RFC 5389 STUN + reduced RFC 8445 ICE agent.

The reference's webrtcbin delegates ICE to libnice through
gst-plugins-bad/gst-libs/gst/webrtc/nice/gstwebrtcnice.c:1 (agent
setup, candidate gathering/signalling) and ext/webrtc/gstwebrtcbin.c:1
(trickle plumbing).  This module implements the subset needed for two
endpoints to find a working UDP path and run DTLS-SRTP over it:

- STUN Binding encode/parse (RFC 5389): XOR-MAPPED-ADDRESS, USERNAME,
  MESSAGE-INTEGRITY (HMAC-SHA1, short-term credentials), FINGERPRINT
  (CRC-32 ^ "STUN"), PRIORITY, USE-CANDIDATE, ICE-CONTROLLING/-ED.
- Candidate gathering: host candidates on local interfaces plus one
  server-reflexive candidate via a STUN Binding to the configured
  stun server (RFC 8445 §5.1.1).
- Connectivity checks (RFC 8445 §7): the agent pairs local x remote
  candidates, sends integrity-protected Binding Requests, answers the
  peer's checks, and nominates aggressively (the controlling agent
  sets USE-CANDIDATE on every check, as classic libnice aggressive
  mode did) — the first validated pair becomes the selected pair.
- Trickle: candidates can be added at any time via
  `add_remote_candidate`; locally gathered ones are surfaced through
  the `on_candidate` callback.
- A minimal `StunServer` (Binding only) so server-reflexive gathering
  is testable on localhost.

TURN relays are out of scope.  All sockets are plain blocking UDP
with a receive thread per agent; non-STUN traffic (DTLS 20..63, RTP
128..191 — RFC 5764 §5.1.2 demux) is handed to the media queue.

A copy of the JAX package's ``net/ice.py``. Host code only.  Credentials,
tie-breakers and transaction ids come from ``secrets`` and ``os.urandom``,
so two agents agree with the JAX package's on the wire, not in bytes.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import queue
import secrets
import socket
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

MAGIC = 0x2112A442
BINDING_REQUEST = 0x0001
BINDING_SUCCESS = 0x0101
BINDING_ERROR = 0x0111

ATTR_MAPPED_ADDRESS = 0x0001
ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_ERROR_CODE = 0x0009
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A

FINGERPRINT_XOR = 0x5354554E                       # "STUN"


# ---------------------------------------------------------------- STUN

def _pad4(b: bytes) -> bytes:
    return b + b"\0" * ((4 - len(b) % 4) % 4)


def build_stun(msg_type: int, txid: bytes,
               attrs: List[Tuple[int, bytes]],
               integrity_key: Optional[bytes] = None,
               fingerprint: bool = True) -> bytes:
    """Serialize a STUN message.  MESSAGE-INTEGRITY is HMAC-SHA1 over
    the message with the length field counting through the MI attr
    (§15.4); FINGERPRINT is CRC-32 ^ 0x5354554E likewise (§15.5)."""
    body = b"".join(struct.pack(">HH", t, len(v)) + _pad4(v)
                    for t, v in attrs)

    def hdr(extra: int) -> bytes:
        return struct.pack(">HHI", msg_type, len(body) + extra,
                           MAGIC) + txid

    if integrity_key is not None:
        mac = hmac.new(integrity_key, hdr(24) + body,
                       hashlib.sha1).digest()
        body += struct.pack(">HH", ATTR_MESSAGE_INTEGRITY, 20) + mac
    if fingerprint:
        crc = (zlib.crc32(hdr(8) + body) ^ FINGERPRINT_XOR) \
            & 0xFFFFFFFF
        body += struct.pack(">HHI", ATTR_FINGERPRINT, 4, crc)
    return hdr(0) + body


@dataclass
class StunMessage:
    msg_type: int
    txid: bytes
    attrs: Dict[int, bytes]
    raw: bytes

    def xor_mapped(self) -> Optional[Tuple[str, int]]:
        v = self.attrs.get(ATTR_XOR_MAPPED_ADDRESS)
        if v is None or len(v) < 8 or v[1] != 0x01:
            return None
        port = struct.unpack(">H", v[2:4])[0] ^ (MAGIC >> 16)
        addr = struct.unpack(">I", v[4:8])[0] ^ MAGIC
        return socket.inet_ntoa(struct.pack(">I", addr)), port

    def check_integrity(self, key: bytes) -> bool:
        """Verify MESSAGE-INTEGRITY (§15.4): HMAC over the bytes up
        to the MI attribute, length field adjusted to include it."""
        raw = self.raw
        pos = 20
        while pos + 4 <= len(raw):
            t, ln = struct.unpack(">HH", raw[pos:pos + 4])
            end = pos + 4 + ln
            if t == ATTR_MESSAGE_INTEGRITY:
                mac = raw[pos + 4:end]
                hdr = struct.pack(
                    ">HHI", self.msg_type, end - 20,
                    MAGIC) + self.txid
                want = hmac.new(key, hdr + raw[20:pos],
                                hashlib.sha1).digest()
                return hmac.compare_digest(mac, want)
            pos = end + ((4 - ln % 4) % 4)
        return False


def parse_stun(data: bytes) -> Optional[StunMessage]:
    if len(data) < 20 or data[0] & 0xC0:
        return None
    msg_type, length, magic = struct.unpack(">HHI", data[:8])
    if magic != MAGIC or len(data) < 20 + length:
        return None
    txid = data[8:20]
    attrs: Dict[int, bytes] = {}
    pos = 20
    end = 20 + length
    while pos + 4 <= end:
        t, ln = struct.unpack(">HH", data[pos:pos + 4])
        attrs[t] = data[pos + 4:pos + 4 + ln]
        pos += 4 + ln + ((4 - ln % 4) % 4)
    return StunMessage(msg_type, txid, attrs, data[:end])


def xor_address_attr(addr: str, port: int) -> Tuple[int, bytes]:
    xport = port ^ (MAGIC >> 16)
    xaddr = struct.unpack(">I", socket.inet_aton(addr))[0] ^ MAGIC
    return (ATTR_XOR_MAPPED_ADDRESS,
            struct.pack(">BBHI", 0, 0x01, xport, xaddr))


def is_stun(data: bytes) -> bool:
    """RFC 5764 §5.1.2 demux: STUN has top two bits 00 + magic."""
    return (len(data) >= 8 and data[0] & 0xC0 == 0
            and struct.unpack(">I", data[4:8])[0] == MAGIC)


# ------------------------------------------------------------ candidates

@dataclass
class IceCandidate:
    foundation: str
    component: int
    priority: int
    address: str
    port: int
    typ: str                                      # host | srflx
    raddr: str = ""
    rport: int = 0

    def to_sdp(self) -> str:
        s = (f"{self.foundation} {self.component} UDP "
             f"{self.priority} {self.address} {self.port} "
             f"typ {self.typ}")
        if self.typ == "srflx" and self.raddr:
            s += f" raddr {self.raddr} rport {self.rport}"
        return s

    @classmethod
    def from_sdp(cls, line: str) -> Optional["IceCandidate"]:
        line = line.strip()
        if line.startswith("candidate:"):
            line = line[len("candidate:"):]
        parts = line.split()
        if len(parts) < 8 or parts[2].upper() != "UDP":
            return None
        c = cls(foundation=parts[0], component=int(parts[1]),
                priority=int(parts[3]), address=parts[4],
                port=int(parts[5]), typ=parts[7])
        for i in range(8, len(parts) - 1, 2):
            if parts[i] == "raddr":
                c.raddr = parts[i + 1]
            elif parts[i] == "rport":
                c.rport = int(parts[i + 1])
        return c


def _candidate_priority(typ: str, local_pref: int,
                        component: int = 1) -> int:
    type_pref = {"host": 126, "srflx": 100}.get(typ, 0)
    return ((type_pref << 24) | (local_pref << 8)
            | (256 - component)) & 0x7FFFFFFF


def _local_addresses() -> List[str]:
    addrs = ["127.0.0.1"]
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       socket.AF_INET):
            a = info[4][0]
            if a not in addrs:
                addrs.append(a)
    except OSError:
        pass
    return addrs


# ----------------------------------------------------------------- agent

@dataclass
class _Pair:
    local: IceCandidate
    remote: IceCandidate
    priority: int
    valid: bool = False
    nominated: bool = False


class IceAgent:
    """One ICE component (RTP with rtcp-mux): a single UDP socket,
    check scheduler, and media demux (gstwebrtcnice.c analog)."""

    def __init__(self, controlling: bool,
                 stun_server: Optional[Tuple[str, int]] = None):
        self.controlling = controlling
        self.stun_server = stun_server
        self.local_ufrag = secrets.token_urlsafe(4)
        self.local_pwd = secrets.token_urlsafe(18)
        self.remote_ufrag = ""
        self.remote_pwd = ""
        self.tiebreaker = secrets.randbits(64)
        self.local_candidates: List[IceCandidate] = []
        self.remote_candidates: List[IceCandidate] = []
        self.selected: Optional[_Pair] = None
        self.state = "new"        # new|gathering|checking|connected|failed
        self.on_candidate: Optional[Callable[[IceCandidate], None]] = None
        self.on_state: Optional[Callable[[str], None]] = None
        self.media_queue: "queue.Queue[Tuple[bytes, Tuple[str, int]]]" \
            = queue.Queue()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.settimeout(0.1)
        self.port = self._sock.getsockname()[1]
        self._pairs: List[_Pair] = []
        self._sent_checks: Dict[bytes, _Pair] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._rx_thread: Optional[threading.Thread] = None
        self._check_thread: Optional[threading.Thread] = None

    # -- state -------------------------------------------------------------
    def _set_state(self, s: str) -> None:
        if self.state in ("connected", "failed") and s == "checking":
            return
        self.state = s
        if self.on_state:
            self.on_state(s)

    # -- gathering (RFC 8445 §5.1.1) ---------------------------------------
    def gather(self) -> List[IceCandidate]:
        self._set_state("gathering")
        out: List[IceCandidate] = []
        for pref, addr in enumerate(reversed(_local_addresses())):
            c = IceCandidate(
                foundation=str(len(out) + 1), component=1,
                priority=_candidate_priority("host", 65535 - pref),
                address=addr, port=self.port, typ="host")
            out.append(c)
        if self.stun_server is not None:
            srflx = self._gather_srflx()
            if srflx is not None:
                out.append(srflx)
        with self._lock:
            self.local_candidates.extend(out)
            self._rebuild_pairs()
        self._ensure_rx()
        if self.on_candidate:
            for c in out:
                self.on_candidate(c)
        return out

    def _gather_srflx(self) -> Optional[IceCandidate]:
        """One Binding round-trip to the STUN server; the
        XOR-MAPPED-ADDRESS is our server-reflexive candidate."""
        txid = os.urandom(12)
        req = build_stun(BINDING_REQUEST, txid, [])
        deadline = time.time() + 2.0
        interval = 0.1
        while time.time() < deadline:
            try:
                self._sock.sendto(req, self.stun_server)
            except OSError:
                return None
            t0 = time.time()
            while time.time() - t0 < interval:
                try:
                    data, src = self._sock.recvfrom(2048)
                except (socket.timeout, OSError):
                    continue
                msg = parse_stun(data) if is_stun(data) else None
                if (msg is not None and msg.txid == txid
                        and msg.msg_type == BINDING_SUCCESS):
                    mapped = msg.xor_mapped()
                    if mapped is None:
                        return None
                    return IceCandidate(
                        foundation="srflx1", component=1,
                        priority=_candidate_priority("srflx", 65535),
                        address=mapped[0], port=mapped[1],
                        typ="srflx", raddr="0.0.0.0",
                        rport=self.port)
            interval = min(interval * 2, 0.8)     # RFC 5389 §7.2.1 RTO
        return None

    # -- remote side -------------------------------------------------------
    def set_remote_credentials(self, ufrag: str, pwd: str) -> None:
        self.remote_ufrag = ufrag
        self.remote_pwd = pwd

    def add_remote_candidate(self, cand: IceCandidate) -> None:
        with self._lock:
            if any(c.address == cand.address and c.port == cand.port
                   for c in self.remote_candidates):
                return
            self.remote_candidates.append(cand)
            self._rebuild_pairs()

    def _rebuild_pairs(self) -> None:
        existing = {(p.local.address, p.local.port,
                     p.remote.address, p.remote.port)
                    for p in self._pairs}
        for lc in self.local_candidates:
            for rc in self.remote_candidates:
                key = (lc.address, lc.port, rc.address, rc.port)
                if key in existing:
                    continue
                g = lc.priority if self.controlling else rc.priority
                d = rc.priority if self.controlling else lc.priority
                pri = ((min(g, d) << 32) + 2 * max(g, d)
                       + (1 if g > d else 0))
                self._pairs.append(_Pair(lc, rc, pri))
        self._pairs.sort(key=lambda p: -p.priority)

    # -- checks (RFC 8445 §7) ----------------------------------------------
    def start(self) -> None:
        """Begin connectivity checks (idempotent)."""
        self._ensure_rx()
        if self._check_thread is None:
            self._set_state("checking")
            self._check_thread = threading.Thread(
                target=self._check_loop, daemon=True)
            self._check_thread.start()

    def _ensure_rx(self) -> None:
        if self._rx_thread is None:
            self._rx_thread = threading.Thread(
                target=self._rx_loop, daemon=True)
            self._rx_thread.start()

    def _check_loop(self) -> None:
        deadline = time.time() + 15.0
        while not self._stop.is_set() and time.time() < deadline:
            if self.state == "connected":
                return
            with self._lock:
                pairs = list(self._pairs)
            for p in pairs[:8]:
                self._send_check(p)
            time.sleep(0.05 if len(self._sent_checks) < 40 else 0.25)
        if self.state != "connected":
            self._set_state("failed")

    def _send_check(self, pair: _Pair) -> None:
        if not self.remote_pwd:
            return
        txid = os.urandom(12)
        attrs = [(ATTR_USERNAME,
                  f"{self.remote_ufrag}:{self.local_ufrag}".encode()),
                 (ATTR_PRIORITY,
                  struct.pack(">I", pair.local.priority))]
        if self.controlling:
            attrs.append((ATTR_ICE_CONTROLLING,
                          struct.pack(">Q", self.tiebreaker)))
            # aggressive nomination: USE-CANDIDATE on every check
            attrs.append((ATTR_USE_CANDIDATE, b""))
        else:
            attrs.append((ATTR_ICE_CONTROLLED,
                          struct.pack(">Q", self.tiebreaker)))
        req = build_stun(BINDING_REQUEST, txid, attrs,
                         integrity_key=self.remote_pwd.encode())
        with self._lock:
            self._sent_checks[txid] = pair
        try:
            self._sock.sendto(req, (pair.remote.address,
                                    pair.remote.port))
        except OSError:
            pass

    # -- receive demux -----------------------------------------------------
    def _rx_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, src = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if is_stun(data):
                self._handle_stun(data, src)
            else:
                self.media_queue.put((data, src))

    def _handle_stun(self, data: bytes, src: Tuple[str, int]) -> None:
        msg = parse_stun(data)
        if msg is None:
            return
        if msg.msg_type == BINDING_REQUEST:
            # peer's connectivity check: verify short-term credentials
            # (USERNAME = ourufrag:theirs, MI keyed with OUR pwd)
            user = msg.attrs.get(ATTR_USERNAME, b"").decode("ascii",
                                                            "replace")
            if not user.startswith(self.local_ufrag + ":"):
                return
            if not msg.check_integrity(self.local_pwd.encode()):
                return
            resp = build_stun(
                BINDING_SUCCESS, msg.txid,
                [xor_address_attr(*src)],
                integrity_key=self.local_pwd.encode())
            try:
                self._sock.sendto(resp, src)
            except OSError:
                return
            # a valid inbound check makes this remote address usable:
            # learn peer-reflexive candidates (§7.3.1.3) and, when the
            # controlling peer nominates, select the pair
            self._learn_remote(src, msg)
            if (not self.controlling
                    and ATTR_USE_CANDIDATE in msg.attrs):
                self._nominate(src)
            # trigger a reverse check so OUR pair validates too
            with self._lock:
                for p in self._pairs:
                    if (p.remote.address, p.remote.port) == src \
                            and not p.valid:
                        self._send_check(p)
        elif msg.msg_type == BINDING_SUCCESS:
            with self._lock:
                pair = self._sent_checks.pop(msg.txid, None)
            if pair is None:
                return
            if self.remote_pwd and not msg.check_integrity(
                    self.remote_pwd.encode()):
                return
            pair.valid = True
            if self.controlling:
                pair.nominated = True
                self._select(pair)

    def _learn_remote(self, src: Tuple[str, int],
                      msg: StunMessage) -> None:
        with self._lock:
            if any(c.address == src[0] and c.port == src[1]
                   for c in self.remote_candidates):
                return
            pri = struct.unpack(
                ">I", msg.attrs.get(ATTR_PRIORITY, b"\0\0\0\0"))[0] \
                or _candidate_priority("srflx", 1)
            self.remote_candidates.append(IceCandidate(
                foundation="prflx", component=1, priority=pri,
                address=src[0], port=src[1], typ="prflx"))
            self._rebuild_pairs()

    def _nominate(self, src: Tuple[str, int]) -> None:
        with self._lock:
            for p in self._pairs:
                if (p.remote.address, p.remote.port) == src:
                    p.valid = True
                    p.nominated = True
                    self._select(p)
                    return

    def _select(self, pair: _Pair) -> None:
        if self.selected is None or not self.selected.nominated:
            self.selected = pair
            self._set_state("connected")

    # -- media I/O ---------------------------------------------------------
    def send(self, data: bytes) -> None:
        pair = self.selected
        if pair is None:
            with self._lock:
                valid = [p for p in self._pairs if p.valid]
            pair = valid[0] if valid else None
        if pair is None:
            raise OSError("ice: no usable pair")
        self._sock.sendto(data, (pair.remote.address,
                                 pair.remote.port))

    def recv(self, timeout: float = 0.5) -> Optional[bytes]:
        try:
            data, _src = self.media_queue.get(timeout=timeout)
            return data
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


# ------------------------------------------------------------ stun server

class StunServer:
    """Minimal RFC 5389 Binding server (the reference points at
    public stun.l.google.com; for tests we serve localhost)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(0.1)
        self.addr = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, src = self._sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                return
            msg = parse_stun(data) if is_stun(data) else None
            if msg is None or msg.msg_type != BINDING_REQUEST:
                continue
            resp = build_stun(BINDING_SUCCESS, msg.txid,
                              [xor_address_attr(*src)])
            try:
                self._sock.sendto(resp, src)
            except OSError:
                return

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
