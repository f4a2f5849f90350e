"""RTSP authentication — the rtsp-auth.c analog.

Reference: subprojects/gst-rtsp-server/gst/rtsp-server/rtsp-auth.c
(gst_rtsp_auth_add_basic / add_digest, gst_rtsp_auth_check,
make_authenticate_response) and rtsp-permissions.c (per-factory role
permissions).  HTTP-style challenge/response per RFC 7616/2617:

* Basic: base64(user:password) compared against registered users;
* Digest: MD5(username:realm:password) with server nonce, optional
  qop=auth (client nonce + nc), as the reference supports since 1.12.

Permissions follow rtsp-permissions.c reduced to per-user allowed
mount paths with the "media.factory.access" / "media.factory.construct"
roles collapsed into path access ("*" = everything).

A copy of the JAX package's ``net/rtsp_auth.py``. Host code only: nothing
in it touches a device.
"""

from __future__ import annotations

import base64
import hashlib
import secrets
import time
from typing import Dict, Optional, Set, Tuple


def _md5(s: str) -> str:
    return hashlib.md5(s.encode()).hexdigest()


class RTSPAuth:
    """Validates Authorization headers and produces WWW-Authenticate
    challenges (gst_rtsp_auth_check / setup_digest_auth)."""

    def __init__(self, realm: str = "gstreamer-tpu",
                 methods: Tuple[str, ...] = ("basic", "digest")):
        self.realm = realm
        self.methods = tuple(m.lower() for m in methods)
        self._users: Dict[str, str] = {}          # user -> password
        self._perms: Dict[str, Set[str]] = {}     # user -> mount paths
        self._nonces: Dict[str, float] = {}       # nonce -> issue time
        self.nonce_lifetime = 300.0

    # -- user registry (gst_rtsp_auth_add_basic/add_digest) ----------
    def add_user(self, user: str, password: str,
                 paths: Set[str] = frozenset({"*"})) -> None:
        self._users[user] = password
        self._perms[user] = set(paths)

    def remove_user(self, user: str) -> None:
        self._users.pop(user, None)
        self._perms.pop(user, None)

    def _allowed(self, user: str, path: str) -> bool:
        perms = self._perms.get(user, set())
        return "*" in perms or path in perms

    # -- challenge ----------------------------------------------------
    def challenge_headers(self) -> list:
        """WWW-Authenticate header values for a 401
        (rtsp-client.c send_generic_response w/ auth headers)."""
        out = []
        if "digest" in self.methods:
            nonce = secrets.token_hex(16)
            self._nonces[nonce] = time.time()
            out.append(("WWW-Authenticate",
                        f'Digest realm="{self.realm}", '
                        f'nonce="{nonce}", algorithm=MD5, '
                        f'qop="auth"'))
        if "basic" in self.methods:
            out.append(("WWW-Authenticate",
                        f'Basic realm="{self.realm}"'))
        return out

    # -- validation ---------------------------------------------------
    def check(self, authorization: Optional[str], method: str,
              uri: str, path: str) -> Optional[str]:
        """Return the authenticated username iff the Authorization
        header is valid AND that user may access `path`; else None."""
        if not authorization:
            return None
        scheme, _, rest = authorization.strip().partition(" ")
        scheme = scheme.lower()
        if scheme == "basic" and "basic" in self.methods:
            try:
                user, _, pw = base64.b64decode(
                    rest.strip()).decode().partition(":")
            except Exception:
                return None
            if self._users.get(user) == pw and self._allowed(user, path):
                return user
            return None
        if scheme == "digest" and "digest" in self.methods:
            params = _parse_digest_params(rest)
            user = params.get("username", "")
            nonce = params.get("nonce", "")
            if user not in self._users or nonce not in self._nonces:
                return None
            if time.time() - self._nonces[nonce] > self.nonce_lifetime:
                del self._nonces[nonce]
                return None
            expect = digest_response(
                user, self.realm, self._users[user], method,
                params.get("uri", uri), nonce,
                qop=params.get("qop"), nc=params.get("nc"),
                cnonce=params.get("cnonce"))
            if secrets.compare_digest(
                    expect, params.get("response", "")) \
                    and self._allowed(user, path):
                return user
            return None
        return None


def _parse_digest_params(text: str) -> Dict[str, str]:
    """Parse the comma-separated key="value" list of a Digest
    header (either direction)."""
    out: Dict[str, str] = {}
    for part in _split_commas(text):
        k, _, v = part.strip().partition("=")
        if k:
            out[k.strip().lower()] = v.strip().strip('"')
    return out


def _split_commas(text: str) -> list:
    """Split on commas not inside quotes."""
    parts, cur, q = [], [], False
    for c in text:
        if c == '"':
            q = not q
            cur.append(c)
        elif c == "," and not q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if cur:
        parts.append("".join(cur))
    return parts


def digest_response(user: str, realm: str, password: str, method: str,
                    uri: str, nonce: str, qop: Optional[str] = None,
                    nc: Optional[str] = None,
                    cnonce: Optional[str] = None) -> str:
    """RFC 7616 §3.4.1 response computation (MD5)."""
    ha1 = _md5(f"{user}:{realm}:{password}")
    ha2 = _md5(f"{method}:{uri}")
    if qop == "auth" and nc and cnonce:
        return _md5(f"{ha1}:{nonce}:{nc}:{cnonce}:auth:{ha2}")
    return _md5(f"{ha1}:{nonce}:{ha2}")


def build_authorization(challenge: str, user: str, password: str,
                        method: str, uri: str) -> Optional[str]:
    """Client side: answer one WWW-Authenticate value
    (gstrtspconnection.c gst_rtsp_connection_set_auth)."""
    scheme, _, rest = challenge.strip().partition(" ")
    scheme = scheme.lower()
    if scheme == "basic":
        tok = base64.b64encode(f"{user}:{password}".encode()).decode()
        return f"Basic {tok}"
    if scheme == "digest":
        params = _parse_digest_params(rest)
        realm = params.get("realm", "")
        nonce = params.get("nonce", "")
        qop = params.get("qop")
        if qop and "auth" in qop.split(","):
            nc, cnonce = "00000001", secrets.token_hex(8)
            resp = digest_response(user, realm, password, method, uri,
                                   nonce, qop="auth", nc=nc,
                                   cnonce=cnonce)
            return (f'Digest username="{user}", realm="{realm}", '
                    f'nonce="{nonce}", uri="{uri}", qop=auth, '
                    f'nc={nc}, cnonce="{cnonce}", response="{resp}"')
        resp = digest_response(user, realm, password, method, uri,
                               nonce)
        return (f'Digest username="{user}", realm="{realm}", '
                f'nonce="{nonce}", uri="{uri}", response="{resp}"')
    return None
