"""webrtcbin — JSEP offer/answer over the SDP library with ICE/STUN
candidate transport and DTLS-SRTP media security.

References: gst-plugins-bad/gst-libs/gst/webrtc/ (session
description/transceiver/ICE types), ext/webrtc/gstwebrtcbin.c
(create-offer / create-answer / set-local-description /
set-remote-description signalling state machine, transceivers with
direction, on-negotiation-needed, add-ice-candidate /
on-ice-candidate trickle signals) and
gst-libs/gst/webrtc/nice/gstwebrtcnice.c (the agent integration this
module replaces with the clean-room net/ice.py).

Scope: the JSEP state machine, SDP generation/parsing with
ice-ufrag/ice-pwd/candidate attributes, transceiver plumbing, a real
ICE agent per bin (host + server-reflexive candidates via the
stun-server property, UDP connectivity checks, aggressive
nomination), and DTLS-SRTP transport security (RFC 5764): offers
carry a=fingerprint/a=setup, the DTLS handshake runs over the
nominated candidate pair (net/dtls.py, OpenSSL-backed like the
reference ext/dtls) and media is SRTP-protected with the exported
keys (clean-room RFC 3711 cipher, net/srtp.py).  The certificate the
peer presents is verified against the SDP a=fingerprint (RFC 8122 /
5763 §5); a mismatch fails the connection.  While enable-dtls=true
(the default) the bin NEVER sends plain RTP — if libssl is absent or
the peer offers no fingerprint the connection fails; plain-RTP
transport requires an explicit enable-dtls=false on both sides.
Signalling is the application's job, exactly as with the reference
element.

A copy of the JAX package's ``net/webrtc.py``.  Packets stay host bytes
(``host_array``).  The bin counts what it drops, which the JAX package's
drops without a trace (``stats``): media rendered before the connection
is up (``dropped_unconnected``), packets that fail SRTP authentication
(``auth_failed``) and stray DTLS retransmits (``dtls_strays``), beside
``sent`` and ``received``."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple


from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            register_element)
from .ice import IceAgent, IceCandidate
from .sdp import SDPMedia, SDPMessage


@dataclass
class WebRTCSessionDescription:
    type: str                            # "offer" | "answer"
    sdp: SDPMessage

    def as_text(self) -> str:
        return self.sdp.as_text()


@dataclass
class WebRTCRTPTransceiver:
    kind: str                            # "audio" | "video"
    direction: str = "sendrecv"
    pt: int = 96
    encoding_name: str = ""
    clock_rate: int = 90000
    mline: int = -1


def _parse_stun_uri(uri: str) -> Optional[Tuple[str, int]]:
    """stun://host:port (the reference's stun-server property
    format, gstwebrtcbin.c)."""
    if not uri:
        return None
    body = uri.split("://", 1)[-1]
    host, _, port = body.partition(":")
    try:
        return (host, int(port or 3478))
    except ValueError:
        return None


@register_element
class WebRTCBin(SinkElement):
    """webrtcbin: JSEP endpoint.  Feed application/x-rtp on the sink
    pad (sent over the nominated ICE pair); received packets are
    available via `pull_received()` / the receive queue — the batch
    model's analog of the dynamic src pads.

    NAT limits (net/ice.py reduction): candidate gathering covers host
    + one server-reflexive (STUN) candidate only — no TURN relay, no
    mDNS candidates.  Peers behind symmetric NAT therefore CANNOT
    connect; when every candidate pair fails the agent enters the
    "failed" state, connection_state becomes "failed", a bus error is
    posted, and media send() raises — the failure is loud, not
    silent."""
    FACTORY = "webrtcbin"
    DESCRIPTION = "A bin for webrtc connections"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "application/x-rtp")]
    PROPERTIES = {
        "stun-server": (str, "", "stun://host:port for srflx "
                                 "candidate gathering"),
        "latency": (int, 200, ""),
        "enable-dtls": (bool, True, "DTLS-SRTP transport (RFC 5764)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.transceivers: List[WebRTCRTPTransceiver] = []
        self.local_description: Optional[
            WebRTCSessionDescription] = None
        self.remote_description: Optional[
            WebRTCSessionDescription] = None
        self.signaling_state = "stable"
        self.connection_state = "new"
        self.ice_connection_state = "new"
        self.on_negotiation_needed = None
        self.on_ice_candidate = None     # (mline, "candidate:…")
        self._ice: Optional[IceAgent] = None
        self._agent = None
        self._dtls = None
        self._srtp_send = None
        self._srtp_recv = None
        self._hs_thread = None
        self._connect_started = False
        self.stats = {"sent": 0, "dropped_unconnected": 0, "received": 0,
                      "auth_failed": 0, "dtls_strays": 0}

    # -- DTLS-SRTP ---------------------------------------------------------
    def _dtls_enabled(self) -> bool:
        from .dtls import available
        return self.props.get("enable-dtls", True) and available()

    def _ensure_agent(self):
        if self._agent is None and self._dtls_enabled():
            from .dtls import DtlsAgent
            self._agent = DtlsAgent()
        return self._agent

    # -- ICE ---------------------------------------------------------------
    def _ensure_ice(self, controlling: bool) -> IceAgent:
        if self._ice is None:
            self._ice = IceAgent(
                controlling=controlling,
                stun_server=_parse_stun_uri(
                    self.props.get("stun-server", "")))

            def _on_cand(c: IceCandidate) -> None:
                self.ice_connection_state = self._ice.state
                if self.on_ice_candidate:
                    self.on_ice_candidate(0, "candidate:" + c.to_sdp())

            def _on_state(s: str) -> None:
                self.ice_connection_state = s

            self._ice.on_candidate = _on_cand
            self._ice.on_state = _on_state
            self._ice.gather()
        return self._ice

    def add_ice_candidate(self, mline: int, candidate: str) -> None:
        """Trickle a remote candidate in (the reference's
        add-ice-candidate signal)."""
        c = IceCandidate.from_sdp(candidate)
        if c is not None and self._ice is not None:
            self._ice.add_remote_candidate(c)

    # -- transceivers ------------------------------------------------------
    def add_transceiver(self, direction: str, kind: str,
                        pt: int = 96, encoding_name: str = "",
                        clock_rate: int = 90000
                        ) -> WebRTCRTPTransceiver:
        t = WebRTCRTPTransceiver(
            kind=kind, direction=direction, pt=pt,
            encoding_name=encoding_name or
            ("H264" if kind == "video" else "PCMU"),
            clock_rate=clock_rate, mline=len(self.transceivers))
        self.transceivers.append(t)
        if self.on_negotiation_needed:
            self.on_negotiation_needed(self)
        return t

    # -- JSEP --------------------------------------------------------------
    def _media_for(self, t: WebRTCRTPTransceiver) -> SDPMedia:
        ice = self._ensure_ice(
            controlling=self.remote_description is None)
        agent = self._ensure_agent()
        m = SDPMedia(media=t.kind, port=ice.port,
                     proto=("UDP/TLS/RTP/SAVPF" if agent
                            else "RTP/AVP"),
                     formats=[str(t.pt)])
        m.connection = "IN IP4 127.0.0.1"
        m.attributes.append(
            ("rtpmap", f"{t.pt} {t.encoding_name}/{t.clock_rate}"))
        m.attributes.append((t.direction, ""))
        m.attributes.append(("ice-ufrag", ice.local_ufrag))
        m.attributes.append(("ice-pwd", ice.local_pwd))
        if agent is not None:
            m.attributes.append(("fingerprint", agent.fingerprint()))
            # offerer is actpass; answerer takes the active role and
            # becomes the DTLS client (RFC 5763 §5)
            role = ("actpass" if self.remote_description is None
                    else "active")
            m.attributes.append(("setup", role))
        for c in ice.local_candidates:
            m.attributes.append(("candidate", c.to_sdp()))
        return m

    def create_offer(self) -> WebRTCSessionDescription:
        msg = SDPMessage()
        msg.origin = "- 0 0 IN IP4 127.0.0.1"
        msg.session_name = "-"
        msg.connection = "IN IP4 127.0.0.1"
        for t in self.transceivers:
            msg.medias.append(self._media_for(t))
        return WebRTCSessionDescription("offer", msg)

    def create_answer(self) -> WebRTCSessionDescription:
        if self.remote_description is None \
                or self.remote_description.type != "offer":
            raise ValueError(
                "webrtcbin: create_answer without a remote offer")
        msg = SDPMessage()
        msg.origin = "- 0 0 IN IP4 127.0.0.1"
        msg.session_name = "-"
        msg.connection = "IN IP4 127.0.0.1"
        for i, rm in enumerate(self.remote_description.sdp.medias):
            if i < len(self.transceivers):
                t = self.transceivers[i]
            else:
                maps = rm.rtpmaps()
                pt = int(rm.formats[0]) if rm.formats else 96
                enc, rate, _ = maps.get(pt, ("", 90000, 1))
                t = WebRTCRTPTransceiver(
                    kind=rm.media, direction="sendrecv", pt=pt,
                    encoding_name=enc, clock_rate=rate,
                    mline=len(self.transceivers))
                self.transceivers.append(t)
            msg.medias.append(self._media_for(t))
        return WebRTCSessionDescription("answer", msg)

    def set_local_description(
            self, desc: WebRTCSessionDescription) -> None:
        self.local_description = desc
        if desc.type == "offer":
            self.signaling_state = "have-local-offer"
        else:
            self.signaling_state = "stable"
            self._connect()

    def set_remote_description(
            self, desc: WebRTCSessionDescription) -> None:
        self.remote_description = desc
        ice = self._ensure_ice(controlling=desc.type == "answer")
        for rm in desc.sdp.medias:
            uf = rm.get_attribute_val("ice-ufrag")
            pw = rm.get_attribute_val("ice-pwd")
            if uf and pw:
                ice.set_remote_credentials(uf, pw)
            for k, v in rm.attributes:
                if k == "candidate":
                    c = IceCandidate.from_sdp(v)
                    if c is not None:
                        ice.add_remote_candidate(c)
        if desc.type == "offer":
            self.signaling_state = "have-remote-offer"
        else:
            self.signaling_state = "stable"
            self._connect()

    # -- transport ---------------------------------------------------------
    def _connect(self) -> None:
        if self._connect_started or not self.transceivers:
            return
        self._connect_started = True
        agent = self._ensure_agent()
        remote_dtls = False
        if self.remote_description is not None:
            for rm in self.remote_description.sdp.medias:
                if rm.get_attribute_val("fingerprint"):
                    remote_dtls = True
        if self.props.get("enable-dtls", True) and (
                agent is None or not remote_dtls):
            # Never degrade to unencrypted media while DTLS is
            # requested (the default): the reference webrtcbin refuses
            # to send plain RTP.  Plain-RTP transport requires an
            # explicit enable-dtls=false on BOTH sides.
            self.connection_state = "failed"
            return
        self.connection_state = "connecting"
        ice = self._ensure_ice(
            controlling=self.local_description is not None
            and self.local_description.type == "offer")
        ice.start()
        if agent is not None and remote_dtls:
            # answerer (a=setup:active) is the DTLS client
            is_client = (self.local_description is not None
                         and self.local_description.type == "answer")
            self._dtls = agent.connection(is_client)
            self._hs_thread = threading.Thread(
                target=self._dtls_handshake_loop, daemon=True)
            self._hs_thread.start()
        else:
            self._hs_thread = threading.Thread(
                target=self._wait_ice_connected, daemon=True)
            self._hs_thread.start()

    def _wait_ice_connected(self) -> None:
        deadline = time.time() + 10.0
        while time.time() < deadline:
            if self._ice.state == "connected":
                self.connection_state = "connected"
                return
            if self._ice.state == "failed":
                break
            time.sleep(0.02)
        self.connection_state = "failed"
        self._post_ice_failed()

    def _post_ice_failed(self) -> None:
        """All candidate pairs failed: post a loud bus error (the
        symmetric-NAT / no-TURN case called out in the class docs)."""
        root = self
        while getattr(root, "parent", None) is not None:
            root = root.parent
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            root.bus.post(Message("error", self.name, {
                "reason": "ICE failed: no candidate pair succeeded "
                          "(no TURN relay support — peers behind "
                          "symmetric NAT cannot connect)"}))

    def _dtls_handshake_loop(self):
        """Wait for ICE nomination, then pump the DTLS handshake over
        the selected pair (RFC 5764 demultiplexes by first byte:
        STUN 0..3, DTLS 20..63, RTP 128..191 — STUN is consumed by
        the ICE agent's receive loop)."""
        try:
            deadline = time.time() + 10.0
            while time.time() < deadline:
                if self._ice.state == "connected":
                    break
                if self._ice.state == "failed":
                    self.connection_state = "failed"
                    return
                time.sleep(0.02)
            else:
                self.connection_state = "failed"
                return
            self._dtls.pump()
            last_flight = b""
            while not self._dtls.complete and time.time() < deadline:
                out = self._dtls.take_outgoing()
                if out:
                    last_flight = out
                    self._ice.send(out)
                data = self._ice.recv(timeout=0.3)
                if data is None:
                    # memory-BIO DTLS has no timer-driven
                    # retransmission: re-pump and re-send the last
                    # flight so a lost datagram can't stall the
                    # handshake until the deadline
                    self._dtls.pump()
                    more = self._dtls.take_outgoing()
                    if more:
                        last_flight = more
                        self._ice.send(more)
                    elif last_flight:
                        self._ice.send(last_flight)
                    continue
                if data and 20 <= data[0] <= 63:
                    self._dtls.feed_incoming(data)
                elif data:
                    self._ice.media_queue.put((data, ("", 0)))
            out = self._dtls.take_outgoing()
            if out:
                self._ice.send(out)
            if self._dtls.complete:
                if not self._verify_peer_fingerprint():
                    self.connection_state = "failed"
                    return
                from .srtp import SrtpSession
                (sk, ss), (rk, rs) = self._dtls.srtp_send_recv_keys()
                self._srtp_send = SrtpSession(sk, ss)
                self._srtp_recv = SrtpSession(rk, rs)
                self.connection_state = "connected"
            else:
                self.connection_state = "failed"
        except Exception:
            self.connection_state = "failed"

    def _verify_peer_fingerprint(self) -> bool:
        """RFC 8122 / RFC 5763 §5: the certificate presented in the
        DTLS handshake MUST match the a=fingerprint signalled in the
        remote SDP; an on-path attacker presenting its own cert is
        rejected here (the reference verifies the digest in its dtls
        plugin, gstdtlsconnection.c)."""
        presented = self._dtls.peer_fingerprint()
        if presented is None or self.remote_description is None:
            return False

        def norm(fp: str) -> str:
            return " ".join(fp.strip().split()).upper()
        for rm in self.remote_description.sdp.medias:
            sig = rm.get_attribute_val("fingerprint")
            if sig and norm(sig) == norm(presented):
                return True
        return False

    def render(self, buf: Buffer) -> str:
        d = buf.data
        pkts = d if isinstance(d, (list, tuple)) else [d]
        if self.connection_state != "connected":
            self.stats["dropped_unconnected"] += len(pkts)
            return FlowReturn.OK
        for b in pkts:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            if self._srtp_send is not None:
                raw = self._srtp_send.protect(raw)
            try:
                self._ice.send(raw)
            except OSError:
                return FlowReturn.ERROR
            self.stats["sent"] += 1
        return FlowReturn.OK

    def pull_received(self, max_packets: int = 64) -> List[bytes]:
        out = []
        if self._ice is None \
                or self.connection_state == "connecting":
            return out
        for _ in range(max_packets):
            data = self._ice.recv(timeout=0.5 if not out else 0.05)
            if data is None:
                break
            if 20 <= data[0] <= 63:
                self.stats["dtls_strays"] += 1
                continue                      # stray DTLS retransmit
            if self._srtp_recv is not None:
                data = self._srtp_recv.unprotect(data)
                if data is None:
                    self.stats["auth_failed"] += 1
                    continue                  # auth failure: drop
            out.append(data)
        self.stats["received"] += len(out)
        return out

    def stop(self):
        if self._ice is not None:
            self._ice.close()
            self._ice = None
