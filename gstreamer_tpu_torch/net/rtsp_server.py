"""RTSP server — gst-rtsp-server equivalent (reduced).

Reference: subprojects/gst-rtsp-server/gst/rtsp-server/ —
rtsp-server.c (TCP accept loop), rtsp-client.c (per-client request
dispatch OPTIONS/DESCRIBE/SETUP/PLAY/PAUSE/TEARDOWN), rtsp-mount-points.c
(path -> factory), rtsp-media-factory.c (launch-string factories with
pay0 convention, gst_rtsp_media_factory_set_launch), rtsp-session.c
(session ids + per-session transports), rtsp-sdp.c (SDP from the
payloader caps), rtsp-stream.c (RTP over UDP to the client ports).

Reduction: media pipelines are this framework's pipelines
whose payloader (`pay0`) output is tapped with an appsink and forwarded
as UDP datagrams (or TCP-interleaved frames); one thread per client
connection, one per playing media.  RTCP runs per stream like
rtsp-stream.c: the server sends compound SR+SDES on the session's RTCP
socket (or interleaved channel 1), receives client RRs (exposed as
`session.last_rr`), and emits BYE on teardown.

The client side lives here too: `rtspsrc` performs
OPTIONS/DESCRIBE/SETUP/PLAY over TCP and pulls RTP from its bound UDP
port or from TCP-interleaved frames (`protocols` property, mirroring
gstrtspsrc's); it parses server SRs and reports RRs back
(gst-plugins-good/gst/rtsp/gstrtspsrc.c).

A copy of the JAX package's ``net/rtsp_server.py``. The media factory
builds its pipeline with the port's ``parse_launch`` on the caller's
``device`` (the card unless the caller names another); a pipeline whose
payloader takes host bytes never touches the device.
"""

from __future__ import annotations

import socket
import threading
import time
import uuid
from typing import Dict, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, register_element)
from .rtsp import (RTSPMessage, RTSPTransport, RTSPUrl, parse_message)
from .sdp import SDPMedia, SDPMessage

# RFC 4175 sampling names per our raw formats (gstrtpvrawpay.c:214)
_SAMPLING = {"RGB": "RGB", "BGR": "BGR", "RGBA": "RGBA", "BGRA": "BGRA",
             "UYVY": "YCbCr-4:2:2"}
_SAMPLING_REV = {v: k for k, v in _SAMPLING.items()}
# media, encoding name and clock rate of the coded payloaders' profiles
# (rtsp-sdp.c takes them from the payloader's output caps)
_CODED = {"rtpjpegpay": ("video", "JPEG", 90000),
          "rtph264pay": ("video", "H264", 90000),
          "rtpvp8pay": ("video", "VP8", 90000),
          "rtpvp9pay": ("video", "VP9", 90000),
          "rtpopuspay": ("audio", "OPUS", 48000),
          "rtppcmupay": ("audio", "PCMU", 8000),
          "rtppcmapay": ("audio", "PCMA", 8000)}


def _send_all(sock: socket.socket, data: bytes,
              patience: float = 10.0) -> None:
    """sendall on a socket whose timeout is the request loop's 0.25 s: a
    send that times out is tried again, for up to `patience` seconds
    without progress.  The JAX package calls sendall there, and a reader
    that falls 0.25 s behind kills its stream thread (ROADMAP.md
    section 3)."""
    view = memoryview(data)
    stalled = 0.0
    while view:
        t0 = time.monotonic()
        try:
            n = sock.send(view)
        except socket.timeout:
            stalled += time.monotonic() - t0
            if stalled > patience:
                raise
            continue
        view = view[n:]
        stalled = 0.0


class RTSPMediaFactory:
    """gst_rtsp_media_factory_set_launch: a launch description whose
    payloader is named pay0 (optionally wrapped in parentheses).

    transport_mode="record" (gst_rtsp_media_factory_set_transport_mode,
    rtsp-media-factory.c) flips the factory to RECORD: the launch must
    then name an appsrc `depay0` which receives the client's RTP
    packets (the reference names its depayloader depay0 the same
    way)."""

    def __init__(self, launch: str, rate_control: bool = True,
                 transport_mode: str = "play", device=None):
        launch = launch.strip()
        if launch.startswith("(") and launch.endswith(")"):
            launch = launch[1:-1].strip()
        self.launch = launch
        self.rate_control = rate_control
        self.transport_mode = transport_mode.lower()
        self.device = device        # the media pipelines' device

    def build(self):
        from ..core.parse import parse_launch
        p = parse_launch(self.launch + " ! appsink name=__rtpsink__",
                         device=self.device)
        for e in p._nodes():     # negotiation builds on the elements' device
            e.device = p.device
        p.negotiate()
        pay = p.get_by_name("pay0")
        if pay is None:
            raise ValueError("factory launch must name its payloader pay0")
        return p, pay

    def build_record(self):
        from ..core.parse import parse_launch
        p = parse_launch(self.launch, device=self.device)
        src = p.get_by_name("depay0")
        if src is None:
            raise ValueError(
                "record factory launch must name its appsrc depay0")
        return p, src

    def describe(self, pay) -> SDPMedia:
        """rtsp-sdp.c gst_rtsp_sdp_from_media: one m= section from the
        payloader's negotiated input."""
        pt = pay.props.get("pt", 96)
        if pt < 0:                          # PCMU / PCMA: static type
            pt = getattr(pay, "_PT", 96)
        media = SDPMedia(media="video", port=0, proto="RTP/AVP",
                         formats=[str(pt)])
        info = getattr(pay, "_info", None)
        coded = _CODED.get(pay.FACTORY)
        if info is None and coded is not None:
            # a payloader of coded media keeps no _info: its encoding is
            # its RTP profile's (the JAX package reads pay._info here and
            # answers DESCRIBE with 500: ROADMAP.md section 3)
            kind, enc, rate = coded
            media.media = kind
            media.attributes.append(("rtpmap", f"{pt} {enc}/{rate}"))
        elif hasattr(info, "width"):        # raw video (RFC 4175)
            sampling = _SAMPLING.get(info.finfo.name, info.finfo.name)
            media.attributes.append(("rtpmap", f"{pt} RAW/90000"))
            media.attributes.append(
                ("fmtp", f"{pt} sampling={sampling}; depth=8; "
                         f"width={info.width}; height={info.height}"))
        else:                               # L16 audio (RFC 3551)
            media.media = "audio"
            rate = getattr(info, "rate", 44100)
            ch = getattr(info, "channels", 2)
            media.attributes.append(("rtpmap", f"{pt} L16/{rate}/{ch}"))
        media.attributes.append(("control", "stream=0"))
        return media


class RTSPMountPoints:
    """rtsp-mount-points.c: path -> media factory."""

    def __init__(self):
        self._factories: Dict[str, RTSPMediaFactory] = {}

    def add_factory(self, path: str, factory: RTSPMediaFactory) -> None:
        self._factories[path] = factory

    def match(self, path: str) -> Optional[RTSPMediaFactory]:
        return self._factories.get(path.split("?", 1)[0])


class RTSPAddressPool:
    """Multicast address/port pool (rtsp-address-pool.c reduced):
    sequential allocation of (group, rtp_port, rtcp_port, ttl)
    tuples from a configured range."""

    def __init__(self, min_address: str = "239.255.42.1",
                 max_address: str = "239.255.42.254",
                 min_port: int = 5000, max_port: int = 5998,
                 ttl: int = 1):
        self.ttl = ttl
        self._min = [int(x) for x in min_address.split(".")]
        self._max = [int(x) for x in max_address.split(".")]
        self._next_addr = list(self._min)
        self._next_port = min_port
        self._max_port = max_port
        self._free: list = []

    def acquire(self):
        if self._free:
            return self._free.pop()
        if self._next_port + 1 > self._max_port:
            raise RuntimeError("address pool exhausted")
        addr = ".".join(str(x) for x in self._next_addr)
        ports = (self._next_port, self._next_port + 1)
        self._next_port += 2
        if self._next_addr[3] < self._max[3]:
            self._next_addr[3] += 1
        return (addr, ports[0], ports[1], self.ttl)

    def release(self, alloc) -> None:
        self._free.append(alloc)


class _Session:
    def __init__(self, factory: RTSPMediaFactory, dest_host: str):
        self.id = uuid.uuid4().hex[:16]
        self.factory = factory
        self.dest_host = dest_host
        self.transport: Optional[RTSPTransport] = None
        self.sock: Optional[socket.socket] = None
        self.rtcp_sock: Optional[socket.socket] = None
        self.conn: Optional[socket.socket] = None     # TCP interleaved
        self.conn_lock = threading.Lock()
        self.thread: Optional[threading.Thread] = None
        self.playing = threading.Event()
        self.ssrc = int.from_bytes(uuid.uuid4().bytes[:4], "big")
        self.packet_count = 0
        self.octet_count = 0
        self.last_rtp_ts = 0
        self.last_rr = None            # most recent client RtcpPacket RR
        self.sr_sent = 0
        self.record = False            # RECORD-mode session
        self.record_pipeline = None
        self.record_src = None
        self.mcast = None              # (group, rtp_port, rtcp_port, ttl)


class RTSPServer:
    """rtsp-server.c: TCP accept loop + per-client dispatch."""

    def __init__(self, address: str = "127.0.0.1", service: int = 0,
                 auth=None, address_pool: Optional[RTSPAddressPool]
                 = None):
        self.address = address
        self.service = service
        self.mount_points = RTSPMountPoints()
        self.auth = auth               # RTSPAuth or None (open server)
        self.address_pool = address_pool
        self.bound_port: Optional[int] = None
        self._srv: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._sessions: Dict[str, _Session] = {}
        self._announced_sdp: Dict[str, SDPMessage] = {}

    # -- lifecycle ----------------------------------------------------------
    def attach(self) -> int:
        """Bind + start serving; returns the bound port."""
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.address, self.service))
        self.bound_port = self._srv.getsockname()[1]
        self._srv.listen(8)
        self._srv.settimeout(0.25)
        self._running.set()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        return self.bound_port

    def shutdown(self) -> None:
        self._running.clear()
        for s in list(self._sessions.values()):
            self._teardown(s)
        if self._srv is not None:
            self._srv.close()
            self._srv = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None

    # -- accept/dispatch ------------------------------------------------------
    def _accept_loop(self):
        while self._running.is_set():
            try:
                conn, addr = self._srv.accept()
            except (socket.timeout, OSError):
                continue
            t = threading.Thread(target=self._client_loop,
                                 args=(conn, addr), daemon=True)
            t.start()

    def _client_loop(self, conn: socket.socket, addr):
        conn.settimeout(0.25)
        pending = b""
        if not hasattr(self, "_conn_locks"):
            self._conn_locks = {}
        self._conn_locks[conn] = threading.Lock()
        try:
            while self._running.is_set():
                try:
                    chunk = conn.recv(65536)
                except socket.timeout:
                    continue
                if not chunk:
                    break
                pending += chunk
                while True:
                    if pending[:1] == b"$":
                        # interleaved binary frame from the client
                        # (TCP RECORD media, RFC 2326 §10.12)
                        if len(pending) < 4:
                            break
                        ln = int.from_bytes(pending[2:4], "big")
                        if len(pending) < 4 + ln:
                            break
                        ch = pending[1]
                        payload = pending[4:4 + ln]
                        pending = pending[4 + ln:]
                        if ch % 2 == 0:          # RTP channel
                            for s in self._sessions.values():
                                if s.conn is conn and s.record:
                                    self.feed_record_interleaved(
                                        s, payload)
                        continue
                    msg, used = parse_message(pending)
                    if msg is None:
                        break
                    pending = pending[used:]
                    resp = self._handle(msg, addr, conn)
                    with self._conn_locks[conn]:
                        conn.sendall(resp.serialize())
        finally:
            self._conn_locks.pop(conn, None)
            conn.close()

    # -- methods (rtsp-client.c handle_request) ------------------------------
    def _handle(self, req: RTSPMessage, addr,
                conn=None) -> RTSPMessage:
        try:
            handler = getattr(self, "_do_" + req.method.lower(), None)
            if handler is None:
                return RTSPMessage.response(501, req)
            if self.auth is not None and req.method != "OPTIONS":
                # rtsp-auth.c gst_rtsp_auth_check: everything past
                # OPTIONS needs a valid Authorization matching the
                # mount's permissions; missing/bad -> 401 + challenge
                path = RTSPUrl.parse(req.uri).abspath
                if path.endswith("/stream=0"):
                    path = path[: -len("/stream=0")]
                user = self.auth.check(
                    req.headers.get("Authorization"), req.method,
                    req.uri, path)
                if user is None:
                    resp = RTSPMessage.response(401, req)
                    for k, v in self.auth.challenge_headers():
                        resp.headers.add(k, v)
                    return resp
            return handler(req, addr, conn)
        except Exception as e:     # noqa: BLE001 — map to 500 like the C
            resp = RTSPMessage.response(500, req)
            resp.headers.set("X-Error", str(e))
            return resp

    def _do_options(self, req, addr, conn=None):
        resp = RTSPMessage.response(200, req)
        resp.headers.set("Public", "OPTIONS, DESCRIBE, ANNOUNCE, "
                                   "SETUP, PLAY, PAUSE, RECORD, "
                                   "TEARDOWN")
        return resp

    def _do_announce(self, req, addr, conn=None):
        """Client publishes its SDP ahead of a RECORD session
        (rtsp-client.c handle_announce_request)."""
        url = RTSPUrl.parse(req.uri)
        factory = self.mount_points.match(url.abspath)
        if factory is None:
            return RTSPMessage.response(404, req)
        if factory.transport_mode != "record":
            return RTSPMessage.response(405, req)
        try:
            self._announced_sdp[url.abspath] = SDPMessage.parse(
                req.body.decode())
        except Exception:
            return RTSPMessage.response(400, req)
        return RTSPMessage.response(200, req)

    def _do_describe(self, req, addr, conn=None):
        url = RTSPUrl.parse(req.uri)
        factory = self.mount_points.match(url.abspath)
        if factory is None:
            return RTSPMessage.response(404, req)
        pipeline, pay = factory.build()
        sdp = SDPMessage(
            origin=f"- 0 0 IN IP4 {self.address}",
            session_name="gstreamer_tpu RTSP stream",
            connection=f"IN IP4 {self.address}",
            times=["0 0"])
        sdp.medias.append(factory.describe(pay))
        resp = RTSPMessage.response(200, req)
        resp.body = sdp.as_text().encode()
        resp.headers.set("Content-Type", "application/sdp")
        resp.headers.set("Content-Base", req.uri.rstrip("/") + "/")
        return resp

    def _do_setup(self, req, addr, conn=None):
        url = RTSPUrl.parse(req.uri)
        path = url.abspath
        if path.endswith("/stream=0"):
            path = path[: -len("/stream=0")]
        factory = self.mount_points.match(path)
        if factory is None:
            return RTSPMessage.response(404, req)
        theader = req.headers.get("Transport")
        if not theader:
            return RTSPMessage.response(461, req)
        transport = RTSPTransport.parse(theader)
        sess = _Session(factory, addr[0])
        sess.transport = transport
        if (transport.mode == "RECORD") != (
                factory.transport_mode == "record"):
            # mode must match the factory's transport mode
            # (rtsp-media.c gst_rtsp_media_complete_pipeline)
            return RTSPMessage.response(461, req)
        if transport.mode == "RECORD":
            sess.record = True
            if transport.is_tcp:
                if transport.interleaved is None:
                    transport.interleaved = (0, 1)
                sess.conn = conn
                sess.conn_lock = self._conn_locks.get(
                    conn, sess.conn_lock)
            else:
                sess.sock = socket.socket(socket.AF_INET,
                                          socket.SOCK_DGRAM)
                sess.sock.bind((self.address, 0))
                sess.sock.settimeout(0.25)
                sess.rtcp_sock = socket.socket(socket.AF_INET,
                                               socket.SOCK_DGRAM)
                sess.rtcp_sock.bind((self.address, 0))
                sess.rtcp_sock.settimeout(0.0)
                transport.server_port = (
                    sess.sock.getsockname()[1],
                    sess.rtcp_sock.getsockname()[1])
            transport.ssrc = None
            self._sessions[sess.id] = sess
            resp = RTSPMessage.response(200, req)
            resp.headers.set("Session", sess.id + ";timeout=60")
            resp.headers.set("Transport", transport.to_string())
            return resp
        if not transport.unicast and not transport.is_tcp:
            # multicast SETUP: allocate group/ports from the pool
            # (rtsp-stream.c gst_rtsp_stream_allocate_udp_sockets
            # mcast path)
            if self.address_pool is None:
                return RTSPMessage.response(461, req)
            sess.mcast = self.address_pool.acquire()
            group, p_rtp, p_rtcp, ttl = sess.mcast
            sess.sock = socket.socket(socket.AF_INET,
                                      socket.SOCK_DGRAM)
            sess.sock.setsockopt(socket.IPPROTO_IP,
                                 socket.IP_MULTICAST_TTL, max(ttl, 1))
            sess.sock.setsockopt(socket.IPPROTO_IP,
                                 socket.IP_MULTICAST_LOOP, 1)
            if self.address not in ("127.0.0.1", "0.0.0.0", ""):
                # egress interface follows the bound address; for
                # loopback/wildcard let the kernel route so local
                # group members on the default interface hear us
                try:
                    sess.sock.setsockopt(
                        socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                        socket.inet_aton(self.address))
                except OSError:
                    pass
            transport.destination = group
            transport.port = (p_rtp, p_rtcp)
            transport.ttl = ttl
            transport.ssrc = sess.ssrc
            self._sessions[sess.id] = sess
            resp = RTSPMessage.response(200, req)
            resp.headers.set("Session", sess.id + ";timeout=60")
            resp.headers.set("Transport", transport.to_string())
            return resp
        if transport.is_tcp:
            # RTP/AVP/TCP;interleaved=n-n+1 over the RTSP connection
            # (rtsp-stream.c TCP transport)
            if transport.interleaved is None:
                transport.interleaved = (0, 1)
            sess.conn = conn
            sess.conn_lock = self._conn_locks.get(conn,
                                                  sess.conn_lock)
        else:
            if transport.client_port == (0, 0):
                return RTSPMessage.response(461, req)
            sess.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sess.sock.bind((self.address, 0))
            # a second socket for RTCP, mirroring rtsp-stream.c's
            # per-stream RTP/RTCP socket pair
            sess.rtcp_sock = socket.socket(socket.AF_INET,
                                           socket.SOCK_DGRAM)
            sess.rtcp_sock.bind((self.address, 0))
            sess.rtcp_sock.settimeout(0.0)
            transport.server_port = (
                sess.sock.getsockname()[1],
                sess.rtcp_sock.getsockname()[1])
            transport.destination = addr[0]
        transport.ssrc = sess.ssrc
        self._sessions[sess.id] = sess
        resp = RTSPMessage.response(200, req)
        resp.headers.set("Session", sess.id + ";timeout=60")
        resp.headers.set("Transport", transport.to_string())
        return resp

    def _session_of(self, req) -> Optional[_Session]:
        sid = (req.headers.get("Session") or "").split(";")[0].strip()
        return self._sessions.get(sid)

    def _do_play(self, req, addr, conn=None):
        sess = self._session_of(req)
        if sess is None:
            return RTSPMessage.response(454, req)
        if sess.thread is None or not sess.thread.is_alive():
            sess.playing.set()
            sess.thread = threading.Thread(
                target=self._stream_loop, args=(sess,), daemon=True)
            sess.thread.start()
        else:
            sess.playing.set()
        resp = RTSPMessage.response(200, req)
        resp.headers.set("Range", "npt=0-")
        resp.headers.set("RTP-Info",
                         f"url={req.uri};seq=0;rtptime=0")
        return resp

    def _do_record(self, req, addr, conn=None):
        """Start consuming the client's RTP into the record media
        (rtsp-client.c handle_record_request / rtsp-media.c
        RECORD mode)."""
        sess = self._session_of(req)
        if sess is None:
            return RTSPMessage.response(454, req)
        if not sess.record:
            return RTSPMessage.response(455, req)
        if sess.thread is None or not sess.thread.is_alive():
            pipeline, src = sess.factory.build_record()
            sess.record_pipeline, sess.record_src = pipeline, src
            sess.playing.set()
            sess.thread = threading.Thread(
                target=self._record_loop, args=(sess,), daemon=True)
            sess.thread.start()
        else:
            sess.playing.set()
        return RTSPMessage.response(200, req)

    def _record_loop(self, sess: _Session) -> None:
        """Receive the client's RTP and feed it to the record
        pipeline's depay0 appsrc; the media runs to completion at
        teardown (batch-model reduction of rtsp-media.c's live
        record pipeline)."""
        while sess.id in self._sessions and sess.record:
            if not sess.playing.is_set():
                time.sleep(0.05)
                continue
            if sess.sock is not None:
                try:
                    data, _ = sess.sock.recvfrom(65536)
                except (socket.timeout, OSError):
                    continue
                if data:
                    sess.record_src.push_buffer(
                        Buffer(data=[data], batch=1))
                    sess.packet_count += 1
                    sess.octet_count += max(0, len(data) - 12)
            else:
                time.sleep(0.05)   # interleaved data arrives via
                #                    _client_loop -> _feed_record

    def feed_record_interleaved(self, sess: _Session,
                                payload: bytes) -> None:
        if sess.record_src is not None:
            sess.record_src.push_buffer(Buffer(data=[payload],
                                               batch=1))
            sess.packet_count += 1

    def _do_pause(self, req, addr, conn=None):
        sess = self._session_of(req)
        if sess is None:
            return RTSPMessage.response(454, req)
        sess.playing.clear()
        return RTSPMessage.response(200, req)

    def _do_teardown(self, req, addr, conn=None):
        sess = self._session_of(req)
        if sess is None:
            return RTSPMessage.response(454, req)
        self._teardown(sess)
        resp = RTSPMessage.response(200, req)
        resp.headers.set("Connection", "close")
        return resp

    def _teardown(self, sess: _Session) -> None:
        self._sessions.pop(sess.id, None)
        sess.playing.clear()
        if sess.thread is not None:
            sess.thread.join(timeout=2.0)
            sess.thread = None
        if sess.record_pipeline is not None:
            # run the record media to completion on the received
            # packets (batch-model finalize of rtsp-media.c's
            # unprepare on RECORD teardown)
            try:
                sess.record_src.end_of_stream()
                sess.record_pipeline.run()
                sess.record_pipeline.set_state("null")
            except Exception:
                pass
            sess.record_pipeline = sess.record_src = None
        if not sess.record:
            try:
                from .rtcp import build_bye
                self._send_rtcp(sess, build_bye(sess.ssrc))
            except OSError:
                pass
        if sess.mcast is not None and self.address_pool is not None:
            self.address_pool.release(sess.mcast)
            sess.mcast = None
        for attr in ("sock", "rtcp_sock"):
            sk = getattr(sess, attr)
            if sk is not None:
                sk.close()
                setattr(sess, attr, None)

    # -- media streaming (rtsp-stream.c) --------------------------------------
    def _send_rtp(self, sess: _Session, pkt: bytes) -> None:
        if sess.conn is not None:
            ch = sess.transport.interleaved[0]
            frame = b"$" + bytes([ch]) + len(pkt).to_bytes(2, "big") + pkt
            with sess.conn_lock:
                _send_all(sess.conn, frame)
        elif sess.mcast is not None:
            group, p_rtp, _p_rtcp, _ttl = sess.mcast
            sess.sock.sendto(pkt, (group, p_rtp))
        else:
            sess.sock.sendto(
                pkt, (sess.dest_host, sess.transport.client_port[0]))

    def _send_rtcp(self, sess: _Session, pkt: bytes) -> None:
        if sess.conn is not None:
            ch = sess.transport.interleaved[1]
            frame = b"$" + bytes([ch]) + len(pkt).to_bytes(2, "big") + pkt
            with sess.conn_lock:
                _send_all(sess.conn, frame)
        elif sess.rtcp_sock is not None \
                and sess.transport.client_port[1]:
            sess.rtcp_sock.sendto(
                pkt, (sess.dest_host, sess.transport.client_port[1]))

    def _poll_client_rtcp(self, sess: _Session) -> None:
        """Receive client RRs on the stream's RTCP socket
        (rtsp-stream.c on_rtcp); latest RR kept on the session."""
        if sess.rtcp_sock is None:
            return
        from .rtcp import TYPE_RR, parse_compound
        try:
            while True:
                data, _ = sess.rtcp_sock.recvfrom(65536)
                for pkt in parse_compound(data):
                    if pkt.ptype == TYPE_RR:
                        sess.last_rr = pkt
        except (BlockingIOError, socket.timeout, OSError,
                ValueError):
            pass

    def _maybe_send_sr(self, sess: _Session, force: bool = False) -> None:
        """Compound SR+SDES at ~1 Hz (RFC 3550 minimal interval
        scaled down; rtsp-stream.c relies on rtpbin's session timer)."""
        now = time.time()
        if not force and now - getattr(sess, "_last_sr_time", 0) < 1.0:
            return
        sess._last_sr_time = now
        from .rtcp import build_sr, ntp_time
        self._send_rtcp(sess, build_sr(
            sess.ssrc, ntp_time(now), sess.last_rtp_ts,
            sess.packet_count, sess.octet_count))
        sess.sr_sent += 1

    def _stream_loop(self, sess: _Session) -> None:
        from .rtp import parse_rtp_header
        pipeline, pay = sess.factory.build()
        sink = pipeline.get_by_name("__rtpsink__")
        pipeline.set_state("PLAYING")
        try:
            while sess.id in self._sessions:
                if not sess.playing.is_set():
                    time.sleep(0.05)
                    continue
                if not pipeline.tick():
                    break
                while True:
                    sample = sink.pull_sample()
                    if sample is None:
                        break
                    pkts = sample.buffer.data
                    if not isinstance(pkts, list):
                        continue
                    for pkt in pkts:
                        if isinstance(pkt, (np.ndarray, torch.Tensor)):
                            pkt = host_array(pkt).tobytes()
                        self._send_rtp(sess, pkt)
                        sess.packet_count += 1
                        sess.octet_count += max(0, len(pkt) - 12)
                        try:
                            sess.last_rtp_ts = \
                                parse_rtp_header(pkt)["timestamp"]
                        except Exception:   # short/odd packet: skip ts
                            pass
                    self._maybe_send_sr(sess)
                    self._poll_client_rtcp(sess)
                    if sess.factory.rate_control and sample.buffer.duration:
                        time.sleep(min(sample.buffer.duration / 1e9, 0.5))
            self._maybe_send_sr(sess, force=True)
        finally:
            pipeline.set_state("NULL")


# ---------------------------------------------------------------------------
# rtspsrc (client element)
# ---------------------------------------------------------------------------

@register_element
class RTSPSrc(SourceElement):
    """rtspsrc (reduced): OPTIONS/DESCRIBE/SETUP/PLAY over TCP, RTP
    datagrams over UDP; emits application/x-rtp buffers whose caps carry
    the decoded SDP fields so a depayloader can negotiate directly."""
    FACTORY = "rtspsrc"
    DESCRIPTION = "Receive data over the network via RTSP (RFC 2326)"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 "application/x-rtp")]
    PROPERTIES = {
        "location": (str, "", "rtsp:// URL"),
        "timeout": (float, 1.0, "UDP receive timeout (s)"),
        "eos-timeouts": (int, 2, "consecutive timeouts before EOS"),
        "protocols": (str, "udp", "transport: udp, udp-mcast, or "
                      "tcp (interleaved)"),
        "do-rtcp": (bool, True, "send RRs / process server SRs"),
        "user-id": (str, "", "authentication user (gstrtspsrc "
                    "user-id; rtsp://user:pw@host also works)"),
        "user-pw": (str, "", "authentication password"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._caps: Optional[Caps] = None
        self._conn = None
        self._udp = None
        self._rtcp = None
        self._cseq = 0
        self._session = None
        self._content_base = None
        self._timeouts = 0
        self._pending = b""            # TCP interleaved byte stream
        self._ssrc = int.from_bytes(uuid.uuid4().bytes[:4], "big")
        self._sources = {}             # ssrc -> RtpSource (RR stats)
        self._clock_rate = 90000
        self.last_sr = None            # latest server SR RtcpPacket
        self.rr_sent = 0
        self._last_rr_time = 0.0

    # -- RTSP client calls ---------------------------------------------------
    def _credentials(self):
        user = self.props.get("user-id", "")
        pw = self.props.get("user-pw", "")
        if not user and self.props["location"]:
            url = RTSPUrl.parse(self.props["location"])
            user, pw = url.user or "", url.password or ""
        return user, pw

    def _call(self, method: str, uri: str, headers=(),
              _retried: bool = False) -> RTSPMessage:
        self._cseq += 1
        req = RTSPMessage.request(method, uri)
        req.headers.set("CSeq", str(self._cseq))
        if self._session:
            req.headers.set("Session", self._session)
        chal = getattr(self, "_auth_challenge", None)
        if chal is not None:
            from .rtsp_auth import build_authorization
            user, pw = self._credentials()
            auth = build_authorization(chal, user, pw, method, uri)
            if auth:
                req.headers.set("Authorization", auth)
        for k, v in headers:
            req.headers.set(k, v)
        self._conn.sendall(req.serialize())
        data, early = b"", b""
        while True:
            chunk = self._conn.recv(65536)
            if not chunk:
                raise ConnectionError("RTSP connection closed")
            data += chunk
            # interleaved frames ahead of the response, and whatever
            # follows it in the same read, belong to the stream (the JAX
            # package drops them: ROADMAP.md section 3)
            while data[:1] == b"$" and len(data) >= 4:
                end = 4 + int.from_bytes(data[2:4], "big")
                if len(data) < end:
                    break
                early, data = early + data[:end], data[end:]
            msg, used = parse_message(data)
            if msg is not None:
                break
        self._pending += early + data[used:]
        if msg.status == 401 and not _retried:
            # answer the challenge and replay once
            # (gstrtspsrc.c gst_rtspsrc_setup_auth)
            user, pw = self._credentials()
            if user:
                chals = [v for k, v in msg.headers.items()
                         if k.lower() == "www-authenticate"]
                # prefer Digest over Basic like the reference
                chals.sort(key=lambda c:
                           0 if c.lower().startswith("digest") else 1)
                if chals:
                    self._auth_challenge = chals[0]
                    return self._call(method, uri, headers,
                                      _retried=True)
        return msg

    def start(self):
        # negotiation queries caps before start(): the session may
        # already be up (gstrtspsrc similarly connects on READY->PAUSED,
        # before the first buffer)
        if self._conn is not None:
            return
        url = RTSPUrl.parse(self.props["location"])
        self._conn = socket.create_connection((url.host, url.port),
                                              timeout=5.0)
        uri = self.props["location"]
        self._call("OPTIONS", uri)
        desc = self._call("DESCRIBE", uri,
                          [("Accept", "application/sdp")])
        if desc.status != 200:
            raise ConnectionError(f"DESCRIBE failed: {desc.status}")
        self._content_base = desc.headers.get("Content-Base", uri)
        sdp = SDPMessage.parse(desc.body.decode())
        media = sdp.medias[0]
        pt = int(media.formats[0])
        self._caps = self._caps_from_sdp(media, pt)
        _, rate, _ = media.rtpmaps().get(pt, ("", 90000, 1))
        self._clock_rate = rate or 90000
        control = media.get_attribute_val("control") or ""
        setup_uri = (self._content_base.rstrip("/") + "/" + control
                     if control else self._content_base)
        if self.props["protocols"] == "tcp":
            t = RTSPTransport(protocol="RTP/AVP/TCP",
                              interleaved=(0, 1))
        elif self.props["protocols"] == "udp-mcast":
            t = RTSPTransport(unicast=False)
        else:
            self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._udp.bind(("0.0.0.0", 0))
            self._udp.settimeout(self.props["timeout"])
            port = self._udp.getsockname()[1]
            # paired RTCP socket (gstrtspsrc udpsrc1 analog)
            self._rtcp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                self._rtcp.bind(("0.0.0.0", port + 1))
            except OSError:
                self._rtcp.bind(("0.0.0.0", 0))
            self._rtcp.settimeout(0.0)
            t = RTSPTransport(client_port=(
                port, self._rtcp.getsockname()[1]))
        resp = self._call("SETUP", setup_uri,
                          [("Transport", t.to_string())])
        if resp.status != 200:
            raise ConnectionError(f"SETUP failed: {resp.status}")
        self._session = (resp.headers.get("Session") or "").split(";")[0]
        self._server_transport = RTSPTransport.parse(
            resp.headers.get("Transport") or "RTP/AVP")
        if self.props["protocols"] == "udp-mcast":
            # join the announced group (gstrtspsrc udpsrc multicast
            # setup: bind the mcast port, add membership)
            st = self._server_transport
            group = st.destination or "239.255.42.1"
            port = st.port[0] or st.server_port[0]
            self._udp = socket.socket(socket.AF_INET,
                                      socket.SOCK_DGRAM)
            self._udp.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_REUSEADDR, 1)
            self._udp.bind(("", port))
            mreq = socket.inet_aton(group) + socket.inet_aton(
                "0.0.0.0")
            self._udp.setsockopt(socket.IPPROTO_IP,
                                 socket.IP_ADD_MEMBERSHIP, mreq)
            self._udp.settimeout(self.props["timeout"])
        resp = self._call("PLAY", self._content_base,
                          [("Range", "npt=0-")])
        if resp.status != 200:
            raise ConnectionError(f"PLAY failed: {resp.status}")
        self._timeouts = 0

    def stop(self):
        try:
            if self._conn is not None and self._session:
                self._call("TEARDOWN", self._content_base)
        except OSError:
            pass
        for s in (self._udp, self._rtcp, self._conn):
            if s is not None:
                s.close()
        self._udp = self._rtcp = self._conn = None
        self._session = None

    @staticmethod
    def _caps_from_sdp(media: SDPMedia, pt: int) -> Caps:
        enc, rate, ch = media.rtpmaps().get(pt, ("", 90000, 1))
        fields = [f"media=(string){media.media}", f"payload=(int){pt}",
                  f"encoding-name=(string){enc}",
                  f"clock-rate=(int){rate}"]
        fmtp = media.get_attribute_val("fmtp") or ""
        params = {}
        if fmtp:
            _, _, rest = fmtp.partition(" ")
            for kv in rest.split(";"):
                k, _, v = kv.strip().partition("=")
                if k:
                    params[k.lower()] = v
        if enc == "RAW":
            fmt = _SAMPLING_REV.get(params.get("sampling", ""),
                                    params.get("sampling", "RGB"))
            fields += [f"format=(string){fmt}",
                       f"width=(int){params.get('width', 0)}",
                       f"height=(int){params.get('height', 0)}"]
        if enc == "L16":
            fields += [f"rate=(int){rate}", f"channels=(int){ch}"]
        return Caps.from_string("application/x-rtp, " + ", ".join(fields))

    # -- source behavior -------------------------------------------------------
    def get_caps(self, filter=None):
        if self._caps is None and self.props["location"]:
            self.start()          # connect lazily: caps come from DESCRIBE
        caps = self._caps or self.src_pads()[0].template_caps
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    # -- RTCP (RFC 3550 session duties, gstrtspsrc manage=true path) --
    def _note_rtp(self, pkt: bytes) -> None:
        if not self.props["do-rtcp"]:
            return
        try:
            from .rtp import parse_rtp_header
            from .rtpmanager import RtpSource
            h = parse_rtp_header(pkt)
            src = self._sources.get(h["ssrc"])
            if src is None:
                src = self._sources[h["ssrc"]] = RtpSource(
                    h["ssrc"], self._clock_rate)
            src.process(h["seq"], h["timestamp"], len(h["payload"]))
        except Exception:
            pass

    def _handle_rtcp(self, data: bytes) -> None:
        from .rtcp import TYPE_SR, parse_compound
        try:
            for pkt in parse_compound(data):
                if pkt.ptype == TYPE_SR:
                    self.last_sr = pkt
        except ValueError:
            pass

    def _rtcp_tick(self) -> None:
        """Poll server SRs; send an RR about once a second."""
        if not self.props["do-rtcp"]:
            return
        if self._rtcp is not None:
            try:
                while True:
                    data, _ = self._rtcp.recvfrom(65536)
                    self._handle_rtcp(data)
            except (BlockingIOError, socket.timeout, OSError):
                pass
        now = time.time()
        if now - self._last_rr_time < 1.0 or not self._sources:
            return
        self._last_rr_time = now
        from .rtcp import build_rr
        rr = build_rr(self._ssrc, list(self._sources.values()))
        try:
            if self._conn is not None and self._udp is None:
                ch = 1
                self._conn.sendall(b"$" + bytes([ch])
                                   + len(rr).to_bytes(2, "big") + rr)
            elif self._rtcp is not None:
                st = getattr(self, "_server_transport", None)
                if st is not None and st.server_port[1]:
                    url = RTSPUrl.parse(self.props["location"])
                    self._rtcp.sendto(rr, (url.host,
                                           st.server_port[1]))
            self.rr_sent += 1
        except OSError:
            pass

    # -- interleaved TCP receive ------------------------------------------
    def _create_tcp(self, deadline_pkts: int) -> Optional[list]:
        pkts = []
        self._conn.settimeout(self.props["timeout"])
        while len(pkts) < deadline_pkts:
            # frame: '$' channel u16-length payload
            while len(self._pending) >= 4 and self._pending[0] == 0x24:
                ln = int.from_bytes(self._pending[2:4], "big")
                if len(self._pending) < 4 + ln:
                    break
                ch = self._pending[1]
                payload = self._pending[4:4 + ln]
                self._pending = self._pending[4 + ln:]
                if ch == 0:
                    pkts.append(payload)
                else:
                    self._handle_rtcp(payload)
            if self._pending[:1] not in (b"", b"$"):
                # interleaved RTSP message (e.g. server request): skip
                # to the next frame marker
                idx = self._pending.find(b"$")
                self._pending = b"" if idx < 0 else self._pending[idx:]
            if pkts and len(self._pending) < 4:
                break
            try:
                chunk = self._conn.recv(65536)
            except socket.timeout:
                self._timeouts += 1
                if self._timeouts >= self.props["eos-timeouts"]:
                    return pkts or None
                continue
            if not chunk:
                return pkts or None
            self._timeouts = 0
            self._pending += chunk
        return pkts

    def create(self, n_frames: int) -> Optional[Buffer]:
        deadline_pkts = 512
        if self._udp is None:                      # TCP interleaved
            pkts = self._create_tcp(deadline_pkts)
            if pkts is None:
                return None
        else:
            pkts = []
            while len(pkts) < deadline_pkts:
                try:
                    data, _ = self._udp.recvfrom(65536)
                    pkts.append(data)
                    self._timeouts = 0
                    # drain whatever else is queued without blocking
                    self._udp.settimeout(0.0)
                    try:
                        while len(pkts) < deadline_pkts:
                            data, _ = self._udp.recvfrom(65536)
                            pkts.append(data)
                    except (BlockingIOError, socket.error):
                        pass
                    finally:
                        self._udp.settimeout(self.props["timeout"])
                    break
                except socket.timeout:
                    self._timeouts += 1
                    if self._timeouts >= self.props["eos-timeouts"]:
                        return None                  # EOS
        if not pkts:
            return None
        for pkt in pkts:
            self._note_rtp(pkt)
        self._rtcp_tick()
        return Buffer(data=pkts, batch=1)


# ---------------------------------------------------------------------------
# rtspclientsink (RECORD publisher element)
# ---------------------------------------------------------------------------

@register_element
class RTSPClientSink(SinkElement):
    """rtspclientsink (gst-rtsp-server/gst/rtsp-sink/gstrtspclientsink.c
    reduced): publishes a payloaded RTP stream to an RTSP server in
    RECORD mode — OPTIONS/ANNOUNCE(SDP)/SETUP(mode=RECORD)/RECORD,
    then RTP over UDP (or TCP-interleaved) to the server's ports."""
    FACTORY = "rtspclientsink"
    DESCRIPTION = "Send data over the network via RTSP RECORD"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host packets
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 "application/x-rtp")]
    PROPERTIES = {
        "location": (str, "", "rtsp:// URL"),
        "protocols": (str, "udp", "transport: udp or tcp"),
        "user-id": (str, "", "authentication user"),
        "user-pw": (str, "", "authentication password"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._conn = None
        self._udp = None
        self._cseq = 0
        self._session = None
        self._server_transport = None
        self._auth_challenge = None
        self.packets_sent = 0

    # a trimmed copy of rtspsrc's call/auth helpers (client duties
    # are identical; gstrtspclientsink.c shares them via gstrtsp lib)
    def _credentials(self):
        user = self.props.get("user-id", "")
        pw = self.props.get("user-pw", "")
        if not user and self.props["location"]:
            url = RTSPUrl.parse(self.props["location"])
            user, pw = url.user or "", url.password or ""
        return user, pw

    def _call(self, method, uri, headers=(), body=b"",
              _retried=False):
        self._cseq += 1
        req = RTSPMessage.request(method, uri)
        req.headers.set("CSeq", str(self._cseq))
        if self._session:
            req.headers.set("Session", self._session)
        if self._auth_challenge is not None:
            from .rtsp_auth import build_authorization
            user, pw = self._credentials()
            auth = build_authorization(self._auth_challenge, user, pw,
                                       method, uri)
            if auth:
                req.headers.set("Authorization", auth)
        for k, v in headers:
            req.headers.set(k, v)
        req.body = body
        self._conn.sendall(req.serialize())
        data = b""
        while True:
            chunk = self._conn.recv(65536)
            if not chunk:
                raise ConnectionError("RTSP connection closed")
            data += chunk
            msg, _used = parse_message(data)
            if msg is not None:
                break
        if msg.status == 401 and not _retried:
            user, _pw = self._credentials()
            if user:
                chals = [v for k, v in msg.headers.items()
                         if k.lower() == "www-authenticate"]
                chals.sort(key=lambda c:
                           0 if c.lower().startswith("digest") else 1)
                if chals:
                    self._auth_challenge = chals[0]
                    return self._call(method, uri, headers, body,
                                      _retried=True)
        return msg

    def _sdp_from_caps(self) -> SDPMessage:
        caps = self.sink_pads()[0].caps
        s = caps[0] if caps is not None and len(caps) else None
        media = "video"
        pt, enc, rate, ch = 96, "RAW", 90000, 1
        if s is not None:
            media = s.get("media") or media
            pt = s.get("payload") or pt
            enc = s.get("encoding-name") or enc
            rate = s.get("clock-rate") or rate
            ch = s.get("channels") or ch
        sdp = SDPMessage(origin="- 0 0 IN IP4 127.0.0.1",
                         session_name="gstreamer_tpu RECORD",
                         connection="IN IP4 127.0.0.1",
                         times=["0 0"])
        m = SDPMedia(media=media, port=0, proto="RTP/AVP",
                     formats=[str(pt)])
        rm = f"{pt} {enc}/{rate}"
        if media == "audio" and ch:
            rm += f"/{ch}"
        m.attributes.append(("rtpmap", rm))
        if s is not None and s.get("width"):
            sampling = _SAMPLING.get(s.get("format") or "", "RGB")
            m.attributes.append(
                ("fmtp", f"{pt} sampling={sampling}; depth=8; "
                         f"width={s.get('width')}; "
                         f"height={s.get('height')}"))
        m.attributes.append(("control", "stream=0"))
        sdp.medias.append(m)
        return sdp

    def start(self):
        url = RTSPUrl.parse(self.props["location"])
        self._conn = socket.create_connection((url.host, url.port),
                                              timeout=5.0)
        uri = self.props["location"]
        self._call("OPTIONS", uri)
        sdp = self._sdp_from_caps()
        resp = self._call("ANNOUNCE", uri,
                          [("Content-Type", "application/sdp")],
                          body=sdp.as_text().encode())
        if resp.status != 200:
            raise ConnectionError(f"ANNOUNCE failed: {resp.status}")
        if self.props["protocols"] == "tcp":
            t = RTSPTransport(protocol="RTP/AVP/TCP",
                              interleaved=(0, 1), mode="RECORD")
        else:
            self._udp = socket.socket(socket.AF_INET,
                                      socket.SOCK_DGRAM)
            self._udp.bind(("0.0.0.0", 0))
            t = RTSPTransport(
                client_port=(self._udp.getsockname()[1],
                             self._udp.getsockname()[1] + 1),
                mode="RECORD")
        resp = self._call("SETUP", uri.rstrip("/") + "/stream=0",
                          [("Transport", t.to_string())])
        if resp.status != 200:
            raise ConnectionError(f"SETUP failed: {resp.status}")
        self._session = (resp.headers.get("Session")
                         or "").split(";")[0]
        self._server_transport = RTSPTransport.parse(
            resp.headers.get("Transport") or "RTP/AVP")
        resp = self._call("RECORD", uri, [("Range", "npt=0-")])
        if resp.status != 200:
            raise ConnectionError(f"RECORD failed: {resp.status}")

    def render(self, buf: Buffer) -> str:
        from ..core.element import FlowReturn
        pkts = buf.data if isinstance(buf.data, list) else [buf.data]
        url = RTSPUrl.parse(self.props["location"])
        for pkt in pkts:
            if isinstance(pkt, (np.ndarray, torch.Tensor)):
                pkt = host_array(pkt).tobytes()
            if not isinstance(pkt, (bytes, bytearray)):
                continue
            if self._udp is not None:
                self._udp.sendto(
                    bytes(pkt),
                    (url.host, self._server_transport.server_port[0]))
            else:
                frame = (b"$\x00" + len(pkt).to_bytes(2, "big")
                         + bytes(pkt))
                self._conn.sendall(frame)
            self.packets_sent += 1
        return FlowReturn.OK

    def stop(self):
        try:
            if self._conn is not None and self._session:
                # give the server's UDP receive loop a beat to drain
                time.sleep(0.3)
                self._call("TEARDOWN", self.props["location"])
        except OSError:
            pass
        for s in (self._udp, self._conn):
            if s is not None:
                s.close()
        self._udp = self._conn = None
        self._session = None
