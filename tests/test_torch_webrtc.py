"""The port's WebRTC stack against the JAX package: ``net/srtp.py``,
``net/dtls.py``, ``net/dtls_elements.py``, ``net/ice.py``, ``net/sctp.py``
and ``net/webrtc.py``.

The JAX package's own tests of these modules (``tests/test_dtls_srtp.py``,
``test_dtls_elements.py``, ``test_ice.py`` and the SCTP cases of
``test_misc_elements2.py``) run again on the port (``on_port``), those under
a library's ``skipif`` too, skipped where the mark's condition holds, as in
the JAX package.  What is deterministic is held byte for byte at tolerance
0: SRTP at fixed keys and salts (ROC rollover, CSRCs and header
extensions included), SCTP packets, chunks and CRC32c, STUN messages at
fixed transaction ids, candidates.  What is random (keys, certificates,
ICE credentials and tie-breakers) is held on the wire: an agent of each
package against one of the other, a JAX ``webrtcbin`` offering to a port
``webrtcbin`` and the reverse, the DTLS elements of one package keying
SRTP with the other's.  Every socket binds port 0; every wait has a
deadline.
"""

import importlib
import inspect
import time

import numpy as np
import pytest

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.net import dtls as jdtls
from gstreamer_tpu.net import dtls_elements as jdtlse
from gstreamer_tpu.net import ice as jice
from gstreamer_tpu.net import sctp as jsctp
from gstreamer_tpu.net import srtp as jsrtp
from gstreamer_tpu.net.rtp import rtp_header

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.net import dtls as tdtls
from gstreamer_tpu_torch.net import dtls_elements as tdtlse
from gstreamer_tpu_torch.net import ice as tice
from gstreamer_tpu_torch.net import sctp as tsctp
from gstreamer_tpu_torch.net import srtp as tsrtp

import test_dtls_elements
import test_dtls_srtp
import test_ice
import test_misc_elements2
from test_torch_analytics import same_spec
from test_torch_captions import pair
from test_torch_flow import NET_TAIL_FACTORIES
from test_torch_rtp import (_cpu_make, _port_class, no_jax_elements,
                            on_port, packets)

DEADLINE = 10.0          # seconds a socket case waits for its condition
needs_ssl = pytest.mark.skipif(not jdtls.available(),
                               reason="system libssl not available")


# -- the JAX package's tests on the port --------------------------------------
def _skip_marks(module, fn, cls=None):
    marks = list(getattr(fn, "pytestmark", []))
    if cls is not None:
        marks += list(getattr(cls, "pytestmark", []))
    mod = getattr(module, "pytestmark", [])
    marks += list(mod if isinstance(mod, list) else [mod])
    return [m for m in marks if m.name == "skipif"]


def reference_cases(module, only=None, exclude=()):
    """(id, module, class name, function, parametrize args) of every test
    of a JAX test module (class methods and ``parametrize`` included),
    those under a ``skipif`` mark too: ``run_case`` skips them where the
    mark's condition holds, as pytest does for the JAX package.  `only`
    keeps the ids whose test name (after the module) starts with one of
    its prefixes; `exclude` drops ids the same way."""
    out = []

    def add(prefix, cls, fn):
        name = prefix.split("::", 1)[1]
        if only is not None and not name.startswith(tuple(only)):
            return
        if name.startswith(tuple(exclude)):
            return
        params = [m for m in getattr(fn, "pytestmark", [])
                  if m.name == "parametrize"]
        if params:
            names, values = params[0].args[:2]
            for k, v in enumerate(values):
                out.append((f"{prefix}[{k}]", module, cls, fn, names, v))
        else:
            out.append((prefix, module, cls, fn, None, None))

    for n, v in vars(module).items():
        if n.startswith("test_") and inspect.isfunction(v):
            add(f"{module.__name__}::{n}", None, v)
        elif n.startswith("Test") and inspect.isclass(v):
            for m, f in vars(v).items():
                if m.startswith("test_") and inspect.isfunction(f):
                    add(f"{module.__name__}::{n}::{m}", n, f)
    return out


def run_case(case, tmp_path, **fixtures):
    """Run a case of ``reference_cases`` on the port (skipped where its
    ``skipif`` condition holds); fails if it builds a JAX element."""
    _id, module, cls, fn, names, values = case
    for m in _skip_marks(module, fn, getattr(module, cls) if cls else None):
        if m.args and m.args[0]:
            pytest.skip(m.kwargs.get("reason", "skipif"))
    args = {}
    if names is not None:
        keys = [k.strip() for k in names.split(",")] if isinstance(
            names, str) else list(names)
        args.update(zip(keys, values if len(keys) > 1 else (values,)))
    params = list(inspect.signature(fn).parameters)
    fixtures = dict(fixtures, tmp_path=tmp_path)
    for p in params:
        if p in fixtures and p not in args:
            args[p] = fixtures[p]
    if cls is not None:
        args["self"] = _port_class(getattr(module, cls))()
    with no_jax_elements():
        return on_port(fn)(**args)


REFERENCE = (reference_cases(test_dtls_srtp)
             + reference_cases(test_dtls_elements)
             + reference_cases(test_ice, exclude=("TestWebRTCCrossProcess",))
             + reference_cases(test_misc_elements2, only=("test_sctp",)))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    run_case(case, tmp_path)


WEBRTC_FACTORIES = [f for f in NET_TAIL_FACTORIES
                    if f.startswith(("srtp", "dtls", "sctp", "webrtc"))]


@pytest.mark.parametrize("factory", WEBRTC_FACTORIES)
def test_factory_spec_matches_reference(factory):
    same_spec(factory)


# -- SRTP at fixed keys -------------------------------------------------------
def _rtp_packets(rng, n, seq0=0xFFF0, csrc=False, ext=False):
    out = []
    for i in range(n):
        p = bytearray(rtp_header(96, (seq0 + i) & 0xFFFF, 3000 * i,
                                 0x12345678 + (i % 2)))
        if csrc:
            p[0] |= 2
            p += rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
        if ext:
            p[0] |= 0x10
            p += b"\xbe\xde\x00\x02" + rng.integers(
                0, 256, 8, dtype=np.uint8).tobytes()
        p += rng.integers(0, 256, int(rng.integers(0, 1400)),
                          dtype=np.uint8).tobytes()
        out.append(bytes(p))
    return out


@needs_ssl
@pytest.mark.parametrize("csrc,ext", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_srtp_packets_match_byte_for_byte(csrc, ext):
    rng = np.random.default_rng(7 + 2 * csrc + ext)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    salt = rng.integers(0, 256, 14, dtype=np.uint8).tobytes()
    pkts = _rtp_packets(rng, 40, csrc=csrc, ext=ext)   # crosses 65535
    js, ts = jsrtp.SrtpSession(key, salt), tsrtp.SrtpSession(key, salt)
    assert (ts.enc_key, ts.auth_key, ts.salt) == \
        (js.enc_key, js.auth_key, js.salt)
    prot = [ts.protect(p) for p in pkts]
    assert prot == [js.protect(p) for p in pkts]
    jd, td = jsrtp.SrtpSession(key, salt), tsrtp.SrtpSession(key, salt)
    assert [td.unprotect(p) for p in prot] == pkts
    assert [jd.unprotect(p) for p in prot] == pkts
    bad = bytearray(prot[3])
    bad[-1] ^= 1
    assert td.unprotect(bytes(bad)) is None


@needs_ssl
@pytest.mark.parametrize("label,n", [(0, 16), (1, 20), (2, 14), (5, 33)])
def test_srtp_kdf_matches(label, n):
    key, salt = bytes(range(16)), bytes(range(100, 114))
    assert tsrtp.srtp_kdf(key, salt, label, n) == \
        jsrtp.srtp_kdf(key, salt, label, n)


@needs_ssl
def test_srtp_elements_match():
    rng = np.random.default_rng(3)
    key = rng.integers(0, 256, 30, dtype=np.uint8).tobytes().hex()
    pkts = _rtp_packets(rng, 12, seq0=10)
    pushes = {"in": [dict(data=pkts[k:k + 4], pts=k) for k in (0, 4, 8)]}
    for desc in (f"srtpenc key={key} ! srtpdec key={key}",
                 f"srtpenc key={key}"):
        pair(f"appsrc name=in caps=application/x-rtp ! {desc} ! "
             "appsink name=out", pushes)


# -- SCTP -------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sctp_packets_match(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(1, 3000)),
                        dtype=np.uint8).tobytes()
    assert tsctp.crc32c(data) == jsctp.crc32c(data)
    chunks = [(int(rng.integers(0, 2**32)), int(rng.integers(0, 9)),
               int(rng.integers(0, 2**16)), 53,
               rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes(), bool(k % 2))
              for k in range(5)]
    tch = [tsctp.build_data_chunk(*c) for c in chunks]
    assert tch == [jsctp.build_data_chunk(*c) for c in chunks]
    pkt = tsctp.build_packet(5000, 5001, 0xABCDEF, tch)
    assert pkt == jsctp.build_packet(5000, 5001, 0xABCDEF, tch)
    assert tsctp.parse_packet(pkt) == jsctp.parse_packet(pkt)
    assert tsctp.build_sack(chunks[0][0]) == jsctp.build_sack(chunks[0][0])


def _sctp_run(make, buffer, pushes):
    enc, dec = make("sctpenc"), make("sctpdec")
    dec.start()
    wire, out = [], []
    for ins in pushes:
        b = enc.host_aggregate({k: buffer(data=np.frombuffer(v, np.uint8),
                                          batch=1, meta={"ppid": p})
                                for k, (v, p) in ins.items()})
        wire.append(packets(b.data))
    order = [1, 0, 3, 2, 4]                  # reordered on the wire
    for i in order:
        o = dec.host_process(buffer(data=list(wire[i]), batch=1))
        if o is not None:
            out.append(([bytes(np.asarray(x).tobytes()) for x in o.data],
                        o.meta["sctp_streams"]))
    return wire, out, dec.sacks


def test_sctp_elements_match():
    rng = np.random.default_rng(11)
    pushes = [{f"sink_{s}": (rng.integers(0, 256, 40 + 9 * s + k,
                                          dtype=np.uint8).tobytes(),
                             51 + (s % 3))
               for s in range(1 + k % 3)} for k in range(5)]
    assert _sctp_run(_cpu_make, Buffer, pushes) == \
        _sctp_run(jmake, JBuffer, pushes)


# -- STUN and ICE -----------------------------------------------------------
def test_stun_messages_match():
    txid = bytes(range(12))
    attrs = [(jice.ATTR_USERNAME, b"abcd:efgh"),
             (jice.ATTR_PRIORITY, b"\x6e\x00\x1e\xff"),
             (jice.ATTR_ICE_CONTROLLING, bytes(8)),
             (jice.ATTR_USE_CANDIDATE, b""),
             jice.xor_address_attr("127.0.0.1", 40000)]
    for key in (None, b"pwdpwdpwdpwdpwdpwdpwdpwd"):
        for fp in (False, True):
            raw = tice.build_stun(tice.BINDING_REQUEST, txid, attrs,
                                  integrity_key=key, fingerprint=fp)
            assert raw == jice.build_stun(jice.BINDING_REQUEST, txid,
                                          attrs, integrity_key=key,
                                          fingerprint=fp)
            t, j = tice.parse_stun(raw), jice.parse_stun(raw)
            assert (t.msg_type, t.txid, t.attrs, t.raw) == \
                (j.msg_type, j.txid, j.attrs, j.raw)
            assert t.xor_mapped() == j.xor_mapped() == ("127.0.0.1", 40000)
            if key is not None:
                assert t.check_integrity(key) and j.check_integrity(key)
            assert tice.is_stun(raw) and jice.is_stun(raw)
    assert tice.xor_address_attr("10.1.2.3", 5) == \
        jice.xor_address_attr("10.1.2.3", 5)


@pytest.mark.parametrize("line", [
    "candidate:1 1 UDP 2130706431 127.0.0.1 40000 typ host",
    "srflx1 1 udp 1677721855 203.0.113.9 5000 typ srflx raddr 0.0.0.0 "
    "rport 40000",
    "1 1 TCP 1 127.0.0.1 9 typ host"])
def test_candidates_match(line):
    t, j = tice.IceCandidate.from_sdp(line), jice.IceCandidate.from_sdp(line)
    assert (t is None) == (j is None)
    if t is not None:
        assert vars(t) == vars(j) and t.to_sdp() == j.to_sdp()


def _wait(cond, deadline=DEADLINE):
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("port_controls", [False, True])
def test_ice_agents_across_packages(port_controls):
    """An agent of each package: checks, nomination, media both ways."""
    ctl = (tice if port_controls else jice).IceAgent(controlling=True)
    ced = (jice if port_controls else tice).IceAgent(controlling=False)
    try:
        for a, b in ((ctl, ced), (ced, ctl)):
            a.set_remote_credentials(b.local_ufrag, b.local_pwd)
        for a, b in ((ctl, ced), (ced, ctl)):
            for c in a.gather():
                b.add_remote_candidate(
                    _pkg(b, "net.ice").IceCandidate.from_sdp(c.to_sdp()))
        ctl.start()
        ced.start()
        assert _wait(lambda: ctl.state == ced.state == "connected")
        ctl.send(b"\x80" + bytes(30))
        assert ced.recv(timeout=DEADLINE) == b"\x80" + bytes(30)
        ced.send(b"\x80\x01" + bytes(20))
        assert ctl.recv(timeout=DEADLINE) == b"\x80\x01" + bytes(20)
    finally:
        ctl.close()
        ced.close()


# -- DTLS across packages ---------------------------------------------------
@needs_ssl
@pytest.mark.parametrize("port_is_client", [False, True])
def test_dtls_handshake_across_packages(port_is_client):
    """A port agent and a JAX agent complete a handshake; both export the
    same SRTP keys, and each sees the other's certificate."""
    ta, ja = tdtls.DtlsAgent(), jdtls.DtlsAgent()
    cli = (ta if port_is_client else ja).connection(is_client=True)
    srv = (ja if port_is_client else ta).connection(is_client=False)
    cli.pump()
    for _ in range(20):
        if cli.complete and srv.complete:
            break
        out = cli.take_outgoing()
        if out:
            srv.feed_incoming(out)
        out = srv.take_outgoing()
        if out:
            cli.feed_incoming(out)
    assert cli.complete and srv.complete
    assert cli.export_srtp_keys() == srv.export_srtp_keys()
    assert cli.selected_srtp_profile() == srv.selected_srtp_profile() \
        == "SRTP_AES128_CM_SHA1_80"
    (csend, _), (srecv, _) = (cli.srtp_send_recv_keys()[0],
                              srv.srtp_send_recv_keys()[1])
    assert csend == srecv
    assert cli.peer_fingerprint() == (ja if port_is_client
                                      else ta).fingerprint()
    assert srv.peer_fingerprint() == (ta if port_is_client
                                      else ja).fingerprint()
    cli.write_app(b"app data" * 20)
    srv.feed_incoming(cli.take_outgoing())
    assert srv.read_app() == b"app data" * 20


def _blobs(buf):
    return [] if buf is None else packets(buf.data)


@needs_ssl
def test_dtls_srtp_elements_across_packages():
    """A JAX dtlssrtpenc/dec pair (client) and a port pair (server) ferry
    their handshake through each other, then RTP protected by either
    comes out of the other's decoder as it went in."""
    jdtlse._release_connection("xj"), tdtlse._release_connection("xt")
    je = jmake("dtlssrtpenc", connection_id="xj", is_client=True)
    jd = jmake("dtlssrtpdec", connection_id="xj", is_client=True)
    te = _cpu_make("dtlssrtpenc", connection_id="xt", is_client=False)
    td = _cpu_make("dtlssrtpdec", connection_id="xt", is_client=False)
    try:
        for e in (je, jd, te, td):
            e.start()
        for _ in range(10):
            for rec in _blobs(je.host_process(None)):
                td.host_process(Buffer(data=[rec], batch=1))
            for rec in _blobs(te.host_process(None)):
                jd.host_process(JBuffer(data=[rec], batch=1))
        assert je._conn().complete and te._conn().complete
        media = [rtp_header(96, 7 + i, 90 * i, 0xFACE) + bytes([i]) * 60
                 for i in range(4)]
        wire = [w for w in _blobs(je.host_process(JBuffer(data=media,
                                                          batch=4)))
                if 128 <= w[0] <= 191]
        assert len(wire) == 4 and all(m[12:] not in w
                                      for m, w in zip(media, wire))
        back = [p for w in wire
                for p in _blobs(td.host_process(Buffer(data=[w], batch=1)))]
        assert back == media
        wire = [w for w in _blobs(te.host_process(Buffer(data=media,
                                                         batch=4)))
                if 128 <= w[0] <= 191]
        back = [p for w in wire
                for p in _blobs(jd.host_process(JBuffer(data=[w],
                                                        batch=1)))]
        assert back == media
    finally:
        for e in (je, jd, te, td):
            e.stop()


# -- webrtcbin across packages ---------------------------------------------
def _pkg(obj, module):
    """`module` (a path under the package) of the package `obj` is from."""
    return importlib.import_module(
        type(obj).__module__.split(".")[0] + "." + module)


def _desc(bin_, kind, text):
    """A session description of `bin_`'s package, parsed from `text`."""
    return _pkg(bin_, "net.webrtc").WebRTCSessionDescription(
        kind, _pkg(bin_, "net.sdp").SDPMessage.parse(text))


def _webrtc_pair(offerer, answerer):
    """Offer and answer between two webrtcbins, through SDP text."""
    offerer.add_transceiver("sendrecv", "video", pt=26,
                            encoding_name="JPEG", clock_rate=90000)
    offer = offerer.create_offer()
    offerer.set_local_description(offer)
    answerer.set_remote_description(_desc(answerer, "offer",
                                          offer.as_text()))
    answer = answerer.create_answer()
    answerer.set_local_description(answer)
    offerer.set_remote_description(_desc(offerer, "answer",
                                         answer.as_text()))


@needs_ssl
@pytest.mark.parametrize("port_offers", [False, True])
def test_webrtcbin_across_packages(port_offers):
    """A JAX webrtcbin offers to a port webrtcbin, and the reverse: both
    reach "connected" over ICE and DTLS-SRTP, and RTP packets round-trip
    both ways, never in plaintext on the wire."""
    t, j = _cpu_make("webrtcbin"), jmake("webrtcbin")
    a, b = (t, j) if port_offers else (j, t)
    try:
        _webrtc_pair(a, b)
        assert _wait(lambda: a.connection_state == "connected"
                     and b.connection_state == "connected"), \
            (a.connection_state, b.connection_state)
        for snd, rcv, buf in ((a, b, JBuffer if a is j else Buffer),
                              (b, a, JBuffer if b is j else Buffer)):
            pkts = [rtp_header(26, 100 + i, 3000 * i, 0xC0FFEE)
                    + bytes([i]) * (200 + i) for i in range(5)]
            snd.render(buf(data=pkts, batch=1))
            got = []
            end = time.monotonic() + DEADLINE
            while len(got) < len(pkts) and time.monotonic() < end:
                got += rcv.pull_received()
            assert got == pkts
        assert t.stats["auth_failed"] == 0
        assert t.stats["sent"] == 5 and t.stats["received"] == 5
    finally:
        a.stop()
        b.stop()


@needs_ssl
def test_webrtcbin_counts_what_it_drops():
    """Media rendered before the connection is up is counted, not lost
    without a trace (the JAX package returns OK and forgets it)."""
    t = _cpu_make("webrtcbin")
    try:
        t.render(Buffer(data=[rtp_header(96, 1, 0, 1) + b"x"] * 3, batch=1))
        assert t.stats["dropped_unconnected"] == 3 and t.stats["sent"] == 0
    finally:
        t.stop()


def _port_peer_proc(offer_text, answer_q, done_q):
    """test_ice's answerer process on the port (a function rebound by
    ``on_port`` cannot be sent to a spawned process)."""
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.net.sdp import SDPMessage
    from gstreamer_tpu_torch.net.webrtc import WebRTCSessionDescription
    b = element_factory_make("webrtcbin")
    b.set_remote_description(WebRTCSessionDescription(
        "offer", SDPMessage.parse(offer_text)))
    answer = b.create_answer()
    b.set_local_description(answer)
    answer_q.put(answer.as_text())
    end = time.time() + 15.0
    while time.time() < end and b.connection_state not in ("connected",
                                                             "failed"):
        time.sleep(0.05)
    got = []
    if b.connection_state == "connected":
        for _ in range(40):
            got = b.pull_received()
            if got:
                break
    done_q.put((b.connection_state, got[0] if got else None))
    b.stop()


@needs_ssl
def test_two_processes_exchange_encrypted_media_on_the_port():
    """test_ice's TestWebRTCCrossProcess case with the port's webrtcbin in
    both processes: SDP over a queue, ICE over UDP, DTLS-SRTP media."""
    import multiprocessing as mp
    import struct
    ctx = mp.get_context("spawn")
    answer_q, done_q = ctx.Queue(), ctx.Queue()
    a = _cpu_make("webrtcbin")
    a.add_transceiver("sendrecv", "audio", pt=0, encoding_name="PCMU",
                      clock_rate=8000)
    offer = a.create_offer()
    a.set_local_description(offer)
    proc = ctx.Process(target=_port_peer_proc,
                       args=(offer.as_text(), answer_q, done_q))
    proc.start()
    try:
        a.set_remote_description(_desc(a, "answer",
                                       answer_q.get(timeout=60)))
        assert _wait(lambda: a.connection_state in ("connected", "failed"))
        assert a.connection_state == "connected"
        pkt = struct.pack("!BBHII", 0x80, 0, 42, 1000, 0xABCD) + b"U" * 40
        state = payload = None
        end = time.time() + DEADLINE
        while time.time() < end:
            a.render(Buffer(data=[pkt], batch=1))
            try:
                state, payload = done_q.get(timeout=0.5)
                break
            except Exception:
                continue
        assert (state, payload) == ("connected", pkt)
    finally:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.terminate()
        a.stop()


def test_ice_module_is_a_copy():
    """STUN constants and the candidate priority formula as the JAX
    package's."""
    for name in ("MAGIC", "BINDING_REQUEST", "BINDING_SUCCESS",
                 "ATTR_FINGERPRINT", "FINGERPRINT_XOR"):
        assert getattr(tice, name) == getattr(jice, name)
    for typ in ("host", "srflx", "prflx"):
        assert tice._candidate_priority(typ, 65535) == \
            jice._candidate_priority(typ, 65535)
