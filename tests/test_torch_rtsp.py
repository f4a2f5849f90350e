"""The port's RTSP, SDP, RTCP and session modules against the JAX package,
bit for bit: ``net/rtsp.py`` (messages, transports, URLs),
``net/rtsp_auth.py`` (Basic and Digest), ``net/rtsp_server.py``
(RTSPServer with its factories, mount points, address pool and RECORD;
rtspsrc over UDP and TCP interleaved with RTCP SR / RR; rtspclientsink),
``net/sdp.py`` (parser, writer, sdpdemux, sdpsrc, rtpsrc, rtpsink),
``net/rtcp.py`` and ``net/rtpmanager.py`` (RtpSource, rtpsession, rtpbin).

The JAX package's ``tests/test_rtsp.py``, ``test_rtsp_auth_record.py``,
``test_sdp.py``, ``test_sdp_fuzz.py`` and the rtpsession / rtpbin / RTCP
classes of ``test_ringbuffer_rtpmanager.py`` run again on the port's
modules, their server fixtures too (``on_port``; the media factories' and
the client's pipelines on the CPU).  Only the multicast end-to-end case is
left out: it sends to a multicast group.  The same inputs through both
packages give the same bytes and fields, tolerance 0.  Every socket case
binds port 0 and is bounded by the elements' own timeouts.
"""

import contextlib
import inspect

import numpy as np
import pytest

from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.net import rtcp as jrtcp
from gstreamer_tpu.net import rtpmanager as jmgr
from gstreamer_tpu.net import rtsp as jrtsp
from gstreamer_tpu.net import rtsp_auth as jauth
from gstreamer_tpu.net import rtsp_server as jserver
from gstreamer_tpu.net import sdp as jsdp
from gstreamer_tpu.net.rtp import rtp_header

from gstreamer_tpu_torch.core.parse import parse_launch as tparse_launch
from gstreamer_tpu_torch.net import rtcp as trtcp
from gstreamer_tpu_torch.net import rtpmanager as tmgr
from gstreamer_tpu_torch.net import rtsp as trtsp
from gstreamer_tpu_torch.net import rtsp_auth as tauth
from gstreamer_tpu_torch.net import rtsp_server as tserver
from gstreamer_tpu_torch.net import sdp as tsdp

import test_ringbuffer_rtpmanager
import test_rtsp
import test_rtsp_auth_record
import test_sdp
import test_sdp_fuzz
from test_torch_captions import pair, plain
from test_torch_mpegts import dplain
from test_torch_rtp import no_jax_elements, on_port, reference_tests, \
    run_on_port
from test_torch_rtp_payloaders import jpegs

FIXTURES = {"server": test_rtsp.server,
            "auth_server": test_rtsp_auth_record.auth_server,
            "record_server": test_rtsp_auth_record.record_server}
REFERENCE = (
    reference_tests(test_rtsp)
    + reference_tests(test_rtsp_auth_record, exclude=(
        "test_rtsp_auth_record::TestMulticast::test_rtspsrc_udp_mcast_e2e",))
    + reference_tests(test_sdp) + reference_tests(test_sdp_fuzz)
    + [c for c in reference_tests(test_ringbuffer_rtpmanager)
       if "::TestRtpSession::" in c[0] or "::TestRtcp::" in c[0]])


@contextlib.contextmanager
def port_fixture(fixture, **kw):
    """A fixture of the JAX package's tests, run on the port."""
    gen = on_port(fixture)(**kw)
    if not inspect.isgenerator(gen):
        yield gen
        return
    value = next(gen)
    try:
        yield value
    finally:
        next(gen, None)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    _id, fn, names, values = case
    with contextlib.ExitStack() as stack:
        stack.enter_context(no_jax_elements())     # the fixtures too
        fx = {}
        for name in inspect.signature(fn).parameters:
            if name in FIXTURES:
                fix = FIXTURES[name]
                wants = inspect.signature(
                    fix._get_wrapped_function()).parameters
                kw = {"tmp_path": tmp_path} if "tmp_path" in wants else {}
                fx[name] = stack.enter_context(port_fixture(fix, **kw))
        run_on_port(fn, names, values, tmp_path, **fx)


# -- messages, transports, URLs, authentication --------------------------------
MESSAGES = [
    b"OPTIONS rtsp://127.0.0.1:8554/test RTSP/1.0\r\nCSeq: 1\r\n\r\n",
    b"RTSP/1.0 200 OK\r\nCSeq: 2\r\nContent-Type: application/sdp\r\n"
    b"Content-Length: 12\r\n\r\nv=0\r\ns=x\r\nzz",
    b"SETUP rtsp://h/a/stream=0 RTSP/1.0\r\nCSeq: 3\r\nTransport: "
    b"RTP/AVP;unicast;client_port=4000-4001\r\nSession: abc;timeout=60\r\n"
    b"\r\n",
    b"RTSP/1.0 401 Unauthorized\r\nCSeq: 4\r\nWWW-Authenticate: Basic "
    b"realm=\"r\"\r\nWWW-Authenticate: Digest realm=\"r\", nonce=\"n\"\r\n"
    b"\r\n",
    b"PLAY rtsp://h/a RTSP/1.0\r\nCSeq: 5\r\n",            # partial
    b"GET_PARAMETER rtsp://h/a RTSP/1.0\r\nCSeq: 6\r\nContent-Length: 4\r\n"
    b"\r\nab"]                                               # short body


def _msg(m):
    if m is None:
        return None
    return (m.method, m.uri, m.status, m.reason, list(m.headers.items()),
            m.body, m.serialize())


@pytest.mark.parametrize("data", MESSAGES)
def test_messages_parse_and_serialize(data):
    (jm, ju), (tm, tu) = jrtsp.parse_message(data), trtsp.parse_message(data)
    assert (_msg(tm), tu) == (_msg(jm), ju)


@pytest.mark.parametrize("text", [
    "RTP/AVP;unicast;client_port=5000-5001",
    "RTP/AVP/TCP;unicast;interleaved=0-1",
    "RTP/AVP;multicast;destination=239.255.42.7;port=5002-5003;ttl=3",
    "RTP/AVP;unicast;client_port=5000-5001;server_port=6000-6001;"
    "ssrc=1A2B3C4D;mode=RECORD",
    "RTP/AVP"])
def test_transport_fields(text):
    j, t = jrtsp.RTSPTransport.parse(text), trtsp.RTSPTransport.parse(text)
    assert dplain(t) == dplain(j)
    assert t.to_string() == j.to_string()
    assert t.is_tcp == j.is_tcp


@pytest.mark.parametrize("url", ["rtsp://127.0.0.1:8554/test",
                                 "rtsp://user:pw@cam.local/live/ch0?x=1",
                                 "rtsp://h/a/stream=0", "rtsp://h"])
def test_urls(url):
    assert dplain(trtsp.RTSPUrl.parse(url)) == \
        dplain(jrtsp.RTSPUrl.parse(url))


def test_authentication_matches(monkeypatch):
    """The same challenges, answers and verdicts (the nonces and cnonces
    drawn from one seeded stream in both packages)."""
    def fixed_tokens():
        rng = np.random.default_rng(5)
        return lambda n=16: bytes(rng.integers(0, 256, n,
                                               dtype=np.uint8)).hex()

    got = []
    for mod in (jauth, tauth):
        monkeypatch.setattr(mod.secrets, "token_hex", fixed_tokens())
        auth = mod.RTSPAuth(realm="cams")
        auth.add_user("user", "pw")
        auth.add_user("viewer", "v", paths={"/public"})
        chals = auth.challenge_headers()
        rows = [chals]
        for _k, chal in chals:
            for user, pw in (("user", "pw"), ("user", "no"),
                             ("viewer", "v")):
                hdr = mod.build_authorization(chal, user, pw, "DESCRIBE",
                                              "rtsp://h/test")
                rows.append((hdr, auth.check(hdr, "DESCRIBE",
                                             "rtsp://h/test", "/test")))
        rows.append(mod.digest_response("u", "r", "p", "PLAY", "rtsp://h/",
                                        "n1", "00000001", "c1", "auth"))
        got.append(rows)
    assert got[1] == got[0]


# -- SDP --------------------------------------------------------------------
def _sdps():
    """The JAX tests' SDPs and seeded variations of them (the fuzz file's
    seeds 3, 7 and 11): ports, payload types, rates, channels, fmtp."""
    out = [test_sdp.SDP_TEXT, test_sdp_fuzz.SDP]
    for seed in (3, 7, 11):
        rng = np.random.default_rng(seed)
        lines = ["v=0", f"o=- {rng.integers(0, 1 << 31)} 0 IN IP4 10.0.0.1",
                 f"s=seed {seed}", "c=IN IP4 10.0.0.1", "t=0 0",
                 "a=tool:fuzz"]
        for m in range(int(rng.integers(1, 4))):
            pt = int(rng.integers(96, 128))
            kind = ["audio", "video"][int(rng.integers(0, 2))]
            enc = (["L16", "OPUS", "PCMU"] if kind == "audio"
                   else ["RAW", "JPEG", "H264", "VP8"])[
                int(rng.integers(0, 3))]
            rate = int(rng.choice([8000, 48000, 90000]))
            lines.append(f"m={kind} {int(rng.integers(1024, 65535))} "
                         f"RTP/AVP {pt}")
            ch = f"/{int(rng.integers(1, 3))}" if kind == "audio" else ""
            lines.append(f"a=rtpmap:{pt} {enc}/{rate}{ch}")
            if enc == "RAW":
                lines.append(f"a=fmtp:{pt} sampling=YCbCr-4:2:2; depth=8; "
                             f"width={int(rng.integers(2, 2000))}; "
                             f"height={int(rng.integers(2, 2000))}")
            lines.append(f"a=control:stream={m}")
        out.append("\r\n".join(lines) + "\r\n")
    return out


@pytest.mark.parametrize("text", _sdps())
def test_sdp_parse_write_and_caps(text):
    j, t = jsdp.SDPMessage.parse(text), tsdp.SDPMessage.parse(text)
    assert dplain(t) == dplain(j)
    assert t.as_text() == j.as_text()
    for jm, tm in zip(j.medias, t.medias):
        assert tm.rtpmaps() == jm.rtpmaps()
        for fmt in jm.formats:
            assert str(tsdp.media_to_caps(tm, int(fmt))) == \
                str(jsdp.media_to_caps(jm, int(fmt)))


# -- RTCP and the session statistics -------------------------------------------
def _session_run(mod, seed):
    rng = np.random.default_rng(seed)
    s = mod.RtpSession(clock_rate=90000)
    seqs = [q & 0xFFFF for q in range(65520, 65560)]
    rng.shuffle(seqs[10:20])
    del seqs[25]
    out = []
    for k, q in enumerate(seqs):
        s.process_packet(rtp_header(96, q, q * 3000, 0x1234 + (k % 2))
                         + bytes(int(rng.integers(1, 50))),
                         arrival_ns=k * 33_000_000
                         + int(rng.integers(0, 9_000_000)))
        if k % 13 == 12:
            out.append(s.create_rtcp(0xABCD, cname="cam@test"))
    out.append(dplain(s.stats()))
    out.append(dplain(s.process_rtcp(jrtcp.build_bye(0x1234))))
    out.append(dplain(s.stats()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_session_statistics_and_reports(seed):
    assert _session_run(tmgr, seed) == _session_run(jmgr, seed)


def test_rtcp_packets_match():
    srcs = [jmgr.RtpSource(7, 90000)]
    for q in (1, 2, 4, 5):
        srcs[0].process(q, q * 3000, 100, arrival_ns=q * 1000)
    blobs = [jrtcp.build_sr(9, jrtcp.ntp_time(1234.25), 90000, 10, 1000),
             jrtcp.build_bye(3), jrtcp.build_rr(9, srcs),
             jrtcp.build_generic_nack(1, 2, [5, 6, 7, 30]),
             jrtcp.build_rist_nack(4, [(10, 3)])]
    assert trtcp.build_sr(9, trtcp.ntp_time(1234.25), 90000, 10, 1000) == \
        blobs[0]
    assert trtcp.build_bye(3) == blobs[1]
    tsrc = tmgr.RtpSource(7, 90000)
    for q in (1, 2, 4, 5):
        tsrc.process(q, q * 3000, 100, arrival_ns=q * 1000)
    assert trtcp.build_rr(9, [tsrc]) == blobs[2]
    assert trtcp.build_generic_nack(1, 2, [5, 6, 7, 30]) == blobs[3]
    assert trtcp.build_rist_nack(4, [(10, 3)]) == blobs[4]
    compound = b"".join(blobs)
    assert dplain(trtcp.parse_compound(compound)) == \
        dplain(jrtcp.parse_compound(compound))
    nack = jrtcp.parse_compound(blobs[3])[0]
    assert trtcp.parse_generic_nack(trtcp.parse_compound(blobs[3])[0]) == \
        jrtcp.parse_generic_nack(nack)


@pytest.mark.parametrize("factory", ["rtpsession", "rtpbin latency=20",
                                     "rtpbin latency=0 do-lost=true"])
def test_session_elements_match(factory):
    from test_torch_rtp import _jitter_input
    jp, _, tp, _ = pair("appsrc name=in caps=application/x-rtp,"
                        f"clock-rate=90000 ! {factory} name=s ! "
                        "appsink name=out", {"in": _jitter_input(7)})
    js, ts = jp.get_by_name("s"), tp.get_by_name("s")
    stats = ("get_session_stats" if factory.startswith("rtpbin")
             else "get_stats")

    def nojitter(st):              # arrival times are the wall clock's
        return {k: ([dict(x, jitter=None) for x in v] if k == "sources"
                    else v) for k, v in st.items()}
    assert nojitter(getattr(ts, stats)()) == nojitter(getattr(js, stats)())


# -- the server ---------------------------------------------------------------
MJPEG = ("( multifilesrc location={d}/cam_%05d.jpg caps=image/jpeg,"
         "framerate=25/1 ! rtpjpegpay name=pay0 pt=26 )")


def _cam(tmp_path, n=6, w=96, h=64):
    for k, b in enumerate(jpegs(w, h, n)):
        (tmp_path / f"cam_{k:05d}.jpg").write_bytes(b)


def _describe(server_mod, factory_kw, tmp_path):
    import socket
    srv = server_mod.RTSPServer(service=0)
    srv.mount_points.add_factory("/cam", server_mod.RTSPMediaFactory(
        MJPEG.format(d=tmp_path), **factory_kw))
    port = srv.attach()
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        req = server_mod.RTSPMessage.request(
            "DESCRIBE", f"rtsp://127.0.0.1:{port}/cam")
        req.headers.set("CSeq", "1")
        resp = test_rtsp._raw_call(s, req) if server_mod is jserver \
            else on_port(test_rtsp._raw_call)(s, req)
        s.close()
        return resp
    finally:
        srv.shutdown()


def test_describe_coded_payloader_is_a_reference_fault(tmp_path):
    """A reference fault (ROADMAP.md section 3): the JAX server describes a
    media by its payloader's ``_info``, which rtpjpegpay (and every coded
    payloader) lacks, so DESCRIBE of an MJPEG camera answers 500.  The
    port describes a coded payloader by its RTP profile."""
    _cam(tmp_path, n=2)
    jresp = _describe(jserver, {}, tmp_path)
    assert jresp.status == 500
    assert "_info" in (jresp.headers.get("X-Error") or "")
    tresp = _describe(tserver, {"device": "cpu"}, tmp_path)
    assert tresp.status == 200
    media = tsdp.SDPMessage.parse(tresp.body.decode()).medias[0]
    assert (media.media, media.rtpmaps()) == ("video",
                                              {26: ("JPEG", 90000, 1)})


def _rgb(samples):
    return np.concatenate([np.stack([np.asarray(p) for p in s.buffer.data],
                                    axis=-1) for s in samples])


def _drain(pipe, name="out"):
    out = []
    while (s := pipe.get_by_name(name).pull_sample()) is not None:
        out.append(s)
    return out


@pytest.mark.parametrize("protocols", ["tcp", "udp"])
def test_rtsp_mjpeg_to_rgb(protocols, tmp_path):
    """The camera path of ``chip_smoke.py``'s ``rtsp_mjpeg_ingest`` and
    ``rtsp_mjpeg_udp`` at a small size: the RGB equals that of
    ``multifilesrc ! jpegdec`` of the same files (in both packages), and
    the server's sender reports reach rtspsrc, whose receiver reports
    reach the server."""
    w, h = 96, 64
    _cam(tmp_path, 6, w, h)
    srv = tserver.RTSPServer(service=0)
    srv.mount_points.add_factory("/cam", tserver.RTSPMediaFactory(
        MJPEG.format(d=tmp_path), rate_control=protocols == "udp",
        device="cpu"))
    port = srv.attach()
    caps = (f"video/x-raw,format=I420,width={w},height={h},framerate=25/1 ! "
            "videoconvertscale ! video/x-raw,format=RGB,width=32,height=32")
    try:
        p = tparse_launch(
            f"rtspsrc name=src location=rtsp://127.0.0.1:{port}/cam "
            f"protocols={protocols} timeout=1.0 eos-timeouts=3 ! "
            f"rtpjpegdepay ! jpegdec ! {caps} ! appsink name=out", batch=16,
            device="cpu")
        p.run()
        got = _rgb(_drain(p))
        src = p.get_by_name("src")
        sessions = list(srv._sessions.values())
        assert src.last_sr is not None and src.last_sr.packet_count > 0
        assert src.rr_sent >= 1
        stats = next(iter(src._sources.values()))
        assert stats.lost == 0
        if protocols == "udp" and sessions:
            assert sessions[0].sr_sent >= 1
    finally:
        srv.shutdown()
    _, files, _, files_port = pair(
        f"multifilesrc location={tmp_path}/cam_%05d.jpg caps=image/jpeg,"
        f"framerate=25/1 ! jpegdec ! {caps} ! appsink name=out")
    assert got.shape == (6, 32, 32, 3)
    np.testing.assert_array_equal(got, _rgb(files["out"]))
    assert plain(got) == plain(_rgb(files_port["out"]))


@pytest.mark.parametrize("protocols", ["udp", "tcp"])
def test_rtspclientsink_record_matches_reference(protocols, tmp_path):
    """RECORD through the port's rtspclientsink and through the JAX
    package's, to two mounts of one port server: the same frames land in
    each mount's file, byte for byte, from the same number of packets."""
    srv = tserver.RTSPServer(service=0)
    outs = {k: tmp_path / f"{k}.rgb" for k in ("jax", "port")}
    for k, out in outs.items():
        srv.mount_points.add_factory(f"/{k}", tserver.RTSPMediaFactory(
            "( appsrc name=depay0 caps=application/x-rtp ! "
            'rtpvrawdepay caps="video/x-raw,format=RGB,width=48,'
            f'height=32" ! filesink location={out} )',
            transport_mode="record", device="cpu"))
    port = srv.attach()
    desc = ("videotestsrc num-buffers=4 pattern=gradient ! "
            "video/x-raw,format=RGB,width=48,height=32,framerate=30/1 ! "
            "rtpvrawpay pt=96 ! rtspclientsink name=snk "
            "location=rtsp://127.0.0.1:{port}/{mount} "
            f"protocols={protocols}")
    try:
        j = jparse_launch(desc.format(port=port, mount="jax"))
        j.run()
        t = tparse_launch(desc.format(port=port, mount="port"),
                          device="cpu")
        assert type(t.get_by_name("snk")).__module__.startswith(
            "gstreamer_tpu_torch.")
        t.run()
    finally:
        srv.shutdown()
    sent = [p.get_by_name("snk").packets_sent for p in (j, t)]
    assert sent[0] == sent[1] > 0
    got = {k: out.read_bytes() for k, out in outs.items()}
    assert len(got["port"]) == 4 * 48 * 32 * 3
    assert got["port"] == got["jax"]
    assert np.frombuffer(got["port"], np.uint8).std() > 0


def _interleave(server_mod, reader_pause, total=8 << 20):
    """`total` bytes of 1400-byte RTP packets through the server's
    interleaved send on one end of a socket pair whose timeout is the
    RTSP connection's 0.25 s; the other end starts reading after
    `reader_pause` seconds.  Returns (the error the sender raised or None,
    the bytes the reader got)."""
    import socket
    import threading
    import time
    a, b = socket.socketpair()
    a.settimeout(0.25)
    sess = server_mod._Session(None, "127.0.0.1")
    sess.transport = server_mod.RTSPTransport(protocol="RTP/AVP/TCP",
                                              interleaved=(0, 1))
    sess.conn = a
    got = bytearray()

    def reader():
        time.sleep(reader_pause)
        b.settimeout(1.0)
        try:
            while chunk := b.recv(1 << 20):
                got.extend(chunk)
        except socket.timeout:
            pass
    t = threading.Thread(target=reader)
    t.start()
    pkt = rtp_header(96, 0, 0, 1) + bytes(1388)
    err = None
    try:
        for _ in range(total // len(pkt)):
            server_mod.RTSPServer._send_rtp(None, sess, pkt)
    except OSError as e:
        err = e
    a.close()
    t.join(10.0)
    b.close()
    return err, len(got)


def test_slow_tcp_reader_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3): the JAX server sends
    interleaved packets with sendall on the RTSP connection, whose timeout
    is its request loop's 0.25 s; a client that stops reading for longer
    ends the stream thread with TimeoutError.  The port's server tries a
    timed-out send again (``_send_all``) and every byte arrives once the
    client reads.  Then the port end to end: a TCP client that reads
    nothing for 1 s after PLAY gets all 20 frames of 640x480 RGB."""
    import socket
    jerr, jgot = _interleave(jserver, reader_pause=1.0)
    terr, tgot = _interleave(tserver, reader_pause=1.0)
    n = (8 << 20) // 1400 * (1400 + 4)
    assert isinstance(jerr, socket.timeout) and jgot < n
    assert terr is None and tgot == n
    frames, alive = _slow_tcp_reader(pause=1.0)
    assert alive and frames == 20


def _slow_tcp_reader(pause, frames=20):
    """A TCP-interleaved client of the port's server that reads nothing for
    `pause` seconds after PLAY: (marker packets it then reads, whether the
    server's stream thread outlived the pause)."""
    import socket
    import time
    srv = tserver.RTSPServer(service=0)
    srv.mount_points.add_factory("/big", tserver.RTSPMediaFactory(
        f"( videotestsrc num-buffers={frames} ! video/x-raw,format=RGB,"
        "width=640,height=480,framerate=30/1 ! rtpvrawpay name=pay0 pt=96 )",
        rate_control=False, device="cpu"))
    port = srv.attach()
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 16)
        s.settimeout(5)
        s.connect(("127.0.0.1", port))
        uri = f"rtsp://127.0.0.1:{port}/big"
        msg = tserver.RTSPMessage
        req = msg.request("SETUP", uri + "/stream=0")
        req.headers.set("CSeq", "1")
        req.headers.set("Transport", "RTP/AVP/TCP;unicast;interleaved=0-1")
        resp = on_port(test_rtsp._raw_call)(s, req)
        session = resp.headers.get("Session").split(";")[0]
        req = msg.request("PLAY", uri)
        req.headers.set("CSeq", "2")
        req.headers.set("Session", session)
        s.sendall(req.serialize())
        sess = srv._sessions[session]
        time.sleep(pause)              # not reading: the server stalls
        alive = sess.thread is not None and sess.thread.is_alive()
        data = bytearray()
        s.settimeout(1.0)
        while True:
            try:
                chunk = s.recv(1 << 20)
            except socket.timeout:
                break
            if not chunk:
                break
            data += chunk
        s.close()
    finally:
        srv.shutdown()
    # the PLAY response, then $-framed packets on channels 0 and 1
    pos, markers = data.find(b"\r\n\r\n") + 4, 0
    while pos + 4 <= len(data) and data[pos] == 0x24:
        ln = int.from_bytes(data[pos + 2:pos + 4], "big")
        pkt = data[pos + 4:pos + 4 + ln]
        if data[pos + 1] == 0 and len(pkt) == ln and pkt[1] & 0x80:
            markers += 1
        pos += 4 + ln
    return markers, alive


def _camera_sends_with_play(pkts):
    """A one-client RTSP camera that answers rtspsrc from canned texts
    (RGB 48x32 over RTP/AVP/TCP) and writes the whole interleaved stream
    in the same write as its PLAY response, then closes.  Returns its
    port."""
    import socket
    import threading
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10.0)
    port = srv.getsockname()[1]
    sdp = ("v=0\r\no=- 0 0 IN IP4 127.0.0.1\r\ns=cam\r\nc=IN IP4 127.0.0.1\r\n"
           "t=0 0\r\nm=video 0 RTP/AVP 96\r\na=rtpmap:96 RAW/90000\r\n"
           "a=fmtp:96 sampling=RGB; depth=8; width=48; height=32\r\n"
           "a=control:stream=0\r\n").encode()

    def serve():
        conn, _ = srv.accept()
        conn.settimeout(10.0)
        buf = b""
        while True:
            chunk = conn.recv(65536)
            if not chunk:
                break
            buf += chunk
            while b"\r\n\r\n" in buf:
                head, buf = buf.split(b"\r\n\r\n", 1)
                lines = head.decode().split("\r\n")
                method = lines[0].split()[0]
                cseq = next(x.split(":", 1)[1].strip() for x in lines
                            if x.lower().startswith("cseq"))
                extra, body = "", b""
                if method == "DESCRIBE":
                    body = sdp
                    extra = (f"Content-Type: application/sdp\r\nContent-Base:"
                             f" rtsp://127.0.0.1:{port}/cam/\r\n"
                             f"Content-Length: {len(body)}\r\n")
                elif method == "SETUP":
                    extra = ("Session: 1234\r\nTransport: RTP/AVP/TCP;"
                             "unicast;interleaved=0-1\r\n")
                out = (f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n{extra}\r\n"
                       .encode() + body)
                if method == "PLAY":
                    out += b"".join(b"$\x00" + len(p).to_bytes(2, "big") + p
                                    for p in pkts)
                conn.sendall(out)
                if method == "PLAY":
                    conn.close()
                    srv.close()
                    return
    threading.Thread(target=serve, daemon=True).start()
    return port


def test_interleaved_data_with_the_play_response_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3), the race behind the JAX
    package's flaky ``test_rtsp.py::TestTcpInterleaved``: rtspsrc reads
    its PLAY response with recv and drops whatever else that read holds,
    so a camera that starts its interleaved stream in the same write
    loses the frames, or the framing.  The port keeps those bytes for the
    stream: every frame arrives, equal to those sent."""
    from gstreamer_tpu.core.buffer import Buffer as JBuffer
    rng = np.random.default_rng(12)
    planes = tuple(rng.integers(0, 256, (3, 32, 48), dtype=np.uint8)
                   for _ in range(3))
    pay = jparse_launch("appsrc name=in caps=video/x-raw,format=RGB,width=48,"
                        "height=32,framerate=30/1 ! rtpvrawpay mtu=1400 ! "
                        "appsink name=out", batch=3)
    pay.get_by_name("in").push_buffer(JBuffer(data=planes, pts=0,
                                              duration=33_333_333, batch=3))
    pay.get_by_name("in").end_of_stream()
    pay.run()
    pkts = pay.get_by_name("out").pull_sample().buffer.data
    got = []
    for parse, kw in ((jparse_launch, {}), (tparse_launch, {"device": "cpu"})):
        port = _camera_sends_with_play(pkts)
        p = parse(f"rtspsrc location=rtsp://127.0.0.1:{port}/cam "
                  "protocols=tcp timeout=1.0 eos-timeouts=2 ! rtpvrawdepay ! "
                  "appsink name=out", **kw)
        try:
            p.run()
            frames = [tuple(np.asarray(x)[k] for x in s.buffer.data)
                      for s in _drain(p) for k in range(s.buffer.batch)]
        except Exception as e:     # the JAX client may lose its framing
            frames = e
        got.append(frames)
    jax, port = got
    assert len(port) == 3
    for k, f in enumerate(port):
        for a, b in zip(f, planes):
            np.testing.assert_array_equal(a, b[k])
    assert isinstance(jax, Exception) or len(jax) < 3
