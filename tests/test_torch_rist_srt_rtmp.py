"""The port's contribution links against the JAX package: ``net/rist.py``
(ristsink, ristsrc, the TR-06-2 header extension and the RIST-form
retransmission elements), ``net/srt.py`` (srtsink, srtsrc over the system
libsrt) and ``net/rtmp.py`` (AMF0, the chunk stream, FLV tags, rtmp2sink,
rtmp2src and ``RtmpRelayServer``).

The JAX package's own tests (``tests/test_rist.py``, ``test_srt.py``,
``test_rtmp.py`` and the RIST cases of ``test_misc_elements2.py``) run
again on the port, the libsrt cases skipped where libsrt is missing, as in
the JAX package.  Byte for byte, tolerance 0: the header extension, the
retransmissions, the generic and range NACKs ristsrc sends for the same
gaps, AMF0, FLV tags and RTMP chunks.  On the wire: a JAX ristsink sends to
a port ristsrc through ``test_rist.LossyRelay`` and every drop is
recovered; a port rtmp2sink publishes through the JAX ``RtmpRelayServer``
to a port rtmp2src; a JAX srtsink sends to a port srtsrc.  Sockets bind
port 0, or take a port or an adjacent pair from the OS under a retry;
every wait has a deadline.
"""

import socket
import threading
import time

import numpy as np
import pytest

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.net import rist as jrist
from gstreamer_tpu.net import rtmp as jrtmp
from gstreamer_tpu.net import srt as jsrt
from gstreamer_tpu.net.rtp import rtp_header

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.net import rist as trist
from gstreamer_tpu_torch.net import rtmp as trtmp
from gstreamer_tpu_torch.net import srt as tsrt

import test_misc_elements2
import test_rist
import test_rtmp
import test_srt
from test_torch_analytics import same_spec
from test_torch_captions import pair
from test_torch_flow import NET_TAIL_FACTORIES
from test_torch_rtp import _cpu_make, packets
from test_torch_webrtc import reference_cases, run_case

DEADLINE = 10.0          # seconds a socket case waits for its condition
needs_srt = pytest.mark.skipif(not jsrt.available(),
                               reason="system libsrt unavailable")

REFERENCE = (reference_cases(test_rist) + reference_cases(test_srt)
             + reference_cases(test_rtmp)
             + reference_cases(test_misc_elements2, only=("test_rist",)))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    run_case(case, tmp_path)


LINK_FACTORIES = [f for f in NET_TAIL_FACTORIES
                  if f.startswith(("rist", "srt", "rtmp"))]


@pytest.mark.parametrize("factory", LINK_FACTORIES)
def test_factory_spec_matches_reference(factory):
    same_spec(factory)


# -- RIST, byte for byte ----------------------------------------------------
def _ts(pid, fill):
    return bytes([0x47, (pid >> 8) & 0x1F, pid & 0xFF, 0x10]) \
        + bytes([fill]) * 184


def _mp2t_packets(rng, n):
    out = []
    for i in range(n):
        pids = rng.choice([0x100, 0x101, 0x1FFF], size=7)
        payload = b"".join(_ts(int(p), int(rng.integers(0, 256)))
                           for p in pids[:1 + i % 7])
        out.append(rtp_header(33, (65530 + i) & 0xFFFF, 90 * i, 0x2000)
                   + payload)
    return out


@pytest.mark.parametrize("drop,ext", [(True, True), (True, False),
                                      (False, True)])
def test_rist_extension_matches(drop, ext):
    pkts = _mp2t_packets(np.random.default_rng(2 * drop + ext), 14)
    props = (f"drop-null-ts-packets={str(drop).lower()} "
             f"sequence-number-extension={str(ext).lower()}")
    pushes = {"in": [dict(data=pkts[k:k + 5], pts=k) for k in (0, 5, 10)]}
    pair(f"appsrc name=in caps=application/x-rtp ! ristrtpext {props} ! "
         "appsink name=out", pushes)
    pair(f"appsrc name=in caps=application/x-rtp ! ristrtpext {props} ! "
         "ristrtpdeext ! appsink name=out", pushes)


def test_rist_retransmission_elements_match():
    def run(make, buffer):
        send, recv = make("ristrtxsend", max_size_packets=8), \
            make("ristrtxreceive")
        send.start()
        out = []
        for k in range(4):
            pkts = [rtp_header(96, 10 * k + i, i, 0x5000) + bytes([i]) * 9
                    for i in range(5)]
            o = send.host_process(buffer(data=pkts, batch=1))
            send.request_retransmit(10 * k + 1)
            send.request_retransmit(3)               # evicted after k=1
            out.append(packets(recv.host_process(o).data))
        return (out, send.num_rtx_requests, send.num_rtx_packets,
                recv.num_rtx_packets, recv.retransmitted_seqs)
    assert run(_cpu_make, Buffer) == run(
        test_misc_elements2.make_element, JBuffer)


def _nacks(mod, nack_type, arrivals):
    """The RTCP bytes a ristsrc of `mod` sends for `arrivals`, NACK pacing
    driven by a fake clock."""
    src = mod.RistSrc(**{"nack-type": nack_type, "reorder-section": 0.07,
                         "max-rtx-retries": 3})
    sent = []

    class Sock:
        def sendto(self, data, addr):
            sent.append(data)

    src._rtcp = Sock()
    src._sender_rtcp = ("127.0.0.1", 9)
    src._ssrc = 0xABCD
    now = 100.0
    for seq in arrivals:
        src._ingest(rtp_header(96, seq, 0, 0xABCD) + b"x", now)
        src._send_nacks(now)
        src._drain(now)
        now += 0.01
    for _ in range(12):
        src._send_nacks(now)
        src._drain(now)
        now += 0.02
    return sent, src.stats


@pytest.mark.parametrize("nack_type", ["generic", "range"])
def test_rist_nacks_match(nack_type):
    """Gaps (a wrap at 65535 among them) give the same NACK packets, on the
    same schedule, and the same loss counts."""
    arrivals = [65530, 65531, 65534, 65535, 2, 3, 9, 10, 11, 30, 4]
    assert _nacks(trist, nack_type, arrivals) == \
        _nacks(jrist, nack_type, arrivals)


# -- RIST on the wire, JAX sender to port receiver --------------------------
def _rist_src(mod=trist, **props):
    """A started ristsrc of `mod` (the port's by default) on an OS-chosen
    even/odd pair (retried: the RTCP port is the media port + 1)."""
    for _ in range(64):
        src = mod.RistSrc(address="127.0.0.1", port=0, **props)
        try:
            src.start()
            return src
        except OSError:
            src.stop()
    raise RuntimeError("no adjacent udp port pair free")


@pytest.mark.parametrize("nack_type", ["generic", "range"])
def test_jax_ristsink_to_port_ristsrc_recovers_every_drop(nack_type):
    src = _rist_src(**{"reorder-section": 0.12, "nack-type": nack_type,
                       "timeout": 1.0})
    relay = test_rist.LossyRelay(src.bound_port, {103, 104, 110, 117})
    sink = jrist.RistSink(address="127.0.0.1", port=relay.port)
    sink.start()
    pkts = test_rist._media(24)
    got = []
    try:
        def feeder():
            for i in range(0, len(pkts), 4):
                sink.render(JBuffer(data=pkts[i:i + 4], batch=1))
                time.sleep(0.005)
        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        end = time.monotonic() + DEADLINE
        while len(got) < len(pkts) and time.monotonic() < end:
            buf = src.create(1)
            if buf is None:
                break
            got.extend(packets(buf.data))
        th.join(2.0)
    finally:
        src.stop()
        sink.stop()
        relay.close()
    assert relay.dropped == 4
    assert got == pkts
    assert src.stats["recovered"] == 4 and src.stats["lost"] == 0
    assert sink.stats["retransmitted"] >= 4


def _stalled_receive(mod, nack_type):
    """A JAX ristsink sends 24 packets through a LossyRelay that drops two
    first copies to a ristsrc of `mod` (receiver-buffer 8) whose pipeline
    is stalled: nothing calls create until every packet has reached its
    socket and (the port's, NACKing from its receive thread) both drops
    are recovered, or 0.5 s have passed.  Then create runs to the end.
    Returns (sent, received, ristsrc's stats)."""
    src = _rist_src(mod, **{"receiver-buffer": 8, "nack-type": nack_type,
                            "timeout": 1.0})
    relay = test_rist.LossyRelay(src.bound_port, {103, 110})
    sink = jrist.RistSink(address="127.0.0.1", port=relay.port)
    pkts, got = test_rist._media(24), []
    try:
        sink.start()
        end = time.monotonic() + DEADLINE
        if mod is trist:                 # its thread learns the sender's SR
            while src._sender_rtcp is None and time.monotonic() < end:
                time.sleep(0.005)
        else:
            time.sleep(0.2)
        sink.render(JBuffer(data=pkts, batch=1))
        stall = time.monotonic() + 0.5
        while time.monotonic() < (end if mod is trist else stall) and (
                relay.dropped < 2 or src.stats["recovered"] < 2):
            time.sleep(0.005)
        while len(got) < len(pkts) and time.monotonic() < end:
            buf = src.create(1)
            if buf is None:
                break
            got.extend(packets(buf.data))
    finally:
        src.stop()
        sink.stop()
        relay.close()
    assert relay.dropped == 2
    return pkts, got, src.stats


@pytest.mark.parametrize("nack_type", ["generic", "range"])
def test_ristsrc_recovers_while_the_pipeline_stalls(nack_type):
    """A reference fault (ROADMAP.md section 3): the JAX package's ristsrc
    reads and NACKs inside create only, so a gap waits unasked while the
    pipeline stalls, and once the backlog passes receiver-buffer its guard
    skips the gap as lost.  The port's NACKs from its receive thread, as
    gstristsrc.c's rtpjitterbuffer runs its timers off the streaming
    thread: both drops come back during the stall, every packet out."""
    pkts, got, stats = _stalled_receive(trist, nack_type)
    assert got == pkts
    assert stats["recovered"] == 2 and stats["lost"] == 0
    pkts, got, stats = _stalled_receive(jrist, nack_type)
    assert stats["recovered"] == 0 and stats["lost"] == 2
    assert got == [p for p in pkts if p not in (pkts[3], pkts[10])]


# -- SRT on the wire, JAX sender to port receiver ---------------------------
def _udp_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@needs_srt
@pytest.mark.parametrize("passphrase", ["", "0123456789abcdef"])
def test_jax_srtsink_to_port_srtsrc(passphrase):
    rng = np.random.default_rng(9)
    payloads = [rng.integers(0, 256, 188 * 7, np.uint8).tobytes()
                for _ in range(10)]
    for _ in range(8):                    # the port may be taken meanwhile
        port = _udp_port()
        src = tsrt.SRTSrc(address="127.0.0.1", port=port, timeout=2.0,
                          passphrase=passphrase)
        try:
            src.start()
            break
        except RuntimeError:
            src.stop()
    got = []

    def receiver():
        while len(got) < len(payloads):
            buf = src.create(1)
            if buf is None:
                return
            got.append(np.asarray(buf.data).tobytes())

    th = threading.Thread(target=receiver, daemon=True)
    th.start()
    sink = jsrt.SRTSink(address="127.0.0.1", port=port, mode="caller",
                        passphrase=passphrase)
    try:
        sink.start()
        time.sleep(0.1)
        for p in payloads:
            sink.render(JBuffer(data=[p], batch=1))
        th.join(DEADLINE)
    finally:
        sink.stop()
        src.stop()
    assert got == payloads


def test_srt_loader_keeps_the_sonames():
    """Both packages look for libsrt under the same names and agree on
    whether it is here; where it is not, both raise the same error."""
    assert tsrt.available() == jsrt.available()
    assert tsrt.LIVE_PAYLOAD == jsrt.LIVE_PAYLOAD
    if not tsrt.available():
        for mod in (tsrt, jsrt):
            with pytest.raises(RuntimeError, match="libsrt not found"):
                mod.SRTSink().start()


# -- RTMP, byte for byte ----------------------------------------------------
AMF_VALUES = ["connect", 1.0, {"app": "live", "ok": True, "n": None,
                               "x": 2.5, "nested": {"a": "b"}}, None,
              False, "", 12345678.0]


def test_amf0_matches():
    enc = b"".join(trtmp.amf0_encode(v) for v in AMF_VALUES)
    assert enc == b"".join(jrtmp.amf0_encode(v) for v in AMF_VALUES)
    assert trtmp.amf0_decode_all(enc) == jrtmp.amf0_decode_all(enc)
    ecma = b"\x08\x00\x00\x00\x01\x00\x01k\x00" + bytes(8) + b"\x00\x00\x09"
    assert trtmp.amf0_decode(ecma) == jrtmp.amf0_decode(ecma)


@pytest.mark.parametrize("seed", [0, 1])
def test_flv_tags_match(seed):
    rng = np.random.default_rng(seed)
    tags = [(int(rng.choice([8, 9, 18])), int(rng.integers(0, 2**31)),
             rng.integers(0, 256, int(rng.integers(0, 900)),
                          np.uint8).tobytes()) for _ in range(9)]
    stream = trtmp.FLV_HEADER + b"".join(trtmp.build_flv_tag(*t)
                                         for t in tags)
    assert stream == jrtmp.FLV_HEADER + b"".join(
        jrtmp.build_flv_tag(*t) for t in tags)
    for cut in (len(stream), len(stream) - 5, 40):
        assert trtmp.parse_flv_stream(stream[:cut]) == \
            jrtmp.parse_flv_stream(stream[:cut])


class _Wire:
    """A socket that records what is sent and serves it back."""

    def __init__(self, data=b""):
        self.sent, self.data = [], data

    def sendall(self, b):
        self.sent.append(bytes(b))

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


def _chunk_wire(mod, chunk, msgs):
    w = _Wire()
    conn = mod.ChunkConnection(w)
    conn.set_chunk_size(chunk)
    conn.send_command("connect", 1, {"app": "live"}, None)
    for m in msgs:
        conn.send_message(*m)
    return b"".join(w.sent)


def _chunk_reads(mod, wire, n):
    conn = mod.ChunkConnection(_Wire(wire))
    return [conn.read_message() for _ in range(n)]


@pytest.mark.parametrize("chunk", [128, 4096])
def test_rtmp_chunks_match(chunk):
    """The chunk stream of the same messages, byte for byte, and the same
    messages read back from it (extended timestamps in whole chunks)."""
    rng = np.random.default_rng(chunk)
    msgs = [(4 + k % 3, [8, 9, 18, 20][k % 4], k % 2,
             [0, 40, 0xFFFFFE, 2**31 + 5][k % 4],
             rng.integers(0, 256, int(rng.integers(1, 9000)),
                          np.uint8).tobytes()) for k in range(8)]
    msgs = [m if m[3] < 0xFFFFFF else m[:4] + (m[4][:chunk],)
            for m in msgs]
    wire = _chunk_wire(trtmp, chunk, msgs)
    assert wire == _chunk_wire(jrtmp, chunk, msgs)
    reads = _chunk_reads(trtmp, wire, len(msgs) + 1)
    assert reads == _chunk_reads(jrtmp, wire, len(msgs) + 1)
    assert [r[3] for r in reads[1:]] == [m[4] for m in msgs]
    assert trtmp._parse_location("rtmp://h:99/app/s") == \
        jrtmp._parse_location("rtmp://h:99/app/s")


def test_rtmp_extended_timestamp_continuations_match():
    """A message with an extended timestamp over several chunks: the
    writer repeats the timestamp in each continuation chunk and the reader
    of both packages does not read it there, so both read the same wrong
    message (kept as the JAX package's)."""
    big = bytes(range(256)) * 4
    msgs = [(6, 8, 1, 2**31 + 5, big), (6, 8, 1, 7, b"next")]
    wire = _chunk_wire(trtmp, 128, msgs)
    assert wire == _chunk_wire(jrtmp, 128, msgs)
    try:
        want = _chunk_reads(jrtmp, wire, 3)
    except Exception as e:                     # noqa: BLE001
        with pytest.raises(type(e)):
            _chunk_reads(trtmp, wire, 3)
    else:
        assert _chunk_reads(trtmp, wire, 3) == want
        assert want[1][3] != big


# -- RTMP on the wire: port publisher, JAX relay, port player ---------------
def test_port_rtmp_through_jax_relay():
    srv = jrtmp.RtmpRelayServer()
    url = f"rtmp://127.0.0.1:{srv.port}/live/cam"
    rng = np.random.default_rng(21)
    payloads = [rng.integers(0, 256, 300 + 997 * k, np.uint8).tobytes()
                for k in range(6)]
    got = []
    try:
        src = _cpu_make("rtmp2src", location=url, timeout=3.0)
        sink = _cpu_make("rtmp2sink", location=url)
        src.start()                     # the player registers first
        sink.start()

        def rx():
            data = b""
            while len(got) < len(payloads):
                buf = src.create(1)
                if buf is None:
                    return
                data += np.asarray(buf.data).tobytes()
                tags, _ = trtmp.parse_flv_stream(data)
                got[:] = tags

        th = threading.Thread(target=rx, daemon=True)
        th.start()
        time.sleep(0.1)
        stream = test_rtmp._flv_stream(payloads)
        for ofs in range(0, len(stream), 1000):
            sink.render(Buffer(data=np.frombuffer(stream[ofs:ofs + 1000],
                                                  np.uint8), batch=1))
        th.join(DEADLINE)
        src.stop()
        sink.stop()
    finally:
        srv.close()
    assert [t[2] for t in got] == payloads
    assert [t[1] for t in got] == [40 * k for k in range(len(payloads))]
