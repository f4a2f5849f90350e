"""The port's ``net/fec.py`` (SMPTE 2022-1: build_fec_packet,
parse_fec_packet, rtpst2022_1_fecenc, rtpst2022_1_fecdec) against the JAX
package, bit for bit.

The JAX package's ``tests/test_fec.py`` runs again on the port's module
(``on_port``).  Its end-to-end case needs libav's VP8 (a ``skipif`` mark):
it runs on the port in ``test_torch_libav.py``, and the same check runs
here with vp8enc / vp8dec over libvpx.
The FEC packets and the encoder's output equal the JAX package's; the
decoder's output equals the JAX package's where each buffer holds whole
rows with their FEC packets.  Where it differs it is a fault of the JAX
package (ROADMAP.md section 3), each shown by a test here: a row that
straddles two buffers, one datagram a buffer, and the 65535 -> 0 wrap.
"""

import numpy as np
import pytest

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.net import fec as jfec
from gstreamer_tpu.net.rtp import parse_rtp_header, rtp_header

from gstreamer_tpu_torch.codecs import vpx as tvpx
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.parse import parse_launch as tparse_launch
from gstreamer_tpu_torch.net import fec as tfec

import test_fec
from test_torch_captions import pair
from test_torch_rtp import _cpu_make, packets, reference_tests, run_on_port

REFERENCE = reference_tests(test_fec)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


def media(n, seq0=100, seed=0, ssrc=0x1234):
    rng = np.random.default_rng(seed)
    return [rtp_header(96, (seq0 + i) & 0xFFFF, (9000 + 33 * i) & 0xFFFFFFFF,
                       ssrc, marker=i % 7 == 6)
            + rng.integers(0, 256, int(rng.integers(20, 1300)),
                           dtype=np.uint8).tobytes() for i in range(n)]


@pytest.mark.parametrize("n,seq0", [(1, 0), (5, 100), (9, 65533)])
def test_fec_packet_bytes(n, seq0):
    m = media(n, seq0, seed=n)
    for pt, seq, ssrc in ((100, 0, 0xFEC0FEC0), (127, 65535, 1)):
        pkt = tfec.build_fec_packet(m, pt, seq, ssrc)
        assert pkt == jfec.build_fec_packet(m, pt, seq, ssrc)
        assert tfec.parse_fec_packet(pkt) == jfec.parse_fec_packet(pkt)
    assert tfec.parse_fec_packet(m[0][:20]) == \
        jfec.parse_fec_packet(m[0][:20])


def fec_stream(m, rows, cuts, **props):
    """`m` through rtpst2022_1_fecenc rows=`rows` in both packages, pushed
    in buffers cut at `cuts`: the packets equal; returns them by buffer."""
    bounds = [0] + list(cuts) + [len(m)]
    prop = " ".join(f"{k}={v}" for k, v in props.items())
    _, ref, _, out = pair(
        f"appsrc name=in ! application/x-rtp ! rtpst2022_1_fecenc "
        f"rows={rows} {prop} ! appsink name=out",
        {"in": [dict(data=m[a:b], pts=k) for k, (a, b)
                in enumerate(zip(bounds, bounds[1:]))]})
    got = [packets(s.buffer.data) for s in out["out"]]
    assert got == [packets(s.buffer.data) for s in ref["out"]]
    return got


def decode(pkt_lists, parse_pkg="port"):
    """Buffers of packets through one rtpst2022_1_fecdec element called
    directly (the port's on the CPU, or the JAX package's), then the end
    of stream: the packets out, buffer by buffer, and the element."""
    e = _cpu_make("rtpst2022_1_fecdec") if parse_pkg == "port" \
        else jmake("rtpst2022_1_fecdec")
    buf = Buffer if parse_pkg == "port" else JBuffer
    e.start()
    outs = []
    for k, pk in enumerate(pkt_lists):
        o = e.host_process(buf(data=list(pk), pts=k))
        outs.append(packets(o.data) if o is not None else [])
    if parse_pkg == "port":
        o = e.host_process(None)
        outs.append(packets(o.data) if o is not None else [])
    return outs, e


@pytest.mark.parametrize("rows", [2, 4, 5, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_whole_rows_decode_as_the_reference(rows, seed):
    """Buffers that each hold whole rows with their FEC packets, a seeded
    drop of at most one packet a row: the port's decoder gives the JAX
    package's packets in the same buffers, and each dropped packet back."""
    rng = np.random.default_rng(seed)
    m = media(rows * 12, seed=seed)
    buffers = fec_stream(m, rows, [rows * 3, rows * 7])
    lost = set()
    lossy = []
    for pk in buffers:
        keep = []
        for i in range(0, len(pk), rows + 1):
            row = pk[i:i + rows + 1]
            drop = int(rng.integers(0, rows + 2))     # rows + 1: no drop
            if drop < rows:
                lost.add(row[drop])
            keep += [p for k, p in enumerate(row) if k != drop]
        lossy.append(keep)
    port, pe = decode(lossy)
    ref, je = decode(lossy, "jax")
    assert port[:-1] == ref and port[-1] == []
    assert pe.recovered == je.recovered == len(lost)
    assert [p for b in port for p in b] == m


def test_straddling_row_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3): the JAX decoder forgets
    its packets at the end of every buffer, so a row whose packets and FEC
    packet fall in two buffers is never recovered (a 1080p JPEG frame is
    about 106 packets: rows of 5 straddle frames).  The port's keeps them
    and recovers the packet, in sequence order."""
    m = media(10)
    buffers = fec_stream(m, 5, [7])           # row 2 straddles the cut
    lost = m[6]
    lossy = [[p for p in b if p != lost] for b in buffers]
    ref, je = decode(lossy, "jax")
    port, pe = decode(lossy)
    assert je.recovered == 0 and lost not in [p for b in ref for p in b]
    assert pe.recovered == 1
    assert [p for b in port for p in b] == m


def test_one_datagram_a_buffer_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3): from udpsrc (one datagram
    a buffer) the JAX decoder recovers nothing.  The port's recovers every
    single loss a row.  It sends the packets on in order once it has seen a
    FEC packet; before that nothing waits, so the first row's loss comes
    out when its FEC packet does, after the packets that followed it."""
    m = media(40, seed=3)
    stream = [p for b in fec_stream(m, 4, []) for p in b]
    lost = {m[k] for k in (1, 6, 15, 33)}
    lossy = [[p] for p in stream if p not in lost]
    ref, je = decode(lossy, "jax")
    port, pe = decode(lossy)
    assert je.recovered == 0
    assert pe.recovered == 4
    assert [p for b in port for p in b] == m[:1] + m[2:4] + m[1:2] + m[4:]


def test_wrap_order_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3): the JAX decoder sorts by
    the raw 16-bit sequence number, so a buffer across the 65535 -> 0
    wrap comes out with 0.. before 65533..  The port's keeps the order."""
    m = media(10, seq0=65531)
    buffers = fec_stream(m, 5, [])
    ref, _ = decode(buffers, "jax")
    port, _ = decode(buffers)
    assert [p for b in port for p in b] == m
    assert [parse_rtp_header(p)["seq"] for p in ref[0]] == \
        sorted(parse_rtp_header(p)["seq"] for p in m)


def test_two_losses_in_a_row_are_passed_over():
    """Two packets of one row lost: not recoverable; the packets after
    them are sent on once the row's FEC packet has come, and the stream
    goes on."""
    m = media(20, seed=4)
    stream = [p for b in fec_stream(m, 5, []) for p in b]
    lost = {m[2], m[3]}
    port, pe = decode([[p] for p in stream if p not in lost])
    got = [p for b in port for p in b]
    assert pe.recovered == 0 and got == [p for p in m if p not in lost]


def fec_of(stream):
    return [p for p in stream if parse_rtp_header(p)["payload_type"] == 100]


def test_lost_fec_packet_holds_until_the_next_row():
    """A row's FEC packet and one of its media packets lost (after a first
    whole row): the packets after the gap wait until a later row's FEC
    packet covers it, and come out in order at that point (or at end of
    stream)."""
    m = media(15, seed=5)
    stream = fec_stream(m, 5, [])[0]
    lossy = [p for p in stream if p not in (m[7], fec_of(stream)[1])]
    cut = lossy.index(m[9])
    port, pe = decode([lossy[:cut], lossy[cut:]])
    assert port[0] == m[:7] and port[1] == m[8:] and port[2] == []
    assert pe.recovered == 0
    tail, _ = decode([lossy[:cut]])
    assert tail[0] == m[:7] and tail[-1] == m[8:9]


def test_hold_ends_a_row_span_past_the_gap():
    """A row's media packet and its FEC packet lost, one datagram a
    buffer, no later FEC packet: the packets after the gap wait until the
    stream has gone a row's span (NA x offset = 5) past it, then go on in
    order."""
    m = media(13, seed=6)
    stream = fec_stream(m, 5, [])[0]
    lossy = [p for p in stream if p not in (m[7], fec_of(stream)[1])]
    port, pe = decode([[p] for p in lossy])
    at = {p: k for k, p in enumerate(lossy)}
    released = at[m[12]]
    assert port[released] == m[8:13]
    assert all(port[k] == [] for k in range(at[m[8]], released))
    assert [p for b in port for p in b] == [p for p in m if p != m[7]]


@pytest.mark.parametrize("one_a_buffer", [False, True])
def test_stream_without_fec_passes_straight_through(one_a_buffer):
    """A stream that carries no FEC packet (sent on another payload type,
    or never sent): nothing waits for a recovery that cannot come.  Each
    buffer's packets come out in that buffer, gaps and all, as the JAX
    package's decoder gives them."""
    m = media(30, seed=8)
    lossy = [p for k, p in enumerate(m) if k not in (3, 4, 17)]
    pushed = [[p] for p in lossy] if one_a_buffer \
        else [lossy[:10], lossy[10:20], lossy[20:]]
    port, pe = decode(pushed)
    ref, _ = decode(pushed, "jax")
    assert port[:-1] == ref == pushed and port[-1] == []
    assert pe.recovered == 0


@pytest.mark.parametrize("rows", [3, 5])
def test_fecdec_in_a_launch_string(rows):
    """appsrc ! rtpst2022_1_fecdec ! appsink with whole rows a buffer: the
    samples equal the JAX package's."""
    m = media(rows * 6, seed=rows)
    buffers = fec_stream(m, rows, [rows * 2, rows * 4])
    lossy = [b[1:] for b in buffers]
    pair("appsrc name=in ! application/x-rtp ! rtpst2022_1_fecdec ! "
         "appsink name=out", {"in": [dict(data=b, pts=k)
                                     for k, b in enumerate(lossy)]})


@pytest.mark.skipif(not tvpx.available(), reason="no libvpx")
def test_end_to_end_vp8_with_loss_on_libvpx():
    """The JAX test's end-to-end case (there on libav's VP8) on the port
    with libvpx: vp8enc ! rtpvp8pay mtu=200 ! rtpst2022_1_fecenc rows=4,
    one media packet dropped, then rtpst2022_1_fecdec ! rtpvp8depay and
    libvpx's decoder: every frame survives, and the frames equal those
    decoded with no loss."""
    head = ("videotestsrc num-buffers=4 pattern=gradient ! video/x-raw,"
            "format=I420,width=64,height=48,framerate=30/1 ! vp8enc ! "
            "rtpvp8pay mtu=200 ! ")
    p = tparse_launch(head + "rtpst2022_1_fecenc rows=4 ! appsink name=out",
                      device="cpu")
    p.run()
    pkts = [x for s in iter(p.get_by_name("out").pull_sample, None)
            for x in packets(s.buffer.data)]
    media_idx = [i for i, pk in enumerate(pkts)
                 if parse_rtp_header(pk)["payload_type"] != 100]
    assert len(media_idx) >= 4
    dropped = pkts[:media_idx[1]] + pkts[media_idx[1] + 1:]

    def frames(chain, pk):
        """The depayloaded VP8 frames, decoded with libvpx (vp8dec reads an
        IVF file in both packages and links to no depayloader)."""
        d = tparse_launch("appsrc name=in ! application/x-rtp ! "
                          f"{chain}rtpvp8depay ! appsink name=out",
                          device="cpu")
        d.get_by_name("in").push_buffer(Buffer(data=pk, batch=len(pk)))
        d.get_by_name("in").end_of_stream()
        d.run()
        dec = tvpx.VpxDecoder("vp8")
        return [f for s in iter(d.get_by_name("out").pull_sample, None)
                for x in packets(s.buffer.data) for f in dec.decode(x)]
    got = frames("rtpst2022_1_fecdec ! ", dropped)
    want = frames("", [pkts[i] for i in media_idx])
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_lone_row_loss_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3): with rows of one packet,
    a buffer whose media packets were all lost makes the JAX decoder raise
    StopIteration (it takes the SSRC from this buffer's media).  The
    port's takes the stream's SSRC from the packets it has seen and
    recovers them."""
    m = media(6, seed=7)
    buffers = fec_stream(m, 1, [3])
    lossy = [buffers[0], [p for p in buffers[1] if p not in m[3:]]]
    with pytest.raises(StopIteration):
        decode(lossy, "jax")
    port, pe = decode(lossy)
    assert pe.recovered == 3 and [p for b in port for p in b] == m
