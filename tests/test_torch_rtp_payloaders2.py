"""The port's ``net/rtp_payloaders2.py`` against the JAX package, bit for
bit: the raw-payload pairs (G.722 ... DV, MP4V, MP4A-LATM), H.265,
H.263 / H.263+ / H.261, RFC 2250 MPEG (audio, video, TS, MPEG-1 system),
RFC 3640 AAC, AC-3, AMR, SBC, JPEG 2000, the Xiph pair, RFC 4571 framing,
rtpgstpay / rtpgstdepay, rtppassthroughpay, RED, ULPFEC and rtpstorage.

The JAX package's ``tests/test_rtp_payloaders2.py`` runs again on the
port's modules (``on_port``; a case fails if it builds a JAX element).
Each factory's properties, pad templates, description and HOST_ELEMENT are
the JAX class's.  The same seeded inputs go through both packages: packets
byte for byte, depayloaded frames, caps and timestamps equal, tolerance 0.
Where the port differs it is a fault of the JAX package with a test of its
own here, logged in ROADMAP.md section 3.
"""

import struct

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.net.rtp import parse_rtp_header, rtp_header

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.parse import parse_launch as tparse_launch

import test_rtp_payloaders2
from test_torch_analytics import same_spec
from test_torch_captions import pair
from test_torch_flow import RTP2_FACTORIES
from test_torch_rtp import packets, reference_tests, run_on_port

REFERENCE = reference_tests(test_rtp_payloaders2)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    """The JAX package's tests of the second payloader batch, on the
    port's module."""
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


@pytest.mark.parametrize("factory", RTP2_FACTORIES)
def test_factory_spec_matches_reference(factory):
    """The slice's 76 factories (this module's, fec's, rtp_tail's and
    siren_elements')."""
    same_spec(factory)


def rows(samples):
    return [packets(s.buffer.data) for s in samples]


def blobs(seed, n=5, lo=1, hi=3000):
    """Seeded coded frames of seeded sizes, as host byte arrays."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8)
            for _ in range(n)]


def frame_pushes(frames, dur=20_000_000):
    return {"in": [dict(data=f, pts=k * dur, duration=dur)
                   for k, f in enumerate(frames)]}


def pay_depay(caps, pay, depay, frames, mtu):
    """`pay` alone, then `pay ! depay`, in both packages: the packets and
    the depayloaded frames equal.  Returns the JAX package's frames."""
    head = f"appsrc name=in caps=\"{caps}\" ! {pay} mtu={mtu}"
    _, ref, _, out = pair(f"{head} ! appsink name=out", frame_pushes(frames))
    assert rows(out["out"]) == rows(ref["out"]) and ref["out"]
    _, ref, _, _ = pair(f"{head} ! {depay} ! appsink name=out",
                        frame_pushes(frames))
    return [b for s in ref["out"] for b in packets(s.buffer.data)]


RAW_PAIRS = [("audio/G722, rate=8000, channels=1", "g722"),
             ("audio/G723, rate=8000, channels=1", "g723"),
             ("audio/x-adpcm, layout=g726", "g726"),
             ("audio/G729, rate=8000, channels=1", "g729"),
             ("audio/x-gsm, rate=8000, channels=1", "gsm"),
             ("audio/x-iLBC", "ilbc"), ("audio/x-speex", "speex"),
             ("audio/x-bv", "bv"), ("audio/qcelp, rate=8000, channels=1",
                                    "qcelp"),
             ("meta/x-klv", "klv"), ("video/x-dv", "dv"),
             ("video/mpeg, mpegversion=4, systemstream=false", "mp4v"),
             ("audio/mpeg, mpegversion=4, stream-format=loas", "mp4a")]


@pytest.mark.parametrize("caps,base", RAW_PAIRS, ids=[b for _c, b in
                                                       RAW_PAIRS])
@pytest.mark.parametrize("mtu", [1400, 97])
def test_raw_pairs(caps, base, mtu):
    frames = blobs(len(base) + mtu)
    got = pay_depay(caps, f"rtp{base}pay", f"rtp{base}depay", frames, mtu)
    assert got == [f.tobytes() for f in frames]


PASSTHROUGH = [
    ("video/x-h263, variant=itu", "h263p"),
    ("video/x-h263, variant=itu, h263version=h263", "h263"),
    ("video/x-h261", "h261"),
    ("audio/mpeg, mpegversion=1", "mpa"),
    ("video/mpeg, systemstream=false", "mpv"),
    ("audio/mpeg, mpegversion=4, stream-format=raw", "mp4g"),
    ("audio/x-ac3", "ac3"),
    ("audio/x-sbc", "sbc"),
    ("image/x-jpc", "j2k"),
    ("audio/x-vorbis", "vorbis"),
    ("video/x-theora", "theora")]


@pytest.mark.parametrize("caps,base", PASSTHROUGH,
                         ids=[b for _c, b in PASSTHROUGH])
@pytest.mark.parametrize("mtu", [1400, 200])
def test_frame_payloaders(caps, base, mtu):
    """Seeded frames of 1 to 3000 bytes: the packets and the frames back
    equal the JAX package's."""
    pay_depay(caps, f"rtp{base}pay", f"rtp{base}depay",
              blobs(mtu + len(base)), mtu)


def _nal(kind, n, rng):
    """An H.265 NAL: a 2-byte header of type `kind`, `n` bytes with no
    start-code emulation."""
    body = rng.integers(1, 256, n, dtype=np.uint8).tobytes()
    return bytes([kind << 1, 1]) + body


@pytest.mark.parametrize("mtu", [1400, 120])
def test_h265_pay_depay(mtu):
    rng = np.random.default_rng(mtu)
    aus = [b"".join(b"\x00\x00\x00\x01" + _nal(k, int(rng.integers(5, 900)),
                                                rng)
                    for k in (32, 33, 34, 19 if t == 0 else 1))
           for t in range(4)]
    got = pay_depay("video/x-h265, stream-format=byte-stream, alignment=au",
                    "rtph265pay", "rtph265depay",
                    [np.frombuffer(a, np.uint8) for a in aus], mtu)
    assert got == aus


def test_h265_aggregation_packet_depay():
    nals = [bytes([32 << 1, 1, 5, 6]), bytes([33 << 1, 1, 7]),
            bytes([19 << 1, 1, 9, 9, 9])]
    ap = bytes([48 << 1, 1]) + b"".join(struct.pack(">H", len(x)) + x
                                        for x in nals)
    pkts = [rtp_header(96, 0, 0, 1, marker=True) + ap]
    _, ref, _, _ = pair("appsrc name=in ! application/x-rtp ! rtph265depay "
                        "! appsink name=out", {"in": [dict(data=pkts,
                                                           pts=0)]})
    assert packets(ref["out"][0].buffer.data) == \
        [b"".join(b"\x00\x00\x00\x01" + x for x in nals)]


@pytest.mark.parametrize("n,ts", [(1, 0), (6, 3)])
def test_mp2t_pay_depay(n, ts):
    rng = np.random.default_rng(n)
    tsb = [np.concatenate([np.frombuffer(b"\x47", np.uint8),
                           rng.integers(0, 256, 187, dtype=np.uint8)])
           for _ in range(n * 11 + ts)]
    frame = np.concatenate(tsb)
    got = pay_depay("video/mpegts, systemstream=true", "rtpmp2tpay",
                    "rtpmp2tdepay", [frame], 1400)
    assert b"".join(got) == frame.tobytes()


def test_mp1s_and_amr_depay():
    rng = np.random.default_rng(8)
    pkts = [rtp_header(96, k, 90 * k, 3, marker=True)
            + rng.integers(0, 256, 40 + k, dtype=np.uint8).tobytes()
            for k in range(6)]
    for depay in ("rtpmp1sdepay", "rtpamrdepay"):
        pair(f"appsrc name=in ! application/x-rtp ! {depay} ! "
             "appsink name=out", {"in": [dict(data=list(pkts), pts=0)]})


@pytest.mark.parametrize("size", [12, 13, 31, 5, 40])
def test_amr_pay(size):
    frames = [np.arange(size, dtype=np.uint8) + k for k in range(3)]
    pay_depay("audio/AMR", "rtpamrpay", "rtpamrdepay", frames, 1400)


def test_stream_framing():
    """rtpstreampay's RFC 4571 bytes cut at odd places still come back as
    the packets (rtpstreamdepay keeps its partial packet)."""
    pkts = [rtp_header(96, k, 100 * k, 9) + bytes([k]) * (10 + 37 * k)
            for k in range(7)]
    _, ref, _, _ = pair("appsrc name=in ! application/x-rtp ! rtpstreampay "
                        "! appsink name=out", {"in": [dict(data=list(pkts),
                                                           pts=0)]})
    stream = packets(ref["out"][0].buffer.data)[0]
    cuts = [0, 1, 30, 31, 200, 513, len(stream)]
    pushes = [dict(data=np.frombuffer(stream[a:b], np.uint8), pts=0)
              for a, b in zip(cuts, cuts[1:])]
    _, ref, _, _ = pair("appsrc name=in ! application/x-rtp-stream ! "
                        "rtpstreamdepay ! appsink name=out",
                        {"in": pushes})
    assert [p for s in ref["out"] for p in packets(s.buffer.data)] == pkts


@pytest.mark.parametrize("pt", [-1, 0, 127])
def test_passthroughpay(pt):
    pkts = [rtp_header(96, k, k, 1, marker=k == 2) + b"ab" for k in range(3)]
    pair(f"appsrc name=in ! application/x-rtp ! rtppassthroughpay pt={pt} "
         "! appsink name=out", {"in": [dict(data=list(pkts), pts=0)]})


def test_gstpay_caps_string_is_the_references():
    """rtpgstpay carries its sink caps as their string: the port's Caps
    print the JAX package's string, so the first packet's bytes match."""
    caps = "audio/x-gsm, rate=(int)8000, channels=(int)1"
    frames = blobs(11, 3)
    got = pay_depay(caps, "rtpgstpay", "rtpgstdepay", frames, 300)
    assert got == [f.tobytes() for f in frames]


def _media(n, size=200, seed=0, seq0=100):
    rng = np.random.default_rng(seed)
    return [rtp_header(96, (seq0 + k) & 0xFFFF, (1000 + 160 * k) & 0xFFFFFFFF,
                       0x1234, marker=k % 5 == 4)
            + rng.integers(0, 256, size + 7 * k, dtype=np.uint8).tobytes()
            for k in range(n)]


def _through(desc, pkt_lists):
    """Packet lists (one a buffer) through `desc` in both packages: the
    packets equal; returns them."""
    _, ref, _, out = pair(
        f"appsrc name=in ! application/x-rtp ! {desc} ! appsink name=out",
        {"in": [dict(data=list(p), pts=k) for k, p in enumerate(pkt_lists)]})
    assert rows(out["out"]) == rows(ref["out"])
    return [p for s in ref["out"] for p in packets(s.buffer.data)]


@pytest.mark.parametrize("distance", [0, 1, 2])
def test_red_round_trip_and_recovery(distance):
    media = _media(12, seed=distance)
    red = _through(f"rtpredenc distance={distance}", [media[:5], media[5:]])
    lossy = [p for k, p in enumerate(red) if k not in (3, 8)]
    back = _through("rtpreddec", [lossy[:4], lossy[4:]])
    if distance:
        assert [parse_rtp_header(p)["payload"] for p in back] == \
            [parse_rtp_header(p)["payload"] for p in media]


def test_red_block_over_1023_bytes_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3): RFC 2198's block header
    has 10 bits of length.  The JAX rtpredenc writes a longer redundant
    payload's length into the timestamp offset's bits, and rtpreddec then
    misframes every packet: no payload comes back as sent.  The port
    leaves such a block out, as gstrtpredenc.c does: the packets come back
    whole, and a loss of a packet over 1023 bytes is not recovered."""
    media = _media(6, size=1100)

    def run(parse, buf_cls, desc, pkts, **kw):
        p = parse(f"appsrc name=in ! application/x-rtp ! {desc} ! "
                  "appsink name=out", **kw)
        p.get_by_name("in").push_buffer(buf_cls(data=list(pkts), pts=0))
        p.get_by_name("in").end_of_stream()
        p.run()
        return [x for s in iter(p.get_by_name("out").pull_sample, None)
                for x in packets(s.buffer.data)]
    jred = run(jparse_launch, JBuffer, "rtpredenc distance=1", media)
    jback = run(jparse_launch, JBuffer, "rtpreddec", jred)
    assert all(parse_rtp_header(a)["payload"] != parse_rtp_header(b)[
        "payload"] for a, b in zip(jback[1:], media[1:]))
    tred = run(tparse_launch, Buffer, "rtpredenc distance=1", media,
               device="cpu")
    assert [len(p) for p in tred] == [len(p) + 1 for p in media]
    tback = run(tparse_launch, Buffer, "rtpreddec", tred, device="cpu")
    assert [parse_rtp_header(p)["payload"] for p in tback] == \
        [parse_rtp_header(p)["payload"] for p in media]
    # below the limit the two packages write the same packets
    small = _media(6, size=900)
    assert run(tparse_launch, Buffer, "rtpredenc distance=1", small,
               device="cpu") == run(jparse_launch, JBuffer,
                                    "rtpredenc distance=1", small)


@pytest.mark.parametrize("group", [2, 4, 16])
def test_ulpfec_enc_dec(group):
    media = _media(32, seed=group)
    fec = _through(f"rtpulpfecenc group-size={group}",
                   [media[:13], media[13:]])
    lost = {media[k] for k in (1, group + 3)}
    lossy = [p for p in fec if p not in lost]
    back = _through("rtpstorage ! rtpulpfecdec", [lossy[:9], lossy[9:]])
    assert lost <= set(back)


def test_ulpfec_eviction_across_the_wrap_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3): the JAX rtpulpfecdec
    keeps its 256 packets with the largest raw sequence numbers, so past
    the 65535 -> 0 wrap it throws away the newest and cannot recover a
    packet lost there.  The port keeps the 256 newest across the wrap."""
    media = _media(300, size=40, seq0=65536 - 280)
    pkts = []
    for parse, buf_cls, kw in ((jparse_launch, JBuffer, {}),
                               (tparse_launch, Buffer, {"device": "cpu"})):
        p = parse("appsrc name=in ! application/x-rtp ! rtpulpfecenc "
                  "group-size=4 ! appsink name=out", **kw)
        p.get_by_name("in").push_buffer(buf_cls(data=list(media), pts=0))
        p.get_by_name("in").end_of_stream()
        p.run()
        pkts.append(packets(p.get_by_name("out").pull_sample().buffer.data))
    assert pkts[0] == pkts[1]
    fec = pkts[0]
    lost = media[283]                 # seq 3, after the wrap
    lossy = [p for p in fec if p != lost]
    got = {}
    for tag, parse, buf_cls, kw in (
            ("jax", jparse_launch, JBuffer, {}),
            ("port", tparse_launch, Buffer, {"device": "cpu"})):
        p = parse("appsrc name=in ! application/x-rtp ! rtpulpfecdec ! "
                  "appsink name=out", **kw)
        p.get_by_name("in").push_buffer(buf_cls(data=lossy, pts=0))
        p.get_by_name("in").end_of_stream()
        p.run()
        got[tag] = packets(p.get_by_name("out").pull_sample().buffer.data)
    assert lost not in got["jax"]
    assert lost in got["port"]
    assert [x for x in got["port"] if x != lost] == got["jax"]


def test_storage_keeps_the_packets():
    media = _media(20)
    _, _, tp, _ = pair("appsrc name=in ! application/x-rtp ! rtpstorage "
                       "name=s ! appsink name=out",
                       {"in": [dict(data=media[:7], pts=0),
                               dict(data=media[7:], pts=1)]})
    assert tp.get_by_name("s").get_packets() == media


def test_gst_raw_video_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3): the JAX rtpgstpay pays a
    raw-video batch plane by plane (each plane of the batch a buffer) and
    its rtpgstdepay hands the converter bytes, which it cannot take.  The
    port pays each frame in the format's bytes and rtpgstdepay, its source
    caps naming raw video, gives planes: the RGB equals the direct
    conversion's."""
    from test_torch_captions import i420
    w, h, n = 64, 48, 3
    caps = f"video/x-raw,format=I420,width={w},height={h},framerate=25/1"
    planes = i420(w, h, n, 5)
    tail = "videoconvertscale ! video/x-raw,format=RGB,width=32,height=32 ! " \
        "appsink name=out"

    def run(parse, buf_cls, mid, data, **kw):
        p = parse(f"appsrc name=in caps={caps} ! {mid}{tail}", batch=n, **kw)
        p.get_by_name("in").push_buffer(buf_cls(data=data, batch=n, pts=0,
                                                duration=40_000_000))
        p.get_by_name("in").end_of_stream()
        p.run()
        return [tuple(np.asarray(x) for x in s.buffer.data)
                for s in iter(p.get_by_name("out").pull_sample, None)]
    rtp = f"rtpgstpay mtu=400 ! rtpgstdepay ! {caps} ! "
    with pytest.raises(TypeError):
        run(jparse_launch, JBuffer, rtp, planes)
    tplanes = tuple(torch.from_numpy(p) for p in planes)
    got = run(tparse_launch, Buffer, rtp, tplanes, device="cpu")
    want = run(tparse_launch, Buffer, "", tplanes, device="cpu")
    assert len(got) == len(want) == 1
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)


def test_gst_raw_video_wire_differs_between_packages():
    """The wire of the reference fault above (ROADMAP.md section 3): for
    raw video both packages' rtpgstpay send the same bytes in as many
    packets, cut into other frames: the JAX package's a plane of the batch
    a frame, the port's a video frame in the format's bytes.  So a JAX
    sender and a port receiver whose caps name raw video do not work
    together: the port's rtpgstdepay cannot rebuild frames from the planes
    (ValueError).  Without those caps the port's gives the JAX package's
    depayloaded bytes, and the JAX package's rtpgstdepay gives each of the
    port's frames as its I420 bytes."""
    from test_torch_captions import i420
    w, h, n = 64, 48, 3
    caps = f"video/x-raw,format=I420,width={w},height={h},framerate=25/1"
    planes = i420(w, h, n, 5)

    def pay(parse, buf_cls, data, **kw):
        p = parse(f"appsrc name=in caps={caps} ! rtpgstpay mtu=400 ! "
                  "appsink name=out", batch=n, **kw)
        p.get_by_name("in").push_buffer(buf_cls(data=data, batch=n, pts=0,
                                                duration=40_000_000))
        p.get_by_name("in").end_of_stream()
        p.run()
        return [x for s in iter(p.get_by_name("out").pull_sample, None)
                for x in packets(s.buffer.data)]

    def depay(parse, buf_cls, pkts, mid="", **kw):
        p = parse("appsrc name=in caps=application/x-rtp ! rtpgstdepay ! "
                  f"{mid}appsink name=out", **kw)
        p.get_by_name("in").push_buffer(buf_cls(data=list(pkts), pts=0))
        p.get_by_name("in").end_of_stream()
        p.run()
        return [x for s in iter(p.get_by_name("out").pull_sample, None)
                for x in packets(s.buffer.data)]
    jpkts = pay(jparse_launch, JBuffer, planes)
    tpkts = pay(tparse_launch, Buffer,
                tuple(torch.from_numpy(p) for p in planes), device="cpu")
    assert len(jpkts) == len(tpkts) and jpkts != tpkts
    assert sum(map(len, jpkts)) == sum(map(len, tpkts))
    with pytest.raises(ValueError):
        depay(tparse_launch, Buffer, jpkts, f"{caps} ! ", device="cpu")
    assert depay(tparse_launch, Buffer, jpkts, device="cpu") == \
        depay(jparse_launch, JBuffer, jpkts) == [p.tobytes() for p in planes]
    assert depay(jparse_launch, JBuffer, tpkts) == \
        [b"".join(p[k].tobytes() for p in planes) for k in range(n)]


def test_ulpfec_order_needs_a_jitterbuffer():
    """Kept from the reference (ROADMAP.md section 3): rtpulpfecdec sends
    a recovered packet when its FEC packet comes, after the packets that
    followed the loss, in both packages; rtpjitterbuffer after it puts the
    stream back in order."""
    media = _media(8, seed=9)
    fec = _through("rtpulpfecenc group-size=4", [media])
    lossy = [p for p in fec if p != media[1]]
    back = _through("rtpstorage ! rtpulpfecdec", [lossy])
    assert back == media[:1] + media[2:4] + media[1:2] + media[4:]
    assert _through("rtpstorage ! rtpulpfecdec ! rtpjitterbuffer",
                    [lossy]) == media
