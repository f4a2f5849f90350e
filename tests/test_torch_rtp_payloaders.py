"""The port's coded-media payloaders against the JAX package, bit for bit:
``net/rtp_payloaders.py`` (PCMU / PCMA, H.264 with FU-A and STAP-A, the
PT and SSRC demuxers, DTMF events, JPEG after RFC 2435, rtpmux /
rtpdtmfmux / rtpfunnel, RTX, VP8, VP9 and Opus) and
``elements/dtmf_icy.py`` (dtmfsrc, icydemux, amrparse, dcaparse; its
aacparse is the port's ``audioparsers.AacParse``).

The JAX package's ``tests/test_rtp_payloaders.py``, ``test_rtp_codecs.py``
and ``test_dtmf_icy.py`` run again on the port's modules (``on_port``; the
cases marked to need libavcodec encode and decode with the libav family and
run in ``test_torch_libav.py``).  The same seeded or committed inputs go through both
packages: packets byte for byte, depayloaded frames, PCM, caps and
timestamps equal, tolerance 0.  The H.264 cases use the synthetic stream
of ``tests/test_videoparsers.py``.
"""

import os
import re
import struct

import numpy as np
import pytest

from gstreamer_tpu.codecs import jpeg as jjpeg
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.net import rtp_payloaders as jpay
from gstreamer_tpu.net.rtp import parse_rtp_header, rtp_header

from gstreamer_tpu_torch.codecs import jpeg as tjpeg
from gstreamer_tpu_torch.codecs import opus as topus
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.parse import parse_launch as tparse_launch
from gstreamer_tpu_torch.elements import audioparsers as taudioparsers
from gstreamer_tpu_torch.elements import dtmf_icy as tdtmf
from gstreamer_tpu_torch.elements.ogg import parse_ogg_pages
from gstreamer_tpu_torch.net import rtp_payloaders as tpay

import test_dtmf_icy
import test_rtp_codecs
import test_rtp_payloaders
from test_torch_captions import pair
from test_torch_rtp import _cpu_make, packets, reference_tests, run_on_port
from test_videoparsers import SC, make_slice, make_sps

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_codecs")
OPUS = os.path.join(DATA, "opus_10s.opus")
VP8 = os.path.join(DATA, "vp8_1080p.ivf")

REFERENCE = (reference_tests(test_rtp_payloaders)
             + reference_tests(test_rtp_codecs)
             + reference_tests(test_dtmf_icy))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    """The JAX package's payloader, RTP-codec and DTMF/ICY tests on the
    port's modules."""
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


def rows(samples):
    """Packets of every sample, as bytes."""
    return [packets(s.buffer.data) for s in samples]


def pay_pair(desc, pushes=None, batch=1):
    """`desc` in both packages; the packets equal too (``pair`` holds the
    samples); returns the JAX samples."""
    _, ref, _, out = pair(desc, pushes, batch=batch)
    assert rows(out["out"]) == rows(ref["out"])
    return ref["out"]


def test_aacparse_is_one_class():
    """dtmf_icy takes the port's audioparsers.AacParse; the registry's
    aacparse is that class."""
    from gstreamer_tpu_torch.core.element import get_factory_class
    assert tdtmf.AacParse is taudioparsers.AacParse
    assert get_factory_class("aacparse") is taudioparsers.AacParse


@pytest.mark.parametrize("enc,pay,depay,dec", [
    ("mulawenc", "rtppcmupay", "rtppcmudepay", "mulawdec"),
    ("alawenc", "rtppcmapay", "rtppcmadepay", "alawdec")])
@pytest.mark.parametrize("mtu", [1400, 100])
def test_law_payloaders(enc, pay, depay, dec, mtu):
    src = ("audiotestsrc num-buffers=3 samplesperbuffer=700 ! "
           f"audio/x-raw,format=S16LE,rate=8000,channels=1 ! {enc} ! ")
    pay_pair(src + f"{pay} mtu={mtu} ! appsink name=out")
    pair(src + f"{pay} mtu={mtu} ! {depay} ! {dec} ! appsink name=out")


def _h264(pad):
    sps = make_sps(8, 6)
    slices = [make_slice(0, idr=(k == 0)) + bytes([0x40 + k]) * pad
              for k in range(4)]
    return b"".join(SC + sps + SC + s for s in slices)


@pytest.mark.parametrize("pad,mtu", [(0, 1400), (200, 64), (40, 80)])
def test_h264_pay_depay(pad, mtu):
    push = {"in": [dict(data=np.frombuffer(_h264(pad), np.uint8), pts=0)]}
    head = "appsrc name=in ! application/octet-stream ! h264parse ! "
    pay_pair(head + f"rtph264pay mtu={mtu} ! appsink name=out", push)
    pair(head + f"rtph264pay mtu={mtu} ! rtph264depay ! appsink name=out",
         push)


def test_h264_stapa_depay():
    n = [bytes([0x67, 1, 2, 3]), bytes([0x68, 7]), bytes([0x65, 9, 9, 9])]
    stap = bytes([24]) + b"".join(struct.pack(">H", len(x)) + x for x in n)
    pkts = [rtp_header(96, 0, 0, 1, marker=True) + stap,
            rtp_header(96, 1, 3000, 1) + bytes([0x41, 5, 5]),
            rtp_header(96, 2, 3000, 1, marker=True) + bytes([0x41, 6])]
    pair("appsrc name=in ! application/x-rtp ! rtph264depay ! "
         "appsink name=out", {"in": [dict(data=pkts, pts=0)]})


@pytest.mark.parametrize("demux,key", [("rtpptdemux", "pt"),
                                       ("rtpssrcdemux", "ssrc")])
def test_demuxers_route_alike(demux, key):
    rng = np.random.default_rng(4)
    pkts = [rtp_header(int(rng.choice([96, 97, 98])) if key == "pt" else 96,
                       k, 90 * k, int(rng.choice([11, 22, 33]))
                       if key == "ssrc" else 5) + bytes([k]) * 3
            for k in range(12)]
    sinks = ("a", "b", "c")
    jp, ref, tp, out = pair(
        f"appsrc name=in ! application/x-rtp ! {demux} name=d "
        "d.src_0 ! appsink name=a d.src_1 ! appsink name=b "
        "d.src_2 ! appsink name=c", {"in": [dict(data=pkts, pts=0)]},
        sinks=sinks)
    for s in sinks:
        assert rows(out[s]) == rows(ref[s])


@pytest.mark.parametrize("props", [
    "tones=5 tone-duration=100 packet-interval=20",
    "tones=123#*A tone-duration=150 volume=10 packet-redundancy=2",
    "tones=D0 tone-duration=40 packet-interval=50"])
def test_dtmf_events_and_tone(props):
    pay_pair(f"rtpdtmfsrc {props} ! appsink name=out", batch=2)
    pair(f"rtpdtmfsrc {props} ! rtpdtmfdepay ! appsink name=out", batch=2)


@pytest.mark.parametrize("props", ["tones=123#*A", "tones=9 volume=20 "
                                   "tone-duration=70 inter-tone-gap=30"])
def test_dtmfsrc(props):
    pair(f"dtmfsrc {props} ! appsink name=out")
    for key in tdtmf.DTMF_KEYS:
        np.testing.assert_array_equal(
            tdtmf.generate_dtmf(key, 400, 8000, 3, start_sample=17),
            test_dtmf_icy.generate_dtmf(key, 400, 8000, 3, start_sample=17))


def jpegs(w, h, n, quality=85):
    """JPEG files of seeded I420 frames from the port's jpegenc (4:2:0
    baseline, what rtpjpegpay takes as type 1)."""
    rng = np.random.default_rng(w + n)
    frames = (rng.integers(0, 256, (n, h, w), dtype=np.uint8),
              rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
              rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8))
    p = tparse_launch(f"appsrc name=in caps=video/x-raw,format=I420,"
                      f"width={w},height={h},framerate=25/1 ! jpegenc "
                      f"quality={quality} ! appsink name=out", batch=n,
                      device="cpu")
    p.get_by_name("in").push_buffer(Buffer(data=frames, pts=0,
                                           duration=40_000_000, batch=n))
    p.get_by_name("in").end_of_stream()
    p.run()
    out = []
    while (s := p.get_by_name("out").pull_sample()) is not None:
        d = s.buffer.data
        out.extend(np.asarray(x).tobytes() for x in
                   (d if isinstance(d, (list, tuple)) else [d]))
    return out


@pytest.mark.parametrize("w,h,quality,mtu", [(64, 48, 255, 300),
                                             (96, 64, 255, 1400),
                                             (64, 48, 75, 200),
                                             (128, 72, 100, 900)])
def test_jpeg_pay_depay(w, h, quality, mtu):
    """RFC 2435 packets equal; the depayloaded JPEGs (headers rebuilt, so
    not the files' bytes) equal, and decode to the files' planes."""
    imgs = jpegs(w, h, 3)
    push = {"in": [dict(data=np.frombuffer(b, np.uint8), pts=k * 40_000_000,
                        duration=40_000_000) for k, b in enumerate(imgs)]}
    head = f"appsrc name=in ! image/jpeg ! rtpjpegpay mtu={mtu} " \
           f"quality={quality} ! "
    pay_pair(head + "appsink name=out", push)
    _, ref, _, out = pair(head + "rtpjpegdepay ! appsink name=out", push)
    back = [x for r in rows(out["out"]) for x in r]
    assert len(back) == len(imgs)
    if quality >= 128:                   # in-band tables: the same image
        for a, b in zip(imgs, back):
            ya = tjpeg.jpeg_decode(a, device="cpu")[0]
            yb = tjpeg.jpeg_decode(b, device="cpu")[0]
            for pa, pb in zip(ya, yb):
                np.testing.assert_array_equal(np.asarray(pa),
                                              np.asarray(pb))


def test_jpeg_tables_match():
    for q in (1, 25, 50, 75, 99, 127):
        assert tpay.rfc2435_make_tables(q) == jpay.rfc2435_make_tables(q)
    qt = tpay.rfc2435_make_tables(60)
    for args in ((0, 8, 6, qt, 0, 0), (1, 240, 135, qt, 0, 64),
                 (65, 10, 10, qt + qt, 3, 16)):
        assert tpay.rfc2435_make_headers(*args) == \
            jpay.rfc2435_make_headers(*args)


def test_jpeg_frame_without_its_first_packet_is_a_reference_fault():
    """A reference fault (ROADMAP.md section 3): rtpjpegdepay keeps no
    sequence numbers, so a frame whose first packet was lost goes on as
    the rest of its scan with no JPEG header (the same bytes in both
    packages), and the decoder raises on it in both: over UDP one lost
    packet ends the camera's rtspsrc ! rtpjpegdepay ! jpegdec."""
    push = {"in": [dict(data=np.frombuffer(b, np.uint8), pts=k * 40_000_000,
                        duration=40_000_000)
                   for k, b in enumerate(jpegs(64, 48, 2))]}
    pkts = [p for r in rows(pay_pair("appsrc name=in ! image/jpeg ! "
                                     "rtpjpegpay mtu=200 ! appsink name=out",
                                     push)) for p in r]
    second = next(k for k, p in enumerate(pkts) if p[1] & 0x80) + 1
    lost = pkts[:second] + pkts[second + 1:]
    j, t = jmake("rtpjpegdepay"), _cpu_make("rtpjpegdepay")
    j.start()
    t.start()
    got_j = packets(j.host_process(JBuffer(data=list(lost), pts=0)).data)
    got_t = packets(t.host_process(Buffer(data=list(lost), pts=0)).data)
    assert got_t == got_j and len(got_t) == 2
    assert got_t[0][:2] == b"\xff\xd8" and got_t[1][:2] != b"\xff\xd8"
    with pytest.raises(ValueError, match="not a JPEG"):
        jjpeg.jpeg_decode(got_j[1])
    with pytest.raises(ValueError, match="not a JPEG"):
        tjpeg.jpeg_decode(got_t[1], device="cpu")
    p = tparse_launch("appsrc name=in caps=application/x-rtp,media=video,"
                      "encoding-name=JPEG,clock-rate=90000,payload=26 ! "
                      "rtpjpegdepay ! jpegdec ! video/x-raw,format=I420,"
                      "width=64,height=48,framerate=25/1 ! appsink name=out",
                      device="cpu")
    p.get_by_name("in").push_buffer(Buffer(data=list(lost), pts=0))
    p.get_by_name("in").end_of_stream()
    with pytest.raises(ValueError, match="not a JPEG"):
        p.run()


@pytest.mark.parametrize("tail", ["rtpmux ssrc=4242 seqnum-offset=100",
                                  "rtpfunnel", "rtpdtmfmux"])
def test_mux_family(tail):
    pay_pair("audiotestsrc num-buffers=3 samplesperbuffer=400 ! "
             "audio/x-raw,format=S16LE,rate=8000,channels=1 ! mulawenc ! "
             f"rtppcmupay ! {tail} ! appsink name=out")


def test_rtx_cycle_matches():
    orig = [rtp_header(0, k, 1000 + k, 777) + bytes([k]) * 10
            for k in range(8)]
    outs = []
    for make, buf in ((jmake, JBuffer), (_cpu_make, Buffer)):
        send = make("rtprtxsend", **{"rtx-payload-type": 97,
                                     "max-size-packets": 6})
        recv = make("rtprtxreceive", **{"rtx-payload-type": 97,
                                        "orig-payload-type": 0})
        q = make("rtprtxqueue")
        for e in (send, recv, q):
            e.start()
        got = [packets(send.host_process(buf(data=list(orig), pts=0)).data)]
        got.append([send.request_retransmit(s) for s in (0, 2, 5, 7)])
        rtx = send.host_process(buf(data=[], pts=0)).data
        got.append(packets(rtx))
        got.append(packets(recv.host_process(
            buf(data=list(orig) + list(rtx), pts=0)).data))
        got.append(recv.num_rtx_packets)
        q.host_process(buf(data=list(orig), pts=0))
        got.append([q.request_retransmit(s) for s in (1, 3)])
        got.append(packets(q.host_process(buf(data=[], pts=0)).data))
        outs.append(got)
    assert outs[1] == outs[0]


def test_vp8_from_ivf():
    """The committed 1080p VP8 stream through ivfparse, rtpvp8pay and
    rtpvp8depay (no libvpx needed): packets equal, and the frames equal
    ivfparse's."""
    head = f"filesrc location={VP8} ! ivfparse ! "
    _, frames, _, _ = pair(head + "appsink name=out")
    pay_pair(head + "rtpvp8pay mtu=1200 ! appsink name=out")
    _, ref, _, out = pair(head + "rtpvp8pay mtu=1200 ! rtpvp8depay ! "
                          "appsink name=out")
    assert [x for r in rows(out["out"]) for x in r] == \
        [x for r in rows(frames["out"]) for x in r]


def _frame_pushes(n, seed, caps_rate=30):
    rng = np.random.default_rng(seed)
    return {"in": [dict(data=rng.integers(0, 256, int(rng.integers(1, 3000)),
                                          dtype=np.uint8),
                        pts=k * 1_000_000_000 // caps_rate,
                        duration=1_000_000_000 // caps_rate)
                   for k in range(n)]}


@pytest.mark.parametrize("codec,mtu", [("vp8", 200), ("vp9", 300),
                                       ("vp9", 1400)])
def test_vpx_pay_depay(codec, mtu):
    push = _frame_pushes(6, mtu)
    head = f"appsrc name=in ! video/x-{codec} ! rtp{codec}pay mtu={mtu} ! "
    pay_pair(head + "appsink name=out", push)
    _, ref, _, out = pair(head + f"rtp{codec}depay ! appsink name=out", push)
    back = [x for r in rows(out["out"]) for x in r]
    assert back == [b["data"].tobytes() for b in push["in"]]


def opus_packets():
    """The audio packets of the committed Ogg-Opus file, its OpusHead's
    channel count and pre-skip."""
    with open(OPUS, "rb") as f:
        pages = parse_ogg_pages(f.read())
    pk = [p for _serial, _g, ps in pages for p in ps]
    ch, pre_skip, _rate, _gain = topus.parse_opus_head(pk[0])
    return [p for p in pk[1:] if not p.startswith(b"OpusTags")], ch, pre_skip


def test_opus_pay_depay_and_decode():
    """Opus packets through rtpopuspay and rtpopusdepay in both packages;
    the depayloaded packets, decoded with opusdec's decoder, give
    opusdec's PCM of the file."""
    pk, ch, pre_skip = opus_packets()
    pk = pk[:60]
    push = {"in": [dict(data=np.frombuffer(p, np.uint8), pts=k * 20_000_000,
                        duration=20_000_000) for k, p in enumerate(pk)]}
    head = "appsrc name=in ! audio/x-opus ! rtpopuspay ! "
    pay_pair(head + "appsink name=out", push)
    _, ref, _, out = pair(head + "rtpopusdepay ! appsink name=out", push)
    back = [x for r in rows(out["out"]) for x in r]
    assert back == pk
    dec = topus.HybridOpusDecoder(ch)
    pcm = np.concatenate([dec.decode(p) for p in back])[pre_skip:]
    whole, _rate, _ch = topus.decode_ogg(open(OPUS, "rb").read())
    np.testing.assert_array_equal(pcm, whole[:len(pcm)])


def test_opusdec_takes_no_packets_in_either_package():
    """opusdec is a file source in both packages (``location``): it has no
    sink pad, so ``rtpopusdepay ! opusdec`` does not link in either
    (ROADMAP.md section 3).  A depayloaded stream is decoded with the
    decoder opusdec runs (``codecs.opus.HybridOpusDecoder``)."""
    desc = ("appsrc name=in ! application/x-rtp ! rtpopusdepay ! opusdec ! "
            "appsink name=out")
    errors = []
    for parse, kw in ((jparse_launch, {}), (tparse_launch,
                                            {"device": "cpu"})):
        with pytest.raises(Exception) as e:
            parse(desc, **kw)
        errors.append((type(e.value).__name__,
                       re.sub(r"\d+", "", str(e.value))))
    assert errors[1] == errors[0] == (
        "ValueError", "cannot link rtpopusdepay ! opusdec: no free pads")


def test_payloader_extensions_match():
    """rtpvp8pay with an audio-level and a twcc extension: the same
    extension blocks in every packet."""

    def setup(make):
        def go(pipe):
            pay = pipe.get_by_name("pay")
            pay.add_extension(make("rtphdrextclientaudiolevel", id=1,
                                   level=12))
            pay.add_extension(make("rtphdrexttwcc", id=3))
        return go

    desc = ("appsrc name=in ! video/x-vp8 ! rtpvp8pay name=pay mtu=300 ! "
            "appsink name=out")
    push = _frame_pushes(4, 9)
    _, ref, _, out = pair(desc, push, setup=setup(_cpu_make),
                          jsetup=setup(jmake))
    assert rows(out["out"]) == rows(ref["out"])
    assert all(parse_rtp_header(p)["extension_profile"] == 0xBEDE
               for r in rows(out["out"]) for p in r)


def test_icydemux(tmp_path):
    payload = bytes(range(256)) * 3
    blob = bytearray()
    meta = b"StreamTitle='Song A';"
    meta += b"\0" * (-len(meta) % 16)
    for k in range(0, len(payload), 100):
        blob += payload[k:k + 100]
        if k + 100 < len(payload):
            blob += bytes([len(meta) // 16]) + meta if k % 200 == 0 \
                else b"\0"
    f = tmp_path / "icy.bin"
    f.write_bytes(bytes(blob))
    pair(f"icydemux location={f} metaint=100 ! appsink name=out")


def _dca(size):
    hdr = bytearray(16)
    hdr[0:4] = b"\x7f\xfe\x80\x01"
    v = size - 1
    hdr[5], hdr[6], hdr[7] = (v >> 12) & 0x3, (v >> 4) & 0xFF, (v & 0xF) << 4
    return bytes(hdr) + bytes((k * 7) & 0xFF for k in range(size - 16))


@pytest.mark.parametrize("parser,blob", [
    ("amrparse", b"#!AMR\n" + b"".join(bytes([m << 3]) + b"\x55" * s
                                       for m, s in ((2, 15), (7, 31),
                                                    (0, 12), (8, 5)) * 3)),
    ("amrparse", b"#!AMR-WB\n" + b"".join(bytes([m << 3]) + b"\x33" * s
                                          for m, s in ((1, 23), (8, 60))
                                          * 4)),
    ("dcaparse", b"\x00\x01" + _dca(96) + _dca(200) + _dca(96)),
    ("aacparse", b"xx" + b"".join(test_dtmf_icy._adts_frame(64 + k, 3)
                                  for k in range(6)))])
def test_thin_parsers(parser, blob):
    pair(f"appsrc name=in ! application/octet-stream ! {parser} ! "
         "appsink name=out",
         {"in": [dict(data=np.frombuffer(blob, np.uint8))]})
