"""The port's pcapparse (``elements/pcapparse.py``) against the JAX package,
bit for bit.

The JAX package's ``tests/test_pcapparse.py`` runs again on the port's
module (``on_port``), and the same captures (built with that file's
``_ipv4`` / ``_ether`` / ``_pcap``) go through both packages: payloads,
timestamps and caps equal, tolerance 0.  A capture of an RTP/JPEG stream
replays through ``filesrc ! pcapparse ! rtpjpegdepay ! jpegdec !
videoconvertscale`` as ``chip_smoke.py``'s ``pcap_mjpeg_replay`` does, to
the same RGB as the JPEG files decoded without RTP.
"""

import numpy as np
import pytest

from gstreamer_tpu.elements import pcapparse as jpcap

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.parse import parse_launch as tparse_launch
from gstreamer_tpu_torch.elements import pcapparse as tpcap

import test_pcapparse
from test_pcapparse import _ether, _ipv4, _pcap
from test_torch_captions import pair, plain
from test_torch_rtp import reference_tests, run_on_port
from test_torch_rtp_payloaders import jpegs, rows

REFERENCE = reference_tests(test_pcapparse)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


def _frames():
    pk = [_ether(_ipv4(b"keep-%d" % k, dport=5004, src="10.0.0.1"))
          for k in range(5)]
    pk.insert(2, _ether(_ipv4(b"other-port", dport=9999)))
    pk.insert(4, _ether(_ipv4(b"other-ip", src="10.9.9.9", dport=5004)))
    pk.append(_ether(_ipv4(b"tcp-data", proto=6, dport=5004)))
    vlan = b"\xaa" * 6 + b"\xbb" * 6 + b"\x81\x00\x00\x2a\x08\x00"
    pk.append(vlan + _ipv4(b"vlan-%d" % 7, dport=5004))
    return pk


@pytest.mark.parametrize("props", [
    "", "dst-port=5004", "src-ip=10.0.0.1", "src-port=5004 ts-offset=11",
    "dst-port=5004 src-ip=10.0.0.1"])
@pytest.mark.parametrize("nanos,le", [(False, True), (True, False)])
def test_captures_match(props, nanos, le):
    blob = _pcap(_frames(), nanos=nanos, le=le)
    pair(f"appsrc name=in ! raw/x-pcap ! pcapparse {props} ! "
         "appsink name=out",
         {"in": [dict(data=np.frombuffer(blob, np.uint8), pts=0)]})


@pytest.mark.parametrize("nanos,le", [(False, True), (True, False)])
def test_caps_property_is_the_src_caps(nanos, le):
    """A reference fault (ROADMAP.md section 3): the JAX pcapparse puts its
    ``caps`` property on each buffer's meta only, and negotiates
    application/octet-stream.  The port's src pad takes the property's
    caps, as gstpcapparse.c does; payloads and timestamps are the
    same."""
    from gstreamer_tpu.core.buffer import Buffer as JBuffer
    from gstreamer_tpu.core.parse import parse_launch as jparse_launch
    from gstreamer_tpu_torch.interop import negotiated_caps
    blob = _pcap(_frames(), nanos=nanos, le=le)
    desc = ("appsrc name=in ! raw/x-pcap ! pcapparse name=pp dst-port=5004 "
            "caps=application/x-rtp,media=video,clock-rate=90000 ! "
            "appsink name=out")
    got = []
    for parse, buf, kw in ((jparse_launch, JBuffer, {}),
                           (tparse_launch, Buffer, {"device": "cpu"})):
        p = parse(desc, **kw)
        p.get_by_name("in").push_buffer(buf(data=np.frombuffer(blob,
                                                               np.uint8),
                                            pts=0))
        p.get_by_name("in").end_of_stream()
        p.run()
        got.append(([(s.buffer.pts, plain(s.buffer.data),
                      str(s.buffer.meta.get("caps")))
                     for s in _drain(p.get_by_name("out"))],
                    negotiated_caps(p)["pp:src"]))
    assert got[1][0] == got[0][0]
    assert got[0][1] == "application/octet-stream(memory:SystemMemory)"
    assert got[1][1] == ("application/x-rtp(memory:SystemMemory), "
                         "media=video, clock-rate=90000")


def test_raw_linktype_and_scan_frame():
    blob = _pcap([_ipv4(b"raw-%d" % k) for k in range(3)], linktype=101)
    pair("appsrc name=in ! raw/x-pcap ! pcapparse ! appsink name=out",
         {"in": [dict(data=np.frombuffer(blob, np.uint8), pts=0)]})
    for pkt, lt in ((_ether(_ipv4(b"x" * 40, proto=6)), 1),
                    (_ipv4(b"y" * 3), 101)):
        for kw in ({}, {"dst_port": 5004}, {"src_port": 1}):
            assert tpcap.scan_frame(pkt, lt, **kw) == \
                jpcap.scan_frame(pkt, lt, **kw)


def rtp_capture(imgs, mtu=1400, dport=5004):
    """RTP/JPEG packets of `imgs` (rtpjpegpay at 25/1 on the CPU), each
    in an Ethernet/IPv4/UDP record, with one foreign datagram between."""
    p = tparse_launch(f"appsrc name=in ! image/jpeg ! rtpjpegpay mtu={mtu} "
                      "! appsink name=out", device="cpu")
    for k, b in enumerate(imgs):
        p.get_by_name("in").push_buffer(Buffer(
            data=np.frombuffer(b, np.uint8), pts=k * 40_000_000,
            duration=40_000_000))
    p.get_by_name("in").end_of_stream()
    p.run()
    pkts = [x for r in rows(_drain(p.get_by_name("out"))) for x in r]
    recs = []
    for k, x in enumerate(pkts):
        recs.append(_ether(_ipv4(x, dport=dport)))
        if k == 3:
            recs.append(_ether(_ipv4(b"noise", dport=dport + 2)))
    return _pcap(recs), len(pkts)


def _drain(sink):
    out = []
    while (s := sink.pull_sample()) is not None:
        out.append(s)
    return out


def test_mjpeg_capture_replays_to_the_files_rgb(tmp_path):
    """The replay chain of ``pcap_mjpeg_replay`` at a small size: the RGB
    equals ``multifilesrc ! jpegdec`` of the same files.  jpegdec learns no
    size from rtpjpegdepay's caps in either package, so a capsfilter names
    it.  pcapparse's ``caps`` sets its src caps in the port; the JAX
    package only tags buffers with them and cannot link a depayloader
    after it (a reference fault, ROADMAP.md section 3)."""
    from gstreamer_tpu.core.parse import parse_launch as jparse_launch
    from gstreamer_tpu.core.pipeline import NegotiationError
    w, h = 96, 64
    imgs = jpegs(w, h, 5)
    for k, b in enumerate(imgs):
        (tmp_path / f"cam_{k:05d}.jpg").write_bytes(b)
    blob, n = rtp_capture(imgs, mtu=300)
    cap = tmp_path / "cam.pcap"
    cap.write_bytes(blob)
    rtp = "application/x-rtp,media=video,encoding-name=JPEG," \
          "clock-rate=90000,payload=26"
    tail = (f"rtpjpegdepay ! jpegdec ! video/x-raw,format=I420,width={w},"
            f"height={h},framerate=25/1 ! videoconvertscale ! "
            "video/x-raw,format=RGB,width=32,height=32 ! appsink name=out")
    replay = f"filesrc location={cap} ! pcapparse dst-port=5004 caps={rtp} ! "
    port = tparse_launch(replay + tail, batch=4, device="cpu")
    port.run()
    out = _drain(port.get_by_name("out"))
    with pytest.raises(NegotiationError, match="pcapparse"):
        jparse_launch(replay + tail, batch=4).run()
    _, files, _, files_port = pair(
        f"multifilesrc location={tmp_path}/cam_%05d.jpg caps=image/jpeg,"
        f"framerate=25/1 ! jpegdec ! video/x-raw,format=I420,width={w},"
        f"height={h},framerate=25/1 ! videoconvertscale ! "
        "video/x-raw,format=RGB,width=32,height=32 ! appsink name=out")

    def rgb(samples):
        return np.concatenate([np.stack([np.asarray(p) for p in s.buffer.data],
                                        axis=-1) for s in samples])
    assert rgb(out).shape == (5, 32, 32, 3)
    np.testing.assert_array_equal(rgb(out), rgb(files_port["out"]))
    np.testing.assert_array_equal(rgb(files["out"]), rgb(out))
    assert n > 5
