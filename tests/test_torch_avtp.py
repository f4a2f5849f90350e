"""The port's ``net/avtp.py`` (IEEE 1722: AAF, CVF and RVF pay/depay,
avtpsink / avtpsrc over AF_PACKET, avtpcrfsync, avtpcrfcheck) against the
JAX package.

The AVTP cases of the JAX package's ``tests/test_misc_elements2.py`` run
again on the port (the AF_PACKET case skips, in both packages, where the
process may not open such a socket).  The PDUs are held byte for byte at
tolerance 0: AAF, CVF with FU-A fragments, RVF lines and line fragments,
CRF-adjusted timestamps; launch strings through both packages give the
same packets, samples and frames.  The port differs from the JAX package
in three places, each a reference fault with its own case below and in
ROADMAP.md section 3: avtpaafpay writes typed S16BE samples big-endian,
avtprvfpay puts at most 255 lines in a PDU, and avtprvfdepay skips a PDU
with no active pixels and gives a one-plane tuple.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.net import avtp as javtp

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.net import avtp as tavtp

import test_misc_elements2
from test_torch_analytics import same_spec
from test_torch_captions import pair
from test_torch_flow import NET_TAIL_FACTORIES
from test_torch_rtp import _cpu_make, packets
from test_torch_webrtc import reference_cases, run_case

REFERENCE = reference_cases(test_misc_elements2, only=("test_avtp",))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    run_case(case, tmp_path)


@pytest.mark.parametrize("factory", [f for f in NET_TAIL_FACTORIES
                                     if f.startswith("avtp")])
def test_factory_spec_matches_reference(factory):
    same_spec(factory)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- PDUs byte for byte -----------------------------------------------------
@pytest.mark.parametrize("rate,ch", [(48000, 2), (44100, 1), (8000, 8),
                                     (12345, 2)])
def test_aaf_pdus_match(rate, ch):
    rng = np.random.default_rng(rate + ch)
    payload = rng.integers(0, 256, 4 * ch * 12, np.uint8).tobytes()
    for seq, tv in ((0, True), (255, False), (300, True)):
        pdu = tavtp.build_aaf_pdu(seq, 0x1122334455667788, 2**33 + 5, rate,
                                  ch, payload, tv=tv)
        assert pdu == javtp.build_aaf_pdu(seq, 0x1122334455667788,
                                          2**33 + 5, rate, ch, payload,
                                          tv=tv)
        assert tavtp.parse_pdu(pdu) == javtp.parse_pdu(pdu)


@pytest.mark.parametrize("mtu", [50, 200, 1400])
def test_cvf_matches(mtu):
    rng = np.random.default_rng(mtu)
    aus = []
    for k in range(4):
        nals = [bytes([0x67]) + rng.integers(1, 256, 9, np.uint8).tobytes(),
                bytes([0x65 if k == 0 else 0x41]) + rng.integers(
                    1, 256, 90 + 400 * k, np.uint8).tobytes()]
        aus.append(b"".join(b"\x00\x00\x00\x01" + n for n in nals))
    pushes = {"in": [dict(data=np.frombuffer(a, np.uint8), pts=40 * k,
                          batch=1) for k, a in enumerate(aus)]}
    desc = ("appsrc name=in caps=video/x-h264,stream-format=byte-stream ! "
            f"avtpcvfpay mtu={mtu}")
    _, ref, _, _ = pair(f"{desc} ! appsink name=out", pushes)
    pdus = [p for s in ref["out"] for p in packets(s.buffer.data)]
    for p in pdus:
        assert tavtp.parse_pdu(p) == javtp.parse_pdu(p)
    _, ref, _, out = pair(f"{desc} ! avtpcvfdepay ! appsink name=out",
                          pushes)
    got = [p for s in out["out"] for p in packets(s.buffer.data)]
    assert got == aus


@pytest.mark.parametrize("w,h,fmt,mtu", [(64, 48, "GRAY16_LE", 1470),
                                         (64, 8, "GRAY16_LE", 96),
                                         (33, 17, "GRAY8", 1470),
                                         (1000, 4, "GRAY8", 300)])
def test_rvf_matches(w, h, fmt, mtu):
    rng = np.random.default_rng(w * h)
    dt = np.uint8 if fmt == "GRAY8" else np.uint16
    frames = rng.integers(0, 256 if fmt == "GRAY8" else 65536, (3, h, w),
                          dt)
    pushes = {"in": [dict(data=(frames[k:k + 1],), pts=k, batch=1)
                     for k in range(3)]}
    desc = (f"appsrc name=in caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=25/1 ! avtprvfpay mtu={mtu}")
    _, ref, _, out = pair(f"{desc} ! appsink name=out", pushes)
    for s in out["out"]:
        for p in packets(s.buffer.data):
            assert tavtp.parse_rvf_pdu(p) == javtp.parse_rvf_pdu(p)
    pdus = [p for s in out["out"] for p in packets(s.buffer.data)]
    d = _cpu_make("avtprvfdepay")
    back = d.host_process(Buffer(data=pdus, batch=1))
    assert isinstance(back.data, tuple) and len(back.data) == 1
    assert np.array_equal(_host(back.data[0]), frames)
    jb = jmake("avtprvfdepay").host_process(JBuffer(data=pdus, batch=1))
    assert np.array_equal(np.asarray(jb.data), frames)


def test_crf_elements_match():
    rng = np.random.default_rng(5)
    crf = bytearray(40)
    crf[0] = javtp.SUBTYPE_CRF
    struct.pack_into(">I", crf, 12, 1000)
    struct.pack_into(">Q", crf, 24, 0x1_0000_5000)
    pdus = [javtp.build_aaf_pdu(k, 7, 3000 + 100 * k, 48000, 2,
                                rng.integers(0, 256, 16,
                                             np.uint8).tobytes())
            for k in range(6)]
    for factory in ("avtpcrfsync", "avtpcrfcheck"):
        outs = []
        for make, buffer in ((_cpu_make, Buffer), (jmake, JBuffer)):
            e = make(factory)
            r = [packets(e.host_process(buffer(data=pdus[:2],
                                               batch=1)).data),
                 packets(e.host_process(buffer(data=[bytes(crf)] + pdus[2:],
                                               batch=1)).data)]
            outs.append((r, e.num_adjusted, e.num_invalid))
        assert outs[0] == outs[1]


# -- the reference faults the port repairs ------------------------------------
def test_aaf_typed_samples_are_big_endian_a_reference_fault():
    """S16BE samples held as int16 values: the port writes them
    big-endian and reads back the same samples; the JAX package writes the
    host's order, so its depayloader reads byte-swapped samples."""
    pcm = (np.arange(96) * 311 - 9000).astype(np.int16).reshape(-1, 2)
    tpay, jpay = _cpu_make("avtpaafpay"), jmake("avtpaafpay")
    tpdu = tpay.host_process(Buffer(data=pcm, batch=1, pts=0)).data[0]
    jpdu = jpay.host_process(JBuffer(data=pcm, batch=1, pts=0)).data[0]
    assert tpdu[24:] == pcm.astype(">i2").tobytes()
    assert jpdu[24:] == pcm.tobytes() != tpdu[24:]
    back = _cpu_make("avtpaafdepay").host_process(Buffer(data=[tpdu],
                                                         batch=1))
    assert np.array_equal(_host(back.data), pcm)
    jback = jmake("avtpaafdepay").host_process(JBuffer(data=[jpdu], batch=1))
    assert not np.array_equal(np.asarray(jback.data), pcm)
    raw = np.frombuffer(pcm.astype(">i2").tobytes(), np.uint8)
    assert tpay.host_process(Buffer(data=raw, batch=1, pts=0)).data[0] == \
        jpay.host_process(JBuffer(data=raw, batch=1, pts=0)).data[0]


def test_rvf_num_lines_wraps_a_reference_fault():
    """A 4-pixel GRAY8 line: 359 lines would fit a PDU, num_lines is 8
    bits.  The port puts 255 lines in a PDU; the JAX package writes 359 &
    0xFF = 103 while carrying 359 lines."""
    frame = (np.arange(400 * 4) % 251).astype(np.uint8).reshape(1, 400, 4)
    t = _cpu_make("avtprvfpay")
    t._depth8, t._w, t._h = True, 4, 400
    j = jmake("avtprvfpay")
    j._depth8, j._w, j._h = True, 4, 400
    th = [tavtp.parse_rvf_pdu(p) for p in t.host_process(
        Buffer(data=(frame,), batch=1, pts=0)).data]
    jh = [javtp.parse_rvf_pdu(p) for p in j.host_process(
        JBuffer(data=(frame,), batch=1, pts=0)).data]
    assert [h["num_lines"] for h in th] == [255, 145]
    assert [len(h["payload"]) // 4 for h in th] == [255, 145]
    assert jh[0]["num_lines"] == 103 and len(jh[0]["payload"]) == 4 * 359
    back = _cpu_make("avtprvfdepay").host_process(Buffer(
        data=t.host_process(Buffer(data=(frame,), batch=1, pts=0)).data,
        batch=1))
    assert np.array_equal(_host(back.data[0]), frame)


def test_rvf_zero_active_pixels_a_reference_fault():
    """A PDU with active_pixels 0: the JAX package divides by the zero
    line size; the port skips the PDU and goes on."""
    bad = javtp.build_rvf_pdu(0, 1, 0, 0, 4, True, 1, 1, 0, True, b"\0" * 8)
    good = javtp.build_rvf_pdu(1, 1, 0, 4, 1, True, 1, 1, 0, True,
                               b"\x01\x02\x03\x04")
    with pytest.raises(ZeroDivisionError):
        jmake("avtprvfdepay").host_process(JBuffer(data=[bad, good],
                                                   batch=1))
    out = _cpu_make("avtprvfdepay").host_process(Buffer(data=[bad, good],
                                                        batch=1))
    assert _host(out.data[0]).tolist() == [[[1, 2, 3, 4]]]


def test_rvf_depay_frames_feed_the_converter():
    """The depayloaded frames (a one-plane tuple on the element's device)
    go through videoconvertscale as appsrc's GRAY8 frames do; the JAX
    package's bare array is read plane by plane there.  The depayloader's
    caps carry no size (as the JAX package's): a capsfilter names it."""
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (2, 48, 64), np.uint8)
    outs = []
    for desc in ("avtprvfpay ! avtprvfdepay ! video/x-raw,format=GRAY8,"
                 "width=64,height=48,framerate=25/1 ! ", ""):
        p = __import__("gstreamer_tpu_torch").parse_launch(
            "appsrc name=in caps=video/x-raw,format=GRAY8,width=64,"
            f"height=48,framerate=25/1 ! {desc}videoconvertscale ! "
            "video/x-raw,format=RGB,width=32,height=24 ! appsink name=out",
            batch=2, device="cpu")
        p.get_by_name("in").push_buffer(Buffer(data=(frames,), batch=2))
        p.get_by_name("in").end_of_stream()
        p.run()
        s = p.get_by_name("out").pull_sample()
        outs.append([_host(x) for x in s.buffer.data])
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    assert outs[0][0].shape == (2, 24, 32)


# -- AF_PACKET on lo --------------------------------------------------------
def _af_packet_ok():
    try:
        s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                          socket.htons(javtp.ETH_P_TSN))
        s.close()
        return True
    except (PermissionError, OSError, AttributeError):
        return False


@pytest.mark.skipif(not _af_packet_ok(), reason="AF_PACKET unavailable")
@pytest.mark.parametrize("port_sends", [False, True])
def test_avtp_over_lo_across_packages(port_sends):
    """An avtpsink of one package to an avtpsrc of the other on lo."""
    src = (jmake if port_sends else _cpu_make)("avtpsrc", ifname="lo",
                                               timeout=3.0)
    sink = (_cpu_make if port_sends else jmake)("avtpsink", ifname="lo")
    buffer = Buffer if port_sends else JBuffer
    src.start()
    sink.start()
    sid = 0xAB00 + port_sends
    pdus = [javtp.build_aaf_pdu(k, sid, 99 + k, 48000, 2, bytes([k]) * 8)
            for k in range(3)]
    got = []

    def rx():
        end = time.monotonic() + 5.0
        while len(got) < 3 and time.monotonic() < end:
            b = src.create(1)
            for p in packets(b.data) if b else []:
                if javtp.parse_pdu(p)["stream_id"] == sid:
                    got.append(p[:len(pdus[0])])

    th = threading.Thread(target=rx)
    th.start()
    time.sleep(0.2)
    sink.render(buffer(data=pdus, batch=1))
    th.join(6.0)
    sink.stop()
    src.stop()
    assert got == pdus and sink.frames_sent == 3
