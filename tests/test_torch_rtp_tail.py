"""The port's ``net/rtp_tail.py`` (rtpmparobustdepay with ``adu_to_mp3``,
rtpxqtdepay, rtpsv3vdepay, rtpasfpay / rtpasfdepay) against the JAX
package, bit for bit.

The rtp_tail cases of the JAX package's ``tests/test_tail_elements.py``
run again on the port (``on_port``); their MP3 frames come from
``tests/test_audioparsers.make_mp3_frame``, which is bound to the port's
``mp3_frame_info`` too.  The same seeded inputs go through both packages:
MP3 streams, samples, caps and timestamps equal, tolerance 0.  ASF goes
over RTP from a file the port's asfmux wrote, read by asfparse.
"""

import struct

import numpy as np
import pytest

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.net import rtp_tail as jtail
from gstreamer_tpu.net.rtp import rtp_header

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.net import rtp_tail as ttail

import test_audioparsers
import test_tail_elements
from test_torch_captions import pair, plain
from test_torch_flv_asf import apushes, asrc
from test_torch_rtp import (_cpu_make, _port_globals, on_port, packets,
                            reference_tests, run_on_port)

REFERENCE = [c for c in reference_tests(test_tail_elements)
             if c[0].split("::")[1] in ("TestAduMp3", "TestRtpXqt",
                                        "TestRtpSv3v", "TestRtpAsf")]


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    """The JAX package's rtp_tail cases on the port's module, their MP3
    frames made with the port's header parser."""
    g = _port_globals(test_tail_elements.__dict__)
    g["make_mp3_frame"] = on_port(test_audioparsers.make_mp3_frame)
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


def mp3_frame(rng, bitrate_idx, sr_idx, mono, mdb, pad=0):
    """An MPEG-1 layer III frame: a valid header, side info whose
    main_data_begin is `mdb`, seeded bytes after it."""
    b3 = (bitrate_idx << 4) | (sr_idx << 2) | (pad << 1)
    hdr = bytes([0xFF, 0xFB, b3, 0xC0 if mono else 0x00])
    kbps = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
            320][bitrate_idx]
    rate = [44100, 48000, 32000][sr_idx]
    size = 144000 * kbps // rate + pad
    side = 17 if mono else 32
    si = bytearray(rng.integers(0, 256, side, dtype=np.uint8).tobytes())
    si[0] = mdb >> 1
    si[1] = (si[1] & 0x7F) | ((mdb & 1) << 7)
    body = rng.integers(0, 256, size - 4 - side, dtype=np.uint8).tobytes()
    return hdr + bytes(si) + body


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adu_to_mp3_with_a_reservoir(seed):
    rng = np.random.default_rng(seed)
    adus = []
    for k in range(12):
        f = mp3_frame(rng, int(rng.integers(5, 12)), seed % 3, k % 2 == 0,
                      0 if k == 0 else int(rng.integers(0, 300)))
        cut = int(rng.integers(40, len(f)))
        adus.append(f[:cut])
    adus.insert(3, b"\x00\x01garbage")
    assert ttail.adu_to_mp3(adus) == jtail.adu_to_mp3(adus)
    assert ttail._mpa_frame_info(adus[0]) == jtail._mpa_frame_info(adus[0])


def _adu_packets(adus, per_packet):
    """ADUs behind 1- or 2-byte descriptors, `per_packet` to a packet."""
    pkts, cur = [], b""
    for k, a in enumerate(adus):
        desc = bytes([len(a)]) if len(a) < 64 else \
            bytes([0x40 | (len(a) >> 8), len(a) & 0xFF])
        cur += desc + a
        if (k + 1) % per_packet == 0 or k == len(adus) - 1:
            pkts.append(rtp_header(14, len(pkts), 1152 * k, 0xAD) + cur)
            cur = b""
    return pkts


@pytest.mark.parametrize("per_packet,tick", [(1, 3), (2, 5), (3, 100)])
def test_mparobustdepay_matches(per_packet, tick):
    rng = np.random.default_rng(per_packet)
    adus = [mp3_frame(rng, 9, 0, False, 0 if k == 0 else 50)[:300]
            for k in range(10)]
    pkts = _adu_packets(adus, per_packet)
    pair("appsrc name=in ! application/x-rtp ! rtpmparobustdepay ! "
         "appsink name=out", {"in": [dict(data=pkts[k:k + tick], pts=k)
                                     for k in range(0, len(pkts), tick)]})


def _xqt(pck, body, q=b"", marker=True, seq=0):
    h = bytes([0x10 | (pck << 2) | (1 if q else 0), 0, 0, 0])
    return rtp_header(96, seq, 1000, 0xBB, marker=marker) + h + q + body


def _sd_tlv(fourcc):
    sd = struct.pack(">I", 16) + fourcc + b"\0" * 8
    tlv = struct.pack(">H", len(sd)) + b"sd" + sd
    pdlen = 8 + len(tlv)
    return struct.pack(">HH", 0, pdlen) + b"\0" * 4 + tlv \
        + b"\0" * ((-pdlen) % 4)


@pytest.mark.parametrize("fourcc", [b"avc1", b"jpeg", b"mp4a", b"zzzz"])
def test_xqtdepay_matches(fourcc):
    rng = np.random.default_rng(len(fourcc) + fourcc[0])
    frame = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    pkts = [_xqt(1, b"whole!", q=_sd_tlv(fourcc), seq=0),
            _xqt(3, frame[:300], marker=False, seq=1),
            _xqt(3, frame[300:], seq=2),
            _xqt(2, struct.pack(">HH", 0x8000, 5) + b"\0" * 4 + b"abcde"
                 + b"\0" * 3, seq=3)]
    j, t = jmake("rtpxqtdepay"), _cpu_make("rtpxqtdepay")
    for e in (j, t):
        e.start()
    a = t.host_process(Buffer(data=list(pkts), pts=0))
    b = j.host_process(JBuffer(data=list(pkts), pts=0))
    assert plain(a.data) == plain(b.data)
    assert str(t._caps) == str(j._caps)


def test_sv3vdepay_matches():
    w, h = 176, 144
    cfg = bytearray(6)
    cfg[0] = 0x40
    cfg[2] = (w >> 7) & 0x1F
    cfg[3] = ((w & 0x7F) << 1) | ((h >> 11) & 1)
    cfg[4] = (h >> 3) & 0xFF
    cfg[5] = (h & 7) << 5
    rng = np.random.default_rng(9)
    pkts = [rtp_header(96, 0, 0, 0xCC) + bytes(cfg)]
    for k in range(6):
        pkts.append(rtp_header(96, k + 1, 3000 * (k // 2), 0xCC,
                               marker=k % 2 == 1) + b"\0\0"
                    + rng.integers(0, 256, 90, dtype=np.uint8).tobytes())
    _, _, tp, _ = pair("appsrc name=in ! application/x-rtp ! rtpsv3vdepay "
                       "name=d ! appsink name=out",
                       {"in": [dict(data=pkts[:4], pts=0),
                               dict(data=pkts[4:], pts=1)]})
    assert (tp.get_by_name("d").width, tp.get_by_name("d").height) == (w, h)


def asf_packets(tmp_path):
    """The data packets of an ASF file the port's asfmux wrote from seeded
    stereo S16 (its data object cut at the fixed packet size)."""
    from gstreamer_tpu_torch.core.parse import parse_launch
    from gstreamer_tpu_torch.elements import asf as tasf
    from test_torch_captions import _run
    path = tmp_path / "a.asf"
    _run(parse_launch, Buffer, f"{asrc('S16LE', 22050, 2)} ! asfmux "
         f"location={path}", {"a": apushes("S16LE", 22050, 2, 700, 4)}, (),
         1, None, device="cpu")
    blob = path.read_bytes()
    at = blob.index(tasf.GUID_DATA)
    size = struct.unpack_from("<Q", blob, at + 16)[0]
    data = blob[at + 50:at + size]
    n = tasf._PACKET_SIZE
    assert len(data) % n == 0 and data
    return [np.frombuffer(data[k:k + n], np.uint8)
            for k in range(0, len(data), n)]


@pytest.mark.parametrize("mtu", [400, 1400, 4000])
def test_asf_over_rtp(mtu, tmp_path):
    """The data packets of an ASF file the port's asfmux wrote through
    rtpasfpay, then rtpasfpay ! rtpasfdepay, in both packages: the RTP
    packets equal, and the ASF packets come back as sent."""
    pk = asf_packets(tmp_path)
    pushes = {"in": [dict(data=p, pts=k * 10_000_000, duration=10_000_000)
                     for k, p in enumerate(pk)]}
    src = "appsrc name=in caps=\"video/x-ms-asf, parsed=true\""
    _, ref, _, out = pair(f"{src} ! rtpasfpay mtu={mtu} ! appsink name=out",
                          pushes)
    assert [packets(s.buffer.data) for s in out["out"]] == \
        [packets(s.buffer.data) for s in ref["out"]]
    _, ref, _, _ = pair(f"{src} ! rtpasfpay mtu={mtu} ! rtpasfdepay ! "
                        "appsink name=out", pushes)
    assert [p for s in ref["out"] for p in packets(s.buffer.data)] == \
        [p.tobytes() for p in pk]
