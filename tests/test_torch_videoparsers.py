"""The port's video parsers against the JAX package, bit for bit: h264parse,
mpegvideoparse, ivfparse, h265parse, mpeg4videoparse, av1parse, vp9parse
and pngparse, with the SPS reader and the emulation-prevention strip.

The same bytes go through both packages, pushed whole or cut into chunks
that split frames; every sample's payload, timestamps, caps and metas and
the negotiated caps equal (``test_torch_captions.pair``), tolerance 0.  The
streams come from the JAX package's own test helpers (``make_sps``,
``make_slice``, the MPEG-2 headers, hand-made IVF files) and, for H.265,
MPEG-4 part 2 and AV1, from seeded frames through the JAX package's
libavcodec encoder (skips only where that library is absent).
"""

import struct

import numpy as np
import pytest

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import videoparsers as jvp
from gstreamer_tpu.native import av as native_av

from gstreamer_tpu_torch import parse_launch as tparse_launch
from gstreamer_tpu_torch.codecs.png import png_encode
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements import videoparsers as tvp

from test_torch_captions import _run, host_element, pair, sample_rows
from test_jpegformat_ivf import _mk_ivf
from test_videoparsers import SC, make_slice, make_sps
from test_videoparsers2 import _enc_stream

needs_av = pytest.mark.skipif(not native_av.available(),
                              reason="libavcodec shim unavailable")


def h264_stream():
    return b"".join(SC + make_sps() + SC + make_slice(0, idr=(k == 0))
                    for k in range(4))


def mpeg2_stream():
    seq = (b"\x00\x00\x01\xb3" + bytes([352 >> 4, ((352 & 0xF) << 4) | 1,
                                        288 & 0xFF, 0x13])
           + b"\x00\x00\x00\x00")
    return b"".join([seq + b"\x00\x00\x01\x00" + bytes([1]) * 16,
                     b"\x00\x00\x01\x00" + bytes([2]) * 16,
                     b"\x00\x00\x01\x00" + bytes([3]) * 16])


def png_stream():
    rng = np.random.default_rng(0)
    return b"".join(png_encode(rng.integers(0, 256, (16, 12, 3), np.uint8))
                    for _ in range(3))


def vp9_superframes():
    f1, f2 = b"\x11" * 10, b"\x22" * 20
    marker = bytes([0xC9])
    idx = marker + (10).to_bytes(2, "little") + (20).to_bytes(2, "little") \
        + marker
    return f1 + f2 + idx


STREAMS = {
    "h264parse": ("application/octet-stream", h264_stream),
    "mpegvideoparse": ("application/octet-stream", mpeg2_stream),
    "ivfparse-vp8": ("video/x-ivf", lambda: _mk_ivf(b"VP80")[0]),
    "ivfparse-vp9": ("video/x-ivf", lambda: _mk_ivf(b"VP90")[0]),
    "ivfparse-av1": ("video/x-ivf", lambda: _mk_ivf(b"AV01")[0]),
    "pngparse": ("application/octet-stream", png_stream),
}
AV_STREAMS = {
    "h265parse": ("libx265", "preset=veryfast:tune=zerolatency:"
                  "x265-params=log-level=none"),
    "mpeg4videoparse": ("mpeg4", ""),
    "av1parse": ("libaom-av1", "usage=realtime:cpu-used=8"),
}


def pushes(blob, chunks, pts=0):
    """`blob` cut into `chunks` nearly equal pushes."""
    cuts = np.linspace(0, len(blob), chunks + 1).astype(int)
    return [dict(data=np.frombuffer(blob[a:b], np.uint8).copy(),
                 pts=pts if k == 0 else None)
            for k, (a, b) in enumerate(zip(cuts, cuts[1:]))]


def run_pair(factory, caps, blob, chunks=1, batch=1):
    factory = factory.split("-")[0]
    return pair(f"appsrc name=in ! {caps} ! {factory} ! appsink name=out",
                {"in": pushes(blob, chunks)}, batch=batch)


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_parser_streams(name, chunks):
    caps, make = STREAMS[name]
    _, ref, _, out = run_pair(name, caps, make(), chunks)
    assert len(out["out"]) == len(ref["out"]) > 0


@needs_av
@pytest.mark.parametrize("factory", sorted(AV_STREAMS))
def test_parser_coded_streams(factory):
    codec, opts = AV_STREAMS[factory]
    blob = _enc_stream(codec, opts=opts)
    for chunks in (1, 4):
        _, ref, _, out = run_pair(factory, "application/octet-stream",
                                  blob, chunks)
        assert len(out["out"]) == len(ref["out"]) > 0


@pytest.mark.parametrize("factory", ["h264parse", "mpegvideoparse",
                                     "h265parse", "mpeg4videoparse",
                                     "av1parse", "pngparse", "ivfparse"])
def test_parser_fuzz(factory):
    """Seeded garbage: the same samples, or the same error, in both."""
    rng = np.random.default_rng(5)
    blob = bytes(rng.integers(0, 256, 700, np.uint8))
    caps = "video/x-ivf" if factory == "ivfparse" \
        else "application/octet-stream"
    desc = f"appsrc name=in ! {caps} ! {factory} ! appsink name=out"
    got = []
    for parse, buf, kw in ((jparse_launch, JBuffer, {}),
                           (tparse_launch, Buffer, {"device": "cpu"})):
        try:
            _, sinks = _run(parse, buf, desc, {"in": pushes(blob, 1)},
                            ("out",), 1, None, **kw)
            got.append(sample_rows(sinks["out"]))
        except Exception as e:             # compared, not hidden
            got.append((type(e).__name__, str(e)))
    assert got[1] == got[0]


def test_vp9parse_superframe():
    blob = vp9_superframes()
    assert tvp.Vp9Parse.split_superframe(blob) == \
        jvp.Vp9Parse.split_superframe(blob)
    push = [dict(data=[np.frombuffer(blob, np.uint8).copy(),
                       np.frombuffer(b"\x33" * 7, np.uint8).copy()],
                 batch=2, pts=0)]
    pair("appsrc name=in caps=video/x-vp9 ! vp9parse ! appsink name=out",
         {"in": push})


@pytest.mark.parametrize("mbs,crop", [((40, 30), None),
                                      ((120, 68), (0, 0, 0, 4)),
                                      ((8, 6), (1, 2, 0, 0))])
def test_parse_sps(mbs, crop):
    sps = make_sps(*mbs, crop=crop)
    assert tvp.parse_sps(sps) == jvp.parse_sps(sps)
    for raw in (b"\x00\x00\x03\x01", b"\x12\x34", b"\x00\x00\x03"):
        assert tvp._rbsp(raw) == jvp._rbsp(raw)


def test_h264parse_sps_info():
    """h264parse keeps the SPS it read, as the JAX element does."""
    blob = SC + make_sps(8, 6) + SC + make_slice(0) + SC + make_slice(0)
    j, t = jmake("h264parse"), host_element("h264parse")
    for e in (j, t):
        e.start()
        e.handle_frame(np.frombuffer(blob, np.uint8))
    assert t.sps == j.sps and t.sps["width"] == 128


def test_ivfparse_keyframe_resolution_and_bad_magic():
    hdr = b"DKIF" + struct.pack("<HH4sHHIIII", 0, 32, b"VP80", 32, 24, 30,
                                1, 1, 0)
    body = bytearray(10)
    body[6:8] = struct.pack("<H", 100)
    body[8:10] = struct.pack("<H", 80)
    _, _, _, out = run_pair("ivfparse", "video/x-ivf",
                            hdr + struct.pack("<IQ", 10, 0) + bytes(body))
    assert out["out"][0].caps[0]["width"] == 100
    with pytest.raises(ValueError):
        run_pair("ivfparse", "video/x-ivf", b"XXXX" + bytes(40))

