"""The port's caption and timecode host modules against the JAX package, bit
for bit: ``video/cc.py``, closedcaption (ccconverter, cccombiner,
ccextractor, cea608mux, line21encoder, line21decoder), cc_sei (the h264 /
h265 caption and SEI inserters and extractors, alpha_combine) and
timecode_misc (timecodestamper, avwait, the timestampers, combdetect, ivtc,
compare, audiolatency).

The same launch strings and the same seeded buffers go through both
packages (the port with ``device="cpu"``); every sample's data, timestamps,
flags, caps and metas, the negotiated caps and the element bus messages
equal, tolerance 0.  Media reach the port's appsinks as CPU tensors; caption
and coded bytes stay host arrays in both.  ``pair`` and ``plain`` serve the
other files of this slice (``test_torch_subpictures.py``,
``test_torch_scopes.py``, ``test_torch_file_formats.py``).
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import timecode_misc as jtm
from gstreamer_tpu.video import cc as jcc

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.elements import timecode_misc as ttm
from gstreamer_tpu_torch.interop import negotiated_caps
from gstreamer_tpu_torch.video import cc as tcc

from test_torch_analytics import same_spec
from test_torch_flow import BROADCAST_FACTORIES
from test_torch_pipeline import _name_elements

DUR = 33366666
CPU = torch.device("cpu")
FACTORIES = ("ccconverter", "cccombiner", "ccextractor", "cea608mux",
             "line21encoder", "line21decoder", "h264ccinserter",
             "h264ccextractor", "h265ccinserter", "h265ccextractor",
             "alpha_combine", "alphacombine", "h264seiinserter",
             "h265seiinserter", "timecodestamper", "avwait",
             "h264timestamper", "h265timestamper", "combdetect", "ivtc",
             "compare", "audiolatency")


# -- helpers: one launch string through both packages ------------------------

def plain(x):
    """Either package's value as plain comparable data: arrays and tensors
    by dtype, shape and bytes, caps and fractions by their string,
    containers walked."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [plain(v) for v in x])
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    elif hasattr(x, "shape") and hasattr(x, "dtype"):    # a jax array
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if type(x).__name__ in ("Caps", "Fraction"):
        return (type(x).__name__, str(x))
    if isinstance(x, bytearray):
        return bytes(x)
    return x


def _copy(data):
    if isinstance(data, (tuple, list)):
        return type(data)(_copy(x) for x in data)
    if isinstance(data, np.ndarray):
        return np.array(data, copy=True)
    return data


def _leaves(data):
    if isinstance(data, (tuple, list)):
        return [x for d in data for x in _leaves(d)]
    return [data]


def _media(caps) -> bool:
    return caps is not None and len(caps) and caps[0].name in (
        "video/x-raw", "audio/x-raw")


def sample_rows(samples, host_bytes=False):
    """A sink's samples as plain data; a media sample of the port must
    hold CPU tensors (unless `host_bytes`: a byte-level element's chunks
    under media caps)."""
    rows = []
    for s in samples:
        b = s.buffer
        leaves = _leaves(b.data)
        if type(s.caps).__module__.startswith("gstreamer_tpu_torch") \
                and _media(s.caps) and not host_bytes:
            assert all(isinstance(v, torch.Tensor) and v.device == CPU
                       for v in leaves), (str(s.caps), leaves)
        rows.append((b.pts, b.dts, b.duration, b.batch, b.flags,
                     str(s.caps), plain(b.data), plain(b.meta)))
    return rows


def drain(sink):
    out = []
    while (s := sink.pull_sample()) is not None:
        out.append(s)
    return out


def bus_rows(pipe):
    return [(m.type, m.src, plain(m.data)) for m in iter(pipe.bus.pop, None)
            if m.type in ("element", "tag", "error")]


def _run(parse, buffer_cls, desc, pushes, sinks, batch, setup, **kw):
    pipe = parse(desc, batch=batch, **kw)
    _name_elements(pipe)
    if setup is not None:
        setup(pipe)
    for name, bufs in pushes.items():
        src = pipe.get_by_name(name)
        for b in bufs:
            src.push_buffer(buffer_cls(**dict(b, data=_copy(b["data"]))))
        src.end_of_stream()
    pipe.run()
    return pipe, {s: drain(pipe.get_by_name(s)) for s in sinks}


def pair(desc, pushes=None, sinks=("out",), batch=1, setup=None,
         jsetup=None, host_bytes=False):
    """`desc` through both packages (the port on the CPU), `setup(pipe)`
    (or `jsetup` for the JAX one) before each runs.  Asserts the samples of
    every sink (`host_bytes`: see ``sample_rows``), the negotiated caps and
    the element / tag / error bus messages equal; returns (JAX pipeline,
    JAX samples, port pipeline, port samples)."""
    pushes = pushes or {}
    jpipe, ref = _run(jparse_launch, JBuffer, desc, pushes, sinks, batch,
                      jsetup or setup)
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                      pushes, sinks, batch, setup, device="cpu")
    for s in sinks:
        assert sample_rows(out[s], host_bytes) == sample_rows(ref[s]), s
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)
    assert bus_rows(tpipe) == bus_rows(jpipe)
    return jpipe, ref, tpipe, out


def i420(w, h, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n,) + s, dtype=np.uint8)
                 for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))


def video_pushes(w, h, batch, ticks, seed=0, dur=DUR):
    return [dict(data=i420(w, h, batch, seed + t), pts=t * batch * dur,
                 duration=dur, batch=batch) for t in range(ticks)]


def vsrc(w, h, name="in", fmt="I420", rate="30000/1001"):
    return (f"appsrc name={name} caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate={rate}")


def host_element(factory, **props):
    """The port's element for a direct call, on the CPU."""
    e = tmake(factory, **props)
    e.device = CPU
    return e


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


@pytest.mark.parametrize("factory", BROADCAST_FACTORIES)
def test_factory_builds_through_parse_launch(factory):
    """Each of the slice's 68 factories alone in a launch string, in both
    packages: the same class name and property values."""
    j = next(iter(jparse_launch(factory).iterate_elements()))
    t = next(iter(gstreamer_tpu_torch.parse_launch(
        factory, device="cpu").iterate_elements()))
    assert (type(t).__name__, t.FACTORY) == (type(j).__name__, j.FACTORY)
    assert plain(t.props) == plain(j.props)


# -- video/cc.py --------------------------------------------------------------

PAIRS = (b"\x94\x2c\x91\xb0", b"\x94\x2c", b"\x01\x02" * 5, b"", b"\x80")


@pytest.mark.parametrize("fn", ["cea608_raw_to_s334_1a",
                                "cea608_raw_to_cc_data"])
@pytest.mark.parametrize("field", [0, 1])
def test_cc_pair_conversions(fn, field):
    for raw in PAIRS:
        got = getattr(tcc, fn)(raw, field)
        assert got == getattr(jcc, fn)(raw, field)
        back = (tcc.cea608_s334_1a_to_raw if "s334" in fn
                else tcc.cc_data_to_cea608_raw)(got, field)
        assert back == (jcc.cea608_s334_1a_to_raw if "s334" in fn
                        else jcc.cc_data_to_cea608_raw)(got, field)


def test_cc_data_s334_roundtrip():
    rng = np.random.default_rng(3)
    for n in range(6):
        cc = b"".join(bytes([rng.choice([0xFC, 0xFD, 0xFA])]) + rng.bytes(2)
                      for _ in range(n))
        s334 = tcc.cc_data_to_s334_1a(cc)
        assert s334 == jcc.cc_data_to_s334_1a(cc)
        assert tcc.s334_1a_to_cc_data(s334) == jcc.s334_1a_to_cc_data(s334)


@pytest.mark.parametrize("fps", [e[1:3] for e in jcc.CDP_FPS_TABLE])
@pytest.mark.parametrize("tc", [None, (1, 2, 3, 4), (23, 59, 59, 29)])
def test_cdp_packets(fps, tc):
    """The CDP writer byte for byte (padding, sequence, checksum) and the
    parser's (cc_data, timecode, fps id), at every framerate of the
    table, with and without a timecode section; a packet with more
    triplets than max_cc_count is cut as the reference cuts it."""
    rng = np.random.default_rng(fps[0] + (tc or (0,))[0])
    for n in (0, 1, 3, 30):
        cc = b"".join(b"\xfc" + rng.bytes(2) for _ in range(n))
        seq = int(rng.integers(0, 1 << 16))
        got = tcc.cc_data_to_cdp(cc, seq, *fps, tc=tc)
        assert got == jcc.cc_data_to_cdp(cc, seq, *fps, tc=tc)
        assert tcc.cdp_to_cc_data(got) == jcc.cdp_to_cc_data(got)
        assert tcc.cdp_fps_entry(*fps) == jcc.cdp_fps_entry(*fps)


def test_cdp_faults_raise_alike():
    bad = bytearray(jcc.cc_data_to_cdp(b"\xfc\x01\x02", 0, 30, 1))
    bad[7] ^= 0xFF
    for blob in (bytes(bad), b"\x00" * 12, b"\x96\x69\xff" + b"\x00" * 9):
        with pytest.raises(ValueError) as je:
            jcc.cdp_to_cc_data(blob)
        with pytest.raises(ValueError) as te:
            tcc.cdp_to_cc_data(blob)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unsupported framerate"):
        tcc.cc_data_to_cdp(b"", 0, 17, 1)


@pytest.mark.parametrize("width", [27, 64, 320, 720, 1024])
def test_line21_waveform(width):
    rng = np.random.default_rng(width)
    for pair_ in (b"\x94\x2c", b"\x00\x00", b"\xff\xff",
                  bytes(rng.integers(0, 256, 2, dtype=np.uint8))):
        line = tcc.line21_encode_line(width, pair_)
        want = jcc.line21_encode_line(width, pair_)
        assert line.dtype == want.dtype and np.array_equal(line, want)
        assert tcc.line21_decode_line(line) == jcc.line21_decode_line(line)
    noise = rng.integers(0, 256, width, dtype=np.uint8)
    assert tcc.line21_decode_line(noise) == jcc.line21_decode_line(noise)


# -- closedcaption elements ---------------------------------------------------

CC_CAPS = {"raw": "closedcaption/x-cea-608,format=raw",
           "s334-1a": "closedcaption/x-cea-608,format=s334-1a",
           "cc_data": "closedcaption/x-cea-708,format=cc_data",
           "cdp": "closedcaption/x-cea-708,format=cdp"}


def caption_pushes(fmt, n, seed, rate=(30000, 1001)):
    """n seeded caption buffers of `fmt`, one a frame."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        pairs = bytes(rng.integers(0, 128, 4, dtype=np.uint8) | 0x80)
        blob = {"raw": pairs[:2],
                "s334-1a": jcc.cea608_raw_to_s334_1a(pairs, 0),
                "cc_data": jcc.cea608_raw_to_cc_data(pairs, 0)
                + jcc.cea608_raw_to_cc_data(pairs[2:], 1),
                "cdp": jcc.cc_data_to_cdp(jcc.cea608_raw_to_cc_data(
                    pairs, 0), k, *rate)}[fmt]
        out.append(dict(data=np.frombuffer(blob, np.uint8),
                        pts=k * DUR, duration=DUR))
    return out


@pytest.mark.parametrize("fin", list(CC_CAPS))
@pytest.mark.parametrize("fout", list(CC_CAPS))
def test_ccconverter(fin, fout):
    """Every input format to every output format at 30000/1001 (the CDP's
    sequence counter across buffers), one field selected for raw."""
    desc = (f"appsrc name=in caps={CC_CAPS[fin]},framerate=30000/1001 ! "
            f"ccconverter field=0 ! {CC_CAPS[fout]} ! appsink name=out")
    _, _, tpipe, out = pair(desc, {"in": caption_pushes(fin, 4, 1)})
    assert len(out["out"]) == 4
    src = tpipe.get_by_name("in")
    assert src in tpipe._host_fed, "the caption bytes were staged"


def test_ccconverter_raw_cdp_raw():
    desc = ("appsrc name=in ! closedcaption/x-cea-608,format=raw,"
            "framerate=30/1 ! ccconverter ! closedcaption/x-cea-708,"
            "format=cdp ! ccconverter ! closedcaption/x-cea-608,"
            "format=raw ! appsink name=out")
    _, _, _, out = pair(desc, {"in": [dict(data=np.frombuffer(
        b"\x94\x2c", np.uint8), pts=0)]})
    assert np.asarray(out["out"][0].buffer.data).tobytes() == b"\x94\x2c"


def combiner_desc(w, h, tail, rate="30000/1001"):
    return (f"cccombiner name=c {vsrc(w, h, rate=rate)} ! c.sink "
            f"appsrc name=cap caps=closedcaption/x-cea-608,format=raw,"
            f"framerate={rate} ! c.caption c. ! {tail}")


@pytest.mark.parametrize("batch,ticks", [(1, 3), (3, 2)])
def test_combiner_line21_chain(batch, ticks):
    """cccombiner ! line21encoder ! line21decoder: the frames with the
    encoded line 21 and the decoded pairs in the meta, a tick at a time."""
    desc = combiner_desc(64, 48, "line21encoder ! line21decoder ! "
                         "appsink name=out")
    pushes = {"in": video_pushes(64, 48, batch, ticks),
              "cap": caption_pushes("raw", ticks, 5)}
    _, _, tpipe, out = pair(desc, pushes, batch=batch)
    pairs = [c for s in out["out"]
             for c in s.buffer.meta["closedcaption"][1]]
    assert set(b["data"].tobytes() for b in pushes["cap"]) <= set(pairs)
    assert tpipe.get_by_name("cap") in tpipe._host_fed
    assert tpipe.get_by_name("in") not in tpipe._host_fed


def test_ccextractor_routes():
    desc = combiner_desc(64, 48, "ccextractor name=x x.src ! appsink "
                         "name=video x.caption_0 ! appsink name=cc",
                         rate="30/1")
    pushes = {"in": video_pushes(64, 48, 2, 2),
              "cap": caption_pushes("raw", 2, 9)}
    _, _, _, out = pair(desc, pushes, sinks=("video", "cc"), batch=2)
    assert out["cc"][0].caps[0].name == "closedcaption/x-cea-608"


def test_ccextractor_caption_branch_through_ccconverter():
    """A reference fault (ROADMAP.md section 3): ccextractor's caption pad
    is negotiated with the video's caps and its buffers carry their
    caption caps in the meta, which the reference's ccconverter does not
    read: it takes the raw pairs for cc_data and gives empty packets.  The
    port's reads the meta's caps: the pairs come back through CDP."""
    desc = combiner_desc(64, 48, "ccextractor name=x x.src ! fakesink "
                         "x.caption_0 ! ccconverter ! closedcaption/x-cea-708,"
                         "format=cdp ! ccconverter ! closedcaption/x-cea-608,"
                         "format=raw ! appsink name=cc")
    caps_ = caption_pushes("raw", 2, 4)
    pushes = {"in": video_pushes(64, 48, 3, 2),
              "cap": [dict(b, data=[b["data"]] * 3) for b in caps_]}
    _, ref = _run(jparse_launch, JBuffer, desc, pushes, ("cc",), 3, None)
    _, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, pushes,
                  ("cc",), 3, None, device="cpu")
    want = [[b["data"].tobytes()] * 3 for b in caps_]
    assert [[np.asarray(x).tobytes() for x in s.buffer.data]
            for s in ref["cc"]] == [[b""] * 3] * 2
    assert [[np.asarray(x).tobytes() for x in s.buffer.data]
            for s in out["cc"]] == want
    assert [str(s.caps) for s in out["cc"]] == [str(s.caps)
                                                for s in ref["cc"]]


@pytest.mark.parametrize("ticks", [1, 3])
def test_cea608mux(ticks):
    desc = ("cea608mux name=m appsrc name=f1 ! closedcaption/x-cea-608,"
            "format=raw,framerate=30/1 ! m.sink_0 appsrc name=f2 ! "
            "closedcaption/x-cea-608,format=raw,framerate=30/1 ! m.sink_1 "
            "m. ! appsink name=out")
    _, _, _, out = pair(desc, {"f1": caption_pushes("raw", ticks, 1),
                               "f2": caption_pushes("raw", ticks, 2)})
    assert len(out["out"]) == ticks


def _line21_buffer(n, w, h, meta, seed=4):
    return dict(data=i420(w, h, n, seed), pts=0, duration=DUR, batch=n,
                meta=meta)


@pytest.mark.parametrize("meta", [
    {"closedcaption": ("raw", [b"\x94\x2c", b"\x91\xb0"])},
    {"closedcaption": ("s334-1a", [b"\x80\x94\x2c\x00\x01\x02"])},
    {"closedcaption": ("raw", [b"\x94"])}, {}])
def test_line21_encoder_decoder_direct(meta):
    """host_process of both packages on the same batch: fewer captions
    than frames repeat the last; a short pair is written as 0x80 0x80."""
    b = _line21_buffer(3, 64, 48, meta)
    j = jmake("line21encoder").host_process(JBuffer(**dict(
        b, data=_copy(b["data"]))))
    t = host_element("line21encoder").host_process(Buffer(**dict(
        b, data=tuple(torch.from_numpy(p) for p in _copy(b["data"])))))
    assert plain(t.data) == plain(j.data) and plain(t.meta) == plain(j.meta)
    jd = jmake("line21decoder").host_process(j)
    td = host_element("line21decoder").host_process(t)
    assert plain(td.meta) == plain(jd.meta)


def test_line21_encoder_writes_row_zero_of_a_copy():
    """line21encoder writes row 0 of each captioned frame into a copy of
    the luma: every other row and the chroma planes are the input's (the
    chroma the very tensors), and the caller's luma is left as it was."""
    host = i420(96, 64, 4, 11)
    planes = tuple(torch.from_numpy(p.copy()) for p in host)
    buf = Buffer(data=planes, batch=4, pts=0, duration=DUR,
                 meta={"closedcaption": ("raw", [b"\x94\x2c"] * 2)})
    out = host_element("line21encoder").host_process(buf)
    assert np.array_equal(planes[0].numpy(), host[0])
    assert out.data[0] is not planes[0]
    assert out.data[1] is planes[1] and out.data[2] is planes[2]
    y = out.data[0].numpy()
    assert np.array_equal(y[:, 1:], host[0][:, 1:])
    assert np.array_equal(y[2:, 0], host[0][2:, 0])
    assert not np.array_equal(y[:2, 0], host[0][:2, 0])


def test_line21_tee_keeps_the_original():
    """A tee'd buffer: the branch without line21encoder sees the original
    bytes."""
    desc = combiner_desc(64, 48, "tee name=t t. ! line21encoder ! appsink "
                         "name=a t. ! appsink name=b", rate="30/1")
    pushes = {"in": video_pushes(64, 48, 2, 1),
              "cap": caption_pushes("raw", 1, 2)}
    _, _, _, out = pair(desc, pushes, sinks=("a", "b"), batch=2)
    orig = pushes["in"][0]["data"][0]
    assert np.array_equal(out["b"][0].buffer.data[0].numpy(), orig)
    assert not np.array_equal(out["a"][0].buffer.data[0].numpy()[:, 0],
                              orig[:, 0])


# -- cc_sei -------------------------------------------------------------------

def annexb(h265, n, seed):
    """n access units of fake NALs: a parameter set, an SEI of another
    type, a VCL slice (IDR first), each with a 3- or 4-byte start code."""
    rng = np.random.default_rng(seed)
    aus = []
    for k in range(n):
        if h265:
            ps, vcl = bytes([32 << 1, 1]), bytes([(19 if k == 0 else 1) << 1,
                                                  1])
            other_sei = bytes([39 << 1, 1, 5, 2]) + rng.bytes(2) + b"\x80"
        else:
            ps, vcl = b"\x67", bytes([0x65 if k == 0 else 0x41])
            other_sei = b"\x06\x05\x02" + rng.bytes(2) + b"\x80"
        body = rng.integers(1, 256, 12, dtype=np.uint8).tobytes()
        aus.append(b"\x00\x00\x00\x01" + ps + rng.bytes(4).replace(b"\x00",
                                                                   b"\x11")
                   + b"\x00\x00\x01" + other_sei + b"\x00\x00\x00\x01" + vcl
                   + body)
    return aus


@pytest.mark.parametrize("codec", ["h264", "h265"])
@pytest.mark.parametrize("n", [1, 3])
def test_cc_inserter_extractor(codec, n):
    """ccinserter ! ccextractor: the SEI-bearing access units byte for
    byte and the extracted cc_data in the meta; an AU without a caption
    passes as it came."""
    aus = annexb(codec == "h265", n, n)
    cc = [bytes([0xFC, 0x41 + i, 0x42 + i]) for i in range(n - 1)] + [b""]
    caps = f"video/x-{codec},stream-format=byte-stream,alignment=au"
    desc = (f"appsrc name=in caps={caps} ! {codec}ccinserter ! "
            f"{codec}ccextractor ! appsink name=out")
    buf = dict(data=[np.frombuffer(a, np.uint8) for a in aus], batch=n,
               pts=0, meta={"closedcaption": ("cc_data", cc)})
    _, _, tpipe, out = pair(desc, {"in": [buf]})
    assert tpipe.get_by_name("in") in tpipe._host_fed
    if n > 1:
        assert out["out"][0].buffer.meta["closedcaption"][1][:n - 1] == \
            cc[:n - 1]


@pytest.mark.parametrize("codec", ["h264", "h265"])
@pytest.mark.parametrize("props", ["", "remove-caption-meta=true"])
def test_sei_inserter(codec, props):
    """seiinserter: caption SEI and user-data-unregistered SEI (a tuple and
    a list of them) before the first slice; the metas dropped on
    request."""
    caps = f"video/x-{codec},stream-format=byte-stream,alignment=au"
    desc = (f"appsrc name=in caps={caps} ! {codec}seiinserter {props} ! "
            f"appsink name=out")
    aus = annexb(codec == "h265", 2, 7)
    udu = [(b"0123456789abcdef", b"hello"), (b"short", b"\x00\x01")]
    bufs = [dict(data=[np.frombuffer(a, np.uint8) for a in aus], batch=2,
                 pts=0, meta={"closedcaption": ("cc_data", [b"\xfc\x01\x02"]
                                                * 2), "sei-user-data": u})
            for u in (udu[0], udu)]
    pair(desc, {"in": bufs})


def test_cc_extractor_without_captions():
    for cls in ("h264ccextractor", "h265ccextractor"):
        blob = np.frombuffer(b"\x00\x00\x00\x01\x65\x88\x80", np.uint8)
        j = jmake(cls).host_process(JBuffer(data=blob, batch=1))
        t = host_element(cls).host_process(Buffer(data=blob, batch=1))
        assert plain(t.meta) == plain(j.meta) == {}
        assert t.data is blob


@pytest.mark.parametrize("factory", ["alpha_combine", "alphacombine"])
@pytest.mark.parametrize("alpha", ["none", "plane", "frames"])
def test_alpha_combine(factory, alpha):
    """The colour planes pass as they are; the alpha plane is made (255) or
    taken from the meta (one plane broadcast over the batch, or a plane a
    frame) on their device."""
    host = i420(32, 24, 3, 2)
    rng = np.random.default_rng(5)
    meta = {} if alpha == "none" else {"alpha": rng.integers(
        0, 256, (24, 32) if alpha == "plane" else (3, 24, 32),
        dtype=np.uint8)}
    j = jmake(factory).host_process(JBuffer(data=host, batch=3, meta=meta))
    planes = tuple(torch.from_numpy(p) for p in host)
    t = host_element(factory).host_process(Buffer(data=planes, batch=3,
                                                   meta=dict(meta)))
    assert plain(t.data) == plain(j.data)
    assert all(a is b for a, b in zip(t.data[:3], planes))
    assert t.data[3].device == CPU


def test_alpha_combine_launch():
    pair(f"{vsrc(32, 24)} ! alpha_combine ! appsink name=out",
         {"in": video_pushes(32, 24, 2, 2)}, batch=2)


# -- timecode_misc ------------------------------------------------------------

@pytest.mark.parametrize("fps", [(25, 1), (30, 1), (30000, 1001),
                                 (60000, 1001), (24000, 1001), (50, 1)])
@pytest.mark.parametrize("drop", [False, True])
def test_frames_to_timecode(fps, drop):
    for n in list(range(0, 40)) + [1799, 1800, 17982, 17983, 107892,
                                   25 * 3600, 10 ** 7]:
        assert ttm.frames_to_timecode(n, *fps, drop) == \
            jtm.frames_to_timecode(n, *fps, drop)


@pytest.mark.parametrize("props", ["", "drop-frame=true post-messages=true",
                                   "start-hour=23 post-messages=true"])
@pytest.mark.parametrize("batch", [1, 4])
def test_timecodestamper(props, batch):
    desc = f"{vsrc(16, 16)} ! timecodestamper {props} ! appsink name=out"
    pair(desc, {"in": video_pushes(16, 16, batch, 3)}, batch=batch)


def test_timecodestamper_messages_from_videotestsrc():
    pair("videotestsrc num-buffers=2 ! video/x-raw,format=GRAY8,width=8,"
         "height=8,framerate=5/1 ! timecodestamper post-messages=true ! "
         "appsink name=out")


@pytest.mark.parametrize("factory", ["timecodestamper", "avwait",
                                     "h264timestamper", "h265timestamper"])
def test_meta_elements_pass_the_tensors(factory):
    """The meta-only elements hand on the very tensor objects they were
    given: no pixel is copied."""
    planes = tuple(torch.from_numpy(p) for p in i420(32, 24, 2, 1))
    e = host_element(factory)
    if factory == "timecodestamper":
        e.set_info(Caps.from_string("video/x-raw,framerate=30/1"), None)
        e.start()
    buf = Buffer(data=planes, batch=2, pts=10 ** 9, duration=DUR)
    out = e.host_process(buf)
    assert out.data is planes
    assert all(a is b for a, b in zip(out.data, planes))


@pytest.mark.parametrize("props", [
    "target-running-time=1000000000", "end-running-time=600000000",
    "recording=false", "mode=timecode target-timecode-str=00:00:00:04"])
@pytest.mark.parametrize("batch", [1, 2])
def test_avwait(props, batch):
    desc = (f"{vsrc(8, 8, rate='5/1')} ! timecodestamper ! avwait {props} ! "
            f"appsink name=out")
    pair(desc, {"in": video_pushes(8, 8, batch, 10 // batch, dur=200000000)},
         batch=batch)


@pytest.mark.parametrize("codec", ["h264", "h265"])
def test_timestampers(codec):
    desc = (f"appsrc name=in caps=video/x-{codec} ! {codec}timestamper ! "
            f"appsink name=out")
    blobs = [dict(data=np.frombuffer(a, np.uint8), pts=k * DUR,
                  **({"dts": 5} if k == 1 else {}))
             for k, a in enumerate(annexb(codec == "h265", 3, 0))]
    pair(desc, {"in": blobs})


def comb_frames(n, w, h, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(60, 70, (n, h, w)).astype(np.uint8)
    y[:, ::2, w // 4:3 * w // 4] = 200          # combing in a band
    y[-1] = 100                                  # a clean frame
    u = rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)
    return (y, u, u.copy())


def test_combdetect():
    """combdetect paints the combed band (the run lengths passing 100 take
    more than 100 columns), over frames whose z counter moves; the chroma
    planes pass as they are."""
    pushes = [dict(data=comb_frames(2, 128, 24, t), pts=t * 2 * DUR,
                   duration=DUR, batch=2) for t in range(2)]
    _, _, _, out = pair(f"{vsrc(128, 24)} ! combdetect ! appsink name=out",
                        {"in": pushes}, batch=2)
    y = out["out"][0].buffer.data[0].numpy()
    assert ((y == 16) | (y == 235)).any()
    planes = tuple(torch.from_numpy(p) for p in comb_frames(1, 32, 8, 0))
    e = host_element("combdetect")
    e.start()
    got = e.host_process(Buffer(data=planes, batch=1))
    assert got.data[1] is planes[1] and got.data[2] is planes[2]
    assert np.array_equal(planes[0].numpy(), comb_frames(1, 32, 8, 0)[0])


def test_ivtc():
    """Duplicates dropped across buffers (the previous frame carried),
    the kept frames indexed on the device; a tick of duplicates only
    gives nothing."""
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 255, (24, 32)).astype(np.uint8) for _ in "ab")
    seqs = [[a, a, b], [b, b, b], [a, b, b]]
    pushes = []
    for t, seq in enumerate(seqs):
        y = np.stack(seq)
        u = rng.integers(0, 256, (3, 12, 16), dtype=np.uint8)
        pushes.append(dict(data=(y, u, u.copy()), pts=t * 3 * DUR,
                           duration=DUR, batch=3))
    _, _, _, out = pair(f"{vsrc(32, 24)} ! ivtc ! appsink name=out",
                        {"in": pushes}, batch=3)
    assert [s.buffer.batch for s in out["out"]] == [2, 2]


@pytest.mark.parametrize("method", ["mem", "max", "mse"])
def test_compare(method):
    desc = (f"compare name=c method={method} threshold=0.5 "
            f"{vsrc(16, 16, 'a', 'GRAY8')} ! c.sink "
            f"{vsrc(16, 16, 'b', 'GRAY8')} ! c.check c. ! appsink name=out")
    rng = np.random.default_rng(1)
    same = [dict(data=(rng.integers(0, 256, (2, 16, 16), dtype=np.uint8),),
                 pts=t * 2 * DUR, duration=DUR, batch=2) for t in range(2)]
    other = [dict(s, data=(np.where(rng.random((2, 16, 16)) < 0.1, 0,
                                    s["data"][0]).astype(np.uint8),))
             for s in same]
    _, _, tpipe, _ = pair(desc, {"a": same, "b": other}, batch=2)


def test_compare_tee_equal():
    pair("compare name=c videotestsrc num-buffers=2 ! video/x-raw,format="
         "GRAY8,width=16,height=16 ! tee name=t t. ! c.sink t. ! c.check "
         "c. ! appsink name=out")


@pytest.mark.parametrize("ch", [1, 2])
def test_audiolatency(ch):
    """The first sample over 0.5 in magnitude (either channel), its offset
    posted; a buffer without a spike posts nothing."""
    rng = np.random.default_rng(ch)
    bufs = []
    for t, at in enumerate([2400, None, 0, 4799]):
        x = (rng.random((4800, ch)) * 0.4 - 0.2).astype(np.float32)
        if at is not None:
            x[at, ch - 1] = -0.75
            x[at + 1:, 0] = 0.9
        bufs.append(dict(data=x, pts=t * 10 ** 8, duration=10 ** 8))
    desc = (f"appsrc name=in caps=audio/x-raw,format=F32LE,rate=48000,"
            f"channels={ch},layout=interleaved ! audiolatency ! "
            f"appsink name=out")
    _, _, tpipe, _ = pair(desc, {"in": bufs})
    e = next(e for e in tpipe.iterate_elements()
             if e.FACTORY == "audiolatency")
    assert e.last_latency_ns == 3 * 10 ** 8 + 4799 * 10 ** 9 // 48000
