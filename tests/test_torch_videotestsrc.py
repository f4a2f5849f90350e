"""Torch port videotestsrc against the JAX element, plane for plane.

Both elements draw the same pattern at the same caps; the port runs on
``device="cpu"``.  Every plane, pts, duration and offset of two consecutive
``create`` calls must be equal (the noise generator's state carries from
one call to the next).  Then the README quick-start launch string through
both packages' ``parse_launch``.  Tolerance 0.  Card-only cases skip here
(the fixture decides at run time).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference side runs on the CPU backend)

from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import videotestsrc as jvts
from gstreamer_tpu.video import format as jformat

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.elements import videotestsrc as tvts
from gstreamer_tpu_torch.interop import negotiated_caps
from gstreamer_tpu_torch.ops import convert_kernel as tck
from gstreamer_tpu_torch.video import format as tformat

PATTERNS = ["smpte", "snow", "black", "white", "ball", "checkers-8",
            "zone-plate", "smpte75", "gamut", "circular", "pinwheel",
            "gradient", "colors", "blink", "solid-color", "bar"]
CAPS = "video/x-raw,format={f},width={w},height={h},framerate=30/1"


def _elements(fmt, w, h, **props):
    caps = CAPS.format(f=fmt, w=w, h=h)
    j = jvts.VideoTestSrc(**props)
    j.set_info(None, JCaps.from_string(caps))
    t = tvts.VideoTestSrc(**props)
    t.device = "cpu"
    t.set_info(None, Caps.from_string(caps))
    j.start()
    t.start()
    return j, t


def _same_buffers(j, t, batches):
    for n in batches:
        jb, tb = j.create(n), t.create(n)
        if jb is None:
            assert tb is None
            continue
        assert (tb.pts, tb.duration, tb.offset, tb.batch) == (
            jb.pts, jb.duration, jb.offset, jb.batch)
        assert len(tb.data) == len(jb.data)
        for tp, jp in zip(tb.data, jb.data):
            jp = np.asarray(jp)
            tp = tp.numpy() if isinstance(tp, torch.Tensor) else tp
            assert tp.dtype == jp.dtype
            assert tp.dtype in (np.uint8, np.uint16)
            assert tp.shape == jp.shape
            assert np.array_equal(tp, jp)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("fmt", ["I420", "RGB"])
def test_pattern_matches_reference(pattern, fmt):
    j, t = _elements(fmt, 64, 48, pattern=pattern)
    _same_buffers(j, t, (3, 2))


@pytest.mark.parametrize("props", [
    {"pattern": "snow", "foreground-color": 0xFF20C0F0,
     "background-color": 0xFF102030},
    {"pattern": "ball", "motion": "sweep", "flip": True},
    {"pattern": "ball", "animation-mode": "running-time", "motion": "hsweep"},
    {"pattern": "zone-plate", "kt": 3, "kxt": 1, "kx2": 11, "ky2": 7},
    {"pattern": "smpte", "horizontal-speed": 5},
    {"pattern": "18"},                                  # by number: ball
    {"pattern": "smpte", "num-buffers": 4},
])
def test_properties_match_reference(props):
    j, t = _elements("I420", 70, 46, **props)
    assert t.props["pattern"] == j.props["pattern"]
    _same_buffers(j, t, (3, 2, 2))


@pytest.mark.parametrize("fmt", ["Y444", "Y42B", "YV12", "BGRx", "GBR"])
def test_snow_in_other_layouts_matches_reference(fmt):
    j, t = _elements(fmt, 36, 20, pattern="snow")
    _same_buffers(j, t, (2, 2))


@pytest.mark.parametrize("pattern", ["smpte", "snow", "ball", "white"])
@pytest.mark.parametrize("fmt", ["NV12", "YUY2", "I420_10LE", "RGB16",
                                 "GRAY8", "P010_10LE", "AYUV64", "Y41B"])
def test_every_layout_and_depth_matches_reference(fmt, pattern):
    j, t = _elements(fmt, 36, 20, pattern=pattern)
    _same_buffers(j, t, (2, 2))
    want = np.uint16 if tformat.FORMATS[fmt].bits == 16 else np.uint8
    t2 = _elements(fmt, 36, 20, pattern=pattern)[1]
    assert all(np.asarray(p).dtype == want for p in t2.create(1).data)


def test_noise_state_is_the_sequential_lcg():
    """The closed form in int64 halves equals the C loop's wrapping uint32
    state, step by step, across two create calls."""
    _, t = _elements("Y444", 8, 4, pattern="snow")
    state, want = 0, []
    for _ in range(3 * 8 * 4):
        state = (state * tvts.LCG_A + tvts.LCG_C) & tvts.M32
        want.append((state >> 16) & 0xFF)
    got = torch.cat([t.create(2).data[0], t.create(1).data[0]]).flatten()
    # snow blends fg (white Y=235) over bg (black Y=16) by the noise byte
    y = np.asarray([tvts._blend(235, 16, v) for v in want])
    assert np.array_equal(got.numpy(), y)


def test_host_tables_are_the_references():
    assert tvts.PATTERNS == jvts.PATTERNS
    assert tvts.FORMAT_LIST == jvts.FORMAT_LIST
    for name in ("BT709_100", "BT709_75", "BT601_100", "BT601_75"):
        assert getattr(tvts, name) == getattr(jvts, name)
    assert np.array_equal(tvts.SINE_TABLE, jvts.SINE_TABLE)
    assert tvts.lcg_affine(12345) == jvts.lcg_affine(12345)
    for a, b in zip(tvts.lcg_tables(50), jvts.lcg_tables(50)):
        assert np.array_equal(a, b)
    assert tvts.VideoTestSrc.PROPERTIES == jvts.VideoTestSrc.PROPERTIES


@pytest.mark.parametrize("fmt", ["I420", "Y42B", "RGB", "BGRA", "GBR"])
def test_pack_matches_reference(fmt):
    canon = np.random.default_rng(61).integers(0, 256, (2, 10, 12, 4))
    ref = jformat.pack(np, jformat.FORMATS[fmt], canon, 12, 10)
    for xp, c in ((np, canon), (torch, torch.as_tensor(canon))):
        out = tformat.pack(xp, tformat.FORMATS[fmt], c, 12, 10)
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            assert np.array_equal(np.asarray(o), r)
            assert np.asarray(o).dtype == np.uint8


def test_pack_of_an_unported_layout_raises():
    # (the name dates from the slice that raised for NV12)  every layout
    # of the format table packs now; only an unknown name raises
    canon = np.zeros((4, 4, 4), np.int64)
    for name in tformat.FORMATS:
        out = tformat.pack(np, tformat.FORMATS[name], canon, 4, 4)
        assert [o.shape for o in out] == \
            tformat.plane_shapes(tformat.FORMATS[name], 4, 4)
    with pytest.raises(ValueError, match="unknown video format"):
        tformat.format_info("NV12_LATER")
    j, t = _elements("I420_10LE", 16, 16, pattern="white")
    _same_buffers(j, t, (1,))


def test_without_cuda_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = tvts.VideoTestSrc(pattern="white")
    with pytest.raises(RuntimeError, match="CUDA"):
        t.set_info(None, Caps.from_string(CAPS.format(f="I420", w=8, h=8)))


# -- the README quick-start string through parse_launch ---------------------

QUICKSTART = ("videotestsrc num-buffers=6 pattern={p} ! "
              "video/x-raw,format=I420,width=64,height=48,framerate=30/1 ! "
              "videoconvertscale add-borders=false ! "
              "video/x-raw,format=RGB,width=32,height=32 ! appsink name=out")
DEFAULTS = ("videotestsrc num-buffers=3 ! videoconvertscale "
            "add-borders=false ! video/x-raw,format=RGB,width=32,height=32 "
            "! appsink name=out")


NV12_LAUNCH = ("videotestsrc num-buffers=6 pattern={p} ! "
               "video/x-raw,format=NV12,width=64,height=48,framerate=30/1 ! "
               "videoconvertscale ! "
               "video/x-raw,format=RGB,width=40,height=40 ! appsink name=out")
# other sources and sinks of the launched converter: 10-bit in, 16-bit
# RGB out (the default bayer dither), packed 4:2:2 in with an upscale
OTHER_LAUNCH = [
    "videotestsrc num-buffers=3 pattern=smpte ! video/x-raw,format=I420_10LE,"
    "width=64,height=48,framerate=30/1 ! videoconvertscale ! "
    "video/x-raw,format=RGB,width=40,height=40 ! appsink name=out",
    "videotestsrc num-buffers=3 pattern=ball ! video/x-raw,format=I420,"
    "width=64,height=48,framerate=30/1 ! videoconvertscale ! "
    "video/x-raw,format=RGB16,width=32,height=24 ! appsink name=out",
    "videotestsrc num-buffers=3 pattern=snow ! video/x-raw,format=YUY2,"
    "width=32,height=24,framerate=30/1 ! videoconvertscale method=lanczos ! "
    "video/x-raw,format=BGRA,width=48,height=40 ! appsink name=out",
    "videotestsrc num-buffers=3 ! video/x-raw,format=GRAY8,width=32,"
    "height=24,framerate=30/1 ! videoconvert ! video/x-raw,format=NV12 ! "
    "appsink name=out",
]


def _name_elements(pipe):
    for i, e in enumerate(pipe.iterate_elements()):
        if e.name == f"{e.FACTORY}{id(e) % 10000}":
            e.name = f"{e.FACTORY}_{i}"


def _run(parse, desc, **kw):
    pipe = parse(desc, batch=4, **kw)
    _name_elements(pipe)
    pipe.run()
    sink = pipe.get_by_name("out")
    samples = []
    while (s := sink.pull_sample()) is not None:
        samples.append(s)
    return pipe, samples


def _same_samples(out, ref):
    assert len(out) == len(ref) >= 1
    for o, r in zip(out, ref):
        ob, rb = o.buffer, r.buffer
        assert (ob.pts, ob.duration, ob.offset, ob.batch) == (
            rb.pts, rb.duration, rb.offset, rb.batch)
        assert str(o.caps) == str(r.caps)
        assert len(ob.data) == len(rb.data)
        for op, rp in zip(ob.data, rb.data):
            assert isinstance(op, torch.Tensor)
            assert np.array_equal(op.cpu().numpy(), np.asarray(rp))


@pytest.mark.parametrize("desc", [QUICKSTART.format(p="snow"),
                                  QUICKSTART.format(p="smpte"),
                                  QUICKSTART.format(p="ball"), DEFAULTS],
                         ids=["snow", "smpte", "ball", "defaults"])
@pytest.mark.parametrize("opt_in", [None, "interpret"])
def test_quickstart_matches_reference(monkeypatch, desc, opt_in):
    if opt_in is None:
        monkeypatch.delenv("GTPU_PALLAS", raising=False)
    else:
        monkeypatch.setenv("GTPU_PALLAS", opt_in)
    jpipe, ref = _run(jparse_launch, desc)
    before = tck.fused_i420_up_hscale.launches
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, desc, device="cpu")
    assert tck.fused_i420_up_hscale.launches == before    # CPU: plain
    _same_samples(out, ref)
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)
    assert tpipe._fused
    conv, jconv = (next(e for e in p.iterate_elements()
                        if e.FACTORY == "videoconvertscale")._converter
                   for p in (tpipe, jpipe))
    assert bool(conv.plan["pallas_ok"]) == bool(jconv._plan["pallas_ok"])
    assert conv.plan["pallas_ok"] == ("format=I420" in desc)
    assert conv._pallas_enabled() == (opt_in is not None)


@pytest.mark.parametrize("desc", [NV12_LAUNCH.format(p="smpte"),
                                  NV12_LAUNCH.format(p="snow")]
                         + OTHER_LAUNCH,
                         ids=["nv12_smpte", "nv12_snow", "i420_10le", "rgb16",
                              "yuy2_up", "gray8_nv12"])
def test_launch_over_other_formats_matches_reference(monkeypatch, desc):
    monkeypatch.delenv("GTPU_PALLAS", raising=False)
    jpipe, ref = _run(jparse_launch, desc)
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, desc, device="cpu")
    _same_samples(out, ref)
    for o, r in zip(out, ref):
        for op, rp in zip(o.buffer.data, r.buffer.data):
            assert op.numpy().dtype == np.asarray(rp).dtype
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)


def test_dither_property_reaches_the_converter():
    desc = ("videotestsrc num-buffers=1 ! video/x-raw,format=I420,width=32,"
            "height=24,framerate=30/1 ! videoconvertscale dither={d} ! "
            "video/x-raw,format=RGB16,width=32,height=24 ! appsink name=out")
    outs = {}
    for d in ("bayer", "none", "verterr"):
        pipe, samples = _run(gstreamer_tpu_torch.parse_launch,
                             desc.format(d=d), device="cpu")
        conv = next(e for e in pipe.iterate_elements()
                    if e.FACTORY == "videoconvertscale")._converter
        assert conv.config["dither-method"] == d
        assert (conv.plan["dither"] is None) == (d == "none")
        outs[d] = samples[0].buffer.data
    assert not all(torch.equal(a, b)
                   for a, b in zip(outs["bayer"], outs["none"]))


def test_dither_property_at_its_default_matches_reference():
    """The reference element accepts `dither` and never hands it to its
    converter; the port's element does.  At the default (bayer) the launched
    bytes are the reference's, RGB16 sink; at any other value they are the
    reference converter's under that `dither-method`, which the reference's
    own launch string cannot produce."""
    desc = ("videotestsrc num-buffers=2 pattern=ball ! video/x-raw,"
            "format=I420,width=32,height=24,framerate=30/1 ! "
            "videoconvertscale{d} ! "
            "video/x-raw,format=RGB16,width=32,height=24 ! appsink name=out")
    _, ref = _run(jparse_launch, desc.format(d=""))
    for d in ("", " dither=bayer"):
        _, out = _run(gstreamer_tpu_torch.parse_launch, desc.format(d=d),
                      device="cpu")
        _same_samples(out, ref)
    _, jnone = _run(jparse_launch, desc.format(d=" dither=none"))
    for a, b in zip(jnone, ref):      # the reference ignores the property
        for x, y in zip(a.buffer.data, b.buffer.data):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    _, tnone = _run(gstreamer_tpu_torch.parse_launch,
                    desc.format(d=" dither=none"), device="cpu")
    assert not all(np.array_equal(x.numpy(), np.asarray(y))
                   for a, b in zip(tnone, jnone)
                   for x, y in zip(a.buffer.data, b.buffer.data))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("opt_in", [None, "1"])
def test_quickstart_on_card_matches_cpu(cuda, monkeypatch, opt_in):
    if opt_in is None:
        monkeypatch.delenv("GTPU_PALLAS", raising=False)
    else:
        monkeypatch.setenv("GTPU_PALLAS", opt_in)
    desc = QUICKSTART.format(p="snow")
    n = tck.fused_i420_up_hscale.launches
    _, out = _run(gstreamer_tpu_torch.parse_launch, desc)
    _, ref = _run(gstreamer_tpu_torch.parse_launch, desc, device="cpu")
    assert (tck.fused_i420_up_hscale.launches > n) == (opt_in is not None)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        for op, rp in zip(o.buffer.data, r.buffer.data):
            assert op.device.type == "cuda"
            assert torch.equal(op.cpu(), rp)
