"""Torch port launch-string runtime against the JAX package, bit for bit.

The same launch strings go through the JAX ``parse_launch`` and the port's
(``device="cpu"``), fed the same seeded numpy frames through ``appsrc``;
every appsink sample (data, pts, duration, batch) and every pad's
negotiated caps string must be equal.  Tolerance 0.  Card-only cases skip
here (the fixture decides at run time).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstreamer_tpu.core import element as jelement
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements.videofilter import VideoBalance as JVideoBalance

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core import element as telement
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.core.parse import ParseError
from gstreamer_tpu_torch.elements.videofilter import VideoBalance
from gstreamer_tpu_torch.interop import negotiated_caps
from gstreamer_tpu_torch.ops import deint_kernel as tdk
from gstreamer_tpu_torch.ops import yscale_kernel as tysk

SRC = ("appsrc name=in caps=video/x-raw,format=I420,width={w},height={h},"
       "framerate=30/1 ! ")
# chip_smoke.py's launch paths (bench_all.py:140-143 with an appsink; BASELINE
# configs[3] with videorate; the headline launch string and its
# add-borders=false variant).  At the small input size the headline scales
# to 32x32 RGB instead of 224x224, which keeps it on the downscale routes;
# GENERIC_SIZES below sends the same strings down the generic pipeline.
LAUNCH = {
    "deint_chain": SRC + "deinterlace method=linear ! videobalance "
    "contrast=1.1 brightness=0.05 ! appsink name=out",
    "deint_rate_chain": SRC + "deinterlace method=scalerbob ! videorate ! "
    "video/x-raw,framerate=30/1 ! videobalance saturation=1.2 ! "
    "appsink name=out",
    "headline_launch": SRC + "videoconvertscale ! "
    "video/x-raw,format=RGB,width={o},height={o} ! appsink name=out",
    "headline_launch_noborders": SRC + "videoconvertscale add-borders=false"
    " ! video/x-raw,format=RGB,width={o},height={o} ! appsink name=out",
}
# a user capsfilter that asks for host memory between two device elements
# forces a host boundary (per-element path, a round trip through host
# memory before videobalance)
FORCED_HOST = (SRC + "identity ! video/x-raw(memory:SystemMemory) ! "
               "videobalance contrast=1.1 brightness=0.05 ! appsink name=out")
DUR = 33333333


def _i420(n, w, h, seed):
    rng = np.random.default_rng(seed)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return (rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            rng.integers(0, 256, (n, ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (n, ch, cw), dtype=np.uint8))


def _name_elements(pipe):
    """Give the auto-named elements ("<factory><id % 10000>") names from
    their position, so both packages' pipelines name their pads alike."""
    for i, e in enumerate(pipe.iterate_elements()):
        if e.name == f"{e.FACTORY}{id(e) % 10000}":
            e.name = f"{e.FACTORY}_{i}"


def _run(parse, buffer_cls, desc, batch, ticks, w, h, **kw):
    pipe = parse(desc, batch=batch, **kw)
    _name_elements(pipe)
    src = pipe.get_by_name("in")
    for t in range(ticks):
        src.push_buffer(buffer_cls(data=_i420(batch, w, h, 40 + t),
                                   pts=t * batch * DUR, duration=DUR,
                                   batch=batch))
    src.end_of_stream()
    pipe.run()
    sink = pipe.get_by_name("out")
    samples = []
    while (s := sink.pull_sample()) is not None:
        samples.append(s)
    return pipe, samples


def _as_int64(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(np.int64)
    return np.asarray(x, np.int64)


def _check(desc, w, h, batch, ticks, o=32):
    desc = desc.format(w=w, h=h, o=o)
    jpipe, ref = _run(jparse_launch, JBuffer, desc, batch, ticks, w, h)
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, batch,
                      ticks, w, h, device="cpu")
    assert len(out) == len(ref) >= 1
    for o, r in zip(out, ref):
        ob, rb = o.buffer, r.buffer
        assert (ob.pts, ob.duration, ob.batch) == (rb.pts, rb.duration,
                                                   rb.batch)
        assert str(o.caps) == str(r.caps)
        assert len(ob.data) == len(rb.data)
        for op, rp in zip(ob.data, rb.data):
            assert isinstance(op, torch.Tensor) and op.device.type == "cpu"
            assert np.array_equal(_as_int64(op), _as_int64(rp))
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)
    return tpipe


@pytest.mark.parametrize("name", sorted(LAUNCH))
def test_launch_matches_reference(name):
    tpipe = _check(LAUNCH[name], 64, 48, batch=4, ticks=2)
    assert tpipe._fused == name.startswith("headline")


# (string, w, h, o): sizes at which the headline strings, scaling to o x o,
# take the converter's generic pipeline.  With add-borders the picture keeps
# its aspect ratio, so a downscale there always ties to "hv" order and stays
# on the phase-split route: its generic cases are the upscales.
GENERIC_LAUNCH = [
    ("headline_launch_noborders", 48, 64, 40),    # "vh": v-scale first
    ("headline_launch", 32, 24, 48),              # upscale, embedded
    ("headline_launch_noborders", 32, 24, 48),
    ("headline_launch", 33, 17, 40),              # odd input, embedded
    ("headline_launch_noborders", 33, 17, 40),
]


@pytest.mark.parametrize("name,w,h,o", GENERIC_LAUNCH)
def test_launch_takes_the_generic_route(name, w, h, o):
    tpipe = _check(LAUNCH[name], w, h, batch=4, ticks=2, o=o)
    assert tpipe._fused
    plan = next(e for e in tpipe.iterate_elements()
                if e.FACTORY == "videoconvertscale")._converter.plan
    assert not (plan["scale_before_matrix"] and plan["scale_order"] == "hv")
    assert plan["rect_active"] == (name == "headline_launch")


def test_deint_chain_matches_reference_at_1080():
    _check(LAUNCH["deint_chain"], 1920, 1080, batch=1, ticks=1)


def test_forced_host_boundary_matches_reference():
    tpipe = _check(FORCED_HOST, 64, 48, batch=4, ticks=2)
    assert not tpipe._fused
    assert "videobalance" in [e.FACTORY for e in tpipe._order
                               if e._forced_host]


def test_negotiated_caps_of_the_deint_chain():
    pipe = gstreamer_tpu_torch.parse_launch(
        LAUNCH["deint_chain"].format(w=64, h=48, o=32), device="cpu")
    _name_elements(pipe)
    pipe.compile()
    caps = negotiated_caps(pipe)
    assert caps["in:src"].startswith("video/x-raw(memory:SystemMemory)")
    assert "framerate=60/1" in caps["out:sink"]
    assert "memory:HBM" in caps["out:sink"]


def test_parse_launch_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    desc = "appsrc name=in ! appsink name=out"
    with pytest.raises(RuntimeError, match="CUDA"):
        gstreamer_tpu_torch.parse_launch(desc)
    with pytest.raises(RuntimeError, match="CUDA"):
        gstreamer_tpu_torch.Pipeline()
    pipe = gstreamer_tpu_torch.parse_launch(desc, device="cpu")
    assert pipe.device.type == "cpu"


def test_pulled_buffers_are_staged_on_the_pipeline_device():
    """Numpy pushed into appsrc becomes tensors on the pipeline's device
    in both execution paths."""
    src = ("appsrc name=in caps=video/x-raw,format=GRAY8,width=3,height=2,"
           "framerate=30/1 ! ")
    for desc, fused in ((src + "identity ! appsink name=out", True),
                        (src + "queue ! videorate ! appsink name=out",
                         False)):
        pipe = gstreamer_tpu_torch.parse_launch(desc, device="cpu")
        src = pipe.get_by_name("in")
        src.push_buffer(Buffer(data=(np.arange(6, dtype=np.uint8)
                                     .reshape(1, 2, 3),), batch=1))
        src.end_of_stream()
        pipe.run()
        assert pipe._fused == fused
        data = pipe.get_by_name("out").pull_sample().buffer.data
        assert isinstance(data[0], torch.Tensor)
        assert torch.equal(data[0], torch.arange(6, dtype=torch.uint8)
                           .reshape(1, 2, 3))


def test_registry_is_the_ports_own():
    """Loading the port's elements leaves the JAX registry as it was, and
    the port's registry holds only the port's classes."""
    jelement._ensure_elements_loaded()
    before = dict(jelement._REGISTRY)
    telement._ensure_elements_loaded()
    gstreamer_tpu_torch.parse_launch(
        "appsrc ! videoconvertscale ! deinterlace ! videorate ! "
        "videobalance ! appsink", device="cpu")
    assert jelement._REGISTRY == before
    assert telement._REGISTRY is not jelement._REGISTRY
    assert set(telement._REGISTRY) == {
        "capsfilter", "identity", "queue", "fakesink", "appsink", "appsrc",
        "videoconvert", "videoscale", "videoconvertscale", "videobalance",
        "videorate", "deinterlace", "autodeinterlace", "videotestsrc",
        "audiotestsrc", "audioconvert", "audioresample", "volume",
        "compositor", "videomixer", "audiomixer", "adder", "audiointerleave",
        "audiorate", "interleave", "deinterleave", "smpte", "smptealpha",
        "shapewipe", "edgetv", "streaktv", "shagadelictv", "vertigotv",
        "quarktv", "revtv", "dicetv", "warptv", "rippletv", "agingtv", "optv",
        "radioactv", "filesrc", "filesink", "multifilesrc", "multifilesink",
        "y4menc", "dataurisrc", "fdsrc", "fdsink", "giosrc", "giosink",
        "rawvideoparse", "rawaudioparse", "jpegenc", "jpegdec", "pngenc",
        "pngdec", "gamma", "videoflip", "videocrop", "videobox",
        "videomedian", "alpha", "progressreport", "taginject", "capssetter",
        "breakmydata", "cpureport", "fakevideosink", "fakeaudiosink",
        "queue2", "downloadbuffer", "tee", "valve", "fakesrc",
        "autovideosink", "autoaudiosink", "watchdog", "concat", "funnel",
        "input-selector", "output-selector", "streamiddemux", "clocksync",
        "multiqueue", "switchbin", "autoconvert", "autovideoconvert",
        "overlaycomposition", "textoverlay", "timeoverlay", "clockoverlay",
        "textrender", "gdkpixbufdec", "gdkpixbufoverlay", "cairooverlay",
        "qroverlay", "debugqroverlay", "gdkpixbufsink", "rsvgdec",
        "rsvgoverlay", "coloreffects", "chromahold", "burn", "chromium",
        "dilate", "dodge", "exclusion", "gaussianblur", "solarize", "bulge",
        "circle", "diffuse", "fisheye", "kaleidoscope", "marble", "mirror",
        "perspective", "pinch", "rotate", "sphere", "square", "stretch",
        "tunnel", "twirl", "waterripple", "bayer2rgb", "rgb2bayer",
        "mulawenc", "mulawdec", "alawenc", "alawdec", "audioamplify",
        "audioinvert", "audiokaraoke", "audioecho", "audiodynamic",
        "spectrum", "level", "equalizer-3bands", "equalizer-10bands",
        "equalizer-nbands", "audiopanorama", "audiowsinclimit",
        "audiowsincband", "audiofirfilter", "audioiirfilter",
        "audiocheblimit", "audiochebband", "stereo", "rganalysis",
        "rgvolume", "rglimiter", "removesilence", "freeverb", "cutter",
        "scaletempo", "pitch", "bs2b"}
    for cls, _rank in telement._REGISTRY.values():
        assert cls.__module__.startswith("gstreamer_tpu_torch.elements.")


def test_unported_factory_raises():
    with pytest.raises(ValueError, match="no element factory"):
        telement.element_factory_make("edgedetect")
    with pytest.raises(ParseError, match="no element factory"):
        gstreamer_tpu_torch.parse_launch("edgedetect ! appsink",
                                         device="cpu")


def _balance(props, caps_cls, cls):
    caps = "video/x-raw,format=I420,width=512,height=512,framerate=30/1"
    b = cls(**props)
    b.set_info(caps_cls.from_string(caps), None)
    return b


def _every_value():
    """A 512x512 I420 frame whose Y plane holds every value and whose U, V
    planes hold every (u, v) pair."""
    uu, vv = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8), indexing="ij")
    return ((np.arange(512 * 512) % 256).astype(np.uint8)
            .reshape(1, 512, 512), uu[None], vv[None])


BALANCE = [{"contrast": 1.1, "brightness": 0.05}, {"saturation": 1.2},
           {"hue": 0.3, "saturation": 0.7, "contrast": 0.9}]


@pytest.mark.parametrize("props", BALANCE)
@pytest.mark.parametrize("lookup", [False, True])
def test_videobalance_matches_tables(props, lookup, monkeypatch):
    """Both routes of videobalance (float32 direct, and the table lookup
    it falls back to) equal the float64 tables on every input value."""
    tb = _balance(props, Caps, VideoBalance)
    ty, tu, tv = tb._tables()
    if lookup:
        monkeypatch.setattr(VideoBalance, "_f32_direct_ok",
                            lambda self, *a: (False, None))
    else:
        assert tb._f32_direct_ok(ty, tu, tv)[0]
    planes = _every_value()
    out = tb.make_fn()(tuple(torch.as_tensor(p) for p in planes))
    y, u, v = (p.astype(np.int64) for p in planes)
    for o, g in zip(out, (ty[y], tu[u, v], tv[u, v])):
        assert o.dtype == torch.uint8
        assert np.array_equal(o.numpy().astype(np.int64), g)


@pytest.mark.parametrize("props", BALANCE[:2])
def test_videobalance_matches_jitted_reference(props):
    """The port equals the JAX element jitted on the CPU on every input
    value, for the launch paths' settings.  (At contrast 0.9 the jitted
    reference differs from its own float64 tables at Y=1: ROADMAP.md
    section 3.)"""
    planes = _every_value()
    out = _balance(props, Caps, VideoBalance).make_fn()(
        tuple(torch.as_tensor(p) for p in planes))
    ref = jax.jit(_balance(props, JCaps, JVideoBalance).make_fn())(
        tuple(jnp.asarray(p) for p in planes))
    for o, r in zip(out, ref):
        assert np.array_equal(o.numpy().astype(np.int64),
                              np.asarray(r, np.int64))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(LAUNCH))
def test_launch_on_card_matches_cpu(cuda, name):
    desc = LAUNCH[name].format(w=64, h=48, o=32)
    n_d, n_y = tdk.deint_both_parities.launches, tysk.yscale_hv.launches
    _, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, 4, 2, 64,
                  48)
    _, ref = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, 4, 2, 64,
                  48, device="cpu")
    if name.startswith("deint"):
        assert tdk.deint_both_parities.launches == n_d + 6
    if name == "headline_launch_noborders":
        assert tysk.yscale_hv.launches > n_y
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        for op, rp in zip(o.buffer.data, r.buffer.data):
            assert op.device.type == "cuda"
            assert torch.equal(op.cpu(), rp)
