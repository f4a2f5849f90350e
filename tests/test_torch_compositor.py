"""The port's aggregators and compositor against the JAX package, bit for bit.

The same launch strings go through the JAX ``parse_launch`` and the port's
(``device="cpu"``), fed the same seeded numpy frames through one or more
``appsrc`` (or made by ``videotestsrc``); every appsink sample (data, pts,
duration, batch, caps) and every pad's negotiated caps must be equal.
The blend ops are held to the JAX package's on the full (dst, src) grid and
on seeded canonical arrays.  Tolerance 0.  The helpers here
(``run_both``, ``planes``) serve ``test_torch_audio_mix.py`` and
``test_torch_smpte.py`` too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.ops import blend as jblend

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.interop import negotiated_caps
from gstreamer_tpu_torch.ops import blend as tblend
from gstreamer_tpu_torch.ops import chroma420_kernel as tck
from gstreamer_tpu_torch.ops import yscale_kernel as tysk
from gstreamer_tpu_torch.video.info import VideoInfo

from test_torch_pipeline import _name_elements

DUR = 33333333


# -- helpers: one launch string through both packages ----------------------

def _copy(data):
    if isinstance(data, (tuple, list)):
        return type(data)(_copy(x) for x in data)
    return np.array(data, copy=True)


def _leaves(data):
    if isinstance(data, (tuple, list)):
        return [x for d in data for x in _leaves(d)]
    return [data]


def _run(parse, buffer_cls, desc, pushes, sinks, batch, **kw):
    pipe = parse(desc, batch=batch, **kw)
    _name_elements(pipe)
    for name, bufs in pushes.items():
        src = pipe.get_by_name(name)
        for b in bufs:
            src.push_buffer(buffer_cls(**dict(b, data=_copy(b["data"]))))
        src.end_of_stream()
    pipe.run()
    out = {}
    for s in sinks:
        sink, got = pipe.get_by_name(s), []
        while (x := sink.pull_sample()) is not None:
            got.append(x)
        out[s] = got
    return pipe, out


def run_both(desc, pushes=None, sinks=("out",), batch=1):
    """Run `desc` in both packages; `pushes` maps an appsrc name to a list
    of Buffer keyword dicts.  Asserts every sample and the negotiated caps
    equal; returns (torch pipeline, {sink: torch samples})."""
    pushes = pushes or {}
    jpipe, ref = _run(jparse_launch, JBuffer, desc, pushes, sinks, batch)
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, pushes,
                      sinks, batch, device="cpu")
    assert_same_samples(out, ref, sinks)
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)
    return tpipe, out


def assert_same_samples(out, ref, sinks):
    """Every sample of every sink: the same pts, duration, batch, caps
    string and data, a CPU tensor in the port against a numpy-able array
    in the JAX package."""
    for s in sinks:
        assert len(out[s]) == len(ref[s]) >= 1, s
        for o, r in zip(out[s], ref[s]):
            ob, rb = o.buffer, r.buffer
            assert (ob.pts, ob.duration, ob.batch) == (rb.pts, rb.duration,
                                                       rb.batch)
            assert str(o.caps) == str(r.caps)
            ol, rl = _leaves(ob.data), _leaves(rb.data)
            assert len(ol) == len(rl)
            for a, b in zip(ol, rl):
                assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype and a.shape == b.shape
                assert np.array_equal(a.numpy(), b)


def planes(fmt, w, h, n, seed, alpha_edges=True):
    """Seeded component planes of `n` frames; an alpha plane holds 0 and
    255 on about a fifth of its pixels each."""
    rng = np.random.default_rng(seed)
    info = VideoInfo(format=fmt, width=w, height=h)
    out = [rng.integers(0, 256, (n,) + s, dtype=np.uint8)
           for s in info.plane_shapes()]
    if info.finfo.has_alpha and alpha_edges:
        a = out[-1]
        r = rng.random(a.shape)
        a[r < 0.2] = 0
        a[r > 0.8] = 255
    return tuple(out)


def video_pushes(specs, batch, ticks, seed=0):
    """{appsrc name: buffers} for specs {name: (format, w, h)}."""
    return {name: [dict(data=planes(fmt, w, h, batch, seed + 10 * k + t),
                        pts=t * batch * DUR, duration=DUR, batch=batch)
                   for t in range(ticks)]
            for k, (name, (fmt, w, h)) in enumerate(specs.items())}


def appsrc(name, fmt, w, h, pad):
    return (f"appsrc name={name} caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=30/1 ! c.{pad} ")


# -- blend ops ---------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0, 1, 127, 128, 254, 255, 256])
def test_blend_plane_full_grid(alpha):
    d, s = np.meshgrid(np.arange(256, dtype=np.int32),
                       np.arange(256, dtype=np.int32), indexing="ij")
    want = np.asarray(jblend.blend_plane(jnp, jnp.asarray(d),
                                         jnp.asarray(s), alpha))
    got = tblend.blend_plane(torch.as_tensor(d), torch.as_tensor(s), alpha)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, jblend.blend_plane(np, d, s, alpha))


def _canon(seed, shape=(3, 40, 56)):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, shape + (4,)).astype(np.int32)
    r = rng.random(shape)
    c[..., 0][r < 0.25] = 0                 # alpha-0 pixels
    c[..., 0][r > 0.75] = 255
    return c


@pytest.mark.parametrize("op", ["overlay_argb", "overlay_argb_addition"])
@pytest.mark.parametrize("alpha", [0, 1, 128, 254, 255])
def test_overlay_matches_reference(op, alpha):
    dst, src = _canon(1), _canon(2)
    want = np.asarray(getattr(jblend, op)(jnp, jnp.asarray(dst),
                                          jnp.asarray(src), alpha))
    got = getattr(tblend, op)(torch.as_tensor(dst), torch.as_tensor(src),
                              alpha)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the numpy route of the reference writes the alpha lane in place
    assert np.array_equal(want, getattr(jblend, op)(np, dst.copy(), src,
                                                    alpha))


def test_source_operator_replaces():
    dst, src = _canon(3), _canon(4)
    got = tblend.source_plane(torch.as_tensor(dst), torch.as_tensor(src), 9)
    assert np.array_equal(got.numpy(), src)


# -- the reference's own launch strings --------------------------------------

def test_mosaic_2x2():
    """tests/test_pipeline.py::test_mosaic_2x2."""
    tpipe, out = run_both(
        "compositor name=c background=black "
        "sink_0::xpos=0 sink_0::ypos=0 sink_1::xpos=64 sink_1::ypos=0 "
        "sink_2::xpos=0 sink_2::ypos=48 sink_3::xpos=64 sink_3::ypos=48 "
        "! video/x-raw,format=I420,width=128,height=96 ! appsink name=out "
        "videotestsrc num-buffers=1 pattern=white ! "
        "video/x-raw,format=I420,width=64,height=48 ! c.sink_0 "
        "videotestsrc num-buffers=1 pattern=red ! "
        "video/x-raw,format=I420,width=64,height=48 ! c.sink_1 "
        "videotestsrc num-buffers=1 pattern=blue ! "
        "video/x-raw,format=I420,width=64,height=48 ! c.sink_2 "
        "videotestsrc num-buffers=1 pattern=green ! "
        "video/x-raw,format=I420,width=64,height=48 ! c.sink_3 ")
    y = out["out"][0].buffer.data[0][0]
    assert [int(y[10, 10]), int(y[10, 100]), int(y[80, 10]),
            int(y[80, 100])] == [235, 81, 41, 145]
    assert tpipe._fused


def test_alpha_blend():
    """tests/test_pipeline.py::test_alpha_blend."""
    _, out = run_both(
        "compositor name=c background=black sink_0::alpha=0.5 "
        "! video/x-raw,format=I420,width=32,height=32 ! appsink name=out "
        "videotestsrc num-buffers=1 pattern=white ! "
        "video/x-raw,format=I420,width=32,height=32 ! c.sink_0")
    y = out["out"][0].buffer.data[0][0]
    assert int(y[5, 5]) == ((16 << 8) + (235 - 16) * 127) >> 8


# tests/test_compositor_banded.py's cases: (xpos, ypos, w, h, alpha)
BANDED = {
    "overlapping_alpha_stack": [(0, 0, 64, 48, 1.0), (32, 16, 64, 48, 0.5),
                                (16, 32, 32, 32, 0.25)],
    "pad_clipped_by_output_edge": [(100, 70, 64, 48, 1.0)],
    "background_only_regions": [(48, 32, 16, 16, 0.75)],
    "full_cover_single_pad": [(0, 0, 128, 96, 1.0)],
}


def _compositor_desc(pads, out_caps, background="black", factory="compositor",
                     fmt="I420", extra=""):
    """pads: [(xpos, ypos, w, h, alpha, more pad props)] -> launch string
    with one appsrc per pad (named in0, in1, ...)."""
    props = " ".join(
        f"sink_{k}::xpos={x} sink_{k}::ypos={y} "
        + (f"sink_{k}::alpha={a} " if a != 1.0 else "")
        + " ".join(f"sink_{k}::{p}" for p in more)
        for k, (x, y, _w, _h, a, *more) in enumerate(pads))
    srcs = " ".join(appsrc(f"in{k}", fmt, w, h, f"sink_{k}")
                    for k, (_x, _y, w, h, *_r) in enumerate(pads))
    return (f"{factory} name=c background={background} {props} ! {out_caps} "
            f"{extra}! appsink name=out {srcs}")


@pytest.mark.parametrize("case", sorted(BANDED))
def test_banded_cases(case):
    pads = BANDED[case]
    desc = _compositor_desc(
        pads, "video/x-raw,format=I420,width=128,height=96")
    specs = {f"in{k}": ("I420", w, h) for k, (_x, _y, w, h, _a)
             in enumerate(pads)}
    run_both(desc, video_pushes(specs, 2, 2), batch=2)


def test_bench_all_string_small():
    """bench_all.py's compositor string (4 I420 pads placed 2x2 into a
    mosaic twice their size), at 64x48 -> 128x96, batch 2, 3 ticks."""
    desc = ("compositor name=c "
            "sink_1::xpos=64 sink_2::ypos=48 "
            "sink_3::xpos=64 sink_3::ypos=48 ! "
            "video/x-raw,width=128,height=96 ! appsink name=out "
            + " ".join(appsrc(f"in{k}", "I420", 64, 48, f"sink_{k}")
                       for k in range(4)))
    specs = {f"in{k}": ("I420", 64, 48) for k in range(4)}
    pushes = video_pushes(specs, 2, 3)
    tpipe, out = run_both(desc, pushes, batch=2)
    assert tpipe._fused and len(out["out"]) == 3
    # every quadrant of every plane is its input plane: no background
    for t, s in enumerate(out["out"]):
        for ci, p in enumerate(s.buffer.data):
            ph, pw = p.shape[-2] // 2, p.shape[-1] // 2
            for k, (qy, qx) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
                q = p[:, qy * ph:(qy + 1) * ph, qx * pw:(qx + 1) * pw]
                assert np.array_equal(q.numpy(),
                                      pushes[f"in{k}"][t]["data"][ci])


# -- compositor cases ----------------------------------------------------------

WALL = ("compositor name=c background=checker "
        "sink_0::width={pw} sink_0::height={ph} "
        "sink_1::xpos={pw} sink_1::width={pw} sink_1::height={ph} "
        "sink_1::alpha=0.5 "
        "sink_2::ypos={ph} sink_2::width={pw} sink_2::height={ph} "
        "sink_3::xpos={qx} sink_3::ypos={qy} sink_3::width={pw} "
        "sink_3::height={ph} sink_3::alpha=0.6 sink_3::zorder=1 ! "
        "video/x-raw,format=BGRA,width={w},height={h} ! appsink name=out ")


def wall_desc(w, h):
    """chip_smoke.py's compositor_wall: four I420 w x h pads, each scaled to
    a quarter and placed on a BGRA w x h checker, the second at alpha 0.5,
    the fourth a picture-in-picture at alpha 0.6 over the middle."""
    return (WALL.format(w=w, h=h, pw=w // 2, ph=h // 2, qx=w // 4,
                        qy=h // 4)
            + " ".join(appsrc(f"in{k}", "I420", w, h, f"sink_{k}")
                       for k in range(4)))


def _spy(monkeypatch):
    """Count the converter's calls of the yscale and chroma420 wrappers
    (it calls them through their modules)."""
    calls = {"yscale_hv": 0, "chroma420_scale": 0}
    for mod, name in ((tysk, "yscale_hv"), (tck, "chroma420_scale")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return calls


def test_scaled_pads_run_the_kernels_plain_versions(monkeypatch):
    """The monitoring wall at 64x48: every pad converts through its own
    converter on the kernel route, one yscale and two chroma420 calls a
    pad a tick (4 and 8 a tick), then blends OVER the checker."""
    calls = _spy(monkeypatch)
    specs = {f"in{k}": ("I420", 64, 48) for k in range(4)}
    ticks = 3
    tpipe, _ = run_both(wall_desc(64, 48), video_pushes(specs, 2, ticks),
                        batch=2)
    assert calls == {"yscale_hv": 4 * ticks, "chroma420_scale": 8 * ticks}
    comp = tpipe.get_by_name("c")
    assert all(c is not None and c.device.type == "cpu"
               for c in comp._converters.values())


@pytest.mark.parametrize("fmt", ["BGRA", "AYUV"])
@pytest.mark.parametrize("op", ["over", "add", "source"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_alpha_output_operators(fmt, op, alpha):
    pads = [(0, 0, 48, 40, 1.0), (20, 12, 44, 36, alpha, f"operator={op}")]
    desc = _compositor_desc(
        pads, f"video/x-raw,format={fmt},width=64,height=48",
        background="checker", fmt=fmt)
    specs = {"in0": (fmt, 48, 40), "in1": (fmt, 44, 36)}
    run_both(desc, video_pushes(specs, 2, 2), batch=2)


@pytest.mark.parametrize("fmt", ["I420", "BGRA"])
def test_equal_zorder_overlap_keeps_pad_order(fmt):
    """Three overlapping pads at equal zorder: the pads' order decides."""
    pads = [(0, 0, 40, 32, 0.5), (16, 8, 40, 32, 0.75), (8, 16, 40, 32, 1.0),
            (24, 20, 40, 28, 0.25, "zorder=0")]
    desc = _compositor_desc(
        pads, f"video/x-raw,format={fmt},width=64,height=48",
        background="white", fmt=fmt)
    specs = {f"in{k}": (fmt, w, h) for k, (_x, _y, w, h, *_r)
             in enumerate(pads)}
    run_both(desc, video_pushes(specs, 1, 2), batch=1)


@pytest.mark.parametrize("fmt", ["I420", "BGRA"])
def test_pads_outside_the_frame(fmt):
    """One pad half outside the frame, one wholly outside (skipped)."""
    pads = [(0, 0, 32, 24, 1.0), (48, 36, 32, 24, 0.5),
            (64, 10, 16, 16, 1.0)]
    desc = _compositor_desc(
        pads, f"video/x-raw,format={fmt},width=64,height=48",
        background="black", fmt=fmt)
    specs = {f"in{k}": (fmt, w, h) for k, (_x, _y, w, h, _a)
             in enumerate(pads)}
    tpipe, _ = run_both(desc, video_pushes(specs, 2, 2), batch=2)
    assert tpipe.get_by_name("c")._geometry["sink_2"] is None


@pytest.mark.parametrize("background",
                         ["checker", "black", "white", "transparent"])
@pytest.mark.parametrize("fmt", ["I420", "RGB", "BGRA", "AYUV"])
def test_every_background(background, fmt):
    pads = [(8, 8, 24, 16, 1.0), (40, 24, 24, 24, 0.5)]
    desc = _compositor_desc(
        pads, f"video/x-raw,format={fmt},width=72,height=52",
        background=background, fmt=fmt)
    specs = {f"in{k}": (fmt, w, h) for k, (_x, _y, w, h, _a)
             in enumerate(pads)}
    run_both(desc, video_pushes(specs, 1, 1), batch=1)


@pytest.mark.parametrize("fmt", ["I420", "BGRA"])
def test_videomixer(fmt):
    pads = [(0, 0, 32, 24, 1.0), (16, 12, 32, 24, 0.5)]
    desc = _compositor_desc(
        pads, f"video/x-raw,format={fmt},width=48,height=36",
        factory="videomixer", fmt=fmt)
    specs = {f"in{k}": (fmt, w, h) for k, (_x, _y, w, h, _a)
             in enumerate(pads)}
    run_both(desc, video_pushes(specs, 2, 2), batch=2)


def test_eos_when_the_first_source_ends():
    """Unequal pushes: the tick is EOS as soon as one source has nothing
    more, so the output has the shorter source's ticks."""
    pads = [(0, 0, 32, 24, 1.0), (16, 12, 32, 24, 0.5)]
    desc = _compositor_desc(
        pads, "video/x-raw,format=I420,width=48,height=36")
    pushes = video_pushes({"in0": ("I420", 32, 24), "in1": ("I420", 32, 24)},
                          2, 3)
    pushes["in1"] = pushes["in1"][:2]
    _, out = run_both(desc, pushes, batch=2)
    assert len(out["out"]) == 2


@pytest.mark.parametrize("factory", ["compositor", "videomixer"])
@pytest.mark.parametrize("fmt", ["I420", "BGRA"])
def test_per_element_path(fmt, factory):
    """A host element downstream splits the graph: the aggregator runs on
    its own in the per-element path."""
    pads = [(0, 0, 32, 24, 1.0), (16, 12, 32, 24, 0.5)]
    desc = _compositor_desc(
        pads, f"video/x-raw,format={fmt},width=48,height=36",
        factory=factory, fmt=fmt,
        extra="! videorate ! video/x-raw,framerate=30/1 ")
    specs = {f"in{k}": (fmt, w, h) for k, (_x, _y, w, h, _a)
             in enumerate(pads)}
    tpipe, _ = run_both(desc, video_pushes(specs, 2, 3), batch=2)
    assert not tpipe._fused


def test_wall_per_element_path(monkeypatch):
    """The wall with queue ! videorate after it: per-element path, the
    same kernel calls."""
    calls = _spy(monkeypatch)
    desc = wall_desc(64, 48).replace(
        "! appsink name=out", "! queue ! videorate ! appsink name=out")
    specs = {f"in{k}": ("I420", 64, 48) for k in range(4)}
    tpipe, _ = run_both(desc, video_pushes(specs, 2, 2), batch=2)
    assert not tpipe._fused
    assert calls == {"yscale_hv": 8, "chroma420_scale": 16}


def test_converters_are_built_on_the_pipeline_device():
    pipe = gstreamer_tpu_torch.parse_launch(wall_desc(64, 48), device="cpu")
    pipe.compile()
    comp = pipe.get_by_name("c")
    assert {c.device.type for c in comp._converters.values()} == {"cpu"}


def test_compile_raises_for_multi_stream_sources():
    """Aggregators compile; a multi-stream source (a demuxer) still raises
    NotImplementedError naming ROADMAP.md."""
    from gstreamer_tpu_torch.core.element import (
        MultiStreamSourceElement, PadDirection, PadTemplate,
        element_factory_make)
    from gstreamer_tpu_torch.core.pipeline import Pipeline, link

    class Demux(MultiStreamSourceElement):
        FACTORY = "testdemux"
        PAD_TEMPLATES = [PadTemplate(
            "src", PadDirection.SRC, "audio/x-raw,format=S16LE,rate=8000,"
            "channels=1,layout=interleaved")]

    pipe = Pipeline(device="cpu")
    src, sink = Demux(name="d"), element_factory_make("fakesink")
    pipe.add(src, sink)
    link(src, sink)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pipe.compile()
    mixer = gstreamer_tpu_torch.parse_launch(
        "audiomixer name=m ! fakesink "
        "audiotestsrc num-buffers=1 ! m.sink_0 "
        "audiotestsrc num-buffers=1 ! m.sink_1", device="cpu")
    mixer.compile()
    assert mixer._fused
