"""The effectv family of the port against the JAX package.

Each of the twelve effects runs through both packages' ``parse_launch``
at 32x24 RGB on the same seeded frames, in one tick and in two (the
feedback state carried across the tick boundary): every appsink sample
must be equal, tolerance 0, and equal to the numpy gold (``_frame``, the
exact port of the C) run over all frames in one call.  The eight device
scans run fused and behind a host element (the per-element path); a
second tick also runs in the port from the state the JAX pipeline carried
out of its first tick (``interop.element_states``).
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.core.pipeline import State as JState

import gstreamer_tpu_torch
from gstreamer_tpu_torch import interop
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.core.element import element_factory_make
from gstreamer_tpu_torch.core.pipeline import State

W, H = 32, 24
CAPS = f"video/x-raw,format=RGB,width={W},height={H},framerate=30/1"
SCANS = ["edgetv", "streaktv", "shagadelictv", "vertigotv", "quarktv",
         "revtv", "dicetv", "warptv"]
HOSTS = ["rippletv", "agingtv", "optv", "radioactv"]
# property settings beside each effect's defaults
PROPS = [
    ("streaktv", "feedback=true"),
    ("quarktv", "planes=4"),
    ("vertigotv", "speed=0.3 zoom-speed=1.05"),
    ("revtv", "linespace=2 gain=7"),
    ("dicetv", "square-bits=2"),
    ("rippletv", "mode=rain"),
    ("agingtv", "scratch-lines=12 color-aging=false"),
    ("agingtv", "pits=false dusts=false"),
    ("optv", "mode=1 speed=3 threshold=30"),
    ("optv", "mode=2"),
    ("optv", "mode=3"),
    ("radioactv", "mode=1 color=0 interval=2"),
    ("radioactv", "mode=2 color=2"),
    ("radioactv", "mode=3 trigger=true color=1"),
]


def frames(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, H, W), np.uint8) for _ in range(3))


def _run(parse, buffer_cls, desc, planes, ticks, **kw):
    """Push the frames in `ticks` equal buffers and tick to EOS; returns
    (pipeline, the samples' planes concatenated)."""
    p = parse(desc, **kw)
    for i, e in enumerate(p.iterate_elements()):
        if e.name == f"{e.FACTORY}{id(e) % 10000}":
            e.name = f"{e.FACTORY}_{i}"
    src, sink = p.get_by_name("in"), p.get_by_name("s")
    n = planes[0].shape[0] // ticks
    for t in range(ticks):
        data = tuple(pl[t * n:(t + 1) * n] for pl in planes)
        if buffer_cls is Buffer:
            data = tuple(torch.as_tensor(x) for x in data)
        src.push_buffer(buffer_cls(data=data, pts=t * n * 33333333,
                                   duration=33333333, batch=n))
    src.end_of_stream()
    p.run()
    outs = []
    while (s := sink.pull_sample()) is not None:
        outs.append([np.asarray(x) if not isinstance(x, torch.Tensor)
                     else x.numpy() for x in s.buffer.data])
    return p, [np.concatenate([o[i] for o in outs]) for i in range(3)]


def run_both(desc, planes, ticks):
    desc = f"appsrc name=in caps={CAPS} ! {desc} ! appsink name=s"
    jp, ref = _run(jparse_launch, JBuffer, desc, planes, ticks)
    tp, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, planes,
                   ticks, device="cpu")
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype == np.uint8 and o.shape == r.shape
        assert np.array_equal(o, r), desc
    assert interop.negotiated_caps(tp) == interop.negotiated_caps(jp)
    return tp, out


def gold(cls_make, caps_cls, buffer_cls, factory, ins, **props):
    """The element's numpy gold over all of `ins` in one call."""
    e = cls_make(factory, **props)
    caps = caps_cls.from_string(CAPS)
    e.set_info(caps, caps)
    e.start()
    data = ins if buffer_cls is JBuffer else tuple(
        torch.as_tensor(x) for x in ins)
    buf = e.host_process(buffer_cls(data=data, pts=0,
                                    batch=ins[0].shape[0]))
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
            for x in buf.data]


@pytest.mark.parametrize("factory", SCANS + HOSTS)
@pytest.mark.parametrize("ticks", [1, 2])
def test_effect_matches_reference(factory, ticks):
    planes = frames(6, seed=sum(map(ord, factory)))
    tp, out = run_both(factory, planes, ticks)
    assert tp._fused == (factory in SCANS)
    ref_gold = gold(jmake, JCaps, JBuffer, factory, planes)
    port_gold = gold(element_factory_make, Caps, Buffer, factory, planes)
    for o, g, p in zip(out, ref_gold, port_gold):
        assert np.array_equal(g, p)
        assert np.array_equal(o, g)


def _parse_props(text):
    return dict(kv.split("=") for kv in text.split())


@pytest.mark.parametrize("factory,props", PROPS)
def test_effect_properties_match_reference(factory, props):
    planes = frames(6, seed=7)
    _, out = run_both(f"{factory} {props}", planes, 2)
    kw = _parse_props(props)
    port_gold = gold(element_factory_make, Caps, Buffer, factory, planes,
                     **kw)
    for o, g in zip(out, port_gold):
        assert np.array_equal(o, g)


@pytest.mark.parametrize("factory", SCANS)
def test_scan_behind_a_host_element(factory):
    """videorate (a host element) puts the scan on the per-element path;
    the carry still crosses the tick boundary."""
    planes = frames(6, seed=11)
    tp, out = run_both(f"videorate ! {factory}", planes, 2)
    assert not tp._fused and tp.get_by_name("s") is not None
    assert tp._scan_fns and not tp._host_elems & set(tp._scan_fns)
    g = gold(element_factory_make, Caps, Buffer, factory, planes)
    for o, r in zip(out, g):
        assert np.array_equal(o, r)


def test_alpha_plane_passes_through():
    rng = np.random.default_rng(3)
    planes = tuple(rng.integers(0, 256, (4, H, W), np.uint8)
                   for _ in range(4))
    desc = (f"appsrc name=in caps={CAPS.replace('RGB', 'RGBA')} ! edgetv ! "
            f"appsink name=s")
    for parse, cls, kw in ((jparse_launch, JBuffer, {}),
                           (gstreamer_tpu_torch.parse_launch, Buffer,
                            dict(device="cpu"))):
        _, out = _run(parse, cls, desc, planes, 2, **kw)
        if cls is JBuffer:
            ref = out
    for o, r in zip(out, ref):
        assert np.array_equal(o, r)


@pytest.mark.parametrize("factory", SCANS)
def test_second_tick_from_carried_state(factory):
    """Tick 1 in the JAX pipeline; its carried state (and the host
    counters of the aux rows) into the port's pipeline; tick 2 in both
    gives the same bytes."""
    planes = frames(6, seed=5)
    first = tuple(p[:3] for p in planes)
    second = tuple(p[3:] for p in planes)
    desc = f"appsrc name=in caps={CAPS} ! {factory} ! appsink name=s"
    jp = jparse_launch(desc)
    src, sink = jp.get_by_name("in"), jp.get_by_name("s")
    jp.set_state(JState.PLAYING)
    src.push_buffer(JBuffer(data=first, pts=0, batch=3))
    assert jp.tick()
    sink.pull_sample()
    states = interop.element_states(jp)
    assert "carry" in states[factory_name(jp, factory)]
    src.push_buffer(JBuffer(data=second, pts=3, batch=3))
    assert jp.tick()
    ref = [np.asarray(x) for x in sink.pull_sample().buffer.data]

    tp = gstreamer_tpu_torch.parse_launch(desc, device="cpu")
    for e, je in zip(tp.iterate_elements(), jp.iterate_elements()):
        e.name = je.name
    tp.set_state(State.PLAYING)
    interop.load_element_states(tp, states)
    tp.get_by_name("in").push_buffer(Buffer(
        data=tuple(torch.as_tensor(x) for x in second), pts=3, batch=3))
    assert tp.tick()
    out = tp.get_by_name("s").pull_sample().buffer.data
    for o, r in zip(out, ref):
        assert np.array_equal(o.numpy(), r)
    # and a fresh port pipeline run over both ticks gives the same bytes
    _, both = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, planes,
                   2, device="cpu")
    for o, b in zip(out, both):
        assert np.array_equal(o.numpy(), b[3:])


def factory_name(pipe, factory):
    return next(e.name for e in pipe.iterate_elements()
                if e.FACTORY == factory)


def test_deinterlacer_state_carries_across():
    """interop carries a deinterlacer's frames and pending fields."""
    rng = np.random.default_rng(8)
    i420 = "video/x-raw,format=I420,width=32,height=24,framerate=30/1"

    def planes(n):
        return (rng.integers(0, 256, (n, 24, 32), np.uint8),
                rng.integers(0, 256, (n, 12, 16), np.uint8),
                rng.integers(0, 256, (n, 12, 16), np.uint8))

    first, second = planes(3), planes(2)
    desc = (f"appsrc name=in caps={i420} ! deinterlace name=d method=yadif "
            "! appsink name=s")
    jp = jparse_launch(desc)
    jp.set_state(JState.PLAYING)
    jp.get_by_name("in").push_buffer(JBuffer(data=first, pts=0, batch=3))
    assert jp.tick()
    states = interop.element_states(jp)
    assert states["d"]["_pending"] == 2
    assert len(states["d"]["carry_planes"]) == 3
    jp.get_by_name("in").push_buffer(JBuffer(data=second, pts=1, batch=2))
    assert jp.tick()
    jsink = jp.get_by_name("s")
    jsink.pull_sample()
    ref = jsink.pull_sample().buffer

    tp = gstreamer_tpu_torch.parse_launch(desc, device="cpu")
    tp.set_state(State.PLAYING)
    interop.load_element_states(tp, states)
    tp.get_by_name("in").push_buffer(Buffer(
        data=tuple(torch.as_tensor(x) for x in second), pts=1, batch=2))
    assert tp.tick()
    out = tp.get_by_name("s").pull_sample().buffer
    assert out.batch == ref.batch == 4
    for o, r in zip(out.data, ref.data):
        assert np.array_equal(o.numpy(), np.asarray(r))


def test_state_resets_when_the_program_is_built():
    """compile() drops the carries, start() the effect's host state: a
    second run of the same pipeline object repeats the first."""
    planes = frames(4, seed=9)
    desc = f"appsrc name=in caps={CAPS} ! vertigotv ! appsink name=s"
    p = gstreamer_tpu_torch.parse_launch(desc, device="cpu")
    outs = []
    for _ in range(2):
        p.compile(batch=2)
        assert p._elem_states is None
        src, sink = p.get_by_name("in"), p.get_by_name("s")
        src.push_buffer(Buffer(data=tuple(torch.as_tensor(x)
                                          for x in planes), batch=4))
        p.set_state(State.PLAYING)
        assert p.tick()
        outs.append(sink.pull_sample().buffer.data)
        p.set_state(State.NULL)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_mesh_and_prefetch_still_raise():
    p = gstreamer_tpu_torch.parse_launch(
        f"appsrc name=in caps={CAPS} ! edgetv ! appsink name=s", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        p.compile(mesh=object())
    # prefetch is ported: it compiles the same scan
    p.compile(prefetch=True)
    assert p._prefetch and [e.FACTORY for e in p._scan_fns] == ["edgetv"]
    p.compile()
    assert p._fused and [e.FACTORY for e in p._scan_fns] == ["edgetv"]
