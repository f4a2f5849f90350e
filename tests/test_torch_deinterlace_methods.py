"""Every deinterlace method of the port against the JAX element, over ticks
of uneven sizes, with its properties, flush and launch strings.

The same seeded I420 frames (64x48) go through the JAX ``Deinterlace``
element and the port's, tick by tick (3, 2 and 4 frames): every output
buffer's bytes, batch, pts and duration must be equal, which holds the
carried frames, the pending fields of the methods with latency and the
linear fallback at the stream's edge fields.  Tolerance 0.

The JAX element jits its tick function once per element, tick shape and
field list, a compile for every tick of every case.  Its synthesis code is
written over an array module (``xp``), so the element-level cases run that
same code unjitted over numpy (``eager``: ``jax.jit`` and ``jax.numpy``
swapped for the test; integer arithmetic, so the same bytes), with the
element's own tick bookkeeping.  The launch strings here and
``tests/test_torch_deint.py``'s every-method case run the JAX element
jitted, as it is.
"""

import jax
import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements.deinterlace import Deinterlace as JDeinterlace

import gstreamer_tpu_torch
from gstreamer_tpu_torch import interop
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.elements.deinterlace import METHODS, Deinterlace

W, H = 64, 48
CAPS = f"video/x-raw,format=I420,width={W},height={H},framerate=30/1"
DUR = 33333333
TICKS = (3, 2, 4)


@pytest.fixture
def eager(monkeypatch):
    """The JAX element's tick function, unjitted, over numpy arrays."""
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(jax, "numpy", np)


def _i420(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, H, W), dtype=np.uint8),
            rng.integers(0, 256, (n, H // 2, W // 2), dtype=np.uint8),
            rng.integers(0, 256, (n, H // 2, W // 2), dtype=np.uint8))


def _element(cls, caps_cls, **props):
    d = cls(**props)
    caps = caps_cls.from_string(CAPS)
    d.set_info(caps, caps)
    d.start()
    return d


def _pair(**props):
    return _element(JDeinterlace, JCaps, **props), \
        _element(Deinterlace, Caps, **props)


def _step(jd, td, planes, pts):
    """One tick through both elements; the outputs must be equal."""
    meta = dict(pts=pts, duration=DUR, batch=planes[0].shape[0])
    ref = jd.host_process(JBuffer(data=planes, **meta))
    out = td.host_process(Buffer(
        data=tuple(torch.as_tensor(p) for p in planes), **meta))
    assert (out.batch, out.pts, out.duration) == \
        (ref.batch, ref.pts, ref.duration)
    assert len(out.data) == len(ref.data) == 3
    for o, r in zip(out.data, ref.data):
        assert o.dtype == torch.uint8 and tuple(o.shape) == r.shape
        assert np.array_equal(o.numpy(), np.asarray(r))
    assert td._pending == jd._pending
    return out


def _run_ticks(jd, td, ticks=TICKS, seed=0):
    outs, pts = [], 0
    for t, n in enumerate(ticks):
        outs.append(_step(jd, td, _i420(n, seed + t), pts))
        pts += n * DUR
    return outs


@pytest.mark.usefixtures("eager")
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fields", ["all", "top", "bottom"])
@pytest.mark.parametrize("layout", ["tff", "bff"])
def test_method_matches_reference_over_uneven_ticks(method, fields, layout):
    jd, td = _pair(method=method, fields=fields, **{"field-layout": layout})
    outs = _run_ticks(jd, td)
    if fields == "all":
        # latency-1 methods hold one field back, yadif two
        held = {"greedyh": 1, "greedyl": 1, "yadif": 2}.get(method, 0)
        assert [o.batch for o in outs] == [6 - held, 4, 8]


def _frames_out(outs):
    return [np.concatenate([o.data[i].numpy() for o in outs])
            for i in range(3)]


@pytest.mark.usefixtures("eager")
@pytest.mark.parametrize("method", ["greedyh", "greedyl", "vfir",
                                    "linearblend", "weave", "yadif",
                                    "tomsmocomp"])
def test_split_invariance_temporal(method):
    """tests/test_deinterlace.py's test_split_invariance_temporal: one
    tick of 6 frames equals three ticks of 2 -- true history, not batch
    clamps -- in the port, and both equal the JAX element."""
    planes = _i420(6, 4)
    one = _step(*_pair(method=method), planes, 0)
    jd, td = _pair(method=method)
    three = [_step(jd, td, tuple(p[2 * t:2 * t + 2] for p in planes),
                   2 * t * DUR) for t in range(3)]
    for a, b in zip(_frames_out([one]), _frames_out(three)):
        assert np.array_equal(a, b)


@pytest.mark.usefixtures("eager")
@pytest.mark.parametrize("props", [
    {"method": "greedyh", "max-comb": 0},
    {"method": "greedyh", "max-comb": 40},
    {"method": "greedyh", "motion-threshold": 0, "motion-sense": 255},
    {"method": "greedyh", "motion-threshold": 90, "motion-sense": 1},
    {"method": "greedyl", "max-comb": 0},
    {"method": "greedyl", "max-comb": 3},
    {"method": "tomsmocomp", "strange-bob": True},
    {"method": "tomsmocomp", "strange-bob": True, "search-effort": 27},
    {"method": "yadif", "field-layout": "bff"},
])
def test_method_properties_match_reference(props):
    jd, td = _pair(**props)
    _run_ticks(jd, td, seed=10)


@pytest.mark.usefixtures("eager")
def test_method_properties_change_the_output():
    """The sub-properties are read: each setting gives other bytes than
    the method's default on the same frames."""
    planes = _i420(3, 21)
    base = {m: _step(*_pair(method=m), planes, 0)
            for m in ("greedyh", "greedyl", "tomsmocomp")}
    for props in ({"method": "greedyh", "max-comb": 0},
                  {"method": "greedyh", "motion-sense": 0},
                  {"method": "greedyl", "max-comb": 0},
                  {"method": "tomsmocomp", "strange-bob": True}):
        out = _step(*_pair(**props), planes, 0)
        assert not all(np.array_equal(a.numpy(), b.numpy()) for a, b in
                       zip(out.data, base[props["method"]].data)), props


@pytest.mark.usefixtures("eager")
@pytest.mark.parametrize("method", ["greedyh", "yadif", "vfir"])
def test_flush_drops_history_like_reference(method):
    """flush() drops the carried frames and pending fields: the next tick
    starts a new stream (edge fields on the linear backup again)."""
    jd, td = _pair(method=method)
    _run_ticks(jd, td, ticks=(3,), seed=30)
    assert td._carry_planes is not None and td._pending == jd._pending
    jd.flush()
    td.flush()
    assert td._carry_planes is None and td._pending == 0
    outs = _run_ticks(jd, td, ticks=(2, 3), seed=31)
    fresh = _run_ticks(*_pair(method=method), ticks=(2, 3), seed=31)
    for a, b in zip(outs, fresh):
        for x, y in zip(a.data, b.data):
            assert torch.equal(x, y)


@pytest.mark.usefixtures("eager")
def test_mode_disabled_passes_through():
    jd, td = _pair(method="yadif", mode="disabled")
    out = _step(jd, td, _i420(3, 40), 0)
    assert out.batch == 3


# -- launch strings through both packages ------------------------------------

def _run(parse, buffer_cls, desc, batch, ticks, **kw):
    pipe = parse(desc, batch=batch, **kw)
    for i, e in enumerate(pipe.iterate_elements()):
        if e.name == f"{e.FACTORY}{id(e) % 10000}":
            e.name = f"{e.FACTORY}_{i}"
    src = pipe.get_by_name("in")
    pts = 0
    for t, n in enumerate(ticks):
        planes = _i420(n, 50 + t)
        if buffer_cls is Buffer:
            planes = tuple(torch.as_tensor(p) for p in planes)
        src.push_buffer(buffer_cls(data=planes, pts=pts, duration=DUR,
                                   batch=n))
        pts += n * DUR
    src.end_of_stream()
    pipe.run()
    sink = pipe.get_by_name("out")
    samples = []
    while (s := sink.pull_sample()) is not None:
        samples.append(s)
    return pipe, samples


LAUNCH = {
    # BASELINE config 4 (bench_all.py:135-174) with a quality method
    "yadif_balance": "deinterlace method=yadif ! videobalance contrast=1.1 "
                     "brightness=0.05 ! appsink name=out",
    "greedyh_rate_balance": "deinterlace method=greedyh ! videorate ! "
                            "video/x-raw,framerate=30/1 ! videobalance "
                            "saturation=1.2 ! appsink name=out",
    "tomsmocomp_top": "deinterlace method=tomsmocomp fields=top ! "
                      "videobalance hue=0.25 ! appsink name=out",
}


@pytest.mark.parametrize("name", sorted(LAUNCH))
def test_launch_matches_reference(name):
    desc = f"appsrc name=in caps={CAPS} ! " + LAUNCH[name]
    jpipe, ref = _run(jparse_launch, JBuffer, desc, 4, (4, 3, 4))
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, 4,
                      (4, 3, 4), device="cpu")
    assert len(out) == len(ref) >= 3
    for o, r in zip(out, ref):
        assert (o.buffer.pts, o.buffer.duration, o.buffer.batch) == \
            (r.buffer.pts, r.buffer.duration, r.buffer.batch)
        assert str(o.caps) == str(r.caps)
        for x, y in zip(o.buffer.data, r.buffer.data):
            assert np.array_equal(x.numpy(), np.asarray(y))
    assert interop.negotiated_caps(tpipe) == interop.negotiated_caps(jpipe)
    assert not tpipe._fused
