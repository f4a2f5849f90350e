"""Control sources and controlled properties: the port against the JAX
package.

The port's copy of ``core/controller.py`` is held to the JAX module value
for value (every interpolation mode, the LFO waveforms, the trigger
source, bindings).  Controlled ``videobalance`` and ``volume`` run in both
packages' pipelines over several ticks with a control source whose value
changes every tick; every appsink sample and every negotiated caps string
must be equal.  Tolerance 0.  Built with ``gstreamer_tpu.audio`` imported
(jax x64), as the launched pipelines run.
"""

import math

import numpy as np
import pytest
import torch

import gstreamer_tpu.audio  # noqa: F401  (jax x64, as the pipelines run)
from gstreamer_tpu.core import controller as jctl
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements.videofilter import VideoBalance as JVideoBalance

import gstreamer_tpu_torch
from gstreamer_tpu_torch import interop
from gstreamer_tpu_torch.core import controller as tctl
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements.videofilter import VideoBalance

SEC = 1_000_000_000
DUR = 33333333
KEYFRAMES = {
    "one": [(SEC, 0.7)],
    "two": [(0, 0.0), (SEC, 1.0)],
    "uneven": [(-5 * SEC, 2.0), (3, -1.5), (40_000_000, 0.25),
               (2 * SEC + 1, 1.125), (7 * SEC, 0.0)],
}
TIMES = [-6 * SEC, -5 * SEC, -1, 0, 1, 2, 3, 4, 39_999_999, 40_000_000,
         123_456_789, SEC, 2 * SEC, 2 * SEC + 1, 3 * SEC, 7 * SEC, 8 * SEC]


def _interp(mod, mode, points, unset=()):
    cs = mod.InterpolationControlSource(mode)
    for ts, v in points:
        cs.set(ts, v)
    cs.set(points[0][0], points[0][1])     # replace, not insert
    for ts in unset:
        cs.unset(ts)
    return cs


@pytest.mark.parametrize("mode", ["none", "linear", "cubic"])
@pytest.mark.parametrize("keys", sorted(KEYFRAMES))
def test_interpolation_matches_reference(mode, keys):
    pts = KEYFRAMES[keys]
    for unset in ((), (pts[-1][0],)):
        ref = _interp(jctl, mode, pts, unset)
        out = _interp(tctl, mode, pts, unset)
        assert out._points == ref._points
        for ts in TIMES:
            assert out.value_at(ts) == ref.value_at(ts), (mode, keys, ts)


def test_interpolation_without_keyframes():
    assert tctl.InterpolationControlSource().value_at(5) == \
        jctl.InterpolationControlSource().value_at(5) == 0.0


@pytest.mark.parametrize("waveform", ["sine", "square", "saw", "triangle"])
@pytest.mark.parametrize("params", [{}, dict(frequency=3.5, amplitude=0.25,
                                             offset=-1.0, timeshift=12345)])
def test_lfo_matches_reference(waveform, params):
    ref = jctl.LFOControlSource(waveform, **params)
    out = tctl.LFOControlSource(waveform, **params)
    for ts in list(range(-SEC, 3 * SEC, 7_777_777)) + TIMES:
        assert out.value_at(ts) == ref.value_at(ts), (waveform, ts)


def test_trigger_matches_reference():
    ref, out = (m.TriggerControlSource(tolerance_ns=10) for m in (jctl, tctl))
    for cs in (ref, out):
        cs.set(0, 1.0)
        cs.set(SEC, 3.0)
    assert out.mode == ref.mode == "none" and out.tolerance == 10
    for ts in TIMES:
        assert out.value_at(ts) == ref.value_at(ts)


def test_controller_binding_syncs_like_reference():
    """Controller.sync_values sets the bound property on the host (an
    int property rounds)."""
    ref_e, out_e = JVideoBalance(), VideoBalance()
    for mod, e in ((jctl, ref_e), (tctl, out_e)):
        c = mod.Controller()
        b = c.bind(e, "contrast", _interp(mod, "linear", KEYFRAMES["two"]))
        assert b.mode == "direct"
        c.sync_values(SEC // 4)
    assert out_e.props == ref_e.props
    assert out_e.props["contrast"] == 0.25


# -- controlled properties through both packages' pipelines ------------------

def _name_elements(pipe):
    for i, e in enumerate(pipe.iterate_elements()):
        if e.name == f"{e.FACTORY}{id(e) % 10000}":
            e.name = f"{e.FACTORY}_{i}"


def _i420(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8))


def _run(parse, mod, buffer_cls, desc, controls, pushes, batch, **kw):
    """controls: {element name: {prop: [(ts, value), ...]}}; pushes: a
    list of (data, batch) pushed into appsrc ``in`` (none: the string has
    its own source).  Returns (pipeline, samples)."""
    pipe = parse(desc, batch=batch, **kw)
    _name_elements(pipe)
    for name, props in controls.items():
        e = pipe.get_by_name(name)
        for prop, pts in props.items():
            e.set_control_source(prop, _interp(mod, "linear", pts))
    src = pipe.get_by_name("in")
    if src is not None:
        pts = 0
        for data, n in pushes:
            src.push_buffer(buffer_cls(data=data, pts=pts, duration=DUR,
                                       batch=n))
            pts += n * DUR
        src.end_of_stream()
    pipe.run()
    sink = pipe.get_by_name("o")
    samples = []
    while (s := sink.pull_sample()) is not None:
        samples.append(s)
    return pipe, samples


def _leaves(data):
    return list(data) if isinstance(data, (tuple, list)) else [data]


def run_both(desc, controls, pushes=(), batch=1):
    jpipe, ref = _run(jparse_launch, jctl, JBuffer, desc, controls, pushes,
                      batch)
    tpushes = [(tuple(torch.as_tensor(p) for p in d) if isinstance(d, tuple)
                else torch.as_tensor(d), n) for d, n in pushes]
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, tctl, Buffer, desc,
                      controls, tpushes, batch, device="cpu")
    assert len(out) == len(ref) >= 1
    for o, r in zip(out, ref):
        ob, rb = o.buffer, r.buffer
        assert (ob.pts, ob.duration, ob.batch) == (rb.pts, rb.duration,
                                                   rb.batch)
        assert str(o.caps) == str(r.caps)
        for op, rp in zip(_leaves(ob.data), _leaves(rb.data)):
            od, rd = op.numpy(), np.asarray(rp)
            assert od.dtype == rd.dtype and od.shape == rd.shape
            assert np.array_equal(od.view(np.uint8), rd.view(np.uint8))
    assert interop.negotiated_caps(tpipe) == interop.negotiated_caps(jpipe)
    return tpipe, out


W, H, B = 64, 48, 2
VSRC = (f"appsrc name=in caps=video/x-raw,format=I420,width={W},height={H},"
        f"framerate=30/1 ! ")
# values that change every tick (ticks start at 0, B*DUR, 2*B*DUR)
BALANCE = {
    "contrast": [(0, 1.3), (3 * B * DUR, 0.6)],
    "brightness": [(0, -0.1), (3 * B * DUR, 0.2)],
    "hue": [(0, 0.0), (3 * B * DUR, 0.45)],
    "saturation": [(0, 1.5), (3 * B * DUR, 0.4)],
}


def _video_pushes(ticks, seed=0, batch=B):
    return [(_i420(batch, W, H, seed + t), batch) for t in range(ticks)]


@pytest.mark.parametrize("props", [("contrast",), ("brightness",),
                                   ("hue", "saturation"), tuple(BALANCE)])
def test_controlled_videobalance_matches_reference(props):
    tpipe, out = run_both(VSRC + "videobalance name=vb ! appsink name=o",
                          {"vb": {p: BALANCE[p] for p in props}},
                          _video_pushes(3), batch=B)
    assert len(out) == 3 and tpipe._fused
    assert tpipe._dyn_elems == {tpipe.get_by_name("vb"): tuple(sorted(props))}


def test_controlled_videobalance_per_element_path():
    """Behind a host element (deinterlace) the per-element path samples
    the values itself: BASELINE config 4's chain with a fade."""
    tpipe, out = run_both(
        VSRC + "deinterlace ! videobalance name=vb brightness=0.05 ! "
        "appsink name=o", {"vb": {"contrast": BALANCE["contrast"]}},
        _video_pushes(3), batch=B)
    assert not tpipe._fused and len(out) == 3


def _tables_f32(c, b, hue, sat):
    """videobalance's tables in float32, one rounding per step, on the
    host (cos / sin correctly rounded)."""
    f32 = np.float32
    c, b, hue, sat = f32(c), f32(b), f32(hue), f32(sat)
    arg = f32(np.pi) * hue
    hc, hs = f32(math.cos(float(arg))), f32(math.sin(float(arg)))
    i = np.arange(256, dtype=np.float32)
    ty = np.clip(np.rint(f32(16) + (i - f32(16)) * c + b * f32(255)), 0, 255)
    ii, jj = (i - f32(128))[:, None], (i - f32(128))[None, :]
    tu = np.clip(np.rint(f32(128) + (ii * hc + jj * hs) * sat), 0, 255)
    tv = np.clip(np.rint(f32(128) + (-ii * hs + jj * hc) * sat), 0, 255)
    return ty.astype(np.int64), tu.astype(np.int64), tv.astype(np.int64)


@pytest.mark.parametrize("vals", [(0.9, 0.0, 0.0, 1.0), (1.3, -0.1, 0.2, 0.5),
                                  (2.0, 1.0, -1.0, 2.0), (0.0, -1.0, 0.5, 0.0),
                                  (1.1, 0.05, 0.37, 1.21)])
def test_dynamic_balance_equals_float32_tables(vals):
    """make_dyn_fn looks up exactly the float32 tables of the tick's
    values, on every input (contrast 0.9 is the rounding tie that XLA's
    fused multiply-add moves: ROADMAP.md §3)."""
    vb = VideoBalance()
    fn = vb.make_dyn_fn()
    y = torch.arange(256, dtype=torch.uint8).repeat_interleave(256)
    u = torch.arange(256, dtype=torch.uint8).repeat_interleave(256)
    v = torch.arange(256, dtype=torch.uint8).repeat(256)
    dyn = dict(zip(("contrast", "brightness", "hue", "saturation"),
                   (float(np.float32(x)) for x in vals)))
    oy, ou, ov = fn((y.view(1, 256, 256), u.view(1, 256, 256),
                     v.view(1, 256, 256)), dyn)
    ty, tu, tv = _tables_f32(*vals)
    assert np.array_equal(oy.numpy().ravel(), ty[y.numpy()])
    assert np.array_equal(ou.numpy().ravel(), tu.ravel())
    assert np.array_equal(ov.numpy().ravel(), tv.ravel())


def _tick_values(ticks=3):
    """BALANCE sampled at each tick's timestamp, as the pipeline does."""
    names = ("contrast", "brightness", "hue", "saturation")
    out = []
    for t in range(ticks):
        vals = []
        for k in names:
            cs = _interp(tctl, "linear", BALANCE[k])
            vals.append(float(np.float32(cs.value_at(t * B * DUR))))
        out.append(tuple(vals))
    return out


@pytest.mark.parametrize("vals", _tick_values() + [
    (1.3, -0.1, 0.2, 0.5), (2.0, 1.0, -1.0, 2.0), (0.0, -1.0, 0.5, 0.0),
    (1.1, 0.05, 0.37, 1.21), (0.9, 0.0, 0.0, 1.0)])
def test_dynamic_balance_tables_match_reference(vals):
    """Every table entry (256 luma, 2 x 65536 chroma) of the port's
    make_dyn_fn against the JAX package's, jitted as its pipeline runs
    it.  At contrast 0.9, Y=1 is a rounding tie that XLA's fused
    multiply-add moves to 3; the port keeps each rounding and gives 2,
    as the float32 and float64 tables do (ROADMAP.md §3)."""
    import jax
    import jax.numpy as jnp
    y = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(1, 256, 256)
    v = np.tile(np.arange(256, dtype=np.uint8), 256).reshape(1, 256, 256)
    names = ("contrast", "brightness", "hue", "saturation")
    ref = jax.jit(JVideoBalance().make_dyn_fn())(
        (jnp.asarray(y), jnp.asarray(y), jnp.asarray(v)),
        {k: np.float32(x) for k, x in zip(names, vals)})
    out = VideoBalance().make_dyn_fn()(
        (torch.from_numpy(y), torch.from_numpy(y), torch.from_numpy(v)),
        dict(zip(names, vals)))
    ref = [np.asarray(r).astype(np.int64).ravel() for r in ref]
    out = [o.numpy().astype(np.int64).ravel() for o in out]
    if vals[0] == 0.9:
        ty = _tables_f32(*vals)[0]
        assert ty[1] == 2 and np.array_equal(out[0], ty[y.ravel()])
        diff = np.nonzero(ref[0] != out[0])[0]
        assert np.array_equal(y.ravel()[diff], np.full(256, 1))
        assert set(ref[0][diff]) == {3}
        ref[0], out[0] = ref[0][y.ravel() != 1], out[0][y.ravel() != 1]
    for o, r in zip(out, ref):
        assert np.array_equal(o, r)


@pytest.mark.parametrize("vals", [(0.6, 0.2, 0.0, 1.5), (0.5, 0.125, 0.25, 1.25)])
def test_static_and_controlled_balance_agree(vals):
    """One constant value, given as a property and as a control source:
    the same bytes in the port, and both equal the JAX package's
    controlled run."""
    names = ("contrast", "brightness", "hue", "saturation")
    static = " ".join(f"{k}={v}" for k, v in zip(names, vals))
    pushes = _video_pushes(2, seed=7)
    _, dyn = run_both(VSRC + "videobalance name=vb ! appsink name=o",
                      {"vb": {k: [(0, v), (SEC, v)]
                              for k, v in zip(names, vals)}}, pushes,
                      batch=B)
    tpipe, st = _run(gstreamer_tpu_torch.parse_launch, tctl, Buffer,
                     VSRC + f"videobalance {static} ! appsink name=o", {},
                     [(tuple(torch.as_tensor(p) for p in d), n)
                      for d, n in pushes], B, device="cpu")
    assert len(st) == len(dyn) == 2
    for a, b in zip(st, dyn):
        for x, y in zip(a.buffer.data, b.buffer.data):
            assert torch.equal(x, y)


# tests/test_pipeline.py:873-920, TestDynamicProperties: a volume ramp
VOLUME = {"v": {"volume": [(0, 0.0), (SEC, 1.0)]}}


@pytest.mark.parametrize("fmt", ["S16LE", "S32LE", "F32LE"])
def test_controlled_volume_matches_reference(fmt):
    tpipe, out = run_both(
        "audiotestsrc wave=sine freq=440 num-buffers=6 samplesperbuffer=1000"
        f" ! audio/x-raw,format={fmt},rate=10000,channels=1 ! volume name=v"
        " ! appsink name=o", VOLUME)
    assert len(out) == 6 and tpipe._fused
    peaks = [float(s.buffer.data.double().abs().max()) for s in out]
    assert peaks == sorted(peaks) and peaks[0] < peaks[-1]


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
def test_controlled_volume_muted_and_constant(fmt):
    """mute wins over the control source; a constant 0.25 through the
    control path (Q27 from the float32 product on integer formats)."""
    run_both("audiotestsrc wave=square num-buffers=2 samplesperbuffer=300 ! "
             f"audio/x-raw,format={fmt},channels=2 ! volume name=v mute=true "
             "! appsink name=o", VOLUME)
    run_both("audiotestsrc wave=sine num-buffers=3 samplesperbuffer=500 ! "
             f"audio/x-raw,format={fmt},rate=2000,channels=1 ! volume name=v "
             "! appsink name=o", {"v": {"volume": [(0, 0.3), (SEC, 0.3)]}})


def test_controlled_volume_through_appsrc():
    """A host element upstream (audioresample) puts volume on the
    per-element path; chunks pushed through appsrc carry their pts."""
    rng = np.random.default_rng(3)
    pushes = [(rng.integers(-32768, 32767, (n, 2), dtype=np.int16), 1)
              for n in (4800, 960, 2400)]
    run_both("appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
             "channels=2,layout=interleaved ! audioresample ! "
             "audio/x-raw,rate=16000 ! volume name=v ! appsink name=o",
             {"v": {"volume": [(0, 1.5), (SEC // 10, 0.2)]}}, pushes)
