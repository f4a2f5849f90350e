"""The port's audio aggregators, interleave and audiorate against the JAX
package, bit for bit (tolerance 0), on the CPU: audiomixer and adder
(integer formats summed in int64 and saturated, float formats summed in
float64 in pad order), audiointerleave, interleave / deinterleave and
audiorate's gap fill and drop, in the fused and the per-element path."""

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.element import element_factory_make as jmake

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.core.element import element_factory_make as tmake

from test_torch_compositor import run_both

RATE = 48000


def _audio(fmt, frames, channels, seed, full_scale=False):
    rng = np.random.default_rng(seed)
    if fmt.startswith("F"):
        dt = np.float32 if fmt == "F32LE" else np.float64
        x = rng.standard_normal((frames, channels)) * (0.9 if full_scale
                                                       else 0.2)
        return x.astype(dt)
    dt = {"S16LE": np.int16, "S32LE": np.int32}[fmt]
    info = np.iinfo(dt)
    if full_scale:
        return rng.integers(info.max // 2, info.max, (frames, channels),
                            dtype=dt, endpoint=True)
    return rng.integers(info.min // 4, info.max // 4, (frames, channels),
                        dtype=dt)


def _pushes(name, chunks, rate=RATE):
    out, t = [], 0
    for x in chunks:
        out.append(dict(data=x, pts=t * 10**9 // rate,
                        duration=len(x) * 10**9 // rate))
        t += len(x)
    return {name: out}


def _src(name, fmt, channels, pad, rate=RATE):
    return (f"appsrc name={name} ! audio/x-raw,format={fmt},rate={rate},"
            f"channels={channels},layout=interleaved ! {pad} ")


# -- tests/test_audio.py's cases --------------------------------------------

def test_audiomixer_two_sines():
    _, out = run_both(
        "audiomixer name=m ! appsink name=out "
        "audiotestsrc num-buffers=1 freq=440 volume=0.3 ! m.sink_0 "
        "audiotestsrc num-buffers=1 freq=440 volume=0.3 ! m.sink_1")
    arr = out["out"][0].buffer.data.numpy()
    assert abs(np.abs(arr.astype(int)).max() - 2 * 0.3 * 32767) < 800


def test_audiomixer_saturates():
    _, out = run_both(
        "audiomixer name=m ! appsink name=out "
        "audiotestsrc num-buffers=1 wave=square volume=1.0 ! m.sink_0 "
        "audiotestsrc num-buffers=1 wave=square volume=1.0 ! m.sink_1")
    arr = out["out"][0].buffer.data.numpy()
    assert arr.max() in (32766, 32767) and arr.min() == -32768


def test_audiointerleave_test_sources():
    _, out = run_both(
        "audiointerleave name=i ! appsink name=out "
        "audiotestsrc num-buffers=1 volume=0.5 ! audio/x-raw,channels=1 ! "
        "i.sink_0 "
        "audiotestsrc num-buffers=1 wave=silence ! audio/x-raw,channels=1 ! "
        "i.sink_1")
    arr = out["out"][0].buffer.data.numpy()
    assert arr.shape[1] == 2 and np.abs(arr[:, 1]).max() == 0


# -- every sum format, both factories ------------------------------------------

@pytest.mark.parametrize("factory", ["audiomixer", "adder"])
@pytest.mark.parametrize("fmt", ["S16LE", "S32LE", "F32LE", "F64LE"])
def test_sum_saturates_or_rounds_once(factory, fmt):
    """Three stereo inputs, one near full scale so that integers saturate,
    three ticks."""
    desc = (f"{factory} name=m ! appsink name=out "
            + "".join(_src(f"in{k}", fmt, 2, f"m.sink_{k}")
                      for k in range(3)))
    pushes = {}
    for k in range(3):
        pushes.update(_pushes(f"in{k}", [
            _audio(fmt, 960, 2, 10 * k + t, full_scale=(k == 0))
            for t in range(3)]))
    tpipe, out = run_both(desc, pushes)
    assert tpipe._fused and len(out["out"]) == 3
    for t, s in enumerate(out["out"]):
        xs = [pushes[f"in{k}"][t]["data"] for k in range(3)]
        if fmt.startswith("F"):
            gold = (xs[0].astype(np.float64) + xs[1] + xs[2]).astype(
                xs[0].dtype)
        else:
            lim = np.iinfo(xs[0].dtype)
            gold = np.clip(sum(x.astype(np.int64) for x in xs), lim.min,
                           lim.max).astype(xs[0].dtype)
        assert np.array_equal(s.buffer.data.numpy(), gold)
    if not fmt.startswith("F"):
        assert int(out["out"][0].buffer.data.max()) == np.iinfo(
            xs[0].dtype).max


@pytest.mark.parametrize("fmt,dt", [("U8", np.uint8), ("U16LE", np.uint16)])
def test_unsigned_sum_keeps_the_reference_clip(fmt, dt):
    """The reference clips every integer sum to the signed range of the
    format's width, unsigned formats too, then casts; so does the port."""
    rng = np.random.default_rng(3)
    top = np.iinfo(dt).max
    desc = ("audiomixer name=m ! appsink name=out "
            + _src("in0", fmt, 2, "m.sink_0") + _src("in1", fmt, 2, "m.sink_1"))
    pushes = {f"in{k}": [dict(data=rng.integers(0, top, (256, 2), dtype=dt,
                                                endpoint=True))]
              for k in range(2)}
    _, out = run_both(desc, pushes)
    assert out["out"][0].buffer.data.numpy().dtype == dt


def test_sum_trims_to_the_shortest_input():
    desc = ("audiomixer name=m ! appsink name=out "
            + _src("in0", "S16LE", 2, "m.sink_0")
            + _src("in1", "S16LE", 2, "m.sink_1"))
    pushes = {**_pushes("in0", [_audio("S16LE", 1000, 2, 1)]),
              **_pushes("in1", [_audio("S16LE", 700, 2, 2)])}
    _, out = run_both(desc, pushes)
    assert out["out"][0].buffer.data.shape == (700, 2)


def test_audiointerleave_three_mono():
    desc = ("audiointerleave name=i ! appsink name=out "
            + "".join(_src(f"in{k}", "S16LE", 1, f"i.sink_{k}")
                      for k in range(3)))
    pushes = {}
    for k in range(3):
        pushes.update(_pushes(f"in{k}", [_audio("S16LE", 500 - 50 * k, 1,
                                                k + t) for t in range(2)]))
    _, out = run_both(desc, pushes)
    assert out["out"][0].buffer.data.shape == (400, 3)


def test_mixer_in_the_per_element_path():
    """audiorate after the mixer splits the graph."""
    desc = ("audiomixer name=m ! audiorate ! appsink name=out "
            + _src("in0", "S16LE", 2, "m.sink_0")
            + _src("in1", "S16LE", 2, "m.sink_1"))
    pushes = {}
    for k in range(2):
        pushes.update(_pushes(f"in{k}", [_audio("S16LE", 480, 2, 5 * k + t,
                                                full_scale=True)
                                         for t in range(3)]))
    tpipe, out = run_both(desc, pushes)
    assert not tpipe._fused and len(out["out"]) == 3


@pytest.mark.parametrize("factory,channels", [
    ("adder", 2), ("audiointerleave", 1), ("interleave", 1)])
def test_aggregator_in_the_per_element_path(factory, channels):
    """Each audio aggregator with audiorate after it (per-element path)."""
    desc = (f"{factory} name=m ! audiorate ! appsink name=out "
            + _src("in0", "S16LE", channels, "m.sink_0")
            + _src("in1", "S16LE", channels, "m.sink_1"))
    pushes = {}
    for k in range(2):
        pushes.update(_pushes(f"in{k}", [_audio("S16LE", 480, channels,
                                                7 * k + t) for t in range(2)]))
    tpipe, out = run_both(desc, pushes)
    assert not tpipe._fused and len(out["out"]) == 2


# -- tests/test_interleave.py's cases -------------------------------------------

def test_deinterleave_channels_split():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((400, 3)) * 1000).astype(np.int16)
    tpipe, out = run_both(
        "appsrc name=in ! audio/x-raw,format=S16LE,rate=8000,"
        "channels=3 ! deinterleave name=d "
        "d.src_0 ! appsink name=o0 "
        "d.src_1 ! appsink name=o1 "
        "d.src_2 ! appsink name=o2", {"in": [dict(data=x)]},
        sinks=("o0", "o1", "o2"))
    for k in range(3):
        assert np.array_equal(out[f"o{k}"][0].buffer.data.numpy()[:, 0],
                              x[:, k])


def test_deinterleave_keep_positions():
    x = _audio("F32LE", 300, 2, 4)
    _, out = run_both(
        "appsrc name=in ! audio/x-raw,format=F32LE,rate=8000,channels=2 ! "
        "deinterleave name=d keep-positions=true "
        "d.src_0 ! appsink name=o0 d.src_1 ! appsink name=o1",
        {"in": [dict(data=x, pts=0, duration=10**9 * 300 // 8000)]},
        sinks=("o0", "o1"))
    assert [out[f"o{k}"][0].buffer.meta["channel-position"]
            for k in range(2)] == [0, 1]


def test_interleave_merge_roundtrip():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((300, 2)).astype(np.float64)
    _, out = run_both(
        "interleave name=i ! appsink name=out "
        "appsrc name=a ! audio/x-raw,format=F64LE,rate=8000,"
        "channels=1 ! i.sink_0 "
        "appsrc name=b ! audio/x-raw,format=F64LE,rate=8000,"
        "channels=1 ! i.sink_1",
        {"a": [dict(data=x[:, :1])], "b": [dict(data=x[:, 1:])]})
    assert np.array_equal(out["out"][0].buffer.data.numpy(), x)


def test_interleave_caps_channels_count():
    _, out = run_both(
        "interleave name=i ! appsink name=out "
        "audiotestsrc num-buffers=1 samplesperbuffer=100 ! "
        "audio/x-raw,format=F32LE,rate=8000,channels=1 ! i.sink_0 "
        "audiotestsrc num-buffers=1 samplesperbuffer=100 wave=saw "
        "! audio/x-raw,format=F32LE,rate=8000,channels=1 ! i.sink_1")
    s = out["out"][0]
    assert s.caps[0]["channels"] == 2 and s.buffer.data.shape[-1] == 2


def test_interleave_orders_pads_lexically():
    """Eleven pads: sink_10 sorts before sink_2, as in the reference."""
    desc = ("interleave name=i ! appsink name=out "
            + "".join(_src(f"in{k}", "S16LE", 1, f"i.sink_{k}", rate=8000)
                      for k in range(11)))
    pushes = {}
    for k in range(11):
        pushes.update(_pushes(f"in{k}", [np.full((64, 1), k, np.int16)],
                              rate=8000))
    _, out = run_both(desc, pushes)
    assert out["out"][0].buffer.data[0].tolist() == [0, 1, 10, 2, 3, 4, 5,
                                                     6, 7, 8, 9]


# -- audiorate -------------------------------------------------------------------

def _audiorate_pair(tolerance):
    caps = "audio/x-raw,format=S16LE,rate=1000,channels=1"
    j = jmake("audiorate", tolerance=tolerance)
    j.set_info(JCaps.from_string(caps), JCaps.from_string(caps))
    t = tmake("audiorate", tolerance=tolerance)
    t.device = torch.device("cpu")
    t.set_info(Caps.from_string(caps), Caps.from_string(caps))
    j.start()
    t.start()
    return j, t


# (pts in ms, frames): a gap of 50, an overlap of 30, an overlap that eats a
# whole buffer, then a jitter inside the tolerance
AUDIORATE_STREAM = [(0, 100), (150, 100), (220, 40), (240, 10), (262, 20)]


@pytest.mark.parametrize("tolerance", [0, 5_000_000])
def test_audiorate_fill_and_drop(tolerance):
    j, t = _audiorate_pair(tolerance)
    rng = np.random.default_rng(7)
    for pts_ms, n in AUDIORATE_STREAM:
        x = rng.integers(-3000, 3000, (n, 1), dtype=np.int16)
        rb = j.host_process(JBuffer(data=x.copy(), pts=pts_ms * 10**6))
        ob = t.host_process(Buffer(data=torch.as_tensor(x.copy()),
                                   pts=pts_ms * 10**6))
        assert (ob is None) == (rb is None)
        if rb is None:
            continue
        assert isinstance(ob.data, torch.Tensor)
        assert np.array_equal(ob.data.numpy(), np.asarray(rb.data))
        assert (ob.pts, ob.duration) == (rb.pts, rb.duration)
    for k in ("in_samples", "out_samples", "add_samples", "drop_samples"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.add_samples == (52 if tolerance == 0 else 50)
    assert t.drop_samples == 40


def test_audiorate_in_a_pipeline():
    rng = np.random.default_rng(9)
    chunks = [rng.integers(-3000, 3000, (n, 1), dtype=np.int16)
              for _pts, n in AUDIORATE_STREAM]
    pushes = {"in": [dict(data=x, pts=p * 10**6, duration=len(x) * 10**6)
                     for (p, _n), x in zip(AUDIORATE_STREAM, chunks)]}
    tpipe, out = run_both(
        "appsrc name=in ! audio/x-raw,format=S16LE,rate=1000,channels=1 ! "
        "audiorate tolerance=0 ! appsink name=out", pushes)
    assert not tpipe._fused
    assert [len(s.buffer.data) for s in out["out"]] == [100, 150, 10, 22]
