"""The port's audio elements and launch strings against the JAX package's.

The same launch strings (``tests/test_audio.py``'s, the ASR front-end of
BASELINE config 2 and variants) go through the JAX ``parse_launch`` and the
port's (``device="cpu"``); every appsink sample (data bytes, dtype, shape,
pts, duration) and every pad's negotiated caps string must be equal.
Tolerance 0.  audioresample's streaming state
(``tests/test_audioresample_state.py``'s cases) is held to the JAX element
and to the reference's own properties.  Card-only cases skip here (the
fixture decides at run time).
"""

import numpy as np
import pytest
import torch

import gstreamer_tpu.audio  # noqa: F401  (jax x64, as the pipelines run)
from gstreamer_tpu.audio import quantize as jquant
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements.audio_elements import AUDIO_FORMATS
from gstreamer_tpu.elements.audio_elements import AudioConvert as JAudioConvert
from gstreamer_tpu.elements.audio_elements import AudioResample as JAudioResample

import gstreamer_tpu_torch
from gstreamer_tpu_torch import interop
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.elements.audio_elements import (AudioConvert,
                                                          AudioResample, WAVES)

ASR = ("audio/x-raw,format=S16LE,rate=48000,channels=2 ! audioconvert ! "
       "audio/x-raw,channels=1 ! audioresample ! audio/x-raw,rate=16000 ! "
       "audioconvert ! audio/x-raw,format=F32LE ! appsink name=o")
# tests/test_audio.py:150-207, TestAudioPipeline
LAUNCH = {
    "to_appsink": "audiotestsrc num-buffers=4 samplesperbuffer=512 ! "
                  "appsink name=o",
    "s16_to_f32": "audiotestsrc num-buffers=2 ! audioconvert ! "
                  "audio/x-raw,format=F32LE ! appsink name=o",
    "channels": "audiotestsrc num-buffers=1 ! audio/x-raw,channels=2 ! "
                "audioconvert ! audio/x-raw,channels=1 ! appsink name=o",
    "asr_frontend": "audiotestsrc num-buffers=4 samplesperbuffer=4800 ! " + ASR,
    "volume": "audiotestsrc num-buffers=1 wave=square ! volume volume=0.5 ! "
              "appsink name=o",
    # the same front-end from 44.1 kHz to 48 kHz (160/147 phases)
    "asr_44k_to_48k": "audiotestsrc num-buffers=3 samplesperbuffer=4410 ! "
                      "audio/x-raw,format=S16LE,rate=44100,channels=2 ! "
                      "audioconvert ! audio/x-raw,channels=1 ! audioresample"
                      " ! audio/x-raw,rate=48000 ! audioconvert ! "
                      "audio/x-raw,format=F32LE ! appsink name=o",
    "resample_s32": "audiotestsrc num-buffers=3 samplesperbuffer=1000 ! "
                    "audio/x-raw,format=S32LE,rate=48000,channels=2 ! "
                    "audioresample ! audio/x-raw,rate=44100 ! appsink name=o",
}
APPSRC = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
          "channels=2,layout=interleaved ! ")


def _name_elements(pipe):
    """Give the auto-named elements names from their position, so both
    packages' pipelines name their pads alike."""
    for i, e in enumerate(pipe.iterate_elements()):
        if e.name == f"{e.FACTORY}{id(e) % 10000}":
            e.name = f"{e.FACTORY}_{i}"


def _run(parse, desc, pushes=(), batch=1, buffer_cls=None, **kw):
    """Build, push `pushes` ((frames, channels) int16 arrays) into appsrc
    where the string has one, run to EOS; (pipeline, samples)."""
    pipe = parse(desc, batch=batch, **kw)
    _name_elements(pipe)
    src = pipe.get_by_name("in")
    if src is not None:
        pts = 0
        for x in pushes:
            src.push_buffer(buffer_cls(data=x, pts=pts, batch=1,
                                       duration=len(x) * 10**9 // 48000))
            pts += len(x) * 10**9 // 48000
        src.end_of_stream()
    pipe.run()
    sink = pipe.get_by_name("o")
    samples = []
    while (s := sink.pull_sample()) is not None:
        samples.append(s)
    return pipe, samples


def _check(desc, **kw):
    """Both packages' samples and negotiated caps equal."""
    jpipe, ref = _run(jparse_launch, desc, buffer_cls=JBuffer, **kw)
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, desc,
                      buffer_cls=Buffer, device="cpu", **kw)
    assert len(out) == len(ref) >= 1
    for o, r in zip(out, ref):
        ob, rb = o.buffer, r.buffer
        assert (ob.pts, ob.duration, ob.batch) == (rb.pts, rb.duration,
                                                   rb.batch)
        assert str(o.caps) == str(r.caps)
        assert isinstance(ob.data, torch.Tensor) and ob.data.device.type == "cpu"
        od, rd = ob.data.numpy(), np.asarray(rb.data)
        assert od.dtype == rd.dtype and od.shape == rd.shape
        assert np.array_equal(od.view(np.uint8), rd.view(np.uint8))
    assert interop.negotiated_caps(tpipe) == interop.negotiated_caps(jpipe)
    return tpipe, out


@pytest.mark.parametrize("name", sorted(LAUNCH))
def test_launch_matches_reference(name):
    tpipe, _ = _check(LAUNCH[name])
    hosts = [e.FACTORY for e in tpipe._order if e in tpipe._host_elems]
    assert tpipe._fused == (not hosts)
    assert hosts == (["audioresample"] if "audioresample" in LAUNCH[name]
                     else [])


def test_asr_frontend_batched_ticks():
    """batch 3: audiotestsrc makes 3 buffers' frames a tick."""
    _check("audiotestsrc num-buffers=3 samplesperbuffer=1600 ! " + ASR,
           batch=3)


def test_asr_frontend_chunked_input():
    """Chunks of uneven length through appsrc: the resampler's history,
    phase and timestamps carry across them."""
    rng = np.random.default_rng(5)
    pushes = [rng.integers(-32768, 32767, (n, 2), dtype=np.int16)
              for n in (4800, 777, 100, 3001, 64, 2400)]
    _, out = _check(APPSRC + "audioconvert ! audio/x-raw,channels=1 ! "
                    "audioresample ! audio/x-raw,rate=16000 ! audioconvert !"
                    " audio/x-raw,format=F32LE ! appsink name=o",
                    pushes=pushes)
    assert sum(len(s.buffer.data) for s in out) <= sum(map(len, pushes)) // 3


@pytest.mark.parametrize("wave", WAVES)
def test_waves_match_reference(wave):
    _check(f"audiotestsrc wave={wave} num-buffers=2 samplesperbuffer=300 ! "
           "audio/x-raw,format=S16LE,rate=8000,channels=2 ! appsink name=o")


CONVERT = [(src, "S16LE", 1) for src in AUDIO_FORMATS] + \
    [(src, "F32LE", 1) for src in AUDIO_FORMATS] + \
    [("S16LE", dst, 2) for dst in AUDIO_FORMATS if dst != "S16LE"] + \
    [("F64LE", dst, 3) for dst in ("S8", "U8", "S24_32LE", "S32LE")]


@pytest.mark.parametrize("src,dst,channels", CONVERT)
def test_convert_formats_match_reference(src, dst, channels):
    """audioconvert from a stereo source to `channels` channels of `dst`:
    unpack, the mix (Q10 integer between integer formats, float64 else),
    the quantizer (tpdf dither on the first buffer where it applies) and
    pack.  (Float mixes of more input channels may differ in the last bit
    of float64 between the packages: test_torch_audio.py's mixer test.)"""
    _check(f"audiotestsrc num-buffers=1 samplesperbuffer=200 wave=saw ! "
           f"audio/x-raw,format={src},rate=8000,channels=2 ! audioconvert ! "
           f"audio/x-raw,format={dst},channels={channels} ! appsink name=o")


@pytest.mark.parametrize("props", ["volume=0.5", "volume=0.3", "mute=true",
                                   "volume=1.7"])
@pytest.mark.parametrize("fmt", ["S16LE", "F32LE", "S8", "U8", "S32LE",
                                 "F64LE"])
def test_volume_matches_reference(fmt, props):
    _check(f"audiotestsrc num-buffers=1 samplesperbuffer=300 wave=square ! "
           f"audio/x-raw,format={fmt},channels=2 ! volume {props} ! "
           f"appsink name=o")


def test_controlled_volume_matches_reference():
    """A volume ramp from a control source (the tests/test_pipeline.py
    TestDynamicProperties string): the gain is sampled each buffer at its
    pts, as float32, in both packages."""
    from gstreamer_tpu.core.controller import \
        InterpolationControlSource as JSource

    from gstreamer_tpu_torch.core.controller import \
        InterpolationControlSource

    desc = ("audiotestsrc wave=sine freq=440 num-buffers=10 "
            "samplesperbuffer=1000 ! audio/x-raw,format=F32LE,rate=10000,"
            "channels=1 ! volume name=v ! appsink name=o")
    outs = []
    for parse, source, kw in ((jparse_launch, JSource, {}),
                              (gstreamer_tpu_torch.parse_launch,
                               InterpolationControlSource,
                               dict(device="cpu"))):
        pipe = parse(desc, **kw)
        cs = source()
        cs.set(0, 0.0)
        cs.set(1_000_000_000, 1.0)
        pipe.get_by_name("v").set_control_source("volume", cs)
        pipe.run()
        sink = pipe.get_by_name("o")
        outs.append([np.asarray(s.buffer.data) for s in
                     iter(sink.pull_sample, None)])
    ref, out = outs
    assert len(out) == len(ref) == 10
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and np.array_equal(o, r)
    assert np.abs(out[0]).max() < 0.05 < 0.6 < np.abs(out[-1]).max()


def test_noise_shaping_matches_reference():
    """noise-shaping makes audioconvert a host element in both packages;
    the recurrence's PRNG carries across buffers in both."""
    tpipe, _ = _check(
        "audiotestsrc wave=sine num-buffers=2 samplesperbuffer=256 ! "
        "audio/x-raw,format=S32LE,rate=44100,channels=1 ! "
        "audioconvert noise-shaping=high dithering=tpdf ! "
        "audio/x-raw,format=S16LE ! appsink name=o")
    assert [e.FACTORY for e in tpipe._order
            if e in tpipe._host_elems] == ["audioconvert"]


@pytest.mark.parametrize("dither", ["rpdf", "tpdf", "tpdf-hf"])
def test_dither_continues_across_buffers(dither):
    """The JAX package draws the dither while jit traces audioconvert's
    function, so its second buffer repeats the first one's dither (a
    silent source makes the output the dither itself).  The port follows
    the C quantizer: its first buffer equals the JAX package's, its second
    continues the PRNG (numpy gold: one reference quantizer drawing both
    buffers in turn)."""
    desc = (f"audiotestsrc wave=silence num-buffers=2 samplesperbuffer=64 ! "
            f"audio/x-raw,format=S32LE,rate=8000,channels=2 ! audioconvert "
            f"dithering={dither} ! audio/x-raw,format=S16LE ! appsink name=o")
    _, ref = _run(jparse_launch, desc)
    _, out = _run(gstreamer_tpu_torch.parse_launch, desc, device="cpu")
    r0, r1 = (np.asarray(s.buffer.data) for s in ref)
    o0, o1 = (s.buffer.data.numpy() for s in out)
    assert np.array_equal(o0, r0) and np.array_equal(r1, r0)
    gold_q = jquant.Quantizer(dither, 16, 2)
    for got in (o0, o1):
        d = gold_q.dither_buf(64)
        want = ((np.clip(d, -(1 << 31), (1 << 31) - 1)
                 & ~np.int64(0xFFFF)) >> 16).astype(np.int16)
        assert np.array_equal(got, want)
    assert not np.array_equal(o1, o0)


def test_convert_state_crosses_packages():
    """interop.convert_arrays reads either package's audioconvert alike;
    the quantizer rebuilt from the reference's state draws what the
    reference draws next."""
    caps = ("audio/x-raw,format=S32LE,rate=8000,channels=6,"
            "layout=interleaved", "audio/x-raw,format=S16LE,rate=8000,"
            "channels=2,layout=interleaved")
    j = JAudioConvert()
    j.set_info(*(JCaps.from_string(c) for c in caps))
    t = AudioConvert()
    t.set_info(*(Caps.from_string(c) for c in caps))
    ja, ta = interop.convert_arrays(j), interop.convert_arrays(t)
    assert ja.keys() == ta.keys() >= {"mix", "mix_int", "quant.shift"}
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and np.array_equal(ja[k], ta[k])
    assert ja["mix"].shape == (6, 2) and int(ja["quant.shift"]) == 16
    j._quant.dither_buf(10)
    q = interop.quantizer_from_arrays(interop.convert_arrays(j))
    assert np.array_equal(q.dither_buf(10), j._quant.dither_buf(10))


# -- audioresample's streaming state (tests/test_audioresample_state.py) ------

def _resamplers(in_rate, out_rate):
    ic = (f"audio/x-raw,format=S16LE,rate={in_rate},channels=2,"
          "layout=interleaved")
    oc = ic.replace(f"rate={in_rate}", f"rate={out_rate}")
    j = JAudioResample()
    j.set_info(JCaps.from_string(ic), JCaps.from_string(oc))
    t = AudioResample()
    t.device = torch.device("cpu")
    t.set_info(Caps.from_string(ic), Caps.from_string(oc))
    for e in (j, t):
        e.start()
    return j, t


def _feed(pair, chunks, pts_list):
    """Both elements through the same chunks; the outputs must be equal
    buffer for buffer (data, pts, duration).  Returns the port's."""
    outs = []
    for x, pts in zip(chunks, pts_list):
        rb = pair[0].host_process(JBuffer(data=x, pts=pts, batch=1))
        ob = pair[1].host_process(Buffer(data=torch.as_tensor(x), pts=pts,
                                         batch=1))
        assert (rb is None) == (ob is None)
        if ob is not None:
            assert (ob.pts, ob.duration) == (rb.pts, rb.duration)
            assert np.array_equal(ob.data.numpy(), np.asarray(rb.data))
            outs.append(ob)
    return outs


def _chunked(x, chunk, in_rate):
    parts = [x[i:i + chunk] for i in range(0, len(x), chunk)]
    pts = np.cumsum([0] + [len(p) * 10**9 // in_rate for p in parts[:-1]])
    return parts, [int(p) for p in pts]


@pytest.mark.parametrize("rates", [(48000, 16000), (44100, 48000),
                                   (48000, 44100), (8000, 44100)])
def test_perfect_stream_across_chunks(rates):
    """Chunked output is a prefix-exact match of one-shot output (the
    reference's test_perfect_stream, audioresample.c:220), and equals the
    JAX element's chunk for chunk."""
    x = np.random.default_rng(0).integers(-32768, 32767, (1400, 2), np.int16)
    one = _feed(_resamplers(*rates), [x], [0])[0].data.numpy()
    for chunk in (512, 700):
        got = np.concatenate([b.data.numpy() for b in _feed(
            _resamplers(*rates), *_chunked(x, chunk, rates[0]))])
        m = min(len(one), len(got))
        assert m > 0 and np.array_equal(got[:m], one[:m])


def test_output_count_perfect():
    pair = _resamplers(44100, 48000)
    rng = np.random.default_rng(1)
    chunks = [rng.integers(-32768, 32767, (441, 2), np.int16)
              for _ in range(20)]
    total_out = sum(len(b.data) for b in _feed(pair, chunks, [None] * 20))
    expect = 20 * 441 * 48000 // 44100
    assert expect - total_out <= pair[1]._res.n_taps * 48000 // 44100 + 2
    assert total_out <= expect


def test_timestamps_follow_output_rate():
    rng = np.random.default_rng(2)
    chunks = [rng.integers(-32768, 32767, (4800, 2), np.int16)
              for _ in range(4)]
    outs = _feed(_resamplers(48000, 16000), chunks,
                 [k * 100_000_000 for k in range(4)])
    count = 0
    for b in outs:
        assert b.pts == outs[0].pts + count * 1_000_000_000 // 16000
        count += len(b.data)


def test_drift_resync():
    x = np.random.default_rng(3).integers(-32768, 32767, (4800, 2), np.int16)
    b1, b2 = _feed(_resamplers(48000, 16000), [x, x], [0, 1_100_000_000])
    assert b1.pts == 0
    hist = 4800 - (len(b1.data) * 48000 // 16000)
    expect_base = 1_100_000_000 - hist * 1_000_000_000 // 48000
    assert abs(b2.pts - expect_base) <= 1_000_000_000 // 48000 + 1


def test_rate_change_midstream_renegotiates():
    """appsrc's caps change 48000 -> 32000 between two buffers: the
    pipeline renegotiates and the resampler restarts at the new rate; the
    outputs equal the JAX pipeline's."""
    desc = (APPSRC + "audioresample ! audio/x-raw,rate=16000 ! "
            "appsink name=o")
    rng = np.random.default_rng(4)
    a = rng.integers(-32768, 32767, (4800, 2), np.int16)
    b = rng.integers(-32768, 32767, (3200, 2), np.int16)
    outs = []
    for parse, buf, kw in ((jparse_launch, JBuffer, {}),
                           (gstreamer_tpu_torch.parse_launch, Buffer,
                            {"device": "cpu"})):
        p = parse(desc, **kw)
        src, sink = p.get_by_name("in"), p.get_by_name("o")
        src.push_buffer(buf(data=a, pts=0, batch=1))
        src.set_caps("audio/x-raw,format=S16LE,rate=32000,channels=2,"
                     "layout=interleaved")
        src.push_buffer(buf(data=b, pts=100_000_000, batch=1))
        assert p.tick() and p.tick()
        res = next(e for e in p.iterate_elements()
                   if e.FACTORY == "audioresample")
        assert res._iinfo.rate == 32000
        got = []
        while len(sink):
            got.append(np.asarray(sink.pull_sample().buffer.data))
        outs.append(got)
    assert len(outs[0]) == len(outs[1]) == 2
    for r, o in zip(*outs):
        assert o.shape[1] == 2 and np.array_equal(r, o)


def _ulps32(a, b):
    """|a - b| in ULPs of float32 at b."""
    return np.abs(a.astype(np.float64) - b) / np.spacing(
        np.abs(b).astype(np.float32)).astype(np.float64)


def test_f32_stream_meets_the_float_contract():
    """F32 through audioresample (44.1 kHz -> 48 kHz) in uneven chunks:
    per output sample, against the float64 gold of the whole stream
    (resample_ref over the same float32 inputs; the stream is
    prefix-exact), the port's error may exceed the JAX element's by at most
    1 ULP of the output; the port's own is within half an ULP."""
    from gstreamer_tpu.audio.resampler import AudioResampler as JResampler
    desc = ("appsrc name=in caps=audio/x-raw,format=F32LE,rate=44100,"
            "channels=2,layout=interleaved ! audioresample ! "
            "audio/x-raw,rate=48000 ! appsink name=o")
    rng = np.random.default_rng(9)
    pushes = [(rng.random((n, 2)) * 2 - 1).astype(np.float32)
              for n in (1000, 333, 1200)]
    outs = [np.concatenate([np.asarray(s.buffer.data) for s in _run(
        parse, desc, pushes=pushes, buffer_cls=cls, **kw)[1]])
        for parse, cls, kw in ((jparse_launch, JBuffer, {}),
                               (gstreamer_tpu_torch.parse_launch, Buffer,
                                {"device": "cpu"}))]
    ref, got = outs
    gold = JResampler("kaiser", 44100, 48000).resample_ref(
        np.concatenate(pushes).astype(np.float64), "f32")[:len(got)]
    assert got.dtype == np.float32 and got.shape == ref.shape == gold.shape
    assert np.all(_ulps32(got, gold) <= 0.5 + 1e-6)
    assert np.all(_ulps32(got, gold) <= _ulps32(ref, gold) + 1.0)


def test_audio_chain_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gstreamer_tpu_torch.parse_launch(LAUNCH["asr_frontend"])
    pipe = gstreamer_tpu_torch.parse_launch(LAUNCH["asr_frontend"],
                                            device="cpu")
    e = AudioResample()                  # outside a pipeline: the default
    ic = Caps.from_string("audio/x-raw,format=S16LE,rate=48000,channels=1")
    with pytest.raises(RuntimeError, match="CUDA"):
        e.set_info(ic, Caps.from_string(
            "audio/x-raw,format=S16LE,rate=16000,channels=1"))
    assert pipe.device.type == "cpu"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain's device route")
    return torch.device("cuda")


def test_asr_chain_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(6)
    pushes = [rng.integers(-32768, 32767, (n, 2), dtype=np.int16)
              for n in (4800, 777, 3001)]
    desc = APPSRC + ASR.split(" ! ", 1)[1]
    _, out = _run(gstreamer_tpu_torch.parse_launch, desc,
                  pushes=[torch.as_tensor(p, device=cuda) for p in pushes],
                  buffer_cls=Buffer)
    _, ref = _run(gstreamer_tpu_torch.parse_launch, desc, pushes=pushes,
                  buffer_cls=Buffer, device="cpu")
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.buffer.data.device.type == "cuda"
        assert torch.equal(o.buffer.data.cpu(), r.buffer.data)
