"""The port's audio DSP family against the JAX package.

The G.711 law codecs (exhaustive over every int16 input and every code),
the 18 audiofx factories, replaygain's three and the four host effects
(cutter, scaletempo, pitch, bs2b): the same launch string and the same
seeded numpy buffers go through both packages; samples, negotiated caps
and bus messages equal, tolerance 0.  rglimiter is the one float case with
a tolerance: the port takes its tanh expression in float64 and rounds once
(the same bytes on the card and the CPU), XLA's float32 tanh is up to 2
ULP away from it, and the port is within 1 ULP of a float64 gold of the
same expression (``-s`` prints the counts).  The 31 factories of this
slice carry the reference's properties and pad templates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstreamer_tpu.audio import law as jlaw
from gstreamer_tpu.core import element as jelement
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch

import gstreamer_tpu_torch
from gstreamer_tpu_torch.audio import law as tlaw
from gstreamer_tpu_torch.core import element as telement
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements import audiofx
from gstreamer_tpu_torch.interop import negotiated_caps

from test_torch_compositor import _copy, assert_same_samples
from test_torch_flow import _spec
from test_torch_pipeline import _name_elements

NEW_FACTORIES = (
    "mulawenc", "mulawdec", "alawenc", "alawdec",
    "audioamplify", "audioinvert", "audiokaraoke", "audioecho",
    "audiodynamic", "spectrum", "level", "equalizer-3bands",
    "equalizer-10bands", "equalizer-nbands", "audiopanorama",
    "audiowsinclimit", "audiowsincband", "audiofirfilter", "audioiirfilter",
    "audiocheblimit", "audiochebband", "stereo",
    "rganalysis", "rgvolume", "rglimiter",
    "removesilence", "freeverb",
    "cutter", "scaletempo", "pitch", "bs2b")
RATE = 48000
FRAMES = 480                     # 10 ms a push
SRC = ("appsrc name=in caps=audio/x-raw,format={fmt},rate={rate},"
       "channels={ch},layout=interleaved ! ")
_DTYPES = {"S16LE": np.int16, "S8": np.int8, "U8": np.uint8,
           "S32LE": np.int32, "F32LE": np.float32, "F64LE": np.float64}


def samples(fmt, ch, seed, frames=FRAMES, scale=1.0):
    """Seeded samples of a format: near full scale for the integer ones
    (`scale` times it), about +-1.3 peak for the float ones."""
    rng = np.random.default_rng(seed)
    dt = _DTYPES[fmt]
    if np.issubdtype(dt, np.floating):
        return (rng.standard_normal((frames, ch)) * 0.4 * scale).astype(dt)
    info = np.iinfo(dt)
    x = rng.integers(info.min, int(info.max) + 1, (frames, ch))
    mid = (int(info.min) + int(info.max) + 1) // 2
    return (mid + (x - mid) * scale).astype(dt)


def pushes(fmt, ch, ticks=3, seed=0, frames=FRAMES, rate=RATE, scale=1.0,
           data=None):
    dur = frames * 10**9 // rate
    return [dict(data=samples(fmt, ch, seed + t, frames, scale)
                 if data is None else data[t], pts=t * dur, duration=dur)
            for t in range(ticks)]


def _run(parse, buffer_cls, desc, bufs, setup, **kw):
    pipe = parse(desc, **kw)
    _name_elements(pipe)
    if setup is not None:
        setup(pipe)
    src = pipe.get_by_name("in")
    for b in bufs:
        src.push_buffer(buffer_cls(**dict(b, data=_copy(b["data"]))))
    src.end_of_stream()
    pipe.run()
    sink, got = pipe.get_by_name("out"), []
    while (x := sink.pull_sample()) is not None:
        got.append(x)
    msgs = [(m.type, m.src, m.data) for m in iter(pipe.bus.pop, None)
            if m.type in ("element", "tag")]
    return pipe, got, msgs


def both(desc, bufs, setup=None, exact=True):
    """`desc` (appsrc "in" ... appsink "out") through both packages, the
    port on the CPU, `setup(pipeline)` before each runs.  Asserts the
    negotiated caps and the bus messages equal, and the samples too where
    `exact`; returns (JAX samples, port samples, port messages)."""
    jpipe, ref, jmsgs = _run(jparse_launch, JBuffer, desc, bufs, setup)
    tpipe, out, tmsgs = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                             bufs, setup, device="cpu")
    if exact:
        assert_same_samples({"out": out}, {"out": ref}, ("out",))
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)
    assert tmsgs == jmsgs
    return ref, out, tmsgs


def desc_of(fmt, ch, chain, rate=RATE):
    return SRC.format(fmt=fmt, ch=ch, rate=rate) + chain + \
        " ! appsink name=out"


# -- registry -----------------------------------------------------------------

@pytest.mark.parametrize("factory", NEW_FACTORIES)
def test_factory_matches_reference(factory):
    """Property names, types, defaults and pad templates as the
    reference's class of the same factory."""
    jelement._ensure_elements_loaded()
    telement._ensure_elements_loaded()
    assert _spec(telement._REGISTRY[factory][0]) == \
        _spec(jelement._REGISTRY[factory][0])


# -- law ----------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["mulaw_encode", "alaw_encode",
                                "mulaw_decode", "alaw_decode"])
def test_law_exhaustive(fn):
    """Every int16 input (encoders) or every code (decoders): the torch and
    the numpy branches equal the jitted JAX function."""
    x = (np.arange(-32768, 32768).astype(np.int16) if "encode" in fn
         else np.arange(256).astype(np.uint8))
    want = np.asarray(jax.jit(getattr(jlaw, fn))(jnp.asarray(x)))
    got = getattr(tlaw, fn)(torch.from_numpy(x))
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(getattr(tlaw, fn)(x), want)


@pytest.mark.parametrize("chain", ["mulawenc ! mulawdec", "alawenc ! alawdec",
                                   "mulawenc", "alawenc"])
@pytest.mark.parametrize("ch", [1, 2])
def test_law_elements(chain, ch):
    both(desc_of("S16LE", ch, chain, rate=8000),
         pushes("S16LE", ch, rate=8000))


# -- the device functions -----------------------------------------------------

@pytest.mark.parametrize("fmt", ["S16LE", "S8", "U8", "S32LE", "F32LE",
                                 "F64LE"])
@pytest.mark.parametrize("method", ["clip", "wrap-negative", "wrap-positive",
                                    "none"])
def test_audioamplify(fmt, method):
    """clipping-method=none on an integer format: XLA's cast saturates
    ([-32768, -20000, 20000, 32767] x 2.5 gives -32768, -32768, 32767,
    32767), so the port clamps before its cast."""
    both(desc_of(fmt, 2, f"audioamplify amplification=2.5 "
                         f"clipping-method={method}"), pushes(fmt, 2))


def test_audioamplify_none_saturates():
    x = np.array([[-32768], [-20000], [20000], [32767]], np.int16)
    _, out, _ = both(desc_of("S16LE", 1, "audioamplify amplification=2.5 "
                                        "clipping-method=none"),
                     pushes("S16LE", 1, ticks=1, frames=4, data=[x]))
    assert out[0].buffer.data[:, 0].tolist() == [-32768, -32768, 32767,
                                                 32767]


@pytest.mark.parametrize("fmt", ["S16LE", "U8", "F32LE"])
@pytest.mark.parametrize("degree", [0.3, 1.0])
def test_audioinvert(fmt, degree):
    both(desc_of(fmt, 2, f"audioinvert degree={degree}"), pushes(fmt, 2))


@pytest.mark.parametrize("fmt,ch", [("S16LE", 2), ("F32LE", 2),
                                    ("S16LE", 4), ("S16LE", 1)])
@pytest.mark.parametrize("level", [0.3, 0.77, 1.0])
def test_audiokaraoke(fmt, ch, level):
    """``l - r * level`` is one fused multiply-add in XLA's float64; taken
    twice rounded, about 1500 of 400 000 S16 samples differ at level 0.3
    (test_twice_rounded_forms_differ_from_the_jax_package)."""
    both(desc_of(fmt, ch, f"audiokaraoke level={level} mono-level=0.2"),
         pushes(fmt, ch))


def test_fma_is_one_rounding():
    """_fma against exact rational arithmetic on samples where the two
    roundings of the plain expression differ from one."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a = rng.integers(-32768, 32768, 4000).astype(np.float64)
    c = rng.integers(-32768, 32768, 4000).astype(np.float64)
    got = audiofx._fma(torch.from_numpy(a), 0.3, torch.from_numpy(c))
    want = [float(Fraction(x) * Fraction(0.3) + Fraction(y))
            for x, y in zip(a, c)]
    assert got.tolist() == want
    assert (a * 0.3 + c != np.asarray(want)).any()


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE", "F64LE"])
@pytest.mark.parametrize("props", ["mode=compressor ratio=0.5 threshold=0.3",
                                   "mode=expander ratio=0.37 threshold=0.25",
                                   "characteristics=soft-knee ratio=0.5 "
                                   "threshold=0.1"])
def test_audiodynamic(fmt, props):
    both(desc_of(fmt, 2, f"audiodynamic {props}"), pushes(fmt, 2))


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("props", ["panorama=0.3", "panorama=-0.45",
                                   "panorama=0.0", "panorama=1.0",
                                   "panorama=0.3 method=simple",
                                   "panorama=-0.7 method=simple"])
def test_audiopanorama(fmt, ch, props):
    """Every ``a + b*c`` in float64, rounded once: 0 differences from XLA's
    fused multiply-add (a float32 multiply, then add, differs at about
    9% of F32 samples at pan 0.3:
    test_twice_rounded_forms_differ_from_the_jax_package)."""
    both(desc_of(fmt, ch, f"audiopanorama {props}"), pushes(fmt, ch))


def test_twice_rounded_forms_differ_from_the_jax_package():
    """Why the port rounds once: on 200 000 seeded stereo frames, the
    plainly spelled float32 ``R + L*pan`` (audiopanorama, pan 0.3) and
    float64 ``l - r*level`` (audiokaraoke S16, level 0.3) differ from the
    JAX package's fused multiply-adds, and the port does not (counts under
    -s)."""
    frames = 200_000
    xf = samples("F32LE", 2, 11, frames=frames)
    xs = samples("S16LE", 2, 12, frames=frames)
    cases = (("audiopanorama panorama=0.3", xf, "F32LE"),
             ("audiopanorama panorama=0.3", xs, "S16LE"),
             ("audiokaraoke level=0.3", xs, "S16LE"))
    for chain, x, fmt in cases:
        ref, _, _ = both(desc_of(fmt, 2, chain),
                         pushes(fmt, 2, ticks=1, frames=frames, data=[x]))
        want = np.asarray(ref[0].buffer.data)
        if chain.startswith("audiopanorama"):
            v = x.astype(np.float32)
            plain = np.stack([v[:, 0] * np.float32(1.0 - np.float32(0.3)),
                              v[:, 1] + v[:, 0] * np.float32(0.3)], -1)
            if fmt == "S16LE":
                plain = np.clip(np.round(plain), -32768, 32767)
        else:
            v = x.astype(np.float64)
            plain = np.clip(np.stack([v[:, 0] - v[:, 1] * 0.3,
                                      v[:, 1] - v[:, 0] * 0.3], -1),
                            -32768, 32767)
        n = int((plain.astype(want.dtype) != want).sum())
        print(f"{chain} {fmt}: twice rounded, {n} of {want.size} samples "
              f"differ from the JAX package; the port: 0")
        assert n > 0


# -- replaygain ---------------------------------------------------------------

def test_rgvolume_fallback_and_tags():
    both(desc_of("F32LE", 2, "rgvolume fallback-gain=-3.0"),
         pushes("F32LE", 2))
    both(desc_of("S16LE", 2, "rganalysis ! audioconvert ! "
                             "audio/x-raw,format=F32LE ! rgvolume "
                             "pre-amp=2.0 headroom=1.0 album-mode=false"),
         pushes("S16LE", 2, ticks=4, frames=4800))


@pytest.mark.parametrize("fmt,ch,rate", [("S16LE", 2, 48000),
                                         ("F32LE", 1, 44100),
                                         ("F32LE", 2, 8000)])
def test_rganalysis_tags(fmt, ch, rate):
    _, _, msgs = both(desc_of(fmt, ch, "rganalysis num-tracks=1", rate),
                      pushes(fmt, ch, ticks=4, frames=rate // 10, rate=rate))
    assert [m[0] for m in msgs] == ["tag"]
    assert "replaygain-album-gain" in msgs[0][2]


def _ulps(a, b):
    """|a - b| in units of float32 spacing at b."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) / np.spacing(np.abs(b).astype(np.float32))


def test_rglimiter():
    """The port rounds the float64 tanh expression once: within 1 ULP of a
    float64 gold and 2 ULP of XLA's float32 tanh (counts under -s)."""
    x = samples("F32LE", 2, 7, frames=200_000, scale=2.0)
    bufs = pushes("F32LE", 2, ticks=1, frames=200_000, data=[x])
    ref, out, _ = both(desc_of("F32LE", 2, "rglimiter"), bufs, exact=False)
    got = out[0].buffer.data.numpy()
    jax_out = np.asarray(ref[0].buffer.data)
    xd = x.astype(np.float64)
    gold = np.where(xd > 0.5, np.tanh((xd - 0.5) / 0.5) * 0.5 + 0.5,
                    np.where(xd < -0.5,
                             np.tanh((xd + 0.5) / 0.5) * 0.5 - 0.5, xd))
    to_jax, to_gold = _ulps(got, jax_out), _ulps(got, gold)
    print(f"rglimiter: {int((to_jax > 0).sum())} of {got.size} samples "
          f"differ from the JAX package (max {to_jax.max():.0f} ULP); max "
          f"{to_gold.max():.3f} ULP from the float64 gold")
    assert got.dtype == np.float32 and got.shape == jax_out.shape
    assert to_jax.max() <= 2 and to_gold.max() <= 1
    quiet = np.abs(x) <= 0.5
    assert np.array_equal(got[quiet], x[quiet])
    both(desc_of("F32LE", 2, "rglimiter enabled=false"), pushes("F32LE", 2))


# -- host elements ------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
def test_audioecho(fmt):
    both(desc_of(fmt, 2, "audioecho delay=7000000 intensity=0.5 "
                         "feedback=0.3"), pushes(fmt, 2, ticks=4))


@pytest.mark.parametrize("props", ["bands=33 interval=5000000",
                                   "bands=16 interval=3000000 "
                                   "message-phase=true threshold=-40",
                                   "bands=9 interval=4000000 "
                                   "multi-channel=true message-phase=true"])
@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
def test_spectrum_messages(props, fmt):
    _, _, msgs = both(desc_of(fmt, 2, f"spectrum {props}"),
                      pushes(fmt, 2, ticks=4))
    assert len(msgs) >= 6 and all(m[2]["name"] == "spectrum" for m in msgs)


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE", "U8"])
def test_level_messages(fmt):
    _, _, msgs = both(desc_of(fmt, 2, "level interval=3000000 "
                                      "peak-ttl=4000000 peak-falloff=20.0"),
                      pushes(fmt, 2, ticks=4))
    assert len(msgs) >= 10 and all(m[2]["name"] == "level" for m in msgs)


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
@pytest.mark.parametrize("chain", ["equalizer-3bands band0=6.0 band2=-3.0",
                                   "equalizer-10bands band0=3.0 band9=-3.0",
                                   "equalizer-nbands num-bands=5",
                                   "equalizer-3bands"])
def test_equalizers(fmt, chain):
    both(desc_of(fmt, 2, chain), pushes(fmt, 2, scale=0.5))


def test_equalizer_nbands_band_gain():
    def setup(pipe):
        eq = next(e for e in pipe.iterate_elements()
                  if e.FACTORY == "equalizer-nbands")
        real = eq.set_info

        def set_info(incaps, outcaps):
            real(incaps, outcaps)
            eq.set_band_gain(2, 9.0)
        eq.set_info = set_info
    both(desc_of("F32LE", 2, "equalizer-nbands num-bands=5"),
         pushes("F32LE", 2), setup)


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
@pytest.mark.parametrize("chain", [
    "audiowsinclimit cutoff=2000 length=31",
    "audiowsinclimit cutoff=2000 length=30 mode=high-pass window=blackman",
    "audiowsinclimit cutoff=900 length=21 window=gaussian",
    "audiowsincband lower-frequency=300 upper-frequency=3400 length=41",
    "audiowsincband lower-frequency=3400 upper-frequency=300 length=40 "
    "mode=band-reject window=hann",
    "audiowsincband lower-frequency=100 upper-frequency=1000 length=25 "
    "window=cosine"])
def test_wsinc(fmt, chain):
    both(desc_of(fmt, 2, chain), pushes(fmt, 2, scale=0.7))


def _set(name, **props):
    def setup(pipe):
        e = pipe.get_by_name(name)
        for k, v in props.items():
            e.set_property(k, v)
    return setup


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
def test_fir_and_iir_filters(fmt):
    both(desc_of(fmt, 2, "audiofirfilter name=f"), pushes(fmt, 2),
         _set("f", kernel=[0.25, 0.5, 0.125, -0.0625]))
    both(desc_of(fmt, 2, "audiofirfilter name=f"), pushes(fmt, 2))
    both(desc_of(fmt, 2, "audioiirfilter name=f"), pushes(fmt, 2, scale=0.5),
         _set("f", b=[0.2, 0.3, 0.2], a=[1.0, -0.5, 0.2]))
    both(desc_of(fmt, 2, "audioiirfilter name=f"), pushes(fmt, 2))


@pytest.mark.parametrize("fmt", ["F32LE", "F64LE"])
@pytest.mark.parametrize("chain", [
    "audiocheblimit cutoff=2000", "audiocheblimit cutoff=5000 mode=high-pass "
    "type=2 poles=6 ripple=40", "audiocheblimit cutoff=100 poles=1",
    "audiochebband lower-frequency=500 upper-frequency=3000",
    "audiochebband lower-frequency=500 upper-frequency=3000 type=2 "
    "mode=band-reject poles=8 ripple=30"])
def test_chebyshev(fmt, chain):
    both(desc_of(fmt, 2, chain), pushes(fmt, 2))


@pytest.mark.parametrize("props", ["stereo=0.5", "stereo=0.9",
                                   "active=false"])
def test_stereo(props):
    both(desc_of("S16LE", 2, f"stereo {props}"), pushes("S16LE", 2))
    both(desc_of("S16LE", 2, f"stereo {props}"),
         pushes("S16LE", 2, frames=481))


def _gated(fmt, ch, ticks, seed=0, frames=FRAMES):
    """Loud and quiet buffers in turns of three."""
    return [dict(b, data=(b["data"] if (t // 3) % 2 == 0
                          else (b["data"].astype(np.int64) // 200).astype(
                              b["data"].dtype)))
            for t, b in enumerate(pushes(fmt, ch, ticks, seed, frames))]


@pytest.mark.parametrize("fmt,ch", [("S16LE", 1), ("S16LE", 2), ("S8", 2)])
@pytest.mark.parametrize("props", ["run-length=20000000 pre-length=10000000",
                                   "run-length=20000000 leaky=true",
                                   "threshold=0.0316 run-length=0"])
def test_cutter(fmt, ch, props):
    _, _, msgs = both(desc_of(fmt, ch, f"cutter {props}"),
                      _gated(fmt, ch, 12))
    assert msgs and all(m[2]["name"] == "cutter" for m in msgs)


def test_cutter_threshold_db_from_a_launch_string():
    """The JAX package divides the launch string's text (TypeError); the
    port converts it: threshold-dB=-30 is threshold 10^(-30/20)."""
    desc = desc_of("S16LE", 1, "cutter threshold-dB=-30 run-length=0")
    with pytest.raises(TypeError):
        jparse_launch(desc)
    pipe = gstreamer_tpu_torch.parse_launch(desc, device="cpu")
    cut = next(e for e in pipe.iterate_elements() if e.FACTORY == "cutter")
    assert cut.props["threshold"] == 10.0 ** (-30 / 20.0)


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE", "F64LE"])
@pytest.mark.parametrize("rate", ["1.5", "0.7"])
def test_scaletempo(fmt, rate):
    both(desc_of(fmt, 2, f"scaletempo rate={rate} stride=8 search=4"),
         pushes(fmt, 2, ticks=5, frames=960))


@pytest.mark.parametrize("props", ["pitch=1.2", "tempo=1.3", "rate=0.8",
                                   "pitch=0.9 output-rate=1.1"])
@pytest.mark.parametrize("ch", [1, 2])
def test_pitch(props, ch):
    both(desc_of("F32LE", ch, f"pitch {props}"),
         pushes("F32LE", ch, ticks=5, frames=960))


@pytest.mark.parametrize("props", ["", "preset=cmoy", "fcut=300 feed=8.0"])
def test_bs2b(props):
    both(desc_of("F32LE", 2, f"bs2b {props}"), pushes("F32LE", 2))
