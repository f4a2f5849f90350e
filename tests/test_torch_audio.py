"""The port's audio modules against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through the JAX package's
function (with ``gstreamer_tpu.audio`` imported, which turns jax x64 on for
the process, as every launch string does) and the port's (``device="cpu"``).
Tolerance 0 for formats, matrices, integer mixing, quantizing and the s16 /
s32 resampler; the float resampler is held to the 1-ULP contract stated at
``test_f32_resample_meets_the_float_contract``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gstreamer_tpu.audio  # noqa: F401  (jax x64, as the pipelines run)
from gstreamer_tpu.audio import channel_mixer as jchmix
from gstreamer_tpu.audio import format as jafmt
from gstreamer_tpu.audio import quantize as jquant
from gstreamer_tpu.audio.info import AudioInfo as JAudioInfo
from gstreamer_tpu.audio.resampler import AudioResampler as JResampler
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.elements.audio_elements import AUDIO_FORMATS

import gstreamer_tpu_torch
from gstreamer_tpu_torch import interop
from gstreamer_tpu_torch.audio import channel_mixer as chmix
from gstreamer_tpu_torch.audio import format as afmt
from gstreamer_tpu_torch.audio import info as ainfo
from gstreamer_tpu_torch.audio import quantize as quant
from gstreamer_tpu_torch.audio import resampler as tres
from gstreamer_tpu_torch.audio.resampler import AudioResampler
from gstreamer_tpu_torch.core.caps import Caps


def _native(name, rng, n=257, ch=3):
    """Random samples of a format over its whole stored range."""
    f = jafmt.format_info(name)
    if f.is_float:
        x = rng.random((n, ch)) * 2.4 - 1.2          # some beyond full scale
        return x.astype(np.float32 if f.width == 32 else np.float64)
    dt = {8: np.int8 if f.is_signed else np.uint8,
          16: np.int16 if f.is_signed else np.uint16}.get(f.width, np.int32)
    lo = -(1 << (f.depth - 1)) if f.is_signed else 0
    hi = (1 << (f.depth - 1)) if f.is_signed else (1 << min(f.depth, 31))
    x = rng.integers(lo, hi, (n, ch), dtype=np.int64)
    x[:2] = [[lo] * ch, [hi - 1] * ch]
    return x.astype(dt)


def _eq(out, ref):
    ref = np.asarray(ref)
    out = out.numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))


# -- formats -------------------------------------------------------------------

@pytest.mark.parametrize("name", AUDIO_FORMATS)
def test_unpack_matches_reference(name):
    x = _native(name, np.random.default_rng(1))
    f, jf = afmt.format_info(name), jafmt.format_info(name)
    assert f == afmt.AudioFormatInfo(**jf.__dict__)
    _eq(afmt.unpack(f, torch.as_tensor(x)), jafmt.unpack(jnp, jf, jnp.asarray(x)))


@pytest.mark.parametrize("name", AUDIO_FORMATS)
def test_pack_matches_reference(name):
    """From int32 canon (every value's low bits) and from float64 canon
    (beyond full scale too: double_to_s32's clamp and truncation)."""
    rng = np.random.default_rng(2)
    f, jf = afmt.format_info(name), jafmt.format_info(name)
    canon = rng.integers(-(1 << 31), 1 << 31, (300, 2), dtype=np.int64)
    canon[:2] = [[-(1 << 31)] * 2, [(1 << 31) - 1] * 2]
    canon = canon.astype(np.int32)
    dbl = rng.random((300, 2)) * 2.5 - 1.25
    dbl[:3] = [[1.0, -1.0], [0.5, 2.0], [-0.0, 1e-12]]
    for c in (canon, dbl):
        _eq(afmt.pack(f, torch.as_tensor(c)), jafmt.pack(jnp, jf, jnp.asarray(c)))


def test_conversions_and_the_format_table():
    assert set(afmt.FORMATS) == set(jafmt.FORMATS)
    for name, jf in jafmt.FORMATS.items():
        assert afmt.FORMATS[name].__dict__ == jf.__dict__
    assert afmt.ALIASES == jafmt.ALIASES
    with pytest.raises(ValueError, match="unknown audio format"):
        afmt.format_info("S7")
    d = np.array([1.0, -1.0, 0.5, 2.0, -3.0, 0.99999999999, -0.0])
    _eq(afmt.double_to_s32(torch.as_tensor(d)), jafmt.double_to_s32(jnp, jnp.asarray(d)))
    s = np.array([-(1 << 31), (1 << 31) - 1, 0, 1, -1], np.int32)
    _eq(afmt.s32_to_double(torch.as_tensor(s)), jafmt.s32_to_double(jnp, jnp.asarray(s)))


def test_byte_layout_is_not_ported():
    """Named when the byte layout raised; it is ported now and held to the
    reference here (every format: test_torch_format_bytes)."""
    f, jfmt = afmt.format_info("S24LE"), jafmt.format_info("S24LE")
    raw = np.arange(12, dtype=np.uint8) * 21
    own = afmt.from_bytes(f, raw, 2)
    assert np.array_equal(own, jafmt.from_bytes(jfmt, raw, 2))
    assert own.shape == (2, 2)
    assert np.array_equal(afmt.to_bytes(f, own), raw)


@pytest.mark.parametrize("caps", [
    "audio/x-raw,format=S16LE,rate=48000,channels=2,layout=interleaved",
    "audio/x-raw,format=F32LE,rate=16000,channels=1",
    "audio/x-raw,format=U8,rate=8000,channels=6",
    "audio/x-raw,format=S24LE,rate=96000,channels=11"])
def test_audio_info_matches_reference(caps):
    i = ainfo.AudioInfo.from_caps_structure(Caps.from_string(caps)[0])
    j = JAudioInfo.from_caps_structure(JCaps.from_string(caps)[0])
    assert (i.format, i.rate, i.channels, i.layout, i.positions, i.bpf) == (
        j.format, j.rate, j.channels, j.layout, j.positions, j.bpf)
    assert str(i.to_caps_structure()) == str(j.to_caps_structure())


# -- channel mixer ---------------------------------------------------------------

@pytest.mark.parametrize("n_out", range(1, 9))
@pytest.mark.parametrize("n_in", range(1, 9))
def test_mixer_matches_reference(n_in, n_out):
    """build_matrix / matrix_int between default layouts, tolerance 0;
    mix_int on full-range S32 against the reference's function over numpy
    (jax.numpy gives the same integers; the launch-string tests run it
    jitted), tolerance 0.  mix_float: each output is a
    float64 dot product of n_in terms, whose order (and use of FMA) XLA
    picks by shape, so the two packages may differ in the last bits:
    |port - reference| <= 2 n_in 2^-53 sum|x m| (the worst-case error of
    such a dot product, for each of the two)."""
    pi, po = ainfo.DEFAULT_POSITIONS[n_in], ainfo.DEFAULT_POSITIONS[n_out]
    m = chmix.build_matrix(pi, po)
    jm = jchmix.build_matrix(pi, po)
    assert m.dtype == jm.dtype == np.float32 and np.array_equal(m, jm)
    mi = chmix.matrix_int(m)
    assert np.array_equal(mi, jchmix.matrix_int(jm))
    rng = np.random.default_rng(10 * n_in + n_out)
    s = rng.integers(-(1 << 31), 1 << 31, (2, 40, n_in)).astype(np.int32)
    _eq(chmix.mix_int(torch.as_tensor(s), mi), jchmix.mix_int(np, s, mi))
    d = rng.random((40, n_in)) * 2 - 1
    out = chmix.mix_float(torch.as_tensor(d), m).numpy()
    ref = jchmix.mix_float(np, d, m)
    tol = 2 * n_in * 2.0 ** -53 * (np.abs(d) @ np.abs(m).astype(np.float64))
    assert out.dtype == ref.dtype and np.all(np.abs(out - ref) <= tol)


def test_unpositioned_matrix_matches_reference():
    pos = tuple(f"ch{i}" for i in range(5))
    assert np.array_equal(chmix.build_matrix(pos, pos[:3], True),
                          jchmix.build_matrix(pos, pos[:3], True))


# -- quantizer ---------------------------------------------------------------------

DITHERS = [quant.DITHER_NONE, quant.DITHER_RPDF, quant.DITHER_TPDF,
           quant.DITHER_TPDF_HF]


@pytest.mark.parametrize("shift", [8, 16])
@pytest.mark.parametrize("dither", DITHERS)
def test_quantizer_matches_reference(dither, shift):
    """dither_buf and apply, tolerance 0, on the first buffer; the port's
    next call continues the PRNG (a numpy gold: one quantizer drawing both
    buffers in turn)."""
    rng = np.random.default_rng(shift)
    s = rng.integers(-(1 << 31), 1 << 31, (2, 50, 3)).astype(np.int32)
    s[0, :2] = [[-(1 << 31)] * 3, [(1 << 31) - 1] * 3]      # saturation
    q = quant.Quantizer(dither, shift, 3, seed=99)
    jq = jquant.Quantizer(dither, shift, 3, seed=99)
    assert np.array_equal(q.dither_buf(7), jq.dither_buf(7))
    assert q.rng.state == jq.rng.state
    _eq(q.apply(torch.as_tensor(s)), jq.apply(jnp, jnp.asarray(s)))
    gold = jquant.Quantizer(dither, shift, 3, seed=99)
    gold.dither_buf(7)
    gold.dither_buf(50)
    d = gold.dither_buf(50)
    want = (np.clip(s.astype(np.int64) + d, -(1 << 31), (1 << 31) - 1)
            & ~np.int64((1 << shift) - 1)).astype(np.int32)
    _eq(q.apply(torch.as_tensor(s)), want)


@pytest.mark.parametrize("ns", ["error-feedback", "simple", "medium", "high"])
def test_noise_shaping_matches_reference(ns):
    rng = np.random.default_rng(3)
    s = rng.integers(-(1 << 30), 1 << 30, (2, 48, 2)).astype(np.int32)
    q = quant.Quantizer("tpdf", 16, 2, ns=ns, seed=77)
    jq = jquant.Quantizer("tpdf", 16, 2, ns=ns, seed=77)
    for _ in range(2):                   # the recurrence's PRNG carries on
        _eq(q.apply(torch.as_tensor(s)), jq._apply_ns(s))


# -- resampler: taps -------------------------------------------------------------

RATES = [(48000, 16000), (44100, 48000), (48000, 44100), (8000, 44100)]
METHODS = ["kaiser", "blackman-nuttall", "linear", "cubic", "nearest"]
# full mode at many phases builds every phase's taps tap by tap: the windowed
# sinc methods above quality 0 take seconds there, so those run the
# interpolated mode that auto picks for them
TAP_CASES = [(m, q, r, mode) for m in METHODS for q in (0, 4, 10)
             for r in RATES for mode in ("full", "interpolated")
             if not (mode == "full" and r != RATES[0] and q > 0
                     and m in ("kaiser", "blackman-nuttall"))]


@pytest.mark.parametrize("method,quality,rates,mode", TAP_CASES)
def test_taps_match_reference(method, quality, rates, mode):
    kw = dict(quality=quality, filter_mode=mode)
    t = AudioResampler(method, *rates, device="cpu", **kw)
    j = JResampler(method, *rates, **kw)
    assert (t.in_red, t.out_red, t.n_taps, t.effective_filter_mode,
            t.oversample, t.latency()) == (
        j.in_red, j.out_red, j.n_taps, j.effective_filter_mode,
        j.oversample, j.latency())
    assert np.array_equal(t.taps_f64, j.taps_f64)
    for dt in tres.DTYPES:
        a, b = t.taps_for(dt), j.taps_for(dt)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n in (0, t.n_taps, 999):
        assert t.out_frames_for(n, samp_phase=1) == j.out_frames_for(n, samp_phase=1)


def test_taps_cross_packages():
    """resampler_arrays reads either package's resampler alike;
    load_taps runs the port on the taps it is given."""
    j = JResampler("kaiser", 44100, 48000, quality=2)
    t = AudioResampler("kaiser", 44100, 48000, quality=2, device="cpu")
    arrays = interop.resampler_arrays(j)
    mine = interop.resampler_arrays(t)
    assert mine.keys() == arrays.keys()
    for k, v in mine.items():
        assert v.dtype == arrays[k].dtype and np.array_equal(v, arrays[k])
    for dt in tres.DTYPES:                   # someone else's taps
        arrays[f"taps.{dt}"] = arrays[f"taps.{dt}"][:, ::-1].copy()
    t.load_taps(arrays)
    j.taps_for = lambda dt: arrays[f"taps.{dt}"]
    x = np.random.default_rng(4).integers(-30000, 30000, (600, 2))
    _eq(t.resample_fn("s16", 600, 2)(torch.as_tensor(x.astype(np.int16))),
        j.resample_ref(x, "s16"))
    with pytest.raises(ValueError, match="n_taps"):
        AudioResampler("kaiser", 44100, 48000, device="cpu").load_taps(arrays)


# -- resampler: application ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jres(*rates):
    """The JAX package's default resampler (read only by the tests)."""
    return JResampler("kaiser", *rates)


def _frames(rates):
    """Input frames for a few blocks of outputs, fewer where upsampling."""
    return 700 if rates[0] >= rates[1] else 300

def _ints(dtype, rng, n, ch=2):
    lim = 1 << (15 if dtype == "s16" else 31)
    x = rng.integers(-lim, lim, (n, ch))
    x[5:40] = lim - 1                    # runs at full scale: the clamp
    x[60:90] = -lim
    return x.astype(np.int16 if dtype == "s16" else np.int32)


@pytest.mark.parametrize("dtype", ["s16", "s32"])
@pytest.mark.parametrize("rates", RATES + [(16000, 48000)])
def test_integer_resample_is_bit_exact(rates, dtype):
    """resample_fn and resample_fn_phased at three start phases equal
    resample_ref, and at the first and last phase the JAX package's jitted
    functions, tolerance 0; the block product and the tap loop both."""
    r = AudioResampler("kaiser", *rates, device="cpu")
    j = _jres(*rates)
    n = _frames(rates)
    x = _ints(dtype, np.random.default_rng(sum(rates)), n)
    gold = j.resample_ref(x.astype(np.int64), dtype)
    _eq(r.resample_fn(dtype, n, 2)(torch.as_tensor(x)), gold)
    _eq(r.resample_fn(dtype, n, 2)(torch.as_tensor(x)),
        jax.jit(j.resample_fn(dtype, n, 2))(jnp.asarray(x)))
    for ph0 in sorted({0, r.out_red // 2, r.out_red - 1}):
        n_out = r.out_frames_for(n, samp_phase=ph0)
        want = j.resample_ref(x.astype(np.int64), dtype, samp_phase=ph0)
        got = r.resample_fn_phased(dtype, n, n_out)(torch.as_tensor(x), ph0)
        _eq(got, want)
        if ph0 == r.out_red - 1:
            _eq(got, jax.jit(j.resample_fn_phased(dtype, n, n_out))(
                jnp.asarray(x), ph0))
        r._blocks[dtype] = dict(taps=r.taps_for(dtype))    # the tap loop
        _eq(r.resample_fn_phased(dtype, n, n_out)(torch.as_tensor(x), ph0), want)
        r._blocks.clear()


def test_batched_chunks_and_route_choice(monkeypatch):
    """Leading chunk axes; the tap loop where the block matrix would be
    too large; an output count of zero."""
    r = AudioResampler("kaiser", 48000, 16000, device="cpu")
    x = _ints("s16", np.random.default_rng(6), 3 * 500, 2).reshape(3, 500, 2)
    got = r.resample_fn("s16", 500, 2)(torch.as_tensor(x))
    assert got.shape == (3, r.out_frames_for(500), 2) and got.is_contiguous()
    for c in range(3):
        _eq(got[c], _jres(48000, 16000).resample_ref(
            x[c].astype(np.int64), "s16"))
    monkeypatch.setattr(tres, "_BLOCK_MAX", 0)
    r2 = AudioResampler("kaiser", 48000, 16000, device="cpu")
    assert "m" not in r2._block_table("s16")
    _eq(r2.resample_fn("s16", 500, 2)(torch.as_tensor(x)), got.numpy())
    empty = r.resample_fn("s16", 100, 2)(torch.as_tensor(x[0, :100]))
    assert empty.shape == (0, 2) and empty.dtype == torch.int16


def _ulps(a, b):
    """|a - b| in ULPs of float32 at b."""
    return np.abs(a.astype(np.float64) - b) / np.spacing(
        np.abs(b).astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("rates", RATES)
def test_f32_resample_meets_the_float_contract(rates):
    """Per output sample, against a float64 gold from the same float32
    inputs and float32 taps (resample_ref in float64): the port's error
    may exceed the JAX package's own error (its convolution and its
    gather-einsum, jitted) by at most 1 ULP of the output.  The port sums
    in float64 and rounds once, so its error stays within half an ULP."""
    r = AudioResampler("kaiser", *rates, device="cpu")
    j = _jres(*rates)
    n = _frames(rates)
    rng = np.random.default_rng(7)
    x = (rng.integers(-32768, 32767, (n, 2)) / 32768.0).astype(np.float32)
    n_out = r.out_frames_for(n)
    gold = j.resample_ref(x.astype(np.float64), "f32")
    got = r.resample_fn("f32", n, 2)(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32 and got.shape == gold.shape == (n_out, 2)
    refs = [np.asarray(jax.jit(j.resample_fn("f32", n, 2))(jnp.asarray(x))),
            np.asarray(jax.jit(j.resample_fn_phased("f32", n, n_out))(
                jnp.asarray(x), 0))]
    assert np.all(_ulps(got, gold) <= 0.5 + 1e-6)
    for ref in refs:
        assert np.all(_ulps(got, gold) <= _ulps(ref, gold) + 1.0)
    # read with pytest -s: the distance between the packages themselves
    print(f"f32 {rates}: port vs JAX package (conv, gather-einsum) at most "
          f"{max(_ulps(got, r.astype(np.float64)).max() for r in refs):.2f} "
          f"ULP; JAX package vs the float64 gold at most "
          f"{max(_ulps(r, gold).max() for r in refs):.2f} ULP")
    ph0 = r.out_red - 1
    n_out = r.out_frames_for(n, samp_phase=ph0)
    gold = j.resample_ref(x.astype(np.float64), "f32", samp_phase=ph0)
    got = r.resample_fn_phased("f32", n, n_out)(torch.as_tensor(x), ph0).numpy()
    assert np.all(_ulps(got, gold) <= 0.5 + 1e-6)


@pytest.mark.parametrize("rates", RATES)
def test_f64_resample_within_the_summation_bound(rates):
    """float64 in and out: |port - gold| <= 2 n_taps 2^-53 sum|t x| per
    output (the worst-case error of a float64 dot product of n_taps terms,
    for each of the two), the JAX package's gather-einsum likewise."""
    r = AudioResampler("kaiser", *rates, device="cpu")
    j = _jres(*rates)
    n = _frames(rates)
    x = np.random.default_rng(8).random((n, 2)) * 2 - 1
    gold = j.resample_ref(x, "f64")
    tol = 2 * r.n_taps * 2.0 ** -53 * _abs_products(j, x)
    got = r.resample_fn("f64", n, 2)(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float64 and np.all(np.abs(got - gold) <= tol)
    ref = np.asarray(jax.jit(j.resample_fn_phased("f64", n, len(gold)))(
        jnp.asarray(x), 0))
    assert np.all(np.abs(ref - gold) <= tol)


def _abs_products(j, x):
    """sum |tap * x| per output (the scale of a dot product's error)."""
    taps = np.abs(j.taps_for("f64"))
    out = np.empty((j.out_frames_for(len(x)), x.shape[1]))
    idx, ph = 0, 0
    for k in range(len(out)):
        out[k] = (np.abs(x[idx:idx + j.n_taps]) * taps[ph][:, None]).sum(0)
        ph += j.in_red
        idx += ph // j.out_red
        ph %= j.out_red
    return out


def test_resampler_device_is_explicit(monkeypatch):
    r = AudioResampler("kaiser", 48000, 16000, device="cpu")
    fn = r.resample_fn("s16", 300, 2)
    with pytest.raises(ValueError, match="move it first"):
        fn(torch.zeros((300, 2), dtype=torch.int16, device="meta"))
    with pytest.raises(ValueError, match="want"):
        fn(torch.zeros((301, 2), dtype=torch.int16))
    with pytest.raises(ValueError, match="unknown resampler dtype"):
        r.resample_fn("u8", 300, 2)(torch.zeros((300, 2)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AudioResampler("kaiser", 48000, 16000)
    with pytest.raises(RuntimeError, match="CUDA"):
        gstreamer_tpu_torch.AudioResampler("linear", 44100, 48000)
