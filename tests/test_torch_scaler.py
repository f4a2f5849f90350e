"""Torch port vs the JAX package: host planners and device functions.

The planners (resampler taps, color matrices) are copies and must give the
reference's arrays exactly; the device functions (scaling, chroma up/down,
matrix application) must give the reference's integers exactly on the same
numpy inputs.  Tolerance 0: every path here is integer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstreamer_tpu.video import chroma as jchroma
from gstreamer_tpu.video import color as jcolor
from gstreamer_tpu.video import scaler as jscaler
from gstreamer_tpu.video.converter import _unpack_finfo
from gstreamer_tpu.video.info import Colorimetry as JColorimetry
from gstreamer_tpu.video.format import format_info as jformat_info

from gstreamer_tpu_torch.video import chroma as tchroma
from gstreamer_tpu_torch.video import color as tcolor
from gstreamer_tpu_torch.video import scaler as tscaler
from gstreamer_tpu_torch.video.converter import _UnpackFinfo
from gstreamer_tpu_torch.video.info import Colorimetry as TColorimetry
from gstreamer_tpu_torch.video.format import format_info as tformat_info

METHODS = ["nearest", "linear", "cubic", "lanczos"]
SIZES = [(1920, 224), (1080, 224), (960, 224), (540, 224), (64, 32),
         (48, 24), (130, 100), (62, 40), (128, 256), (33, 7)]


def _i64(x):
    return np.asarray(x, np.int64)


def _same(a, b):
    return np.array_equal(_i64(a), _i64(b))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("max_taps", [0, 2])
def test_resampler_planner_matches(method, size, max_taps):
    kw = {"max_taps_opt": max_taps} if max_taps else {}
    ref = jscaler.make_resampler(method, *size, 0, **kw)
    port = tscaler.make_resampler(method, *size, 0, **kw)
    assert port.max_taps == ref.max_taps
    assert np.array_equal(port.offset, ref.offset)
    assert np.array_equal(port.taps_s16(), ref.taps_s16())
    assert np.array_equal(tscaler.tap_matrix(port), jscaler.tap_matrix(ref))


def _pair(method, n_in, n_out):
    return (jscaler.make_resampler(method, n_in, n_out),
            tscaler.make_resampler(method, n_in, n_out))


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_scale_axis_exact_matches(method, axis):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (2, 40, 64)).astype(np.int16)
    n_in = img.shape[axis]
    jr, tr = _pair(method, n_in, n_in // 2 - 3)
    ref = jax.jit(lambda x: jscaler.scale_axis_exact(jnp, x, axis, jr))(
        jnp.asarray(img))
    assert _same(tscaler.scale_axis_exact(torch, _t(img), axis, tr), ref)
    assert _same(tscaler.scale_axis_exact(np, img, axis, tr), ref)


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_split_scales_match(method):
    rng = np.random.default_rng(12)
    even = rng.integers(0, 256, (2, 24, 30)).astype(np.int16)
    odd = rng.integers(0, 256, (2, 24, 30)).astype(np.int16)
    jr, tr = _pair(method, 60, 17)
    ref_c = jax.jit(lambda e, o: jscaler.scale_cols_split_exact(
        jnp, e, o, jr))(jnp.asarray(even), jnp.asarray(odd))
    assert _same(tscaler.scale_cols_split_exact(torch, _t(even), _t(odd), tr),
                 ref_c)
    jr, tr = _pair(method, 48, 13)
    ref_r = jax.jit(lambda e, o: jscaler.scale_rows_split_exact(
        jnp, e, o, jr))(jnp.asarray(even), jnp.asarray(odd))
    assert _same(tscaler.scale_rows_split_exact(torch, _t(even), _t(odd), tr),
                 ref_r)


@pytest.mark.parametrize("cosited", [False, True])
@pytest.mark.parametrize("axis", [-1, -2])
def test_up2_phases_and_down2_match(cosited, axis):
    rng = np.random.default_rng(13)
    c = rng.integers(0, 256, (2, 9, 14)).astype(np.int16)
    ref = jax.jit(lambda x: jchroma.up2_phases(jnp, x, axis, cosited))(
        jnp.asarray(c))
    port = tchroma.up2_phases(torch, _t(c), axis, cosited)
    assert all(_same(p, r) for p, r in zip(port, ref))
    ref = jax.jit(lambda x: jchroma.down2(jnp, x, axis, cosited))(
        jnp.asarray(c))
    assert _same(tchroma.down2(torch, _t(c), axis, cosited), ref)
    assert _same(tchroma.down2(np, c, axis, cosited), ref)


_CONVERSIONS = [
    # (in format, in colorimetry, out format, out colorimetry)
    ("I420", "bt709", "RGB", "srgb"),
    ("I420", "bt601", "RGB", "srgb"),
    ("I420", "bt601", "I420", "bt709"),
    ("RGB", "srgb", "I420", "bt709"),
    ("I420", "bt2020", "RGB", "srgb"),
]


def _prepared(pkg_color, unpack, fmt_info, colorimetry, conv, bits=8):
    ifmt, ofmt = fmt_info(conv[0]), fmt_info(conv[2])
    m = pkg_color.compute_matrix_to_rgb(
        pkg_color.identity(), colorimetry.from_string(conv[1]), unpack(ifmt))
    m = pkg_color.compute_matrix_to_yuv(
        m, colorimetry.from_string(conv[3]), unpack(ofmt))
    return pkg_color.prepare_matrix(m, unpack_rgb=ifmt.is_rgb,
                                    pack_rgb=ofmt.is_rgb, bits=bits)


@pytest.mark.parametrize("conv", _CONVERSIONS)
def test_matrix_planner_matches(conv):
    for bits in (8, 16):
        ref = _prepared(jcolor, _unpack_finfo, jformat_info, JColorimetry,
                        conv, bits)
        port = _prepared(tcolor, _UnpackFinfo, tformat_info, TColorimetry,
                         conv, bits)
        assert port.mode == ref.mode
        assert np.array_equal(port.im, ref.im)


@pytest.mark.parametrize("mode", ["ayuv_argb", "matrix8", "table",
                                  "matrix16", "identity"])
def test_apply_prepared_planes_matches(mode):
    im = _prepared(jcolor, _unpack_finfo, jformat_info, JColorimetry,
                   _CONVERSIONS[0] if mode == "ayuv_argb"
                   else _CONVERSIONS[2]).im
    hi = 65536 if mode == "matrix16" else 256
    rng = np.random.default_rng(14)
    chans = [rng.integers(0, hi, (2, 6, 10)).astype(np.int32)
             for _ in range(4)]
    ref = jax.jit(lambda *c: jcolor.apply_prepared_planes(
        jnp, c, jcolor.PreparedMatrix(mode, im)))(
            *(jnp.asarray(c) for c in chans))
    port = tcolor.apply_prepared_planes(
        torch, tuple(_t(c) for c in chans), tcolor.PreparedMatrix(mode, im))
    gold = tcolor.apply_prepared_planes(
        np, tuple(chans), tcolor.PreparedMatrix(mode, im))
    for p, g, r in zip(port, gold, ref):
        assert _same(p, r) and _same(g, r)
