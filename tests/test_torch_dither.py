"""The torch port's VideoDither against the JAX package's, value for value.

Every method x target quantization (1, 2, 8, 64) x depth (8, 16 bit) on the
same channel planes, made from a seed with numpy: the reference's
``VideoDither.apply`` under numpy (its exact host form) against the port's
under numpy and under torch (CPU tensors).  Then the two converter plans
that dither by default.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.video import dither as jd
from gstreamer_tpu.video.format import format_info as jformat_info
from gstreamer_tpu_torch.video import dither as td
from gstreamer_tpu_torch.video.format import format_info

METHODS = ["none", "bayer", "verterr", "floyd-steinberg", "sierra-lite"]
H, W = 21, 19          # not multiples of the 16x16 Bayer map


def test_bayer_map_is_the_reference_table():
    assert np.array_equal(td.BAYER_MAP, jd.BAYER_MAP)


@pytest.mark.parametrize("fmt,bits", [("RGB16", 8), ("BGR15", 8), ("RGB", 8),
                                      ("I420_10LE", 16), ("AYUV64", 16),
                                      ("RGB10A2_LE", 16), ("ARGB", 8)])
@pytest.mark.parametrize("quant", [1, 2, 8, 64])
@pytest.mark.parametrize("method", METHODS)
def test_decision_matches_reference(method, quant, fmt, bits):
    ref = jd.make_converter_dither(method, quant, jformat_info(fmt), bits)
    own = td.make_converter_dither(method, quant, format_info(fmt), bits)
    assert (ref is None) == (own is None)
    if ref is not None:
        assert (own.method, own.flags_quantize, own.bits, own.shift,
                own.mask, own.maxv) == (ref.method, ref.flags_quantize,
                                        ref.bits, ref.shift, ref.mask,
                                        ref.maxv)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("quant", [1, 2, 8, 64])
@pytest.mark.parametrize("method", METHODS)
def test_apply_matches_reference(method, quant, bits):
    # quantizers as a format of 5/6/5 (or 10-bit) components would give
    # them, raised to the target quantization; no alpha plane
    native = [0, 8, 4, 8] if bits == 8 else [0, 64, 64, 64]
    quantizer = [max(q, quant) if q else 0 for q in native]
    flag = any(quant > q for q in native if q)
    ref = jd.VideoDither(method, flag, bits, quantizer)
    own = td.VideoDither(method, flag, bits, quantizer)
    rng = np.random.default_rng(100 * quant + bits)
    maxv = (1 << bits) - 1
    chans = (None,) + tuple(
        rng.integers(0, maxv + 1, (2, H, W)).astype(np.int32)
        for _ in range(3))
    # bright pixels, so the saturating adds are exercised
    chans[1][0, :4] = maxv
    want = ref.apply(np, chans, H, W)
    got_np = own.apply(np, chans, H, W)
    got = own.apply(torch, tuple(c if c is None else torch.as_tensor(c)
                                 for c in chans), H, W)
    assert want[0] is None and got[0] is None and got_np[0] is None
    for w_, g, gn in zip(want[1:], got[1:], got_np[1:]):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w_) and np.array_equal(gn, w_)


@pytest.mark.parametrize("method", ["bayer", "verterr"])
def test_apply_with_alpha_plane(method):
    ref = jd.VideoDither(method, False, 16, [16384, 64, 64, 64])
    own = td.VideoDither(method, False, 16, [16384, 64, 64, 64])
    rng = np.random.default_rng(3)
    chans = tuple(rng.integers(0, 65536, (1, H, W)).astype(np.int32)
                  for _ in range(4))
    want = ref.apply(np, chans, H, W)
    got = own.apply(torch, tuple(torch.as_tensor(c) for c in chans), H, W)
    for w_, g in zip(want, got):
        assert np.array_equal(g.numpy(), w_)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown dither"):
        td.VideoDither("blue-noise", False, 8, [0, 8, 4, 8]).apply(
            np, (None,) * 4, 1, 1)
