"""Torch port fused-ingest route against the JAX package, bit for bit.

The JAX kernel ``fused_i420_up_hscale`` runs in its own interpret mode (as
``tests/test_video_convert.py::test_pallas_fused_path_matches`` runs it on
the CPU); the port's wrapper gets CPU tensors and so runs the kernel's plain
version.  Then the slice as a whole: with ``GTPU_PALLAS=interpret`` both
converters take their fused-ingest route.  Tolerance 0.  Card-only cases
skip here (the fixture decides at run time).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstreamer_tpu.ops import convert_kernel as jck
from gstreamer_tpu.video import scaler as jscaler
from gstreamer_tpu.video.converter import VideoConverter as JConverter
from gstreamer_tpu.video.info import VideoInfo as JInfo

from gstreamer_tpu_torch import VideoConverter, VideoInfo
from gstreamer_tpu_torch.interop import plan_arrays
from gstreamer_tpu_torch.ops import convert_kernel as tck
from gstreamer_tpu_torch.video import scaler as tscaler

# (in_w, in_h, out_w, method, taps): heights off the TPU kernel's 128-row
# tile and half-widths off its 128 lanes included
SHAPES = [
    (128, 120, 64, "linear", 2),
    (70, 46, 33, "linear", 2),
    (128, 120, 64, "cubic", 0),
    (70, 46, 33, "lanczos", 0),
    (260, 132, 100, "linear", 0),
]


def _res(pkg, method, taps, n_in, n_out):
    kw = {"max_taps_opt": taps} if taps else {}
    return pkg.make_resampler(method, n_in, n_out, 0, **kw)


def _i420(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h_cosited", [False, True])
def test_plain_matches_reference_kernel(shape, h_cosited):
    w, h, ow, method, taps = shape
    y, u, v = _i420(2, w, h, 51)
    jh = _res(jscaler, method, taps, w, ow)
    th = _res(tscaler, method, taps, w, ow)
    ref = jck.fused_i420_up_hscale(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
        jscaler.tap_matrix(jh), None, h_cosited=h_cosited, interpret=True)
    before = tck.fused_i420_up_hscale.launches
    out = tck.fused_i420_up_hscale(torch.as_tensor(y), torch.as_tensor(u),
                                   torch.as_tensor(v), th, h_cosited)
    assert tck.fused_i420_up_hscale.launches == before   # CPU: plain version
    assert len(out) == len(ref) == 5
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.dtype == torch.int16
        assert tuple(o.shape) == (2, h if i == 0 else h // 2, ow)
        assert np.array_equal(o.numpy().astype(np.int64),
                              np.asarray(r, np.int64)), i


@pytest.mark.parametrize("shape", SHAPES)
def test_tap_tables_cover_the_dense_matrix(shape):
    """The kernel sums over the resampler's (offset, taps) table, the
    reference over the dense tap matrix: the two agree because no row of the
    table is clipped at an edge (every offset lies in [0, in - taps])."""
    w, _, ow, method, taps = shape
    res = _res(tscaler, method, taps, w, ow)
    off = np.asarray(res.offset)
    assert off.min() >= 0 and off.max() + res.max_taps <= w
    m = tscaler.tap_matrix(res)
    assert np.array_equal(m, jscaler.tap_matrix(_res(jscaler, method, taps,
                                                     w, ow)))
    ts = res.taps_s16()
    for j in range(ow):
        assert np.array_equal(m[j, off[j]:off[j] + res.max_taps], ts[j])
        assert m[j].sum() == ts[j].sum()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    th = _res(tscaler, "linear", 2, 64, 16)
    y, u, v = (torch.as_tensor(p) for p in _i420(1, 64, 48, 52))
    with pytest.raises(ValueError, match="odd size"):
        tck.fused_i420_up_hscale(y[:, :47], u, v, th, False)
    with pytest.raises(ValueError):
        tck.fused_i420_up_hscale(y, u[:, :20], v, th, False)
    with pytest.raises(TypeError):
        tck.fused_i420_up_hscale(y.to(torch.int16), u, v, th, False)
    with pytest.raises(ValueError, match="unsupported device"):
        tck.fused_i420_up_hscale(*(torch.empty(p.shape, dtype=torch.uint8,
                                               device="meta")
                                   for p in (y, u, v)), th, False)


# -- the slice as a whole: both converters on their fused-ingest route -----

CONVERT = {
    # tests/test_video_convert.py::test_pallas_fused_path_matches
    "128x120_to_64x60": (128, 120, 64, 60, "RGB", "linear", 2),
    "width_only": (128, 120, 64, 120, "RGB", "linear", 2),   # v_res is None
    "cubic": (70, 46, 30, 24, "RGB", "cubic", 0),
    "to_i420": (128, 120, 64, 60, "I420", "linear", 2),      # chroma down2
}


def _converters(cfg, site=None):
    w, h, ow, oh, ofmt, method, taps = cfg
    opts = {"resampler-method": method, "resampler-taps": taps}
    kw = {"chroma_site": site} if site else {}
    conv = VideoConverter(VideoInfo(format="I420", width=w, height=h, **kw),
                          VideoInfo(format=ofmt, width=ow, height=oh),
                          opts, device="cpu")
    jconv = JConverter(JInfo(format="I420", width=w, height=h, **kw),
                       JInfo(format=ofmt, width=ow, height=oh), opts)
    return conv, jconv


@pytest.mark.parametrize("name", list(CONVERT))
def test_fused_route_matches_reference(monkeypatch, name):
    cfg = CONVERT[name]
    conv, jconv = _converters(cfg)
    planes = _i420(2, cfg[0], cfg[1], 53)
    monkeypatch.delenv("GTPU_PALLAS", raising=False)
    assert not conv._pallas_enabled()
    off = conv.convert(planes)                     # the existing route
    monkeypatch.setenv("GTPU_PALLAS", "interpret")
    assert conv.plan["pallas_ok"] and jconv._plan["pallas_ok"]
    assert conv._pallas_enabled() and jconv._pallas_enabled()
    assert (conv.plan["v_res"] is None) == (name == "width_only")
    calls = []
    real = conv._pipeline_pallas
    monkeypatch.setattr(conv, "_pipeline_pallas",
                        lambda xp, p: calls.append(1) or real(xp, p))
    on = conv.convert(planes)
    assert calls == [1]
    ref = jconv.convert(tuple(jnp.asarray(p) for p in planes))
    gold = jconv.convert_ref(planes)
    assert len(on) == len(ref) == len(gold) == len(off)
    for o, f, r, g in zip(on, off, ref, gold):
        assert o.dtype == torch.uint8
        assert np.array_equal(o.numpy(), np.asarray(r))
        assert np.array_equal(o.numpy(), np.asarray(g))
        assert torch.equal(o, f)       # opt-in or not: the same bytes


@pytest.mark.parametrize("mode,enabled", [(None, False), ("0", False),
                                          ("1", True), ("interpret", True)])
def test_opt_in_values(monkeypatch, mode, enabled):
    conv, _ = _converters(CONVERT["128x120_to_64x60"])
    if mode is None:
        monkeypatch.delenv("GTPU_PALLAS", raising=False)
    else:
        monkeypatch.setenv("GTPU_PALLAS", mode)
    assert conv._pallas_enabled() is enabled


@pytest.mark.parametrize("cfg,site", [
    (CONVERT["128x120_to_64x60"], None),
    (CONVERT["128x120_to_64x60"], "cosited"),          # up_v_cosited: not ok
    ((128, 120, 64, 60, "RGB", "linear", 2), "mpeg2"),
    ((64, 48, 64, 48, "RGB", "linear", 2), None),      # no scale
    ((130, 62, 100, 40, "RGB", "lanczos", 0), None),   # "vh" order
    ((128, 120, 64, 60, "RGB", "linear", 2, {"dest-y": 4, "dest-height": 40}),
     None),                                            # rect active
])
def test_pallas_ok_agrees_with_reference(cfg, site):
    extra = cfg[7] if len(cfg) > 7 else {}
    w, h, ow, oh, ofmt, method, taps = cfg[:7]
    opts = {"resampler-method": method, "resampler-taps": taps, **extra}
    kw = {"chroma_site": site} if site else {}
    conv = VideoConverter(VideoInfo(format="I420", width=w, height=h, **kw),
                          VideoInfo(format=ofmt, width=ow, height=oh), opts,
                          device="cpu")
    jconv = JConverter(JInfo(format="I420", width=w, height=h, **kw),
                       JInfo(format=ofmt, width=ow, height=oh), opts)
    own, ref = plan_arrays(conv.plan), plan_arrays(jconv._plan)
    assert own["pallas_ok"].dtype == np.bool_
    assert bool(own["pallas_ok"]) == bool(ref["pallas_ok"])
    assert bool(conv.plan["pallas_ok"]) == bool(jconv._plan["pallas_ok"])


@pytest.mark.parametrize("shape", SHAPES + [(1920, 1080, 224, "linear", 2)])
@pytest.mark.parametrize("h_cosited", [False, True])
def test_kernel_matches_plain_on_card(cuda, shape, h_cosited):
    w, h, ow, method, taps = shape
    th = _res(tscaler, method, taps, w, ow)
    y, u, v = (torch.as_tensor(p).to(cuda) for p in _i420(3, w, h, 54))
    n = tck.fused_i420_up_hscale.launches
    out = tck.fused_i420_up_hscale(y, u, v, th, h_cosited)
    torch.cuda.synchronize()
    assert tck.fused_i420_up_hscale.launches == n + 1
    for o, p in zip(out, tck.fused_i420_up_hscale_plain(y, u, v, th,
                                                        h_cosited)):
        assert torch.equal(o, p)


def test_fused_route_on_card_matches_cpu(cuda, monkeypatch):
    cfg = CONVERT["128x120_to_64x60"]
    planes = _i420(2, cfg[0], cfg[1], 55)
    monkeypatch.setenv("GTPU_PALLAS", "1")
    conv, _ = _converters(cfg)
    card = VideoConverter(conv.in_info, conv.out_info, conv.config)
    n = tck.fused_i420_up_hscale.launches
    out = card.convert(planes)
    assert tck.fused_i420_up_hscale.launches == n + 1
    for o, r in zip(out, conv.convert(planes)):
        assert torch.equal(o.cpu(), r)
