"""Torch port kernels: plain versions vs the JAX package, kernels vs plain.

The plain version beside each CUDA kernel is what runs for a CPU tensor;
here it is held bit for bit against the JAX package's functions on the same
numpy inputs.  The kernels themselves run only on a CUDA card: those cases
skip here (the fixture decides at run time) and are held against the plain
versions by ``python3 chip_smoke.py`` and by these tests on the card.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax.experimental.pallas import tpu as pltpu

from gstreamer_tpu.ops import chroma420_kernel as jck
from gstreamer_tpu.ops import hscale_kernel as jhk
from gstreamer_tpu.ops import scale2d_kernel as js2
from gstreamer_tpu.video import scaler as jscaler

import gstreamer_tpu_torch
from gstreamer_tpu_torch import VideoConverter, VideoInfo
from gstreamer_tpu_torch.ops import chroma420_kernel as tck
from gstreamer_tpu_torch.ops import hscale_kernel as thk
from gstreamer_tpu_torch.ops import scale2d_kernel as ts2
from gstreamer_tpu_torch.ops import yscale_kernel as tysk
from gstreamer_tpu_torch.video import scaler as tscaler

# (in_w, in_h, out_w, out_h, method, taps): tests/test_chroma_kernel.py's
# shapes, plus the headline 1080p -> 224 at linear/2 and cubic
SHAPES = [
    (480, 270, 112, 112, "linear", 2),
    (64, 48, 32, 24, "cubic", 0),
    (130, 62, 100, 40, "lanczos", 0),
    (256, 128, 64, 256, "linear", 0),
]
HEADLINE = [(1920, 1080, 224, 224, "linear", 2),
            (1920, 1080, 224, 224, "cubic", 0)]


def _res(pkg, method, taps, n_in, n_out):
    kw = {"max_taps_opt": taps} if taps else {}
    return pkg.make_resampler(method, n_in, n_out, 0, **kw)


def _frames(shape, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,) + shape,
                                                dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES + HEADLINE)
def test_yscale_plain_matches_reference(shape):
    w, h, ow, oh, method, taps = shape
    y = _frames((h, w), 1 if w > 1000 else 2, 21)
    jh, jv = (_res(jscaler, method, taps, w, ow),
              _res(jscaler, method, taps, h, oh))
    th, tv = (_res(tscaler, method, taps, w, ow),
              _res(tscaler, method, taps, h, oh))
    ref = jax.jit(lambda x: jscaler.scale_axis_exact(
        jnp, jscaler.scale_axis_exact(jnp, x, -1, jh), -2, jv))(
            jnp.asarray(y))
    before = tysk.yscale_hv.launches
    out = tysk.yscale_hv(torch.as_tensor(y), th, tv)     # CPU: plain version
    assert out.dtype == torch.int16 and tuple(out.shape) == (y.shape[0], oh, ow)
    assert np.array_equal(out.numpy().astype(np.int64),
                          np.asarray(ref, np.int64))
    assert tysk.yscale_hv.launches == before


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h_cos,v_cos", [(False, False), (True, False),
                                         (True, True)])
def test_chroma420_plain_matches_reference_kernel(shape, h_cos, v_cos):
    w, h, ow, oh, method, taps = shape
    c = _frames((h // 2, w // 2), 2, 22)
    jh, jv = (_res(jscaler, method, taps, w, ow),
              _res(jscaler, method, taps, h, oh))
    th, tv = (_res(tscaler, method, taps, w, ow),
              _res(tscaler, method, taps, h, oh))
    ref = jck.chroma420_scale(jnp.asarray(c), jh, jv, h_cos, v_cos, w, h,
                              interpret=True)
    before = tck.chroma420_scale.launches
    out = tck.chroma420_scale(torch.as_tensor(c), th, tv, h_cos, v_cos, w, h)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, oh, ow)
    assert np.array_equal(out.numpy().astype(np.int64),
                          np.asarray(ref, np.int64))
    assert tck.chroma420_scale.launches == before


# the two standalone scale ops: lane-aligned widths (the reference's TPU
# gate) and widths the port also takes, downscales only
STANDALONE = [
    (128, 48, 32, 24, "linear", 2),
    (256, 130, 64, 40, "cubic", 0),
    (70, 46, 33, 20, "lanczos", 0),
    (480, 270, 112, 112, "linear", 2),
]


@pytest.mark.parametrize("shape", STANDALONE)
def test_standalone_scale_plain_matches_reference(shape):
    """hscale_u8 and scale_hv_u8 on CPU tensors (their plain versions)
    against (a) what the reference kernels' docstrings define them to
    equal, the reference's scale_axis_exact(-1) then (-2), at every shape,
    and (b) the reference Pallas kernels themselves under
    force_tpu_interpret_mode() (their wrappers have no interpret switch of
    their own) where the reference's own gate admits the shape."""
    w, h, ow, oh, method, taps = shape
    y = _frames((h, w), 2, 25)
    jh, jv = (_res(jscaler, method, taps, w, ow),
              _res(jscaler, method, taps, h, oh))
    th, tv = (_res(tscaler, method, taps, w, ow),
              _res(tscaler, method, taps, h, oh))
    assert thk.applicable(th, y.shape) and ts2.applicable(th, tv, y.shape)
    ref_h = np.asarray(jscaler.scale_axis_exact(jnp, jnp.asarray(y), -1, jh))
    ref_hv = np.asarray(jscaler.scale_axis_exact(jnp, jnp.asarray(ref_h), -2,
                                                 jv))
    counts = (thk.hscale_u8.launches, ts2.scale_hv_u8.launches)
    out_h = thk.hscale_u8(torch.as_tensor(y), th)
    out_hv = ts2.scale_hv_u8(torch.as_tensor(y), th, tv)
    assert (thk.hscale_u8.launches, ts2.scale_hv_u8.launches) == counts
    assert out_h.dtype == out_hv.dtype == torch.int32
    assert tuple(out_h.shape) == (2, h, ow)
    assert tuple(out_hv.shape) == (2, oh, ow)
    assert np.array_equal(out_h.numpy(), ref_h)
    assert np.array_equal(out_hv.numpy(), ref_hv)
    if jhk.applicable(jh, y.shape) and js2.applicable(jh, jv, y.shape):
        with pltpu.force_tpu_interpret_mode():
            ker_h = np.asarray(jhk.hscale_u8(jnp.asarray(y), jh))
            ker_hv = np.asarray(js2.scale_hv_u8(jnp.asarray(y), jh, jv))
        assert np.array_equal(out_h.numpy(), ker_h)
        assert np.array_equal(out_hv.numpy(), ker_hv)
    else:
        assert w % 128           # only the TPU lane rule kept it out


def test_standalone_gates_keep_the_references_rules():
    up = _res(tscaler, "linear", 2, 64, 128)
    down = _res(tscaler, "linear", 2, 64, 16)
    jup = _res(jscaler, "linear", 2, 128, 256)
    assert not thk.applicable(up, (1, 48, 64))
    assert not jhk.applicable(jup, (1, 48, 128))
    assert thk.applicable(down, (1, 48, 64))
    assert not ts2.applicable(down, None, (1, 48, 64))
    assert not ts2.applicable(down, _res(tscaler, "linear", 2, 48, 96),
                              (1, 48, 64))


@pytest.mark.parametrize("shape", STANDALONE + HEADLINE)
def test_standalone_scale_kernels_match_plain_on_card(cuda, shape):
    w, h, ow, oh, method, taps = shape
    th, tv = (_res(tscaler, method, taps, w, ow),
              _res(tscaler, method, taps, h, oh))
    y = torch.as_tensor(_frames((h, w), 3, 26)).to(cuda)
    n_h, n_hv = thk.hscale_u8.launches, ts2.scale_hv_u8.launches
    kh = thk.hscale_u8(y, th)
    khv = ts2.scale_hv_u8(y, th, tv)
    torch.cuda.synchronize()
    assert (thk.hscale_u8.launches, ts2.scale_hv_u8.launches) == (n_h + 1,
                                                                  n_hv + 1)
    assert torch.equal(kh, thk.hscale_u8_plain(y, th))
    assert torch.equal(khv, ts2.scale_hv_u8_plain(y, th, tv))


def test_wrappers_raise_on_other_devices():
    th = _res(tscaler, "linear", 2, 64, 16)
    tv = _res(tscaler, "linear", 2, 48, 12)
    with pytest.raises(ValueError):
        tysk.yscale_hv(torch.empty((1, 48, 64), dtype=torch.uint8,
                                   device="meta"), th, tv)
    with pytest.raises(ValueError):
        tck.chroma420_scale(torch.empty((1, 24, 32), dtype=torch.uint8,
                                        device="meta"), th, tv, True, False,
                            64, 48)
    meta = torch.empty((1, 48, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        thk.hscale_u8(meta, th)
    with pytest.raises(ValueError):
        ts2.scale_hv_u8(meta, th, tv)


@pytest.mark.parametrize("shape", SHAPES + HEADLINE)
@pytest.mark.parametrize("h_cos,v_cos", [(False, False), (True, False),
                                         (True, True)])
def test_kernels_match_plain_on_card(cuda, shape, h_cos, v_cos):
    w, h, ow, oh, method, taps = shape
    th, tv = (_res(tscaler, method, taps, w, ow),
              _res(tscaler, method, taps, h, oh))
    y = torch.as_tensor(_frames((h, w), 3, 23)).to(cuda)
    c = torch.as_tensor(_frames((h // 2, w // 2), 3, 24)).to(cuda)
    n_y, n_c = tysk.yscale_hv.launches, tck.chroma420_scale.launches
    ky = tysk.yscale_hv(y, th, tv)
    kc = tck.chroma420_scale(c, th, tv, h_cos, v_cos, w, h)
    torch.cuda.synchronize()
    assert tysk.yscale_hv.launches == n_y + 1
    assert tck.chroma420_scale.launches == n_c + 1
    assert torch.equal(ky, tysk.yscale_hv_plain(y, th, tv))
    assert torch.equal(kc, tck.chroma420_scale_plain(c, th, tv, h_cos,
                                                     v_cos))


def test_converter_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ii = VideoInfo(format="I420", width=64, height=48)
    oi = VideoInfo(format="RGB", width=32, height=24)
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoConverter(ii, oi)
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoConverter(ii, oi, device="cuda")
    assert VideoConverter(ii, oi, device="cpu").device.type == "cpu"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    pkg = Path(gstreamer_tpu_torch.__file__).parent
    files = sorted(pkg.rglob("*.py")) + [pkg.parent / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "gstreamer_tpu"), (
                f"{path} imports {mod}")
