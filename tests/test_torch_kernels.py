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

from gstreamer_tpu.ops import chroma420_kernel as jck
from gstreamer_tpu.video import scaler as jscaler

import gstreamer_tpu_torch
from gstreamer_tpu_torch import VideoConverter, VideoInfo
from gstreamer_tpu_torch.ops import chroma420_kernel as tck
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
