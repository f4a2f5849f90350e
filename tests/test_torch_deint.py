"""Torch port deinterlace: the deint kernel's plain version and the element
against the JAX package, bit for bit.

The plain version beside the CUDA kernel (what a CPU tensor runs) is held
against the JAX Pallas kernel in interpret mode and against the JAX
element's XLA route; the port's Deinterlace element, every method,
against the JAX element over two ticks.  All inputs are seeded numpy;
tolerance 0.  The kernel itself runs only on a CUDA card: those cases skip
here (the fixture decides at run time).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.elements.deinterlace import Deinterlace as JDeinterlace
from gstreamer_tpu.ops import deint_kernel as jdk

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.elements.deinterlace import Deinterlace
from gstreamer_tpu_torch.ops import deint_kernel as tdk

METHODS = ("linear", "scalerbob")
# the element's other methods (plain torch, no kernel)
TEMPORAL = ("tomsmocomp", "greedyh", "greedyl", "vfir", "linearblend",
            "weave", "weave-tff", "weave-bff", "yadif")


def _plane(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# tests/test_deinterlace.py TestDeintKernel's shapes
@pytest.mark.parametrize("shape", [(3, 64, 256), (2, 30, 96)])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("parity0", [0, 1])
def test_plain_matches_reference_kernel(shape, method, parity0):
    plane = _plane(shape, 7)
    ref = jdk.deint_both_parities(plane, method, parity0, interpret=True)
    before = tdk.deint_both_parities.launches
    out = tdk.deint_both_parities(torch.as_tensor(plane), method, parity0)
    assert out.dtype == torch.uint8
    assert tuple(out.shape) == (shape[0], 2) + shape[1:]
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert tdk.deint_both_parities.launches == before   # CPU: no launch


@pytest.mark.parametrize("shape", [(3, 46, 301), (2, 2, 5), (1, 30, 17)])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("parity0", [0, 1])
def test_plain_matches_reference_xla_route(shape, method, parity0):
    """Odd widths, and frames of 2 rows, which the TPU kernel does not
    take: the JAX element's own XLA formulation is the reference there
    (the element splits frames into fields, so it needs an even
    height)."""
    plane = _plane(shape, 8)
    d = JDeinterlace(method=method)
    n_fields = 2 * shape[0]
    ref = d._deint_fields(jnp, jnp.asarray(plane), list(range(n_fields)),
                          parity0, luma=True)
    out = tdk.deint_both_parities_plain(torch.as_tensor(plane), method,
                                        parity0)
    assert np.array_equal(out.reshape((n_fields,) + shape[1:]).numpy(),
                          np.asarray(ref))


def _gold(plane, method, parity0):
    """tests/test_deinterlace.py TestDeintKernel._gold: rows r-1 and r+1
    clamped, the kept parity copied."""
    h = plane.shape[-2]
    src16 = plane.astype(np.int16)
    t = src16[:, np.clip(np.arange(h) - 1, 0, h - 1)]
    b = src16[:, np.clip(np.arange(h) + 1, 0, h - 1)]
    interp = (t if method == "scalerbob"
              else ((t + b + 1) >> 1)).astype(np.uint8)
    m = (np.arange(h) % 2 == 0)[:, None]
    p0, p1 = np.where(m, plane, interp), np.where(~m, plane, interp)
    first, second = (p0, p1) if parity0 == 0 else (p1, p0)
    return np.stack([first, second], axis=1)


@pytest.mark.parametrize("shape", [(3, 45, 301), (2, 1, 5), (1, 3, 16)])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("parity0", [0, 1])
def test_plain_matches_gold_at_odd_heights(shape, method, parity0):
    """Odd heights, which neither JAX route takes; the kernel takes any
    H >= 1, so its plain version is held to a numpy gold there."""
    plane = _plane(shape, 11)
    out = tdk.deint_both_parities(torch.as_tensor(plane), method, parity0)
    assert np.array_equal(out.numpy(), _gold(plane, method, parity0))


def test_wrapper_checks_its_arguments():
    ok = torch.zeros((2, 4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="method"):
        tdk.deint_both_parities(ok, "yadif", 0)
    with pytest.raises(ValueError, match="parity0"):
        tdk.deint_both_parities(ok, "linear", 2)
    with pytest.raises(ValueError, match="uint8"):
        tdk.deint_both_parities(ok.to(torch.int16), "linear", 0)
    with pytest.raises(ValueError, match="device"):
        tdk.deint_both_parities(torch.empty((2, 4, 8), dtype=torch.uint8,
                                            device="meta"), "linear", 0)


W, H, B = 64, 48, 4
CAPS = f"video/x-raw,format=I420,width={W},height={H},framerate=30/1"


def _i420(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, H, W), dtype=np.uint8),
            rng.integers(0, 256, (n, H // 2, W // 2), dtype=np.uint8),
            rng.integers(0, 256, (n, H // 2, W // 2), dtype=np.uint8))


def _element(cls, caps_cls, **props):
    d = cls(**props)
    caps = caps_cls.from_string(CAPS)
    d.set_info(caps, caps)
    d.start()
    return d


@pytest.mark.parametrize("method", METHODS + TEMPORAL)
@pytest.mark.parametrize("fields", ["all", "top", "bottom"])
@pytest.mark.parametrize("layout", ["tff", "bff"])
def test_element_matches_reference_over_two_ticks(method, fields, layout):
    props = {"method": method, "fields": fields, "field-layout": layout}
    jd = _element(JDeinterlace, JCaps, **props)
    td = _element(Deinterlace, Caps, **props)
    for tick in range(2):
        planes = _i420(B, 30 + tick)
        meta = dict(pts=tick * B * 33333333, duration=33333333, batch=B)
        ref = jd.host_process(JBuffer(data=planes, **meta))
        out = td.host_process(Buffer(
            data=tuple(torch.as_tensor(p) for p in planes), **meta))
        assert (out.batch, out.pts, out.duration) == \
            (ref.batch, ref.pts, ref.duration)
        assert len(out.data) == len(ref.data) == 3
        for o, r in zip(out.data, ref.data):
            assert o.dtype == torch.uint8
            assert np.array_equal(o.numpy().astype(np.int64),
                                  np.asarray(r, np.int64))


@pytest.mark.parametrize("shape", [(64, 1080, 1920), (64, 540, 960),
                                   (3, 45, 301), (2, 30, 96), (1, 1, 16)])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("parity0", [0, 1])
def test_kernel_matches_plain_on_card(cuda, shape, method, parity0):
    plane = torch.as_tensor(_plane(shape, 9)).to(cuda)
    before = tdk.deint_both_parities.launches
    k = tdk.deint_both_parities(plane, method, parity0)
    torch.cuda.synchronize()
    assert tdk.deint_both_parities.launches == before + 1
    assert torch.equal(k, tdk.deint_both_parities_plain(plane, method,
                                                        parity0))


def test_kernel_takes_an_unaligned_plane_on_card(cuda):
    """A plane that starts off a 16-byte boundary takes the byte path."""
    flat = torch.as_tensor(_plane((2 * 30 * 96 + 1,), 10)).to(cuda)
    plane = flat[1:].view(2, 30, 96)
    k = tdk.deint_both_parities(plane, "linear", 0)
    assert torch.equal(k, tdk.deint_both_parities_plain(plane, "linear", 0))
