"""The OpenCV family's two CUDA kernels against their plain versions, on
the card (no JAX here: the card's machine has none).

    python -m pytest --noconftest -q tests/test_torch_opencv_card.py

segmentation's mixture (``csrc/gmm.cu``) at odd heights and widths that
are no multiple of 32, the carry continued over ticks, both methods, a
scene whose spawned modes tie, one that fills all five modes and one whose
sorted weights straddle backgroundRatio; disparity's cost volume and pass
in one kernel (``csrc/disparity.cu``) from gray planes at awkward sizes,
640x480 and 1280x720, both methods: cost and aggregated volumes and
disparities.  Bit for bit.  Every test skips without a card.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu_torch.ops import gmm_kernel as gk
from gstreamer_tpu_torch.ops import sgbm_kernel as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32).cpu(), b.view(torch.int32).cpu())
    return torch.equal(a.cpu(), b.cpu())


def _frames(kind, n, h, w, rng):
    base = rng.integers(30, 220, (3, 1, h, w))
    if kind == "flat":
        x = np.full((3, n, h, w), 100)
        x[:, ::3, :, : w // 2] = 180
    elif kind == "five":
        cols = rng.integers(0, 256, (7, 3))
        x = cols[rng.integers(0, 7, (n, h, w))].transpose(3, 0, 1, 2)
    else:
        x = base + rng.normal(0, 8, (3, n, h, w)) \
            + (rng.random((3, n, h, w)) < 0.1) * rng.integers(0, 128, (3, n, h, w))
    return [torch.from_numpy(np.clip(p, 0, 255).astype(np.uint8)) for p in x]


@pytest.mark.parametrize("n,h,w", [(3, 37, 45), (5, 17, 33), (4, 1, 1),
                                   (2, 64, 96)])
@pytest.mark.parametrize("method", ["mog2", "mog"])
@pytest.mark.parametrize("kind", ["noisy", "flat", "five"])
def test_gmm_kernel_matches_plain(cuda, n, h, w, method, kind):
    rng = np.random.default_rng(n * h + w)
    on = method == "mog2"
    alpha, act = gk.rates(0.05 if kind == "noisy" else 0.2, on)
    kc = {k: torch.from_numpy(v).to(cuda)
          for k, v in gk.init_carry(h, w).items()}
    pc = {k: v.clone() for k, v in kc.items()}
    for _ in range(3):                       # the carry across ticks
        planes = _frames(kind, n, h, w, rng)
        kc, km = gk.gmm(kc, *[p.to(cuda) for p in planes], alpha, act, on)
        pc, pm = gk.gmm_plain(pc, *[p.to(cuda) for p in planes], alpha, act,
                              on)
        assert _same(km, pm)
        for key in kc:
            assert _same(kc[key], pc[key]), key


def test_gmm_kernel_at_the_background_ratio(cuda):
    """Sorted weights whose running sum reaches backgroundRatio within a
    few ulps: the kernel's in-order sum gives the plain version's masks."""
    rng = np.random.default_rng(0)
    h, w = 100, 100
    wt = np.empty((h, w, 5), np.float32)
    wt[..., 0] = 0.5 + rng.uniform(-1e-3, 1e-3, (h, w))
    wt[..., 1] = 0.25 + rng.uniform(-1e-3, 1e-3, (h, w))
    wt[..., 2] = (0.9 - wt[..., 0].astype(np.float64) - wt[..., 1]
                  + rng.uniform(-3e-6, 3e-6, (h, w)))
    wt[..., 3] = 0.06
    wt[..., 4] = 1 - wt[..., :4].sum(-1)
    means = np.array([[0, 0, 0], [250, 0, 0], [0, 250, 0], [0, 0, 250],
                      [250, 250, 0]], np.float32)
    carry = {"weight": wt, "mean": np.broadcast_to(means, (h, w, 5, 3)).copy(),
             "var": np.full((h, w, 5), 15.0, np.float32),
             "nmodes": np.full((h, w), 5, np.int32)}
    carry = {k: torch.from_numpy(v).to(cuda) for k, v in carry.items()}
    planes = [torch.full((1, h, w), v, dtype=torch.uint8, device=cuda)
              for v in (0, 0, 250)]
    alpha, act = gk.rates(1e-6, True)
    kc, km = gk.gmm(carry, *planes, alpha, act, True)
    pc, pm = gk.gmm_plain(carry, *planes, alpha, act, True)
    assert _same(km, pm) and (pm == 0).any() and (pm != 0).any()
    for key in kc:
        assert _same(kc[key], pc[key]), key


# (pairs, H, W): H < 9; W < 16; one pixel; 257 columns (two levels of the
# W-scan); 4100 (three, a short H); heights that are no multiple of the
# kernel's 23-row strips; 640x480 and 1280x720, where the order of the
# integral image's adds decides the sums
DISPARITY_SHAPES = [(2, 5, 20), (1, 1, 1), (2, 30, 7), (1, 12, 257),
                    (1, 3, 4100), (2, 50, 33), (1, 47, 70), (1, 480, 640),
                    (1, 720, 1280)]


def _pair(n, h, w, seed):
    rng = np.random.default_rng(seed)
    gl = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    gr = np.roll(gl, -5, -1) ^ (rng.random((n, h, w)) < 0.1).astype(np.uint8)
    return torch.from_numpy(gl), torch.from_numpy(gr)


@pytest.mark.parametrize("shape", DISPARITY_SHAPES)
@pytest.mark.parametrize("method", ["sgbm", "sbm"])
def test_sgbm_kernel_matches_plain(cuda, shape, method):
    """The fused kernel (csrc/disparity.cu) from two gray planes against the
    plain versions on the card: the cost volume, the aggregated volume and
    the disparities."""
    gl, gr = (p.to(cuda) for p in _pair(*shape, sum(shape)))
    disp, cost, agg = sk.disparity(gl, gr, method, want_volumes=True)
    plain = sk.cost_volume(gl.float(), gr.float())
    assert _same(cost, plain)
    if method == "sgbm":
        plain = sk.sgbm_plain(plain)
        assert _same(agg, plain)
    else:
        assert agg is None
    assert _same(disp, sk.first_argmin(plain))
    only, none1, none2 = sk.disparity(gl, gr, method)
    assert none1 is None and none2 is None and _same(only, disp)


def test_sgbm_kernel_on_an_image_cost_volume(cuda):
    """Stereo images on the card against the port's CPU path."""
    rng = np.random.default_rng(4)
    gl = torch.from_numpy(rng.integers(0, 256, (2, 37, 70), dtype=np.uint8))
    gr = torch.roll(gl, 3, -1)
    for method in ("sgbm", "sbm"):
        card = sk.disparity(gl.to(cuda), gr.to(cuda), method,
                            want_volumes=True)
        cpu = sk.disparity(gl, gr, method, want_volumes=True)
        for a, b in zip(card, cpu):
            assert (a is None) == (b is None)
            if a is not None:
                assert _same(a, b)
