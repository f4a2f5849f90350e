"""The torch port's chroma filters against the JAX package's, value for value.

Every function of ``video/chroma.py`` on the same integer planes, made from
a seed with numpy: along both axes, cosited and not, at lengths 1-5 and at
odd and even lengths above them.  The port runs under torch (CPU tensors)
and under numpy; the reference runs under numpy.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.video import chroma as jch
from gstreamer_tpu_torch.video import chroma as tch

LENGTHS = [1, 2, 3, 4, 5, 8, 13, 16, 31]
# lengths of the interlaced filters: field groups of 4 lines, also where
# the height is no multiple of 4
LINES = [4, 5, 6, 7, 8, 48, 50, 54]


def _plane(n, axis, seed, dup):
    """An int16 plane (2, ., .) whose `axis` has n samples, nearest-
    duplicated in groups of `dup` along it as unpack_planes leaves it."""
    rng = np.random.default_rng(seed)
    shape = [2, 6, 7]
    shape[axis] = -(-n // dup)
    p = rng.integers(0, 256, shape).astype(np.int16)
    if dup > 1:
        sl = [slice(None)] * 3
        sl[axis] = slice(0, n)
        p = np.repeat(p, dup, axis=axis)[tuple(sl)]
    return p


def _same(fn, p, *args):
    ref = np.asarray(getattr(jch, fn)(np, p, *args))
    own_np = np.asarray(getattr(tch, fn)(np, p, *args))
    own = getattr(tch, fn)(torch, torch.as_tensor(p), *args)
    assert own.dtype == torch.int16
    assert own_np.shape == ref.shape == tuple(own.shape)
    assert np.array_equal(own_np, ref)
    assert np.array_equal(own.numpy(), ref)


# the reference's cosited down2 needs 3 samples (its FILT_3_1 head and
# FILT_1_3 tail index past a shorter plane), so those cases do not exist
FILTER_CASES = [(fn, dup, n, cosited)
                for fn, dup in (("up2", 2), ("down2", 1), ("up4", 4),
                                ("down4", 1))
                for n in LENGTHS for cosited in (False, True)
                if not (fn == "down2" and cosited and n < 3)]


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("fn,dup,n,cosited", FILTER_CASES)
def test_filter_matches_reference(fn, dup, n, axis, cosited):
    _same(fn, _plane(n, axis, 11 * n + dup, dup), axis, cosited)


@pytest.mark.parametrize("cosited", [False, True])
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_up2_half_matches_reference(n, extra, axis, cosited):
    out_size = 2 * n + extra
    _same("up2_half", _plane(n, axis, 7 * n, 1), axis, cosited, out_size)


@pytest.mark.parametrize("cosited", [False, True])
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("n", LENGTHS)
def test_up2_phases_matches_reference(n, axis, cosited):
    p = _plane(n, axis, 5 * n, 1)
    ref = jch.up2_phases(np, p, axis, cosited)
    own = tch.up2_phases(torch, torch.as_tensor(p), axis, cosited)
    own_np = tch.up2_phases(np, p, axis, cosited)
    for r, o, on in zip(ref, own, own_np):
        assert np.array_equal(o.numpy(), r) and np.array_equal(on, r)


@pytest.mark.parametrize("cosited", [False, True])
@pytest.mark.parametrize("n", LINES)
def test_up2_interlaced_matches_reference(n, cosited):
    # up2_interlaced reads a plane whose field lines alternate chroma rows;
    # any values hold the arithmetic, so the plane is plain random
    _same("up2_interlaced", _plane(n, -2, 3 * n, 1), -2, cosited)


@pytest.mark.parametrize("n", LINES)
def test_down2_interlaced_selects_the_packs_rows(n):
    # The reference's down2_interlaced cannot run (it names a module it
    # does not import), so the port is held to the rule its docstring
    # gives: chroma row c of the packed plane is full row
    # (c & ~1) * 2 + (c & 1), clamped to the last row.
    p = _plane(n, -2, 3 * n, 1)
    for xp, arr in ((np, p), (torch, torch.as_tensor(p))):
        out = np.asarray(tch.down2_interlaced(xp, arr, -2, False))
        assert out.shape == p.shape
        stored = out[..., ::2, :]
        for c in range(stored.shape[-2]):
            src = min((c & ~1) * 2 + (c & 1), n - 1)
            assert np.array_equal(stored[..., c, :], p[..., src, :])
    with pytest.raises(NameError):
        jch.down2_interlaced(np, p, -2, False)


def test_interlaced_up_wide_values_stay_exact():
    # 16-bit samples: the 7*l + l + 4 sums need int32
    rng = np.random.default_rng(1)
    p = rng.integers(0, 65536, (1, 50, 9)).astype(np.int32)
    ref = jch.up2_interlaced(np, p, -2, False)
    own = tch.up2_interlaced(torch, torch.as_tensor(p), -2, False)
    assert own.dtype == torch.int32 and np.array_equal(own.numpy(), ref)
