"""The port's OpenCV analysis family against the JAX package, bit for bit.

segmentation's mixture (``ops/gmm_kernel.py``'s plain version, the step the
CPU runs) against the JAX package's ``_gmm_step`` jitted on the CPU, carry
and masks, over scenes that pin its float hazards: noisy scenes, a flat
scene whose spawned modes tie at alpha, a scene that fills all five modes,
a shadow scene, and a scene whose sorted weights' running sums straddle
backgroundRatio (the order of the cumsum's adds decides the mask there).
disparity's SAD cost volume against the reference's expression jitted at
640x480 (its float32 integral image passes 2^24 there), its semi-global
pass against the reference's ``lax.scan``; then the six factories through
launch strings in both packages, and ``interop``'s hand-over of
segmentation's carry.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.core.pipeline import State as JState
from gstreamer_tpu.elements.opencv_analysis import Segmentation as JSeg

import gstreamer_tpu_torch
from gstreamer_tpu_torch import interop
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.pipeline import State
from gstreamer_tpu_torch.ops import gmm_kernel as gk
from gstreamer_tpu_torch.ops import sgbm_kernel as sk

from test_torch_compositor import run_both

FACTORIES = ("segmentation", "motioncells", "templatematch", "cvtracker",
             "grabcut", "disparity")
DUR = 33333333


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    from gstreamer_tpu.core.element import get_factory_class as jget
    from gstreamer_tpu_torch.core.element import get_factory_class as tget
    j, t = jget(factory), tget(factory)
    assert t.PROPERTIES == j.PROPERTIES
    assert [(p.name, p.direction, str(p.caps)) for p in t.PAD_TEMPLATES] \
        == [(p.name, p.direction, str(p.caps)) for p in j.PAD_TEMPLATES]
    assert t.DESCRIPTION == j.DESCRIPTION
    assert getattr(t, "HOST_ELEMENT", False) \
        == getattr(j, "HOST_ELEMENT", False)


# -- the mixture: plain version against the jitted reference step ------------

def scenes(kind, h, w, t, rng):
    base = rng.integers(40, 220, (h, w, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (7, 3)).astype(np.float32)
    for k in range(t):
        if kind == "noisy":
            x = np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).round()
            if k % 13 == 5:
                x[2:h // 2, 3:w // 2] = rng.integers(0, 256, 3)
        elif kind == "flat":            # spawned modes tie at alpha
            x = np.full((h, w, 3), 100.0)
            if k % 7 == 3:
                x[:, :w // 2] = 180
        elif kind == "five":            # every pixel fills its five modes
            x = cols[rng.integers(0, 7, (h, w))]
        else:                           # "shadow": a darkened region
            x = base.copy()
            if k >= 20 and k % 2 == 0:
                x[h // 4:, w // 4:] *= 0.7
            x = np.clip(x + rng.normal(0, 2, (h, w, 3)), 0, 255).round()
        yield x.astype(np.float32)


def _jstep(lr, method):
    seg = JSeg(**{"learning-rate": lr})
    on = method == "mog2"
    return seg, jax.jit(lambda c, x: seg._gmm_step(jnp, c, x, on, on))


@pytest.mark.parametrize("kind", ["noisy", "flat", "five", "shadow"])
@pytest.mark.parametrize("method", ["mog2", "mog"])
@pytest.mark.parametrize("lr", [0.01, 0.2])
def test_gmm_plain_matches_reference_step(kind, method, lr):
    seg, jstep = _jstep(lr, method)
    h, w = 24, 40
    jc = seg._gmm_init(h, w)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    alpha, act = gk.rates(lr, method == "mog2")
    seen = {"shadow": 0, "five": 0}
    for x in scenes(kind, h, w, 60, np.random.default_rng(3)):
        jc, jm = jstep(jc, jnp.asarray(x))
        tc, tm = gk.gmm_step_plain(tc, torch.from_numpy(x), alpha, act,
                                   method == "mog2")
        assert np.array_equal(tm.numpy(), np.asarray(jm))
        for key in jc:
            assert np.array_equal(_bits(tc[key].numpy()), _bits(jc[key])), key
        seen["shadow"] += int((np.asarray(jm) == gk.SHADOW_VAL).sum())
        seen["five"] += int((np.asarray(jc["nmodes"]) == gk.K).sum())
    if kind == "five":
        assert seen["five"] > 0
    if kind == "shadow" and method == "mog2":
        assert seen["shadow"] > 0


def _straddling_carry(h, w, rng):
    """Five far-apart modes whose weights' running sum reaches
    backgroundRatio within a few ulps after one update."""
    wt = np.empty((h, w, 5), np.float32)
    wt[..., 0] = 0.5 + rng.uniform(-1e-3, 1e-3, (h, w))
    wt[..., 1] = 0.25 + rng.uniform(-1e-3, 1e-3, (h, w))
    wt[..., 2] = (0.9 - wt[..., 0].astype(np.float64) - wt[..., 1]
                  + rng.uniform(-3e-6, 3e-6, (h, w)))
    wt[..., 3] = 0.06
    wt[..., 4] = 1 - wt[..., :4].sum(-1)
    means = np.array([[0, 0, 0], [250, 0, 0], [0, 250, 0], [0, 0, 250],
                      [250, 250, 0]], np.float32)
    return {"weight": wt,
            "mean": np.broadcast_to(means, (h, w, 5, 3)).copy(),
            "var": np.full((h, w, 5), 15.0, np.float32),
            "nmodes": np.full((h, w), 5, np.int32)}


def test_gmm_cumsum_order_decides_the_mask(monkeypatch):
    """The sorted weights' cumsum adds in order (XLA's reduce-window on the
    CPU); associative_scan's tree would give other masks here."""
    lr, h, w = 1e-6, 100, 100
    seg, jstep = _jstep(lr, "mog2")
    c = _straddling_carry(h, w, np.random.default_rng(0))
    x = np.broadcast_to(np.array([0, 0, 250], np.float32), (h, w, 3)).copy()
    _, jm = jstep(c, jnp.asarray(x))
    jm = np.asarray(jm)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    alpha, act = gk.rates(lr, True)
    _, tm = gk.gmm_step_plain(tc, torch.from_numpy(x), alpha, act, True)
    assert np.array_equal(tm.numpy(), jm)
    assert (jm == 0).sum() > 0 and (jm != 0).sum() > 0

    def tree(ws):
        a0, a1, a2, a3, a4 = ws.unbind(-1)
        s01, s23 = a0 + a1, a2 + a3
        return torch.stack([a0, s01, s01 + a2, s01 + s23, s01 + s23 + a4], -1)
    monkeypatch.setattr(gk, "_cumsum5", tree)
    _, other = gk.gmm_step_plain(tc, torch.from_numpy(x), alpha, act, True)
    assert (other.numpy() != jm).sum() > 0


def test_gmm_separate_roundings_differ():
    """The contracted weight update matters: over a noisy scene the plain
    version's weights equal the reference's, and the same update rounded
    twice differs from the fused one on the way."""
    seg, jstep = _jstep(0.01, "mog2")
    h, w = 24, 40
    jc = seg._gmm_init(h, w)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    alpha, act = gk.rates(0.01, True)
    diff = 0
    for x in scenes("noisy", h, w, 30, np.random.default_rng(4)):
        wt = tc["weight"]
        o = torch.zeros_like(wt)
        diff += int(((wt + alpha * (o - wt)) - act
                     != gk.fma32(alpha, o - wt, wt) - act).sum())
        jc, _ = jstep(jc, jnp.asarray(x))
        tc, _ = gk.gmm_step_plain(tc, torch.from_numpy(x), alpha, act, True)
        assert np.array_equal(_bits(tc["weight"].numpy()),
                              _bits(jc["weight"]))
    assert diff > 0


def test_gmm_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(6)
    n, h, w = 4, 9, 13
    planes = [torch.from_numpy(rng.integers(0, 256, (n, h, w), np.uint8))
              for _ in range(3)]
    carry = {k: torch.from_numpy(v) for k, v in gk.init_carry(h, w).items()}
    alpha, act = gk.rates(0.05, True)
    before = gk.gmm.launches
    c1, m1 = gk.gmm(carry, *planes, alpha, act, True)
    c2, m2 = gk.gmm_plain(carry, *planes, alpha, act, True)
    assert gk.gmm.launches == before          # no kernel launched
    assert torch.equal(m1, m2)
    for k in c1:
        assert torch.equal(c1[k], c2[k])
    with pytest.raises(ValueError):
        gk.gmm({**carry, "var": carry["var"][:, :1]}, *planes, alpha, act,
               True)


# -- disparity: the cost volume and the semi-global pass ----------------------

def _ref_cost(gl, gr, nd=32, blk=9):
    """The reference's SAD volume (opencv_analysis.py:928-944)."""
    w = gl.shape[-1]
    r = blk // 2
    costs = []
    for d in range(nd):
        shifted = jnp.pad(gr, [(0, 0)] * (gr.ndim - 2)
                          + [(0, 0), (d, 0)])[..., :, :w]
        ad = jnp.abs(gl - shifted)
        padded = jnp.pad(ad, [(0, 0)] * (ad.ndim - 2) + [(r, r), (r, r)],
                         mode="edge")
        c = jnp.cumsum(jnp.cumsum(padded, axis=-2), axis=-1)
        c = jnp.pad(c, [(0, 0)] * (ad.ndim - 2) + [(1, 0), (1, 0)])
        costs.append(c[..., blk:, blk:] - c[..., :-blk, blk:]
                     - c[..., blk:, :-blk] + c[..., :-blk, :-blk])
    return jnp.stack(costs, axis=-1)


def _ref_sgbm(cost, p1=8.0, p2=32.0):
    """The reference's column pass (opencv_analysis.py:947-967)."""
    nd = cost.shape[-1]
    dd = jnp.arange(nd)
    far = (jnp.abs(dd[:, None] - dd[None, :]) > 1).astype(jnp.float32)
    near = (jnp.abs(dd[:, None] - dd[None, :]) == 1).astype(jnp.float32)

    def col_step(prev, c_col):
        m = prev.min(-1, keepdims=True)
        trans = jnp.minimum(prev[..., None, :] + p1 * near + p2 * far,
                            m[..., None] + p2)
        agg = c_col + trans.min(-1) - m
        return agg, agg

    cols = jnp.moveaxis(cost, -2, 0)
    _, agg = jax.lax.scan(col_step, cols[0], cols[1:])
    return jnp.moveaxis(jnp.concatenate([cols[:1], agg], 0), 0, -2)


@pytest.mark.parametrize("shape", [(1, 480, 640), (2, 37, 70)])
def test_cost_volume_matches_reference(shape):
    rng = np.random.default_rng(0)
    gl = rng.integers(0, 256, shape).astype(np.float32)
    gr = rng.integers(0, 256, shape).astype(np.float32)
    ref = np.asarray(jax.jit(_ref_cost)(gl, gr))
    got = sk.cost_volume(torch.from_numpy(gl), torch.from_numpy(gr)).numpy()
    assert np.array_equal(_bits(got), _bits(ref))
    if shape[-1] == 640:
        # the order of the integral image's adds decides the sums here
        x = torch.from_numpy(rng.standard_normal((2, 300, 700))
                             .astype(np.float32) * 1000)
        for axis in (-1, -2):
            want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=axis))(
                x.numpy()))
            assert np.array_equal(_bits(sk.scan_cumsum(x, axis).numpy()),
                                  _bits(want))
            seq = np.cumsum(x.numpy(), axis=axis, dtype=np.float32)
            tree = np.asarray(jax.lax.associative_scan(
                jnp.add, x.numpy(), axis=axis % 3))
            print(f"axis {axis}: numpy's order differs at "
                  f"{(seq != want).sum()}, associative_scan's at "
                  f"{(tree != want).sum()}, torch's at "
                  f"{(torch.cumsum(x, axis).numpy() != want).sum()}")
            assert (seq != want).sum() > 0 and (tree != want).sum() > 0


@pytest.mark.parametrize("shape", [(2, 13, 45), (1, 7, 1), (3, 5, 64)])
def test_sgbm_plain_matches_reference_scan(shape):
    rng = np.random.default_rng(sum(shape))
    cost = rng.integers(0, 2000, shape + (32,)).astype(np.float32)
    ref = np.asarray(jax.jit(_ref_sgbm)(cost))
    agg = sk.sgbm_plain(torch.from_numpy(cost))
    assert np.array_equal(_bits(agg.numpy()), _bits(ref))
    assert np.array_equal(sk.first_argmin(agg).numpy(),
                          ref.argmin(-1).astype(np.uint8))


def test_sgbm_three_candidates_are_the_dense_minimum():
    """The kernel's transition (prev[d], prev[d+-1] + P1, m + P2) equals the
    reference's dense minimum, on float costs with fractions too."""
    rng = np.random.default_rng(9)
    prev = torch.from_numpy((rng.standard_normal((500, 32)) * 40)
                            .astype(np.float32))
    m = prev.min(-1, keepdim=True).values
    dd = torch.arange(32)
    gap = (dd[:, None] - dd[None, :]).abs()
    dense = torch.minimum((prev[:, None, :] + (gap == 1).float() * sk.P1)
                          + (gap > 1).float() * sk.P2,
                          (m + sk.P2)[..., None]).min(-1).values
    inf = torch.full_like(prev[:, :1], float("inf"))
    left = torch.cat([inf, prev[:, :-1]], 1) + sk.P1
    right = torch.cat([prev[:, 1:], inf], 1) + sk.P1
    three = torch.minimum(torch.minimum(prev, m + sk.P2),
                          torch.minimum(left, right))
    assert torch.equal(three, dense)


def _stereo(h, w, n, seed):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (3, n, h, w)).astype(np.uint8)
    return left, np.roll(left, -5, -1)


@pytest.mark.parametrize("method", ["sgbm", "sbm"])
@pytest.mark.parametrize("h,w,n", [(32, 48, 2), (480, 640, 1)])
def test_disparity_launch(method, h, w, n):
    left, right = _stereo(h, w, n, 11)
    caps = f"video/x-raw,format=RGB,width={w},height={h},framerate=30/1"
    run_both(f"disparity name=d method={method} ! appsink name=out "
             f"appsrc name=l caps={caps} ! d.sink_left "
             f"appsrc name=r caps={caps} ! d.sink_right",
             {"l": [dict(data=tuple(left), batch=n)],
              "r": [dict(data=tuple(right), batch=n)]}, batch=n)


# -- segmentation and the host elements through launch strings ----------------

def rgba_ticks(n, ticks, h=32, w=48, seed=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(30, 220, (4, h, w))
    out = []
    for t in range(ticks):
        d = np.clip(base[:, None] + rng.normal(0, 5, (4, n, h, w)), 0,
                    255).astype(np.uint8)
        d[:3, :, 5:15, 10:30] = rng.integers(0, 256, (3, n, 1, 1))
        d[:3, 1::2, 20:, 25:] = (d[:3, 1::2, 20:, 25:] * 0.7).astype(np.uint8)
        out.append(dict(data=tuple(d), batch=n, pts=t * n * DUR,
                        duration=n * DUR))
    return out


SEG = "appsrc name=in caps=video/x-raw,format=RGBA,width=48,height=32," \
      "framerate=30/1 ! segmentation {} ! appsink name=out"


@pytest.mark.parametrize("props", ["", "test-mode=true", "learning-rate=0.2",
                                   "method=mog", "method=mog test-mode=true",
                                   "method=codebook",
                                   "method=codebook learning-rate=0.2"])
def test_segmentation_launch(props, monkeypatch):
    calls = []
    real = gk.gmm

    def spy(*a, **kw):
        calls.append(a[1].shape[0])
        return real(*a, **kw)
    monkeypatch.setattr(gk, "gmm", spy)
    run_both(SEG.format(props), {"in": rgba_ticks(8, 5)}, batch=8)
    # the mixture runs once a tick, over its eight frames
    assert calls == ([] if "codebook" in props else [8] * 5)


def _host_rgb(n, ticks, h=64, w=96):
    out = []
    for t in range(ticks):
        d = np.full((3, n, h, w), 40, np.uint8)
        for k in range(n):
            x = 4 + 3 * (t * n + k)
            d[:, k, 10:30, x:x + 16] = 200
            d[0, k, 15:20, x + 3:x + 8] = 90
        out.append(dict(data=tuple(d), batch=n, pts=t * n * DUR,
                        duration=n * DUR))
    return out


def _messages(pipe):
    return [(m.type, m.src, m.data) for m in iter(pipe.bus.pop, None)
            if m.type == "element"]


@pytest.mark.parametrize("desc", [
    "motioncells gridx=4 gridy=3 postallmotion=true",
    "motioncells gridx=5 gridy=5 usealpha=true motioncellsidx=1:1,2:2,2:3",
    "cvtracker object-initial-x=4 object-initial-y=10 "
    "object-initial-width=16 object-initial-height=20",
])
def test_host_elements_launch(desc):
    import test_torch_compositor as tc
    caps = "video/x-raw,format=RGB,width=96,height=64,framerate=30/1"
    full = f"appsrc name=in caps={caps} ! {desc} ! appsink name=out"
    pushes = {"in": _host_rgb(4, 3)}
    jp, ref = tc._run(jparse_launch, JBuffer, full, pushes, ("out",), 4)
    tp, out = tc._run(gstreamer_tpu_torch.parse_launch, Buffer, full, pushes,
                      ("out",), 4, device="cpu")
    tc.assert_same_samples(out, ref, ("out",))
    jm, tm = _messages(jp), _messages(tp)
    assert tm == jm and len(tm) > 0
    if desc.startswith("cvtracker"):
        from gstreamer_tpu_torch.analytics import (ObjectDetectionMtd,
                                                   relation_meta_of)
        for s in out["out"]:
            metas = relation_meta_of(s.buffer)
            assert len(metas) == 4
            assert all(len(m.iter_mtds(ObjectDetectionMtd)) == 1
                       for m in metas.values())


def test_grabcut_and_templatematch_launch(tmp_path):
    rng = np.random.default_rng(2)
    seq = rgba_ticks(2, 1)
    a = np.zeros_like(seq[0]["data"][3])
    a[:, 5:15, 10:30] = 3
    a[:, 0:2, :] = 1
    seq[0]["data"] = seq[0]["data"][:3] + (a,)
    run_both("appsrc name=in caps=video/x-raw,format=RGBA,width=48,height=32,"
             "framerate=30/1 ! grabcut test-mode=true ! appsink name=out",
             {"in": seq}, batch=2)
    from PIL import Image
    img = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    path = tmp_path / "t.png"
    Image.fromarray(img[10:22, 20:36]).save(path)
    for method in range(6):
        run_both("appsrc name=in caps=video/x-raw,format=BGR,width=96,"
                 f"height=64,framerate=30/1 ! templatematch template={path} "
                 f"method={method} ! appsink name=out",
                 {"in": [dict(data=tuple(img.transpose(2, 0, 1)[:, None]),
                              batch=1)]})


# -- interop: segmentation's carry handed from the JAX package ---------------

@pytest.mark.parametrize("method", ["mog2", "codebook"])
def test_segmentation_carry_hand_over(method):
    """Two ticks in the JAX pipeline; its carry (weight, mean, var, nmodes;
    the codebook's lo, hi, used, frame) into the port's pipeline; the next
    two ticks in both give the same masks, and the same carry."""
    ticks = rgba_ticks(16, 4)
    desc = SEG.format(f"method={method}").replace("segmentation",
                                                  "segmentation name=seg")
    jp = jparse_launch(desc, batch=16)
    jp.set_state(JState.PLAYING)
    src, sink = jp.get_by_name("in"), jp.get_by_name("out")
    for t in ticks[:2]:
        src.push_buffer(JBuffer(**t))
        assert jp.tick()
        sink.pull_sample()
    states = interop.element_states(jp)
    keys = ({"weight", "mean", "var", "nmodes"} if method == "mog2"
            else {"lo", "hi", "used", "frame"})
    assert set(states["seg"]["carry"]) == keys
    ref = []
    for t in ticks[2:]:
        src.push_buffer(JBuffer(**t))
        assert jp.tick()
        ref.append([np.asarray(x) for x in sink.pull_sample().buffer.data])

    tp = gstreamer_tpu_torch.parse_launch(desc, batch=16, device="cpu")
    tp.set_state(State.PLAYING)
    interop.load_element_states(tp, states)
    for t, r in zip(ticks[2:], ref):
        tp.get_by_name("in").push_buffer(Buffer(**dict(t, data=tuple(
            torch.from_numpy(np.array(x)) for x in t["data"]))))
        assert tp.tick()
        out = tp.get_by_name("out").pull_sample().buffer.data
        for o, x in zip(out, r):
            assert np.array_equal(o.numpy(), x)
    jcarry = interop.element_states(jp)["seg"]["carry"]
    tcarry = interop.element_states(tp)["seg"]["carry"]
    for k in keys:
        assert np.array_equal(_bits(tcarry[k]), _bits(jcarry[k])), k
