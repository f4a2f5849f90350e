"""numpy walks of the OpenCV family's two kernel schedules, held bit for bit
against the plain versions they replace on the card.

``disparity_walk`` is ``csrc/disparity.cu`` step for step: the per-strip
column prefixes of the first kernel, then for each strip of ``ROWS``
output rows the padded columns left to right in chunks of ``CHUNK``, each
column's exact int32 prefix down the strip's 32 padded rows, the per-level
running float32 sums of ``scan_cumsum``'s order along the row, the ring of
the last 9 columns of the integral image (by the column mod 9), the box
sums in the reference's grouping, and the semi-global pass (or the
argmin) over the chunk's columns 8 behind.  It must equal ``cost_volume`` + ``sgbm_plain`` +
``first_argmin`` at every size below, 640x480 included, where the order of
the integral image's adds starts to matter.

``sort_network`` and ``gmm_step_model`` are ``csrc/gmm.cu``'s frame loop:
the one pass over the modes that updates the owned mode in place, the
stable sort of the five (weight, mode bit) pairs as an odd-even
transposition network of ten adjacent exchanges (a 9-exchange network needs
an index compare in each exchange to be stable), and the background modes
as a bitmask (the heaviest mode alone where it holds at least
``SOLE_BG``), against the stable ``argsort`` (ties, -0.0, equal weights)
and ``gmm_step_plain``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from gstreamer_tpu_torch.ops import gmm_kernel as gk
from gstreamer_tpu_torch.ops import sgbm_kernel as sk

ND = sk.NUM_DISP
LANES = 32                    # padded rows a strip's warp holds, one a lane
ROWS = LANES - sk.BLOCK       # output rows a strip
RING = sk.BLOCK               # the ring of the integral image's columns
CHUNK = 2 * RING              # columns a chunk
LEVELS = 4                    # scan_cumsum levels: padded widths to 16**4


def _pad_ad(gl, gr, rows, cols, h, w):
    """|L - R shifted by d| at padded rows and columns (edge-padded by 4,
    zeros entering the shift): (..., len(rows), len(cols), ND) int32."""
    y = np.clip(np.asarray(rows) - 4, 0, h - 1)
    x = np.clip(np.asarray(cols) - 4, 0, w - 1)
    d = np.arange(ND)
    xs = x[:, None] - d[None, :]
    left = gl[..., y, :][..., x].astype(np.int32)[..., None]
    right = gr[..., y, :][..., np.clip(xs, 0, w - 1)].astype(np.int32)
    right = np.where(xs >= 0, right, 0)
    return np.abs(left - right)


def strip_prefixes(gl, gr):
    """The first kernel: for each strip s, each padded column and
    disparity, the sum of |L - R| over the padded rows above the strip's
    first row (s * ROWS - 1 and up), exact.  (..., S, Wp, ND) int32."""
    h, w = gl.shape[-2:]
    strips = -(-h // ROWS)
    cols = np.arange(w + 8)
    ad = _pad_ad(gl, gr, np.arange(max(strips - 1, 0) * ROWS), cols, h, w)
    run = np.cumsum(ad, axis=-3, dtype=np.int32)
    out = np.zeros(gl.shape[:-2] + (strips, w + 8, ND), np.int32)
    for s in range(1, strips):
        out[..., s, :, :] = run[..., s * ROWS - 1, :, :]
    return out


def _min_key(v):
    """The warp minimum's value and the first lane that holds it."""
    return v.min(-1, keepdims=True), v.argmin(-1)


def disparity_walk(gl, gr, method, want=False):
    """The kernel's schedule over (N, H, W) uint8 gray planes.  Returns the
    first minimal disparities (N, H, W) uint8 and, with `want`, the cost
    and aggregated volumes it formed (N, H, W, ND) float32."""
    n, h, w = gl.shape
    hp, wp = h + 8, w + 8
    strips = -(-h // ROWS)
    pre = strip_prefixes(gl, gr)
    disp = np.zeros((n, h, w), np.uint8)
    cost = np.zeros((n, h, w, ND), np.float32)
    agg = np.zeros((n, h, w, ND), np.float32)
    f32 = np.float32
    for s in range(strips):
        y0 = s * ROWS
        prow = y0 - 1 + np.arange(LANES)               # a lane's padded row
        # the W-scan's per-level running sums and next-block bases, and
        # the ring of the integral image's last RING columns (column -1:
        # the zero column)
        lvl = np.zeros((LEVELS, n, LANES, ND), f32)
        base = np.zeros((LEVELS + 1, n, LANES, ND), f32)
        ring = np.zeros((RING, n, LANES, ND), f32)
        prev = np.zeros((n, ROWS, ND), f32)
        m = np.zeros((n, ROWS, 1), f32)
        for c0 in range(0, wp, CHUNK):
            tile = {}
            for k in range(CHUNK):                     # phase A
                c = c0 + k
                if c >= wp:
                    break
                a = _pad_ad(gl, gr, np.clip(prow, 0, hp - 1), [c], h, w)[
                    ..., 0, :]                         # (n, LANES, ND)
                a[:, 0] = pre[:, s, c] if s else 0     # lane 0: above
                a = np.cumsum(a, axis=1, dtype=np.int32)   # exact, any order
                v = a.astype(f32)
                # scan_cumsum along the row: blocks of 16 in order, each
                # level's block total into the next level when it closes
                lvl[0] = v if c % 16 == 0 else lvl[0] + v
                cur = lvl[0] + base[1]
                q = c
                for lev in range(LEVELS - 1):
                    if q % 16 != 15:
                        break
                    q //= 16
                    lvl[lev + 1] = (lvl[lev] if q % 16 == 0
                                    else lvl[lev + 1] + lvl[lev])
                    base[lev + 1] = lvl[lev + 1] + base[lev + 2]
                old = ring[k % RING].copy()
                ring[k % RING] = cur
                if c >= 8:
                    hi, hi9 = cur[:, 9:9 + ROWS], old[:, 9:9 + ROWS]
                    tile[k] = ((hi - cur[:, :ROWS]) - hi9) + old[:, :ROWS]
            for k, box in tile.items():                # phase B
                x = c0 + k - 8
                if x >= w:
                    break
                rows = slice(y0, min(y0 + ROWS, h))
                live = rows.stop - rows.start
                if method == "sgbm":
                    if x == 0:
                        prev = box
                    else:
                        left = np.concatenate(
                            [np.full_like(prev[..., :1], np.inf),
                             prev[..., :-1]], -1) + f32(sk.P1)
                        right = np.concatenate(
                            [prev[..., 1:],
                             np.full_like(prev[..., :1], np.inf)], -1) \
                            + f32(sk.P1)
                        t = np.minimum(np.minimum(prev, m + f32(sk.P2)),
                                       np.minimum(left, right))
                        prev = (box + t) - m
                    m, best = _min_key(prev)
                    agg[:, rows, x] = prev[:, :live]
                else:
                    _, best = _min_key(box)
                disp[:, rows, x] = best[:, :live]
                cost[:, rows, x] = box[:, :live]
    return (disp, cost, agg) if want else disp


def _plain(gl, gr, method):
    cost = sk.cost_volume(torch.from_numpy(gl).float(),
                          torch.from_numpy(gr).float())
    vol = sk.sgbm_plain(cost) if method == "sgbm" else cost
    return sk.first_argmin(vol).numpy(), cost.numpy(), vol.numpy()


def _pair(n, h, w, seed):
    rng = np.random.default_rng(seed)
    gl = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    gr = np.roll(gl, -5, -1) ^ (rng.random((n, h, w)) < 0.1).astype(np.uint8)
    return gl, gr


# (N, H, W): H < 9; W < 16; 257 (two levels); 4100 (three levels, short);
# heights that are no multiple of ROWS; 640x480
WALK_SIZES = [(2, 5, 20), (1, 1, 1), (2, 30, 7), (1, 12, 257), (1, 3, 4100),
              (2, 50, 33), (1, 47, 70), (1, 480, 640)]


@pytest.mark.parametrize("n,h,w", WALK_SIZES)
@pytest.mark.parametrize("method", ["sgbm", "sbm"])
def test_disparity_walk_matches_plain(n, h, w, method):
    gl, gr = _pair(n, h, w, n * h + w)
    disp, cost, agg = disparity_walk(gl, gr, method, want=True)
    pdisp, pcost, pvol = _plain(gl, gr, method)
    assert np.array_equal(cost.view(np.int32), pcost.view(np.int32))
    if method == "sgbm":
        assert np.array_equal(agg.view(np.int32), pvol.view(np.int32))
    assert np.array_equal(disp, pdisp)


def test_disparity_walk_levels():
    """The sizes above reach every level the kernel keeps: 4100 columns
    pad to 4108, whose W-scan has levels of 4108, 257, 17 and 2."""
    sizes = []
    for wp in (w + 8 for _, _, w in WALK_SIZES):
        lv = [wp]
        while lv[-1] > 16:
            lv.append(-(-lv[-1] // 16))
        sizes.append(len(lv))
    assert max(sizes) == LEVELS and 3 in sizes and 1 in sizes


def test_row_scan_of_the_integer_volume_is_exact():
    """scan_cumsum along H of the integer |L - R| volume equals an int32
    cumsum: its sums stay under 2^24 ((H + 8) * 255 at 720p is 185 640),
    so no order rounds."""
    rng = np.random.default_rng(3)
    for h in (1, 17, 728):
        ad = rng.integers(0, 256, (2, h, 40)).astype(np.float32)
        ad[0] = 255.0                                  # the largest sums
        got = sk.scan_cumsum(torch.from_numpy(ad), -2).numpy()
        want = np.cumsum(ad.astype(np.int32), axis=-2, dtype=np.int32)
        assert np.array_equal(got, want.astype(np.float32))
        if h == 728:
            jax_sum = np.asarray(jax.jit(
                lambda v: jnp.cumsum(v, axis=-2))(ad))
            assert np.array_equal(jax_sum, got)


def test_disparity_wrapper_runs_the_plain_version_on_the_cpu():
    gl, gr = _pair(2, 13, 45, 1)
    for method in ("sgbm", "sbm"):
        disp, cost, agg = sk.disparity(torch.from_numpy(gl),
                                       torch.from_numpy(gr), method,
                                       want_volumes=True)
        pdisp, pcost, pvol = _plain(gl, gr, method)
        assert np.array_equal(disp.numpy(), pdisp)
        assert np.array_equal(cost.numpy().view(np.int32),
                              pcost.view(np.int32))
        assert (agg is None) == (method == "sbm")
        if agg is not None:
            assert np.array_equal(agg.numpy().view(np.int32),
                                  pvol.view(np.int32))
        only, none1, none2 = sk.disparity(torch.from_numpy(gl),
                                          torch.from_numpy(gr), method)
        assert none1 is None and none2 is None
        assert torch.equal(only, disp)
    with pytest.raises(ValueError):
        sk.disparity(torch.from_numpy(gl).float(), torch.from_numpy(gr),
                     "sgbm")
    with pytest.raises(ValueError):
        sk.disparity(torch.from_numpy(gl), torch.from_numpy(gr), "bm")


# -- the mixture's selection logic -------------------------------------------

def sort_network(ws, payload):
    """csrc/gmm.cu's stable descending sort: odd-even transposition, five
    rounds of adjacent exchanges, an exchange only when the right weight is
    strictly heavier.  ws, payload: lists of K tensors; returns both in
    sorted order."""
    ws, payload = list(ws), list(payload)
    for r in range(gk.K):
        for i in range(r & 1, gk.K - 1, 2):
            s = ws[i + 1] > ws[i]
            ws[i], ws[i + 1] = (torch.where(s, ws[i + 1], ws[i]),
                                torch.where(s, ws[i], ws[i + 1]))
            payload[i], payload[i + 1] = (
                torch.where(s, payload[i + 1], payload[i]),
                torch.where(s, payload[i], payload[i + 1]))
    return ws, payload


SOLE_BG = float(np.float32(0.9001))          # csrc/gmm.cu's kSoleBg


def sorted_background_bits(w):
    """The background modes' bits from the sorting network and the running
    sum in sorted order (w: a list of K weight tensors)."""
    bit = [torch.tensor(1 << k, dtype=torch.int32) for k in range(gk.K)]
    ws, pm = sort_network(w, [bit[k].expand_as(w[0]).clone()
                              for k in range(gk.K)])
    bg = torch.zeros(w[0].shape, dtype=torch.int32)
    csum = ws[0]
    for q in range(gk.K):
        if q:
            csum = csum + ws[q]
        bg |= torch.where((csum - ws[q]) < gk._BGRATIO, pm[q], 0)
    return bg


def background_bits(w):
    """csrc/gmm.cu's background bits: the heaviest mode (the first of
    equals) alone where its weight is at least SOLE_BG, else the sorted
    running sum's."""
    wmax, kmax = w[0], torch.zeros(w[0].shape, dtype=torch.int32)
    for k in range(1, gk.K):
        more = w[k] > wmax
        wmax = torch.where(more, w[k], wmax)
        kmax = torch.where(more, k, kmax)
    return torch.where(wmax >= SOLE_BG, 1 << kmax, sorted_background_bits(w))


def gmm_step_model(carry, x, alpha, act, with_shadow):
    """One frame of csrc/gmm.cu's loop over (P,) pixels in torch: one pass
    over the modes in order (the distance, the match within Tb as a bit,
    the weight with -w for o - w, the first active mode within Tg updated
    in place with o = 1), the spawn, the normalisation, the sorting
    network carrying each mode's bit (or the heaviest mode alone), the
    background modes as a bitmask and the shadow test of background modes
    only.  carry as
    gmm_step_plain's flattened to P pixels; x: (P, 3) float32."""
    fma32 = gk.fma32
    K = gk.K
    f32 = torch.float32
    w = list(carry["weight"].unbind(-1))
    m = list(carry["mean"].unbind(1))
    v = list(carry["var"].unbind(-1))
    n = carry["nmodes"]
    bit = [torch.tensor(1 << k, dtype=torch.int32) for k in range(K)]
    zero_i = torch.zeros_like(n)
    zero = torch.zeros((), dtype=f32)
    alpha_t = torch.tensor(alpha, dtype=f32)
    eps = torch.tensor(gk._F32_EPS, dtype=f32)
    near, live = zero_i.clone(), zero_i.clone()
    first = torch.full_like(n, -1)
    for k in range(K):
        d = x - m[k]
        dist2 = gk._dot3(d, d)
        near |= torch.where(dist2 < v[k] * gk.TB, bit[k], 0)
        w0 = w[k]
        w[k] = fma32(alpha, -w0, w0) - act
        mine = (first < 0) & (k < n) & (dist2 < v[k] * gk.TG)
        first = torch.where(mine, k, first)
        wo = fma32(alpha, 1.0 - w0, w0) - act
        w[k] = torch.where(mine, wo, w[k])
        rho = alpha_t / torch.maximum(wo, eps)
        m[k] = torch.where(mine[:, None], fma32(rho[:, None], d, m[k]), m[k])
        v[k] = torch.where(mine, torch.clamp(fma32(rho, dist2 - v[k], v[k]),
                                             gk.VAR_MIN, gk.VAR_MAX), v[k])
        alive = (k < n) & (w[k] > 0)
        w[k] = torch.where(alive, w[k], zero)
        live |= torch.where(alive, bit[k], 0)
    nn = sum(((live >> k) & 1) for k in range(K)).to(torch.int32)
    spawn = first < 0
    best, slot = w[0], torch.zeros_like(n)
    for k in range(1, K):
        lower = w[k] < best
        best = torch.where(lower, w[k], best)
        slot = torch.where(lower, k, slot)
    slot = torch.where(nn >= K, slot, nn)
    for k in range(K):
        sp = spawn & (slot == k)
        w[k] = torch.where(sp, alpha_t, w[k])
        m[k] = torch.where(sp[:, None], x, m[k])
        v[k] = torch.where(sp, torch.tensor(gk.VAR_INIT, dtype=f32), v[k])
    nn = torch.where(spawn, torch.clamp(nn + 1, max=K), nn)
    tot = torch.maximum((((w[0] + w[1]) + w[2]) + w[3]) + w[4], eps)
    w = [torch.where(k < nn, w[k] / tot, zero) for k in range(K)]
    bg = background_bits(w)
    bg &= (1 << nn) - 1
    matches_bg = (bg & near) != 0
    mask = torch.where(matches_bg, 0, 255).to(torch.uint8)
    if with_shadow:
        shadow = torch.zeros_like(matches_bg)
        for k in range(K):
            num = gk._dot3(x, m[k])
            den = torch.maximum(gk._dot3(m[k], m[k]), eps)
            ratio = num / den
            ds = fma32(-ratio[:, None], m[k], x)
            dist2s = gk._dot3(ds, ds)
            shadow |= (((bg >> k) & 1) == 1) & (ratio >= gk.SHADOW_TAU) \
                & (ratio <= 1.0) & (dist2s < (v[k] * gk.TB) * (ratio * ratio))
        mask = torch.where(~matches_bg & shadow, gk.SHADOW_VAL, mask) \
            .to(torch.uint8)
    return ({"weight": torch.stack(w, -1), "mean": torch.stack(m, 1),
             "var": torch.stack(v, -1), "nmodes": nn}, mask)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from([0.0, -0.0, 0.25, 0.5, 1e-6, 0.125, 1.0]),
                min_size=gk.K, max_size=gk.K))
def test_sort_network_is_the_stable_argsort(weights):
    w = torch.tensor(weights, dtype=torch.float32)[None]
    ws, pm = sort_network(list(w.unbind(-1)),
                          [torch.tensor([k]) for k in range(gk.K)])
    order = torch.argsort(-w, dim=-1, stable=True)[0]
    assert [int(p) for p in pm] == order.tolist()
    assert torch.equal(torch.stack(ws, -1).view(torch.int32),
                       torch.gather(w, -1, order[None]).view(torch.int32))


@settings(max_examples=600, deadline=None)
@given(st.floats(SOLE_BG, 1.0, width=32),
       st.lists(st.floats(0.0, 1.0, width=32), min_size=gk.K - 1,
                max_size=gk.K - 1),
       st.integers(0, gk.K - 1))
def test_heaviest_mode_alone_is_the_background(top, rest, at):
    """Normalised weights whose heaviest is at least SOLE_BG: the sorted
    running sum marks that mode alone as background, so the kernel skips
    the sort there.  The others share the rest of the total (ties
    included), as the kernel's normalisation leaves them."""
    rest = np.asarray(rest, np.float64)
    rest = rest / max(rest.sum(), 1.0) * (1.0 - top) / (1.0 + 1e-7)
    raw = np.insert(rest, at, top).astype(np.float32)
    tot = np.float32(max(np.float32(np.float32(np.float32(np.float32(
        raw[0] + raw[1]) + raw[2]) + raw[3]) + raw[4]), np.float32(1e-6)))
    w = [torch.tensor([raw[k] / tot], dtype=torch.float32)
         for k in range(gk.K)]
    if float(max(w, key=float)) < SOLE_BG:
        return
    assert int(sorted_background_bits(w)) == int(background_bits(w))


def test_sort_network_on_every_tie_pattern():
    """Every pattern of five weights from three levels (243): the network
    gives the stable order, as the 0-1 principle needs for a sort."""
    import itertools
    pats = torch.tensor(list(itertools.product((0.0, 0.5, 1.0), repeat=5)))
    ws, pm = sort_network(list(pats.unbind(-1)),
                          [torch.full((len(pats),), k) for k in range(gk.K)])
    want = torch.argsort(-pats, dim=-1, stable=True)
    assert torch.equal(torch.stack(pm, -1), want)


def _flat(carry):
    h, w = carry["nmodes"].shape
    return {"weight": carry["weight"].reshape(h * w, gk.K),
            "mean": carry["mean"].reshape(h * w, gk.K, 3),
            "var": carry["var"].reshape(h * w, gk.K),
            "nmodes": carry["nmodes"].reshape(h * w)}, (h, w)


def _straddle():
    """chip_smoke.py's straddling carry: five far-apart modes whose sorted
    weights' running sum reaches backgroundRatio within a few ulps."""
    rng = np.random.default_rng(0)
    h = w = 40
    wt = np.empty((h, w, 5), np.float32)
    wt[..., 0] = 0.5 + rng.uniform(-1e-3, 1e-3, (h, w))
    wt[..., 1] = 0.25 + rng.uniform(-1e-3, 1e-3, (h, w))
    wt[..., 2] = (0.9 - wt[..., 0].astype(np.float64) - wt[..., 1]
                  + rng.uniform(-3e-6, 3e-6, (h, w)))
    wt[..., 3] = 0.06
    wt[..., 4] = 1 - wt[..., :4].sum(-1)
    means = np.array([[0, 0, 0], [250, 0, 0], [0, 250, 0], [0, 0, 250],
                      [250, 250, 0]], np.float32)
    carry = {"weight": wt,
             "mean": np.broadcast_to(means, (h, w, 5, 3)).copy(),
             "var": np.full((h, w, 5), 15.0, np.float32),
             "nmodes": np.full((h, w), 5, np.int32)}
    return {k: torch.from_numpy(v) for k, v in carry.items()}


def _scene(kind, n, h, w, rng):
    if kind == "flat":
        x = np.full((n, h, w, 3), 100)
        x[::3, :, : w // 2] = 180
    elif kind == "five":
        cols = rng.integers(0, 256, (7, 3))
        x = cols[rng.integers(0, 7, (n, h, w))]
    else:
        x = (rng.integers(30, 220, (1, h, w, 3))
             + rng.normal(0, 8, (n, h, w, 3))
             + (rng.random((n, h, w, 3)) < 0.1) * rng.integers(0, 128,
                                                               (n, h, w, 3)))
    return torch.from_numpy(np.clip(x, 0, 255).astype(np.float32))


@pytest.mark.parametrize("kind", ["straddle", "noisy", "flat", "five"])
@pytest.mark.parametrize("method", ["mog2", "mog"])
def test_gmm_model_matches_plain_step(kind, method):
    """The kernel's frame loop, modelled, equals gmm_step_plain bit for bit:
    carry and masks over several frames, with shadows, tied spawns, five
    live modes and the backgroundRatio straddle."""
    on = method == "mog2"
    rng = np.random.default_rng(5)
    if kind == "straddle":
        carry = _straddle()
        frames = torch.tensor([[0.0, 0.0, 250.0]]).expand(40, 40, 3)[None]
        alpha, act = gk.rates(1e-6, on)
    else:
        h, w = 24, 30
        carry = {k: torch.from_numpy(v) for k, v in
                 gk.init_carry(h, w).items()}
        frames = _scene(kind, 12, h, w, rng)
        alpha, act = gk.rates(0.05 if kind == "noisy" else 0.2, on)
    flat, (h, w) = _flat(carry)
    pc = carry
    masks = []
    for x in frames:
        pc, pm = gk.gmm_step_plain(pc, x, alpha, act, on)
        flat, km = gmm_step_model(flat, x.reshape(h * w, 3), alpha, act, on)
        assert torch.equal(km.reshape(h, w), pm)
        for key, t in _flat(pc)[0].items():
            a, b = flat[key], t
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), key
        masks.append(pm)
    seen = torch.stack(masks).unique().tolist()
    if kind == "straddle":
        assert 0 in seen and 255 in seen
    if kind == "noisy" and on:
        assert 127 in seen
