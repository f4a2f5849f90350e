"""Host side of the torch port's two-pass scale kernels, on the CPU.

The CUDA kernel (gstreamer_tpu_torch/csrc/scale2pass.cuh) gets everything it
indexes from numpy tables made in ``ops/_scale2pass.py``: the input rows each
tile of output rows reads, the chroma rows each chunk of them is built from,
the taps packed as byte limbs for dp4a in a bank-aware column order, and the
size of its shared memory.  Here the tables are held against brute-force
lists, the packed taps against ``taps_s16``, and ``emulate`` (the block loop
in numpy, over the same tables and with the same word arithmetic) against
the plain versions and the JAX package, bit for bit.  The kernel itself runs
only on a CUDA card: that case skips here, decided inside the fixture.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gstreamer_tpu.ops import chroma420_kernel as jck
from gstreamer_tpu.video import scaler as jscaler

import gstreamer_tpu_torch
from gstreamer_tpu_torch.ops import _scale2pass as sp
from gstreamer_tpu_torch.ops import chroma420_kernel as tck
from gstreamer_tpu_torch.ops import scale2d_kernel as ts2
from gstreamer_tpu_torch.ops import yscale_kernel as tysk
from gstreamer_tpu_torch.video import scaler as tscaler
from gstreamer_tpu_torch.video.scaler import SCALE_U8

CSRC = Path(gstreamer_tpu_torch.__file__).parent / "csrc"
SITINGS = [(False, False), (False, True), (True, False), (True, True)]
# (in_w, in_h, out_w, out_h, method, taps)
HEADLINE = [(1920, 1080, 224, 224, "linear", 2),
            (1920, 1080, 224, 224, "cubic", 0),
            (1920, 1080, 224, 224, "lanczos", 0)]
SMALL = [(70, 46, 33, 20, "lanczos", 0),
         (71, 47, 33, 20, "cubic", 0),
         (64, 48, 32, 24, "linear", 2),
         (484, 270, 112, 112, "linear", 2),
         (256, 128, 64, 256, "linear", 0),
         (64, 48, 5, 1, "cubic", 0)]


def _res(pkg, method, taps, n_in, n_out):
    kw = {"max_taps_opt": taps} if taps else {}
    return pkg.make_resampler(method, n_in, n_out, 0, **kw)


def _pair(shape, pkg=tscaler):
    w, h, ow, oh, method, taps = shape
    return _res(pkg, method, taps, w, ow), _res(pkg, method, taps, h, oh)


def _frames(shape, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,) + shape,
                                                dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# -- the rows a tile reads ---------------------------------------------------

@pytest.mark.parametrize("tile", [32, 7, 1])
@pytest.mark.parametrize("shape", HEADLINE + SMALL[:1])
def test_row_table_equals_brute_force(shape, tile):
    _, vr = _pair(shape)
    rows, count, vstart = sp.row_table(vr, tile)
    off, tv, oh = np.asarray(vr.offset), vr.max_taps, vr.out_size
    assert rows.shape[0] == len(count) == -(-oh // tile)
    assert rows.shape[1] == count.max()
    for t in range(len(count)):
        want = sorted({int(off[r]) + q
                       for r in range(t * tile, min(t * tile + tile, oh))
                       for q in range(tv)})
        assert rows[t, :count[t]].tolist() == want
        assert 0 <= want[0] and want[-1] < vr.in_size
    for r in range(oh):                  # the window is a run of the list
        got = rows[r // tile, vstart[r]:vstart[r] + tv]
        assert got.tolist() == list(range(int(off[r]), int(off[r]) + tv))


def test_linear2_reads_fewer_than_half_of_the_rows():
    _, vr = _pair(HEADLINE[0])
    rows, count, _ = sp.row_table(vr, 32)
    assert int(count.sum()) == 448 < 1080 // 2
    assert count.max() == 64


@pytest.mark.parametrize("v_cosited", [False, True])
@pytest.mark.parametrize("shape", HEADLINE[:2] + SMALL[:2] + SMALL[-1:])
def test_chroma_table_lists_what_each_chunk_needs(shape, v_cosited):
    _, vr = _pair(shape)
    ch = (vr.in_size + 1) // 2
    tile = min(32, vr.out_size)
    rows, count, _ = sp.row_table(vr, tile)
    crows, cn, slots = sp.chroma_table(rows, count, ch, v_cosited)
    assert cn.max() == crows.shape[2] <= 2 * sp.ROWS_PER_CHUNK
    for t in range(len(count)):
        for i in range(count[t]):
            y, c = int(rows[t, i]), i // sp.ROWS_PER_CHUNK
            staged = crows[t, c, :cn[t, c]]
            assert np.all(np.diff(staged) > 0)
            k = y >> 1
            if y & 1:
                nb = min(k + 1, ch - 1)
            else:
                nb = k if v_cosited else max(k - 1, 0)
            assert staged[slots[t, i] & 255] == k
            assert staged[slots[t, i] >> 8] == nb
        for c in range(crows.shape[1]):  # nothing staged that no row needs
            used = {int(s) & 255 for s in slots[t, c * 8:c * 8 + 8][
                :max(0, min(8, count[t] - c * 8))]}
            used |= {int(s) >> 8 for s in slots[t, c * 8:c * 8 + 8][
                :max(0, min(8, count[t] - c * 8))]}
            assert used == set(range(cn[t, c]))


# -- packed taps -------------------------------------------------------------

def _unpack(first, packed):
    """{entry: {byte position in the line: tap}} from a packed table."""
    nw, n, _ = packed.shape
    u = packed.view(np.uint32).astype(np.int64)
    out = []
    for s in range(n):
        taps = {}
        for q in range(nw):
            for i in range(4):
                lo = (u[q, s, 0] >> (8 * i)) & 255
                hi = (u[q, s, 1] >> (8 * i)) & 255
                hi = hi - 256 if hi > 127 else hi
                if lo or hi:
                    taps[4 * (int(first[s]) + q) + i] = int(256 * hi + lo)
        out.append(taps)
    return out


@pytest.mark.parametrize("shape", HEADLINE + SMALL)
def test_packed_taps_recombine_to_taps_s16(shape):
    for res in _pair(shape):
        cols, packed = sp.pack_h(res, SCALE_U8)
        assert packed.dtype == np.int32 and packed.flags.c_contiguous
        assert cols.dtype == np.int32 and cols.flags.c_contiguous
        assert packed.shape == (sp.words_per_column(res.max_taps),
                                res.out_size, 2)
        assert sorted(cols[:, 1].tolist()) == list(range(res.out_size))
        ts16 = res.taps_s16(SCALE_U8)
        for (first, j), got in zip(cols, _unpack(cols[:, 0], packed)):
            want = {int(res.offset[j]) + i: int(t)
                    for i, t in enumerate(ts16[j]) if t}
            assert got == want
            assert 4 * first <= res.offset[j] < 4 * first + 4
            # the last word read stays inside the staged row's padding
            assert 4 * (first + packed.shape[0]) <= res.in_size + 6


def test_column_order_spreads_a_warp_over_the_banks():
    """Headline cubic: in natural order the 32 lanes of a warp meet some
    bank three times; in column_order six of seven warps meet none twice."""
    hr, _ = _pair(HEADLINE[1])
    cols, _ = sp.pack_h(hr, SCALE_U8)

    def clashes(first):
        return [int(np.bincount(first[i:i + 32] % 32).max())
                for i in range(0, len(first), 32)]

    natural = clashes(np.asarray(hr.offset) >> 2)
    ordered = clashes(cols[:, 0])
    assert max(natural) == 3
    assert sorted(ordered) == [1, 1, 1, 1, 1, 1, 3]
    assert sum(ordered) < sum(natural)


def test_column_order_handles_few_banks_and_short_rows():
    assert sp.column_order(np.zeros(5, int)).tolist() == [0, 1, 2, 3, 4]
    order = sp.column_order(np.arange(70) * 2)       # only even banks
    assert sorted(order.tolist()) == list(range(70))


# -- shared memory -----------------------------------------------------------

def _a16(n):
    return (n + 15) // 16 * 16


@pytest.mark.parametrize("shape,plane,chroma", [
    # the totals the kernel's own Layout gave on an H100 (the launcher
    # refuses a launch whose host total differs from it)
    (HEADLINE[0], 67584, 84768),
    (HEADLINE[1], 108032, 105952),
])
def test_smem_bytes_equals_the_kernels_layout(shape, plane, chroma):
    hr, vr = _pair(shape)
    w, h = hr.in_size, vr.in_size
    for cw, want in ((0, plane), ((w + 1) // 2, chroma)):
        p = sp.plan(hr, vr, SCALE_U8, (h + 1) // 2 if cw else 0, cw, False)
        nwv = (vr.max_taps + 6) // 4
        assert (p.nw, p.nwv) == ((hr.max_taps + 6) // 4, nwv)
        pitch = (p.n_max + 7) // 8 * 8 + 8
        pitch += 0 if (pitch // 4) % 2 else 4
        row = _a16(w) + 16
        total = (_a16(p.nw * hr.out_size * 8) + _a16(nwv * p.tile_rows * 8)
                 + _a16(hr.out_size * pitch))
        if cw:
            total += (p.stages * p.cr_max * _a16(cw) + p.cr_max * row
                      + 8 * row)
        else:
            total += p.stages * 8 * row
        assert p.smem == total == want
        assert p.smem <= sp.SMEM_TARGET < sp.SMEM_LIMIT == 227 * 1024
        assert (p.tile_rows, p.stages) == (32, 3)


def test_constants_mirror_the_cuda_header():
    src = (CSRC / "scale2pass.cuh").read_text()
    assert int(re.search(r"kRowsPerChunk = (\d+);", src)[1]) == \
        sp.ROWS_PER_CHUNK
    assert max(sp.STAGES) <= int(re.search(r"kMaxStages = (\d+);", src)[1])
    assert min(sp.STAGES) >= 2
    assert "return static_cast<int>(align16(in_w)) + 16;" in src
    assert "const int pitch = ((n_max + 7) & ~7) + 8;" in src


def test_tiling_shrinks_the_tile_and_raises_past_the_limit():
    hr = _res(tscaler, "cubic", 0, 3840, 1920)
    vr = _res(tscaler, "cubic", 0, 2160, 1080)
    p = sp.plan(hr, vr, SCALE_U8)          # past the target: one block an SM
    assert 1 < p.tile_rows < 32 and p.stages == min(sp.STAGES)
    assert sp.SMEM_TARGET < p.smem <= sp.SMEM_LIMIT
    hr = _res(tscaler, "cubic", 0, 1920, 960)
    vr = _res(tscaler, "cubic", 0, 1080, 540)
    p = sp.plan(hr, vr, SCALE_U8)          # a smaller tile meets the target
    assert 1 < p.tile_rows < 32 and p.smem <= sp.SMEM_TARGET
    wide = _res(tscaler, "cubic", 0, 65536, 32768)
    with pytest.raises(ValueError, match="shared memory"):
        sp.plan(wide, vr, SCALE_U8)


def test_plan_is_cached_per_resampler_pair_and_tables_are_c_arrays():
    hr, vr = _pair(SMALL[0])
    p = sp.plan(hr, vr, SCALE_U8)
    assert sp.plan(hr, vr, SCALE_U8) is p
    hr2, _ = _pair(SMALL[0])
    assert sp.plan(hr2, vr, SCALE_U8) is not p
    pc = sp.plan(hr, vr, SCALE_U8, 23, 35, True)
    assert pc is not p and pc.cw == 35 and pc.cr_max >= 2
    for table in list(p.host.values()) + list(pc.host.values()):
        assert table.flags.c_contiguous and table.dtype == np.int32


# -- the block loop over the tables == the plain versions == JAX --------------

@pytest.mark.parametrize("shape", SMALL + HEADLINE[:2])
def test_emulated_kernel_equals_plain_luma(shape):
    hr, vr = _pair(shape)
    y = torch.as_tensor(_frames((vr.in_size, hr.in_size), 1, 31))
    got = sp.emulate(y, hr, vr, SCALE_U8)
    assert torch.equal(got, tysk.yscale_hv_plain(y, hr, vr).int())
    assert torch.equal(got, ts2.scale_hv_u8_plain(y, hr, vr))


@pytest.mark.parametrize("sitings", SITINGS)
@pytest.mark.parametrize("shape", SMALL + HEADLINE[1:2])
def test_emulated_kernel_equals_plain_chroma(shape, sitings):
    hr, vr = _pair(shape)
    c = torch.as_tensor(_frames(((vr.in_size + 1) // 2,
                                 (hr.in_size + 1) // 2), 1, 32))
    got = sp.emulate(c, hr, vr, SCALE_U8, sitings)
    assert torch.equal(got, tck.chroma420_scale_plain(c, hr, vr, *sitings))


@pytest.mark.parametrize("shape", [SMALL[0], SMALL[3]])
def test_emulated_kernel_equals_the_jax_package(shape):
    w, h = shape[0], shape[1]
    hr, vr = _pair(shape)
    jh, jv = _pair(shape, jscaler)
    y = _frames((h, w), 2, 33)
    c = _frames((h // 2, w // 2), 2, 34)
    ref_y = jscaler.scale_axis_exact(
        jnp, jscaler.scale_axis_exact(jnp, jnp.asarray(y), -1, jh), -2, jv)
    assert np.array_equal(sp.emulate(torch.as_tensor(y), hr, vr,
                                     SCALE_U8).numpy(), np.asarray(ref_y))
    for sitings in SITINGS[:3]:
        ref_c = jck.chroma420_scale(jnp.asarray(c), jh, jv, *sitings, w, h,
                                    interpret=True)
        got = sp.emulate(torch.as_tensor(c), hr, vr, SCALE_U8, sitings)
        assert np.array_equal(got.numpy(), np.asarray(ref_c))
        assert torch.equal(got, tck.chroma420_scale(
            torch.as_tensor(c), hr, vr, *sitings, w, h))


def test_word_filters_equal_the_byte_filters():
    """The up2 filters as the kernel does them on whole words: (3a + b +
    2) >> 2 as avg(a, half(a, b)), for every pair of bytes; (a + b + 1)
    >> 1."""
    a = np.repeat(np.arange(256), 256).astype(np.uint32)
    b = np.tile(np.arange(256), 256).astype(np.uint32)
    wa = a | a << 8 | a << 16 | a << 24
    wb = b | (b ^ 255) << 8 | b << 16 | (b ^ 255) << 24
    f = sp._filt31(wa, wb)
    assert np.array_equal(f & 255, (3 * a + b + 2) >> 2)
    assert np.array_equal((f >> 8) & 255, (3 * a + (b ^ 255) + 2) >> 2)
    half = (a + b) >> 1
    assert np.array_equal((a + half + 1) >> 1, (3 * a + b + 2) >> 2)
    assert np.array_equal(sp._avg(wa, wb) & 255, (a + b + 1) >> 1)


# -- on the card ---------------------------------------------------------------

@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("shape", SMALL + HEADLINE[:2])
def test_two_pass_kernels_match_plain_on_card(cuda, shape, skip):
    """Bulk-copy staging (aligned) and word staging (a view one byte in)."""
    hr, vr = _pair(shape)
    w, h = hr.in_size, vr.in_size
    ch, cw = (h + 1) // 2, (w + 1) // 2

    def view(hh, ww, seed):
        flat = torch.as_tensor(np.random.default_rng(seed).integers(
            0, 256, 2 * hh * ww + 16, dtype=np.uint8)).to(cuda)
        return flat[skip:skip + 2 * hh * ww].view(2, hh, ww)

    y, c = view(h, w, 35), view(ch, cw, 36)
    assert torch.equal(tysk.yscale_hv(y, hr, vr),
                       tysk.yscale_hv_plain(y, hr, vr))
    assert torch.equal(ts2.scale_hv_u8(y, hr, vr),
                       ts2.scale_hv_u8_plain(y, hr, vr))
    for sitings in SITINGS:
        assert torch.equal(tck.chroma420_scale(c, hr, vr, *sitings, w, h),
                           tck.chroma420_scale_plain(c, hr, vr, *sitings))
