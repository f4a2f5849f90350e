"""Host side of the torch port's horizontal-only scale kernels, on the CPU.

``hscale_u8`` (csrc/hscale.cu) and ``fused_i420_up_hscale``
(csrc/fused_ingest.cu) share the packed dp4a horizontal pass of
csrc/scale2pass.cuh and get from ``ops/_scale2pass.py`` the packed taps, the
cut of the rows into blocks (runs of 8-row chunks; for chroma, runs of
chroma rows with their clamped halo), the ring depth and the size of the
block's shared memory.  Here ``emulate_hscale`` and ``emulate_fused`` (the
block loops in numpy, over the same tables and with the same word
arithmetic, every byte no copy writes filled at random) are held against the
plain versions and the JAX kernels, bit for bit; the partition against brute
force; the shared-memory size against the layout written out.  The kernels
themselves run only on a CUDA card: those cases skip here, decided inside the
fixture.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gstreamer_tpu.ops import convert_kernel as jck
from gstreamer_tpu.ops import hscale_kernel as jhk
from gstreamer_tpu.video import scaler as jscaler

import gstreamer_tpu_torch
from gstreamer_tpu_torch.ops import _scale2pass as sp
from gstreamer_tpu_torch.ops import convert_kernel as tck
from gstreamer_tpu_torch.ops import hscale_kernel as thk
from gstreamer_tpu_torch.video import scaler as tscaler
from gstreamer_tpu_torch.video.scaler import SCALE_U8

CSRC = Path(gstreamer_tpu_torch.__file__).parent / "csrc"
# (in_w, in_h, out_w, method, taps): tests/test_torch_fused_ingest.py's
# SHAPES (23 chroma rows and 260 % 16 == 4 among them), then a width with
# W % 16 == 4 at 2 taps, lanczos off the 16-byte grid and one chroma chunk
SHAPES = [
    (128, 120, 64, "linear", 2),
    (70, 46, 33, "linear", 2),
    (128, 120, 64, "cubic", 0),
    (70, 46, 33, "lanczos", 0),
    (260, 132, 100, "linear", 0),
    (484, 270, 112, "linear", 2),
    (132, 38, 50, "lanczos", 0),
    (64, 8, 20, "cubic", 0),
]
HEADLINE = [(1920, 1080, 224, "linear", 2), (1920, 1080, 224, "cubic", 0)]


def _res(pkg, method, taps, n_in, n_out):
    kw = {"max_taps_opt": taps} if taps else {}
    return pkg.make_resampler(method, n_in, n_out, 0, **kw)


def _i420(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8))


def _a16(n):
    return (n + 15) // 16 * 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# -- the block loops over the tables == the plain versions == JAX -------------

@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_hscale_equals_plain(shape, aligned):
    w, h, ow, method, taps = shape
    res = _res(tscaler, method, taps, w, ow)
    y = torch.as_tensor(_i420(3, w, h, 61)[0])
    got = sp.emulate_hscale(y, res, SCALE_U8, aligned=aligned)
    want = thk.hscale_u8_plain(y, res)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("h_cosited", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_fused_equals_plain(shape, aligned, h_cosited):
    w, h, ow, method, taps = shape
    res = _res(tscaler, method, taps, w, ow)
    y, u, v = (torch.as_tensor(p) for p in _i420(2, w, h, 62))
    got = sp.emulate_fused(y, u, v, res, h_cosited, SCALE_U8, aligned=aligned)
    want = tck.fused_i420_up_hscale_plain(y, u, v, res, h_cosited)
    assert len(got) == len(want) == 5
    for i, (g, p) in enumerate(zip(got, want)):
        assert g.dtype == p.dtype == torch.int16 and g.shape == p.shape, i
        assert torch.equal(g, p), i


@pytest.mark.parametrize("n_slots", [1, 2, 7, 1000])
def test_emulation_holds_for_any_number_of_blocks(n_slots):
    """The cut into blocks follows the card's size; the bytes do not."""
    w, h, ow, method, taps = SHAPES[3]
    res = _res(tscaler, method, taps, w, ow)
    y, u, v = (torch.as_tensor(p) for p in _i420(5, w, h, 63))
    assert torch.equal(sp.emulate_hscale(y, res, SCALE_U8, n_slots=n_slots),
                       thk.hscale_u8_plain(y, res))
    for g, p in zip(sp.emulate_fused(y, u, v, res, False, SCALE_U8,
                                     n_slots=n_slots),
                    tck.fused_i420_up_hscale_plain(y, u, v, res, False)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[4]])
def test_emulated_hscale_equals_the_jax_package(shape):
    w, h, ow, method, taps = shape
    y = _i420(2, w, h, 64)[0]
    res = _res(tscaler, method, taps, w, ow)
    jh = _res(jscaler, method, taps, w, ow)
    got = sp.emulate_hscale(torch.as_tensor(y), res, SCALE_U8).numpy()
    ref = jscaler.scale_axis_exact(jnp, jnp.asarray(y), -1, jh)
    assert np.array_equal(got, np.asarray(ref))
    if jhk.applicable(jh, y.shape):      # the reference's own gate
        with pltpu.force_tpu_interpret_mode():
            ker = np.asarray(jhk.hscale_u8(jnp.asarray(y), jh))
        assert np.array_equal(got, ker)


def test_reference_hscale_kernel_gate_admits_a_shape():
    """At least one case above runs the Pallas kernel itself."""
    w, h, ow, method, taps = SHAPES[0]
    assert jhk.applicable(_res(jscaler, method, taps, w, ow), (2, h, w))


@pytest.mark.parametrize("h_cosited", [False, True])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[2], SHAPES[3]])
def test_emulated_fused_equals_the_jax_kernel(shape, h_cosited):
    w, h, ow, method, taps = shape
    y, u, v = _i420(2, w, h, 65)
    res = _res(tscaler, method, taps, w, ow)
    jh = _res(jscaler, method, taps, w, ow)
    ref = jck.fused_i420_up_hscale(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
        jscaler.tap_matrix(jh), None, h_cosited=h_cosited, interpret=True)
    got = sp.emulate_fused(torch.as_tensor(y), torch.as_tensor(u),
                           torch.as_tensor(v), res, h_cosited, SCALE_U8)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(r, np.int64)), i


# -- the partition into blocks -----------------------------------------------

@pytest.mark.parametrize("total,run", [(276480, 131), (69120, 33), (46, 8),
                                       (7, 1), (8, 3), (1081, 5)])
def test_row_runs_cover_every_row_once(total, run):
    runs = sp.row_runs(total, run)
    assert runs.dtype == np.int32
    seen = np.zeros(total, int)
    for i, (r0, n) in enumerate(runs):
        assert r0 == i * run * sp.ROWS_PER_CHUNK        # the kernel's own rule
        assert 0 < n <= run * sp.ROWS_PER_CHUNK
        seen[r0:r0 + n] += 1
    assert np.all(seen == 1)
    assert len(runs) == -(-(-(-total // sp.ROWS_PER_CHUNK)) // run)


@pytest.mark.parametrize("hc,run", [(540, 45), (540, 49), (540, 13), (23, 8),
                                    (23, 2), (4, 8), (1, 1), (5, 1),
                                    (1080, 1000)])
def test_chroma_runs_cover_every_row_once_with_halo_inside(hc, run):
    runs = sp.chroma_runs(hc, run)
    assert runs.dtype == np.int32 and runs.flags.c_contiguous
    assert runs.shape[1] == 4
    seen = np.zeros(hc, int)
    for k0, k1, lo, hi in runs:
        assert k0 % sp.CHROMA_ROWS_PER_CHUNK == 0
        assert 0 < k1 - k0 <= run * sp.CHROMA_ROWS_PER_CHUNK
        seen[k0:k1] += 1
        assert 0 <= lo <= k0 and k1 - 1 <= hi <= hc - 1     # inside the plane
        # exactly the rows the interstitial row filter reads, clamped
        need = {min(max(k + d, 0), hc - 1) for k in range(k0, k1)
                for d in (-1, 0, 1)}
        assert need == set(range(lo, hi + 1))
        # what chunk m reads stays in the window while group m + 1 is there:
        # staged rows 4m - 1 .. 4m + 7 are distinct modulo the window
        assert sp.WINDOW_ROWS >= 2 * sp.CHROMA_ROWS_PER_CHUNK + 1
    assert np.all(seen == 1)
    chunks = -(-hc // sp.CHROMA_ROWS_PER_CHUNK)
    assert len(runs) <= -(-chunks // min(run, chunks))
    sizes = [k1 - k0 for k0, k1, _, _ in runs[:-1]]
    assert len(set(sizes)) <= 1                              # even runs


@pytest.mark.parametrize("n_chunks,slots,waves,want", [
    (34560, 264, 16, 9),           # hscale_u8, batch 256 of 1080 rows
    (8640, 264, 16, 3),            # batch 64
    (34560, 264, 1, 131),          # one block a slot
    (69120, 264, 8, 33),           # fused chroma, batch 256: 2 * 135 a frame
    (17280, 264, 8, 9),            # batch 64
    (270, 264, 8, 2),              # one frame: MIN_RUN
    (1, 264, 1, 1),                # fewer chunks than MIN_RUN
    (1, 264, 8, 1),
])
def test_run_chunks(n_chunks, slots, waves, want):
    run = sp.run_chunks(n_chunks, slots, waves)
    assert run == want
    blocks = -(-n_chunks // run)
    assert blocks <= max(slots * waves, -(-n_chunks // sp.MIN_RUN))


# -- shared memory -----------------------------------------------------------

@pytest.mark.parametrize("shape,hscale,fused", [
    # (ring depth, bytes, blocks an SM) of hscale_u8 and of the fused kernel
    (HEADLINE[0], (3, 64416, 3), (4, 72736, 3)),
    (HEADLINE[1], (2, 63264, 3), (3, 75392, 3)),
    ((3840, 2160, 224, "cubic", 0), (2, 108320, 2), (4, 162848, 1)),
    ((3840, 2160, 1920, "cubic", 0), (2, 230688, 1), (4, 230944, 1)),
])
def test_smem_bytes_equals_the_kernels_layout(shape, hscale, fused):
    w, h, ow, method, taps = shape
    res = _res(tscaler, method, taps, w, ow)
    nw = (res.max_taps + 6) // 4
    row = _a16(w) + 16
    taps_b = _a16(nw * ow * 8)
    for stages in (2, 3, 4):
        # HLayout: taps | ring | two buffers of 8 x ow results
        for elem in (2, 4):
            assert sp.hsmem_bytes(w, ow, nw, stages, elem) == (
                taps_b + stages * 8 * row + 2 * (_a16(8 * ow * elem) + 16))
        # CLayout: taps | ring of 4-row groups | window | chunk | 2 x 2
        # buffers
        chroma = (taps_b + stages * 4 * _a16(w // 2) + 12 * row + 8 * row
                  + 4 * (_a16(4 * ow * 2) + 16))
        assert sp.fused_smem_bytes(w, ow, nw, stages) == max(
            chroma, sp.hsmem_bytes(w, ow, nw, stages, 2))
    p, pf = sp.hplan(res, SCALE_U8), sp.hplan(res, SCALE_U8, fused=True)
    assert (p.nw, pf.nw) == (nw, nw)
    assert (p.stages, p.smem, p.blocks_per_sm) == hscale
    assert (pf.stages, pf.smem, pf.blocks_per_sm) == fused
    assert p.smem == sp.hsmem_bytes(w, ow, nw, p.stages, 4)
    assert pf.smem == sp.fused_smem_bytes(w, ow, nw, pf.stages)
    for plan in (p, pf):        # that many blocks do fit one SM
        assert plan.blocks_per_sm * (plan.smem + 1024) <= 228 * 1024
        assert plan.smem <= sp.SMEM_LIMIT


def test_hplan_is_cached_and_raises_past_the_limit():
    res = _res(tscaler, "lanczos", 0, 70, 33)
    p = sp.hplan(res, SCALE_U8)
    assert sp.hplan(res, SCALE_U8) is p
    assert sp.hplan(res, SCALE_U8, fused=True) is not p
    assert sp.hplan(_res(tscaler, "lanczos", 0, 70, 33), SCALE_U8) is not p
    for table in p.host.values():
        assert table.flags.c_contiguous and table.dtype == np.int32
    cols, packed = sp.pack_h(res, SCALE_U8)
    assert np.array_equal(p.host["hcols"], cols)
    assert np.array_equal(p.host["htaps"], packed)
    wide = _res(tscaler, "cubic", 0, 65536, 32768)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        sp.hplan(wide, SCALE_U8)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        sp.hplan(wide, SCALE_U8, fused=True)


def test_constants_mirror_the_cuda_sources():
    head = (CSRC / "scale2pass.cuh").read_text()
    fused = (CSRC / "fused_ingest.cu").read_text()
    assert "kChromaRowsPerChunk = kRowsPerChunk / 2;" in head
    assert sp.CHROMA_ROWS_PER_CHUNK == sp.ROWS_PER_CHUNK // 2
    assert int(re.search(r"kWindowRows = (\d+);", fused)[1]) == sp.WINDOW_ROWS
    assert max(sp.H_STAGES) <= int(re.search(r"kMaxStages = (\d+);", head)[1])
    assert min(sp.H_STAGES) >= 2
    assert "return align16(static_cast<size_t>(rows) * ow * elem) + 16;" \
        in head
    assert max(sp.H_BLOCKS_PER_SM) == int(
        re.search(r"kHBlocksPerSM = (\d+);", head)[1])


def test_one_h_pass_and_one_copy_of_the_word_filters():
    """The int32 byte loop and its helpers are gone; both h-only kernels and
    the two-pass kernel run the same dot; the up2 word filters live in the
    shared header only."""
    head = (CSRC / "scale2pass.cuh").read_text()
    sources = {n: (CSRC / f"{n}.cu").read_text()
               for n in ("hscale", "fused_ingest", "chroma420")}
    for gone in ("hpass_rows", "stage_span", "load_htables", "htable_bytes"):
        assert gone not in head
        assert all(gone not in s for s in sources.values())
    assert head.count("void hdot8(") == 1 and head.count("hdot8(") == 3
    assert head.count("uint32_t filt31(") == 1
    assert all("filt31(uint32_t" not in s for s in sources.values())
    assert "up2_columns(" in sources["fused_ingest"]
    assert "up2_columns(" in sources["chroma420"]
    assert "up2_row(" in sources["fused_ingest"]
    assert "up2_row(" in sources["chroma420"]


# -- on the card ---------------------------------------------------------------

@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("shape", SHAPES + HEADLINE)
def test_h_only_kernels_match_plain_on_card(cuda, shape, skip):
    """Bulk-copy staging (aligned) and word staging (a view one byte in)."""
    w, h, ow, method, taps = shape
    res = _res(tscaler, method, taps, w, ow)

    def view(p):
        flat = torch.zeros(p.size + 16, dtype=torch.uint8, device=cuda)
        flat[skip:skip + p.size] = torch.as_tensor(p.reshape(-1)).to(cuda)
        return flat[skip:skip + p.size].view(p.shape)

    y, u, v = (view(p) for p in _i420(3, w, h, 66))
    n_h, n_f = thk.hscale_u8.launches, tck.fused_i420_up_hscale.launches
    assert torch.equal(thk.hscale_u8(y, res), thk.hscale_u8_plain(y, res))
    for h_cosited in (False, True):
        for k, p in zip(tck.fused_i420_up_hscale(y, u, v, res, h_cosited),
                        tck.fused_i420_up_hscale_plain(y, u, v, res,
                                                       h_cosited)):
            assert torch.equal(k, p)
    torch.cuda.synchronize()
    assert thk.hscale_u8.launches == n_h + 1
    assert tck.fused_i420_up_hscale.launches == n_f + 2
