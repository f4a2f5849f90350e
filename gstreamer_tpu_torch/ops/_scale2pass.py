"""Host side of the tap-scale kernels (csrc/scale2pass.cuh).

For the two-pass kernels (yscale_hv, scale_hv_u8, chroma420_scale) it makes
everything a block would otherwise work out for itself, once per resampler
pair, in numpy:

* the taps of both passes as byte limbs packed four to a word for ``dp4a``
  (``pack_taps``): ``tap = 256 * hi + lo`` with ``lo`` in 0..255 and ``hi``
  in -128..127, each output's taps shifted so that they start on a word of
  the line they run along; the horizontal ones in an order of the columns
  that keeps a warp's loads off each other's shared-memory banks
  (``column_order``);
* the input rows each tile of output rows reads (``row_table``), compacted,
  and where each output row's vertical window starts in that list;
* for 4:2:0 chroma, the half-resolution rows each chunk of those rows is
  built from (``chroma_table``);
* the tile size, the depth of the staging ring and the block's shared
  memory, sized exactly as the kernel lays it out (``tiling``,
  ``smem_bytes``).

For the h-only kernels (hscale_u8, fused_i420_up_hscale) it makes the same
packed horizontal taps (``pack_h``) and, beside them, how the rows are cut
into blocks: the chunks of 8 rows a block owns (``run_chunks``), the runs of
chroma rows of the fused kernel with the clamped halo rows each stages
(``chroma_runs``), the depth of the ring and the block's shared memory
(``hplan``, ``hsmem_bytes``, ``fused_smem_bytes``).

``emulate`` (two-pass) and ``emulate_hscale`` / ``emulate_fused`` (h-only)
walk those tables the way a block does, in numpy, so that the tables and the
packed arithmetic can be held against the plain versions without a card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

ROWS_PER_CHUNK = 8             # scale2pass.cuh kRowsPerChunk
BANKS = 32                     # 4-byte banks of shared memory, lanes a warp
MAX_TILE_ROWS = 32
STAGES = (3, 2)                # ring depths tried, deepest first
SMEM_TARGET = 112 * 1024       # two blocks on one SM
SMEM_LIMIT = 227 * 1024        # what one Hopper block may use


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _cache(res) -> dict:
    return res.__dict__.setdefault("_cuda_cache", {})


# -- tables of the two-pass kernels (numpy) ----------------------------------

def words_per_column(th: int) -> int:
    """Source words one output column's taps span once its first tap may sit
    on any byte of the first word."""
    return (th + 3 + 3) // 4


def column_order(woff) -> np.ndarray:
    """An order of the output columns in which every run of 32 (a warp of
    the h pass, one column a lane) starts on source words that fall in
    different shared-memory banks as far as the offsets allow: the words of
    a warp's load then cost one pass over the banks, not one per clash.
    Greedy: each run takes one column from each of the fullest banks."""
    woff = np.asarray(woff, np.int64)
    buckets = [list(np.flatnonzero(woff % BANKS == r)) for r in range(BANKS)]
    order = []
    while len(order) < len(woff):
        want = min(BANKS, len(woff) - len(order))
        run = []
        while len(run) < want:
            full = sorted((b for b in buckets if b), key=len, reverse=True)
            run += [b.pop(0) for b in full[:want - len(run)]]
        order += sorted(run)
    return np.asarray(order, np.int64)


def pack_taps(start, taps, order=None):
    """(first int32 [n], packed int32 [nw][n][2]): entry s stands for output
    order[s] (all outputs in turn when order is None), whose taps meet the
    bytes start[.] .. start[.] + T - 1 of a line; it reads the line's words
    first[s] .. first[s] + nw - 1, and packed[q][s] holds the low (u8) and
    high (s8) limbs of the four taps that meet word q, zero where none does."""
    start = np.asarray(start, np.int64)
    taps = np.asarray(taps, np.int64)
    n, t = taps.shape
    nw = words_per_column(t)
    padded = np.zeros((n, 4 * nw), np.int64)
    at = (start & 3)[:, None] + np.arange(t)[None, :]
    padded[np.arange(n)[:, None], at] = taps
    lo = padded & 255
    hi = (padded - lo) >> 8
    assert hi.min() >= -128 and hi.max() <= 127
    if order is None:
        order = np.arange(n)

    def words(b):               # [n][4 nw] bytes -> [nw][n] words
        b = (b[order] & 255).reshape(n, nw, 4)
        w = b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24
        return w.T

    # C order spelled out: stacking transposed views may keep their order
    packed = np.ascontiguousarray(np.stack([words(lo), words(hi)], -1),
                                  np.uint32)
    return (start[order] >> 2).astype(np.int32), packed.view(np.int32)


def pack_h(res, precision: int):
    """(cols int32 [out][2], packed int32 [nw][out][2]), both in
    column_order: entry s stands for output column cols[s][1], which reads
    source words cols[s][0] .. cols[s][0] + nw - 1 of a row (pack_taps)."""
    off = np.asarray(res.offset, np.int64)
    order = column_order(off >> 2)
    first, packed = pack_taps(off, res.taps_s16(precision), order)
    cols = np.stack([first, order], -1).astype(np.int32)
    return np.ascontiguousarray(cols), packed


def hbuf_pitch(n_max: int) -> int:
    """scale2pass.cuh hbuf_pitch: bytes between the columns of the h-pass
    buffer (it is kept column by column, so that the v pass reads along a
    line as the h pass does): room for whole chunks and the zero-tap words
    past the last row, and an odd number of words, so that neighbouring
    columns start in different banks."""
    pitch = (n_max + 7) // 8 * 8 + 8
    return pitch if (pitch // 4) % 2 else pitch + 4


def row_table(v_res, tile: int):
    """(rows int32 [tiles][n_max], count int32 [tiles], vstart int32 [out]):
    rows[t][:count[t]] are the input rows, ascending, that the vertical taps
    of output rows t*tile .. t*tile+tile-1 read; output row r's window is
    entries vstart[r] .. vstart[r] + taps - 1 of its tile's list."""
    off = np.asarray(v_res.offset, np.int64)
    tv, oh = v_res.max_taps, v_res.out_size
    lists = []
    vstart = np.zeros(oh, np.int32)
    for r0 in range(0, oh, tile):
        o = off[r0:r0 + tile]
        need = np.unique(o[:, None] + np.arange(tv)[None, :])
        vstart[r0:r0 + tile] = np.searchsorted(need, o)
        lists.append(need)
    count = np.array([len(x) for x in lists], np.int32)
    rows = np.zeros((len(lists), int(count.max())), np.int32)
    for t, need in enumerate(lists):
        rows[t, :len(need)] = need
        rows[t, len(need):] = need[-1]
    return rows, count, vstart


def chroma_table(rows, count, ch: int, v_cosited: bool):
    """For 4:2:0 chroma, what each chunk of ROWS_PER_CHUNK needed
    full-resolution rows is built from: (crows int32 [tiles][chunks][cr_max],
    cn int32 [tiles][chunks], slots int32 [tiles][n_max]).  Chunk c of tile t
    stages half-resolution rows crows[t][c][:cn[t][c]]; full-resolution row
    rows[t][i] is the up2 row filter of staged rows slots[t][i] & 255 (row
    y >> 1) and slots[t][i] >> 8 (its neighbour, clamped at the edges; the
    row itself where the filter copies)."""
    tiles, n_max = rows.shape
    chunks = (n_max + ROWS_PER_CHUNK - 1) // ROWS_PER_CHUNK
    per = [[None] * chunks for _ in range(tiles)]
    slots = np.zeros((tiles, n_max), np.int32)
    cn = np.zeros((tiles, chunks), np.int32)
    for t in range(tiles):
        for c in range(chunks):
            i0 = c * ROWS_PER_CHUNK
            ys = rows[t, i0:min(i0 + ROWS_PER_CHUNK, int(count[t]))]
            ys = ys.astype(np.int64)
            if not len(ys):
                per[t][c] = ys
                continue
            k = ys >> 1
            below = np.minimum(k + 1, ch - 1)
            above = k if v_cosited else np.maximum(k - 1, 0)
            nb = np.where(ys & 1, below, above)
            staged = np.unique(np.concatenate([k, nb]))
            per[t][c] = staged
            cn[t, c] = len(staged)
            slots[t, i0:i0 + len(ys)] = (np.searchsorted(staged, k)
                                         | np.searchsorted(staged, nb) << 8)
    crows = np.zeros((tiles, chunks, max(int(cn.max()), 1)), np.int32)
    for t in range(tiles):
        for c in range(chunks):
            crows[t, c, :cn[t, c]] = per[t][c]
    return crows, cn, slots


def smem_bytes(in_w: int, ow: int, nw: int, tv: int, tile: int, n_max: int,
               stages: int, cw: int = 0, cr_max: int = 0) -> int:
    """scale2pass.cuh Layout.total: packed h taps | the tile's packed v taps
    | h-pass result (u8, column by column) | the staging ring, and for chroma
    (cw > 0) the up2 buffers."""
    row = _align16(in_w) + 16
    total = (_align16(nw * ow * 8)
             + _align16(words_per_column(tv) * tile * 8)
             + _align16(ow * hbuf_pitch(n_max)))
    if cw:
        return (total + stages * cr_max * _align16(cw) + cr_max * row
                + ROWS_PER_CHUNK * row)
    return total + stages * ROWS_PER_CHUNK * row


@dataclass
class Plan:
    """What one launch of a two-pass kernel needs beside its input."""

    tile_rows: int
    stages: int
    n_max: int
    nw: int                     # words a column's h taps span
    nwv: int                    # words an output row's v taps span
    smem: int
    cw: int = 0                 # chroma: width of the half-resolution plane
    cr_max: int = 0
    chunks: int = 0
    host: dict = field(default_factory=dict)    # name -> numpy table
    dev: dict = field(default_factory=dict)     # what launch() has bound


def tiling(v_res, in_w: int, ow: int, th: int, ch: int = 0, cw: int = 0,
           v_cosited: bool = False):
    """(tile_rows, stages, row tables, chroma tables or None): the largest
    tile of output rows (at most MAX_TILE_ROWS) and the deepest ring whose
    block fits the shared-memory target; failing that, the largest tile
    that fits what a block may use at all, with the shallowest ring."""
    nw, tv = words_per_column(th), v_res.max_taps
    tile = min(MAX_TILE_ROWS, max(1, v_res.out_size))
    fallback = None
    while True:
        rt = row_table(v_res, tile)
        ct = chroma_table(rt[0], rt[1], ch, v_cosited) if cw else None
        cr_max = ct[0].shape[2] if cw else 0
        for stages in STAGES:
            need = smem_bytes(in_w, ow, nw, tv, tile, rt[0].shape[1], stages,
                              cw, cr_max)
            if need <= SMEM_TARGET:
                return tile, stages, rt, ct
        if fallback is None and need <= SMEM_LIMIT:
            fallback = (tile, stages, rt, ct)
        if tile == 1:
            if fallback is not None:
                return fallback
            raise ValueError(
                f"scale of width {in_w}->{ow} with {th}x{tv} taps needs "
                f"{need} bytes of shared memory per block, more than "
                f"{SMEM_LIMIT}")
        tile = (tile + 1) // 2


def plan(h_res, v_res, precision: int, ch: int = 0, cw: int = 0,
         v_cosited: bool = False) -> Plan:
    """The tables and sizes of scaling with (h_res, v_res): a stored plane,
    or 4:2:0 chroma of (ch, cw) half-resolution samples when cw > 0.  Cached
    on v_res."""
    key = ("plan", id(h_res), precision, ch, cw, bool(v_cosited))
    cache = _cache(v_res)
    hit = cache.get(key)
    if hit is not None and hit[0] is h_res:
        return hit[1]
    in_w, ow, th = h_res.in_size, h_res.out_size, h_res.max_taps
    tile, stages, (rows, count, vstart), ct = tiling(
        v_res, in_w, ow, th, ch, cw, v_cosited)
    cols, packed = pack_h(h_res, precision)
    vword, vpacked = pack_taps(vstart, v_res.taps_s16(precision))
    host = {"hcols": cols, "htaps": packed, "vword": vword,
            "vtaps": vpacked, "rows": rows, "count": count}
    p = Plan(tile_rows=tile, stages=stages, n_max=rows.shape[1],
             nw=packed.shape[0], nwv=vpacked.shape[0], smem=0, cw=cw,
             host=host)
    if cw:
        host["crows"], host["cn"], host["slots"] = ct
        p.cr_max, p.chunks = ct[0].shape[2], ct[0].shape[1]
    for k, v in host.items():      # the kernel indexes them as C arrays
        host[k] = np.ascontiguousarray(v)
    p.smem = smem_bytes(in_w, ow, p.nw, v_res.max_taps, tile, p.n_max,
                        stages, cw, p.cr_max)
    cache[key] = (h_res, p)
    return p


def launch(source: str, symbol: str, x: torch.Tensor, out: torch.Tensor,
           h_res, v_res, precision: int, batch: int, sitings=None) -> None:
    """Launch the two-pass kernel `symbol` of csrc/<source>.cu on x's device
    and current stream; raises on a CUDA error.  `sitings` = (h_cosited,
    v_cosited) selects the chroma entry's argument list.  The tables go to
    the device, and the C function is bound, once per plan and device."""
    from . import _build
    in_w, in_h = h_res.in_size, v_res.in_size
    ch, cw = ((in_h + 1) // 2, (in_w + 1) // 2) if sitings else (0, 0)
    p = plan(h_res, v_res, precision, ch, cw, bool(sitings and sitings[1]))
    key = (str(x.device), symbol, bool(sitings and sitings[0]))
    bound = p.dev.get(key)
    if bound is None:
        dev = {k: torch.as_tensor(v).to(x.device) for k, v in p.host.items()}
        ptrs = [dev[k].data_ptr() for k in ("hcols", "htaps", "vword",
                                            "vtaps", "rows", "count")]
        ints = [in_w, v_res.out_size, h_res.out_size, p.nw, p.nwv,
                precision, p.tile_rows, p.n_max, p.stages, p.smem]
        if sitings:
            ptrs += [dev[k].data_ptr() for k in ("crows", "cn", "slots")]
            ints = [ch, cw] + ints + [int(bool(sitings[0])),
                                      int(bool(sitings[1])), p.cr_max,
                                      p.chunks]
        else:
            ints = [in_h] + ints
        lib, fn = _build.function(
            source, symbol,
            "pp" + "p" * len(ptrs) + "i" * (1 + len(ints)) + "p")
        bound = p.dev[key] = (lib, fn, dev, tuple(ptrs), tuple(ints))
    lib, fn, _, ptrs, ints = bound
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), out.data_ptr(), *ptrs, batch, *ints, stream)
    _build.check(lib, status, symbol)


# -- the h-only kernels: packed taps, partition, shared memory ---------------

CHROMA_ROWS_PER_CHUNK = ROWS_PER_CHUNK // 2    # kChromaRowsPerChunk
WINDOW_ROWS = 12               # fused_ingest.cu kWindowRows
H_STAGES = (4, 3, 2)           # ring depths tried, deepest first
H_BLOCKS_PER_SM = (3, 2, 1)    # blocks an SM tried, most first
SM_SMEM = 228 * 1024           # shared memory of one Hopper SM; a resident
BLOCK_RESERVE = 1024           # block takes this much of it beside its own
MIN_RUN = 2                    # fewest chunks a block owns
HSCALE_WAVES = 16              # blocks a slot of the card takes in turn:
FUSED_WAVES = 2                # stored rows; the fused kernel's chroma rows


def out_span_bytes(rows: int, ow: int, elem: int) -> int:
    """scale2pass.cuh out_span_bytes: one buffer of rows x ow results of
    elem bytes, with room to start at any 16-byte phase."""
    return _align16(rows * ow * elem) + 16


def hsmem_bytes(in_w: int, ow: int, nw: int, stages: int, elem: int) -> int:
    """scale2pass.cuh HLayout.total: packed h taps | ring of `stages` chunks
    | two buffers of a chunk's results (elem bytes each)."""
    return (_align16(nw * ow * 8)
            + stages * ROWS_PER_CHUNK * (_align16(in_w) + 16)
            + 2 * out_span_bytes(ROWS_PER_CHUNK, ow, elem))


def fused_smem_bytes(in_w: int, ow: int, nw: int, stages: int) -> int:
    """fused_ingest.cu smem_total: the larger of its luma block (HLayout,
    int16 out) and its chroma block (CLayout: packed h taps | ring of
    `stages` groups of 4 half-resolution rows | window of column-filtered
    rows | the chunk's 8 finished rows | two buffers of results, even and
    odd apart)."""
    row = _align16(in_w) + 16
    chroma = (_align16(nw * ow * 8)
              + stages * CHROMA_ROWS_PER_CHUNK * _align16(in_w // 2)
              + WINDOW_ROWS * row + ROWS_PER_CHUNK * row
              + 4 * out_span_bytes(CHROMA_ROWS_PER_CHUNK, ow, 2))
    return max(hsmem_bytes(in_w, ow, nw, stages, 2), chroma)


def run_chunks(n_chunks: int, slots: int, waves: int) -> int:
    """Chunks a block owns when n_chunks are spread over `waves` blocks for
    each of the card's `slots` (blocks it runs at a time), in runs of at
    least MIN_RUN chunks."""
    return max(min(MIN_RUN, n_chunks), -(-n_chunks // (slots * waves)), 1)


def row_runs(total_rows: int, run: int) -> np.ndarray:
    """int32 [blocks][2]: (first row, rows) of each block of an h-only
    launch over total_rows consecutive rows, `run` chunks a block."""
    step = run * ROWS_PER_CHUNK
    first = np.arange(0, total_rows, step)
    return np.stack([first, np.minimum(step, total_rows - first)],
                    -1).astype(np.int32)


def chroma_runs(hc: int, run: int) -> np.ndarray:
    """int32 [runs][4], (k0, k1, lo, hi) of each run a chroma plane of hc
    rows is cut into, at most `run` chunks of CHROMA_ROWS_PER_CHUNK rows
    each and as even as that allows: the block builds rows k0 .. k1-1 and
    stages rows lo .. hi for them, one halo row each side, clamped."""
    chunks = -(-hc // CHROMA_ROWS_PER_CHUNK)
    runs = -(-chunks // run)
    step = -(-chunks // runs) * CHROMA_ROWS_PER_CHUNK
    k0 = np.arange(0, hc, step)
    k1 = np.minimum(k0 + step, hc)
    return np.ascontiguousarray(np.stack(
        [k0, k1, np.maximum(k0 - 1, 0), np.minimum(k1, hc - 1)], -1),
        np.int32)


@dataclass
class HPlan:
    """What a launch of an h-only kernel needs beside its input."""

    nw: int                     # words a column's h taps span
    stages: int
    smem: int
    blocks_per_sm: int
    host: dict = field(default_factory=dict)    # name -> numpy table
    dev: dict = field(default_factory=dict)     # device -> tensors on it


def hplan(res, precision: int, fused: bool = False) -> HPlan:
    """The packed taps, ring depth and shared memory of h-scaling with
    `res` (hscale_u8, or the fused ingest when `fused`): the most blocks an
    SM can hold at a time (of H_BLOCKS_PER_SM) with a ring of at least two
    chunks, and the deepest ring that many blocks leave room for.  Cached on
    res."""
    key = ("hplan", precision, bool(fused))
    cache = _cache(res)
    if key in cache:
        return cache[key]
    in_w, ow = res.in_size, res.out_size
    nw = words_per_column(res.max_taps)

    def need(stages):
        return (fused_smem_bytes(in_w, ow, nw, stages) if fused
                else hsmem_bytes(in_w, ow, nw, stages, 4))

    for blocks in H_BLOCKS_PER_SM:
        room = min(SM_SMEM // blocks - BLOCK_RESERVE, SMEM_LIMIT)
        stages = next((n for n in H_STAGES if need(n) <= room), None)
        if stages is not None:
            break
    else:
        raise ValueError(
            f"h-scale of width {in_w}->{ow} with {res.max_taps} taps needs "
            f"{need(min(H_STAGES))} bytes of shared memory per block, more "
            f"than {SMEM_LIMIT}")
    cols, packed = pack_h(res, precision)
    p = HPlan(nw=nw, stages=stages, smem=need(stages), blocks_per_sm=blocks,
              host={"hcols": cols, "htaps": packed})
    cache[key] = p
    return p


def on_device(p: HPlan, device, name: str, make=None) -> torch.Tensor:
    """Table `name` of the plan on `device`, sent there once; `make()`
    gives a table the plan does not hold yet."""
    dev = p.dev.setdefault(str(device), {})
    if name not in dev:
        if name not in p.host:
            p.host[name] = np.ascontiguousarray(make())
        dev[name] = torch.as_tensor(p.host[name]).to(device)
    return dev[name]


def slots(p: HPlan, device) -> int:
    """Blocks of the plan's kernel the card runs at a time."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * p.blocks_per_sm


# -- the block loop in numpy: tables and packed arithmetic, no card ----------

def _bytes_of(words):
    w = np.asarray(words, np.uint32)
    return np.stack([(w >> s) & 255 for s in (0, 8, 16, 24)], -1
                    ).reshape(w.shape[:-1] + (-1,)).astype(np.int64)


def _avg(a, b, up: int = 1):
    """__vavgu4: (a + b + 1) >> 1 per byte of packed words; with up=0
    __vhaddu4: (a + b) >> 1."""
    ab, bb = _bytes_of(a[..., None]), _bytes_of(b[..., None])
    r = ((ab + bb + up) >> 1).astype(np.uint32)
    return r[..., 0] | r[..., 1] << 8 | r[..., 2] << 16 | r[..., 3] << 24


def _filt31(a, b):
    """(3a + b + 2) >> 2 per byte of packed words, as the kernel does it:
    the rounded-up average of a and the rounded-down average of a and b."""
    return _avg(a, _avg(a, b, 0))


def _words(rows_u8, n_words):
    """u8 rows [..., n] as little-endian words [..., n_words], zero padded."""
    pad = 4 * n_words - rows_u8.shape[-1]
    b = np.pad(rows_u8, [(0, 0)] * (rows_u8.ndim - 1) + [(0, pad)])
    return np.ascontiguousarray(b).view(np.uint32)


def _up2_h_words(c_words, cw, cosited):
    """The kernel's up2 column filter on packed words: [n][cwords] chroma
    words -> [n][2 cwords] full-width words."""
    w = c_words.copy()
    cwords = w.shape[-1]
    t = cw - 4 * (cwords - 1)                   # valid bytes of the last word
    last = (w[..., -1] >> np.uint32(8 * (t - 1))) & np.uint32(255)
    if t < 4:
        keep = np.uint32((1 << (8 * t)) - 1)
        w[..., -1] = (w[..., -1] & keep) | (last * np.uint32(0x01010101)
                                            & ~keep)
    prev_b = np.concatenate([w[..., :1] & np.uint32(255), w[..., :-1] >> 24],
                            -1)
    next_b = np.concatenate([w[..., 1:] & np.uint32(255), last[..., None]],
                            -1)
    p = (w << 8) | prev_b
    n = (w >> 8) | (next_b << 24)
    if cosited:
        e, o = w, _avg(w, n)
    else:
        e, o = _filt31(w, p), _filt31(w, n)
    eb, ob = _bytes_of(e[..., None]), _bytes_of(o[..., None])
    full = np.stack([eb, ob], -1).reshape(w.shape[:-1] + (-1,))
    return _words(full.astype(np.uint8), 2 * cwords)


def _packed_dot(lines, first, packed, precision):
    """The kernel's dp4a pass: lines [..., words] uint32; entry s reads
    words first[s] .. + nw - 1 against packed[:, s] -> [..., n] in 0..255."""
    nw = packed.shape[0]
    lo_b = _bytes_of(np.ascontiguousarray(packed[..., 0].T).view(np.uint32))
    hi_b = _bytes_of(np.ascontiguousarray(packed[..., 1].T).view(np.uint32))
    hi_b = np.where(hi_b > 127, hi_b - 256, hi_b)
    idx = np.asarray(first)[:, None] + np.arange(nw)[None, :]     # [n][nw]
    px = _bytes_of(lines[..., idx])                               # [...][n][4 nw]
    acc = ((px * hi_b).sum(-1) << 8) + (px * lo_b).sum(-1)
    return np.clip((acc + (1 << precision) - 1) >> precision, 0, 255)


def emulate(x: torch.Tensor, h_res, v_res, precision: int, sitings=None):
    """What the two-pass kernel computes, block by block, from the same
    tables (CPU, numpy inside): (B, H, W) uint8, or (B, ch, cw) chroma with
    `sitings` = (h_cosited, v_cosited), -> (B, oh, ow) int32."""
    src = x.numpy()
    in_w, in_h = h_res.in_size, v_res.in_size
    ch, cw = ((in_h + 1) // 2, (in_w + 1) // 2) if sitings else (0, 0)
    p = plan(h_res, v_res, precision, ch, cw, bool(sitings and sitings[1]))
    t = p.host
    ow, oh = h_res.out_size, v_res.out_size
    rwords = (_align16(in_w) + 16) // 4
    pitch = hbuf_pitch(p.n_max)
    out = np.zeros((src.shape[0], oh, ow), np.int32)
    for tile in range(len(t["count"])):
        n = int(t["count"][tile])
        hbuf = np.zeros((src.shape[0], ow, pitch), np.uint8)
        for c0 in range(0, n, ROWS_PER_CHUNK):
            ids = t["rows"][tile, c0:min(c0 + ROWS_PER_CHUNK, n)]
            if sitings:
                c = c0 // ROWS_PER_CHUNK
                staged = t["crows"][tile, c, :t["cn"][tile, c]]
                hc = _up2_h_words(_words(src[:, staged], (cw + 3) // 4), cw,
                                  sitings[0])
                sl = t["slots"][tile, c0:c0 + len(ids)]
                a, b = hc[:, sl & 255], hc[:, sl >> 8]
                rows = _avg(a, b) if sitings[1] else _filt31(a, b)
                rows = np.pad(rows, [(0, 0), (0, 0),
                                     (0, rwords - rows.shape[-1])])
            else:
                rows = _words(src[:, ids], rwords)
            h = _packed_dot(rows, t["hcols"][:, 0], t["htaps"], precision)
            hbuf[:, t["hcols"][:, 1], c0:c0 + len(ids)] = np.moveaxis(h, 1, 2)
        r0 = tile * p.tile_rows
        r1 = min(r0 + p.tile_rows, oh)
        v = _packed_dot(hbuf.view(np.uint32), t["vword"][r0:r1],
                        t["vtaps"][:, r0:r1], precision)       # [B][ow][rows]
        out[:, r0:r1] = np.moveaxis(v, 1, 2)
    return torch.as_tensor(out)


def _chunk_dot(flat_words, stride_w, cols, packed, precision):
    """hpass_store over one chunk: flat_words [B][words] holds 8 rows
    stride_w words apart -> [B][8][ow], output columns in natural order."""
    out = np.zeros(flat_words.shape[:1] + (ROWS_PER_CHUNK, len(cols)),
                   np.int64)
    for k in range(ROWS_PER_CHUNK):
        out[:, k, cols[:, 1]] = _packed_dot(
            flat_words, k * stride_w + cols[:, 0], packed, precision)
    return out


def _stage(rows_u8, stride, aligned, rng):
    """A ring slot after stage_run: rows_u8 [B][n][len] land len apart when
    `aligned` (one bulk copy) else `stride` apart; every other byte of the
    slot is whatever was there (random here) -> [B][words]."""
    b, n, length = rows_u8.shape
    slot = rng.integers(0, 256, (b, ROWS_PER_CHUNK * (_align16(length) + 16)),
                        dtype=np.uint8)
    step = length if aligned else stride
    for k in range(n):
        slot[:, k * step:k * step + length] = rows_u8[:, k]
    return np.ascontiguousarray(slot).view(np.uint32), step // 4


def _emulate_hrun(rows_u8, p: HPlan, precision, aligned, rng):
    """scale2pass.cuh hrun over rows_u8 [n][len] -> [n][ow] int64."""
    n, in_w = rows_u8.shape
    cols, packed = p.host["hcols"], p.host["htaps"]
    out = np.zeros((n, len(cols)), np.int64)
    for r0 in range(0, n, ROWS_PER_CHUNK):
        chunk = rows_u8[None, r0:r0 + ROWS_PER_CHUNK]
        words, stride_w = _stage(chunk, _align16(in_w) + 16, aligned, rng)
        res = _chunk_dot(words, stride_w, cols, packed, precision)[0]
        out[r0:r0 + chunk.shape[1]] = res[:chunk.shape[1]]
    return out


def emulate_hscale(x: torch.Tensor, res, precision: int, n_slots: int = 3,
                   aligned: bool = True, seed: int = 0) -> torch.Tensor:
    """What csrc/hscale.cu computes, block by block, from the same tables
    (CPU, numpy inside): (..., H, W) uint8 -> (..., H, ow) int32.
    `aligned` picks the staging (one bulk copy a chunk, or word by word);
    bytes of a ring slot that no copy writes are random."""
    rng = np.random.default_rng(seed)
    in_w, ow = res.in_size, res.out_size
    aligned = aligned and in_w % 16 == 0
    src = x.numpy().reshape(-1, in_w)
    p = hplan(res, precision)
    run = run_chunks(-(-len(src) // ROWS_PER_CHUNK), n_slots, HSCALE_WAVES)
    out = np.full((len(src), ow), -1, np.int64)
    for r0, n in row_runs(len(src), run):
        out[r0:r0 + n] = _emulate_hrun(src[r0:r0 + n], p, precision, aligned,
                                       rng)
    return torch.as_tensor(out.astype(np.int32)).reshape(
        tuple(x.shape[:-1]) + (ow,))


def emulate_fused(y, u, v, res, h_cosited: bool, precision: int,
                  n_slots: int = 3, aligned: bool = True, seed: int = 0):
    """What csrc/fused_ingest.cu computes, block by block, from the same
    tables (CPU, numpy inside): y (B, H, W), u, v (B, H/2, W/2) uint8 ->
    (Y, U_even, U_odd, V_even, V_odd) int16."""
    rng = np.random.default_rng(seed)
    b, in_h, in_w = y.shape
    hc, wc, ow = in_h // 2, in_w // 2, res.out_size
    p = hplan(res, precision, fused=True)
    cols, packed = p.host["hcols"], p.host["htaps"]
    y_run = run_chunks(-(-b * in_h // ROWS_PER_CHUNK), n_slots, HSCALE_WAVES)
    c_run = run_chunks(2 * b * -(-hc // CHROMA_ROWS_PER_CHUNK), n_slots,
                       FUSED_WAVES)
    rs = _align16(in_w) + 16
    cs, cwords = _align16(wc), (wc + 3) // 4

    ysrc = y.numpy().reshape(-1, in_w)
    oy = np.full((b * in_h, ow), -1, np.int64)
    for r0, n in row_runs(len(ysrc), y_run):
        oy[r0:r0 + n] = _emulate_hrun(ysrc[r0:r0 + n], p, precision,
                                      aligned and in_w % 16 == 0, rng)
    outs = [oy.reshape(b, in_h, ow)]
    for plane in (u.numpy(), v.numpy()):
        even = np.full((b, hc, ow), -1, np.int64)
        odd = np.full((b, hc, ow), -1, np.int64)
        for k0, k1, lo, hi in chroma_runs(hc, c_run):
            n_staged = hi - lo + 1
            n_out = -(-(k1 - k0) // CHROMA_ROWS_PER_CHUNK)
            window = rng.integers(0, 2 ** 32, (b, WINDOW_ROWS, rs // 4),
                                  dtype=np.uint32)

            def columns(g):         # up2_columns of group g into the window
                i0 = g * CHROMA_ROWS_PER_CHUNK
                if i0 >= n_staged:
                    return
                rows = plane[:, lo + i0:lo + min(i0 + CHROMA_ROWS_PER_CHUNK,
                                                 n_staged)]
                slot = rng.integers(0, 256, (b, rows.shape[1], cs),
                                    dtype=np.uint8)    # rows cs apart
                slot[..., :wc] = rows
                full = _up2_h_words(slot.view(np.uint32)[..., :cwords], wc,
                                    h_cosited)
                for i in range(rows.shape[1]):
                    window[:, (i0 + i) % WINDOW_ROWS, :full.shape[-1]] = \
                        full[:, i]

            columns(0)
            for m in range(n_out):
                columns(m + 1)
                kc0 = k0 + m * CHROMA_ROWS_PER_CHUNK
                nk = min(CHROMA_ROWS_PER_CHUNK, k1 - kc0)
                chunk = rng.integers(0, 2 ** 32, (b, ROWS_PER_CHUNK, rs // 4),
                                     dtype=np.uint32)
                for k in range(2 * nk):             # up2_row
                    kc = kc0 + (k >> 1)
                    nb = min(kc + 1, hc - 1) if k & 1 else max(kc - 1, 0)
                    chunk[:, k] = _filt31(
                        window[:, (kc - lo) % WINDOW_ROWS],
                        window[:, (nb - lo) % WINDOW_ROWS])
                res8 = _chunk_dot(chunk.reshape(b, -1), rs // 4, cols, packed,
                                  precision)
                even[:, kc0:kc0 + nk] = res8[:, 0:2 * nk:2]
                odd[:, kc0:kc0 + nk] = res8[:, 1:2 * nk:2]
        outs += [even, odd]
    return tuple(torch.as_tensor(o.astype(np.int16)) for o in outs)


def check_plane(x: torch.Tensor, shape_hw, what: str) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"{what}: expected uint8, got {x.dtype}")
    if x.ndim < 2 or tuple(x.shape[-2:]) != tuple(shape_hw):
        raise ValueError(f"{what}: expected (..., {shape_hw[0]}, "
                         f"{shape_hw[1]}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
