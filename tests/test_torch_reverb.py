"""freeverb and removesilence: the port's two per-sample recursions.

freeverb: the plain version of ``ops/freeverb_kernel.py`` (and so the
element on the CPU) equals the scalar float32 gold of gstfreeverb.c
(``tests/test_freeverb.py::GoldFreeverb``, here extended to stereo input)
bit for bit at 8, 44.1 and 48 kHz, mono and stereo, S16 and F32.  The JAX
package's scan lets XLA contract its multiply-adds, so it is held to the
JAX package's own tolerance (F32 ``atol=2e-5``, S16 1 LSB; ``-s`` prints the
largest distance).  removesilence: the VAD's power and states, the dropped
buffers, squashed timestamps and bus messages equal the JAX package's.  Both
continue mid-stream from the JAX package's state through ``interop``.  The
kernels themselves run only on the card: those cases skip without one.
What the CPU can check of them is their arithmetic: ``block_model`` walks
``csrc/freeverb.cu``'s block-pipelined schedule in numpy and equals the
plain version bit for bit, and the VAD kernel's identities and its
three-phase loop hold against the plain version.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch

import gstreamer_tpu_torch
from gstreamer_tpu_torch import interop
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements.removesilence import Vad
from gstreamer_tpu_torch.ops import _build
from gstreamer_tpu_torch.ops import freeverb_kernel as fk
from gstreamer_tpu_torch.ops import vad_kernel as vk

from test_freeverb import F, GoldFreeverb
from test_removesilence import gold_vad_power
from test_torch_audiofx import both, desc_of, pushes

RATES = (8000, 44100, 48000)


class StereoGold(GoldFreeverb):
    """GoldFreeverb with gstfreeverb.c's stereo input (:700):
    in1 = (in + DC) * gain a channel."""

    def process_stereo(self, xs):
        out = np.zeros((len(xs), 2), np.float32)
        for k, (vl, vr) in enumerate(xs):
            in2l, in2r = F(vl), F(vr)
            in1l = F((in2l + fk.DC_OFFSET) * fk.FIXED_GAIN)
            in1r = F((in2r + fk.DC_OFFSET) * fk.FIXED_GAIN)
            ol = orr = F(0.0)
            for c in self.combL:
                ol = F(ol + self._comb_process(c, in1l))
            for c in self.combR:
                orr = F(orr + self._comb_process(c, in1r))
            for a in self.apL:
                ol = self._ap_process(a, ol)
            for a in self.apR:
                orr = self._ap_process(a, orr)
            ol = F(ol - fk.DC_OFFSET)
            orr = F(orr - fk.DC_OFFSET)
            out[k, 0] = F(ol * self.wet1 + orr * self.wet2 + in2l * self.dry)
            out[k, 1] = F(orr * self.wet1 + ol * self.wet2 + in2r * self.dry)
        return out


def gold_out(x, rate, **props):
    """The gold over (frames, 1 or 2) samples of the element's format."""
    g = StereoGold(rate, **props)
    xf = x.astype(np.float32)
    out = (g.process_mono(xf[:, 0]) if x.shape[1] == 1
           else g.process_stereo(xf))
    if x.dtype == np.int16:
        out = np.clip(out, -32768, 32767).astype(np.int16)
    return out


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _cat(samples):
    return np.concatenate([np.asarray(s.buffer.data) for s in samples])


def freeverb_pushes(fmt, ch, rate, frames=600, ticks=2, seed=0):
    scale = 0.25 if fmt == "S16LE" else 1.0
    return pushes(fmt, ch, ticks=ticks, seed=seed, frames=frames, rate=rate,
                  scale=scale)


# -- freeverb -----------------------------------------------------------------

@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("fmt", ["F32LE", "S16LE"])
def test_freeverb_plain_equals_scalar_gold(rate, ch, fmt):
    """The element on the CPU (the kernel's plain version), two pushes with
    the state carried: the gold's bits."""
    props = dict(room_size=0.6, damping=0.3, width=0.8, level=0.4)
    bufs = freeverb_pushes(fmt, ch, rate)
    pipe = gstreamer_tpu_torch.parse_launch(desc_of(
        fmt, ch, "freeverb room-size=0.6 damping=0.3 width=0.8 level=0.4",
        rate), device="cpu")
    src = pipe.get_by_name("in")
    for b in bufs:
        src.push_buffer(Buffer(**b))
    src.end_of_stream()
    before = fk.freeverb.launches
    pipe.run()
    out, sink = [], pipe.get_by_name("out")
    while (s := sink.pull_sample()) is not None:
        out.append(s.buffer.data.numpy())
    want = gold_out(np.concatenate([b["data"] for b in bufs]), rate, **props)
    assert same_bits(np.concatenate(out), want)
    assert fk.freeverb.launches == before            # CPU: no launch


def test_plain_version_streams_and_defaults():
    """Three streams in one call equal three calls of one stream; the
    default parameters give the gold of tests/test_freeverb.py."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 500, 1)) * 0.3).astype(np.float32)
    sizes = fk.ring_sizes(44100)
    prm = fk.params(0.5, 0.2, 1.0, 0.5)
    st = fk.fresh_state(3, sizes, "cpu")
    out = fk.freeverb(torch.from_numpy(x), st, sizes, prm).numpy()
    for k in range(3):
        assert same_bits(out[k], GoldFreeverb(44100).process_mono(x[k, :, 0]))


@pytest.mark.parametrize("fmt,ch,rate", [("F32LE", 1, 44100),
                                         ("F32LE", 2, 48000),
                                         ("S16LE", 2, 8000),
                                         ("S16LE", 1, 48000)])
def test_freeverb_against_jax_package(fmt, ch, rate):
    ref, out, _ = both(desc_of(fmt, ch, "freeverb room-size=0.7", rate),
                       freeverb_pushes(fmt, ch, rate, frames=3000, ticks=2),
                       exact=False)
    got, want = _cat(out).astype(np.float64), _cat(ref).astype(np.float64)
    assert got.shape == want.shape
    dist = np.abs(got - want)
    print(f"freeverb {fmt} {ch} ch {rate} Hz: {int((dist > 0).sum())} of "
          f"{dist.size} samples differ from the JAX package, max {dist.max()}")
    assert dist.max() <= (1 if fmt == "S16LE" else 2e-5)


def test_ring_sizes_match_reference():
    from gstreamer_tpu.elements.freeverb import Freeverb as JFreeverb
    from gstreamer_tpu.audio.info import AudioInfo as JAudioInfo
    for rate in (1, 8000, 22050, 44100, 48000, 96000, 192000):
        j = JFreeverb()
        j._info = JAudioInfo(format="F32LE", rate=rate, channels=2)
        cl, cr, al, ar = j._sizes()
        assert fk.ring_sizes(rate) == cl + cr + al + ar
        assert fk.params(0.6, 0.3, 0.8, 0.4) == tuple(
            F(v) for v in JFreeverb(**{"room-size": 0.6, "damping": 0.3,
                                       "width": 0.8, "level": 0.4})._params())
    # the rings the kernel keeps in shared memory: all 24 to 48 kHz, the
    # allpasses to 384 kHz, none above
    assert [fk.schedule(fk.ring_sizes(r))["shared"]
            for r in (1, 48000, 96000, 384000, 768000)] == [2, 2, 1, 1, 0]


def test_schedule_from_layout():
    """Block and chunk lengths come from the ring lengths: a block is at
    most half the shortest comb ring (lag 2) or a single frame when that
    ring is one float (lag 1); a chunk is the shortest allpass ring."""
    want = {1: (1, 1, 1), 100: (1, 2, 1), 1000: (12, 2, 5),
            8000: (101, 2, 40), 48000: (512, 2, 244),
            192000: (512, 2, 979)}
    for rate, (block, lag, chunk) in want.items():
        sc = fk.schedule(fk.ring_sizes(rate))
        assert (sc["block"], sc["lag"], sc["chunk"]) == (block, lag, chunk)
        assert sc["pitch"] % 32 == 4 and sc["pitch"] >= block


def block_model(x, rings, idx, fs, sizes, prm):
    """A numpy walk of csrc/freeverb.cu's schedule over one stream, in one
    order its barriers allow: (frames, 1 or 2) float32 -> (frames, 2);
    `rings`, `idx`, `fs` (numpy) updated in place.  Two slots of block
    buffers (windows, comb inputs, comb sums); the consumers stage block
    b + lag's slot after writing block b back; the comb warp's chains read
    and overwrite a slot's windows; the allpasses run a chunk at a time.
    Every ring position needs at most one wrap, as the kernel assumes."""
    f32 = np.float32
    feedback, damp1, damp2, wet1, wet2, dry = (f32(v) for v in prm)
    dc, gain = fk.DC_OFFSET, fk.FIXED_GAIN
    sc = fk.schedule(sizes)
    B, lag, C = sc["block"], sc["lag"], sc["chunk"]
    lay = fk.layout(sizes).astype(np.int64)
    off, size = lay[:fk.N_RINGS], lay[fk.N_RINGS:2 * fk.N_RINGS]
    coff, csize = off[:16, None], size[:16, None]
    aoff, asize = off[16:, None], size[16:, None]
    n, ch = x.shape
    nblocks = -(-n // B)
    slots = [{"win": np.zeros((16, B), f32), "in": np.zeros((2, B), f32),
              "sum": np.zeros((2, B), f32)} for _ in range(2)]
    sb = idx[:16, None].astype(np.int64)      # next block staged
    wb = sb.copy()                            # next block written back
    ab = idx[16:, None].astype(np.int64)      # next allpass chunk
    out = np.empty((n, 2), f32)

    def wrap(pos, sz):
        assert (pos < 2 * sz).all()
        return np.where(pos >= sz, pos - sz, pos)

    def frames(b):
        return b * B + np.arange(min(B, n - b * B))

    def stage(b):
        nonlocal sb
        t = frames(b)
        nb, sl = len(t), slots[b & 1]
        if ch == 2:
            sl["in"][:, :nb] = ((x[t] + dc) * gain).T
        else:
            sl["in"][:, :nb] = (x[t, 0] * f32(2.0) + dc) * gain
        win = rings[coff + wrap(sb + np.arange(nb), csize)]
        sl["win"][:, :nb] = win
        for c in range(2):
            v = np.zeros(nb, f32)
            for k in range(8):
                v = v + win[8 * c + k]
            sl["sum"][c, :nb] = v
        sb = wrap(sb + nb, csize)

    def combs(b):                             # the comb warp
        sl = slots[b & 1]
        ins = sl["in"][[0] * 8 + [1] * 8]
        for f in range(len(frames(b))):
            fs[:] = sl["win"][:, f] * damp2 + fs * damp1
            sl["win"][:, f] = ins[:, f] + fs * feedback

    def write_back(b):
        nonlocal wb
        nb = len(frames(b))
        rings[coff + wrap(wb + np.arange(nb), csize)] = \
            slots[b & 1]["win"][:, :nb]
        wb = wrap(wb + nb, csize)

    def finish(b):
        nonlocal ab
        t = frames(b)
        sl = slots[b & 1]
        for f0 in range(0, len(t), C):
            j = np.arange(min(C, len(t) - f0))
            pos = aoff + wrap(ab + j, asize)
            bo = rings[pos]                   # every ring read first
            v = sl["sum"][:, f0 + j].copy()
            for a in range(4):
                o = bo[[a, 4 + a]] - v
                rings[pos[[a, 4 + a]]] = v + bo[[a, 4 + a]] * f32(0.5)
                v = o
            v = v - dc
            in2 = x[t[f0 + j]] if ch == 2 else x[t[f0 + j]][:, [0, 0]]
            out[t[f0 + j], 0] = v[0] * wet1 + v[1] * wet2 + in2[:, 0] * dry
            out[t[f0 + j], 1] = v[1] * wet1 + v[0] * wet2 + in2[:, 1] * dry
            ab = wrap(ab + len(j), asize)

    for b in range(min(lag, nblocks)):
        stage(b)
    for b in range(nblocks):
        combs(b)
        write_back(b)
        if lag == 1 and b + 1 < nblocks:
            stage(b + 1)
        finish(b)
        if lag == 2 and b + 2 < nblocks:
            stage(b + 2)
    idx[:] = (idx.astype(np.int64) + n) % size
    return out


MODEL_RATES = (1, 100, 1000, 8000, 44100, 48000, 96000, 192000)


@pytest.mark.parametrize("rate", MODEL_RATES)
@pytest.mark.parametrize("ch", [1, 2])
def test_block_schedule_equals_plain(rate, ch):
    """The kernel's schedule, walked in numpy at the block and chunk
    lengths it derives from the layout, equals the plain version bit for
    bit: two pushes (1200 then 777 frames, neither a multiple of a block)
    with the state carried — outputs, rings, indices and filterstores."""
    rng = np.random.default_rng(rate * 3 + ch)
    sizes = fk.ring_sizes(rate)
    prm = fk.params(0.6, 0.3, 0.8, 0.4)
    pst = fk.fresh_state(1, sizes, "cpu")
    mst = {k: v[0].numpy().copy() for k, v in pst.items()}
    for frames in (1200, 777):
        x = (rng.standard_normal((frames, ch)) * 0.3).astype(np.float32)
        want = fk.freeverb_plain(torch.from_numpy(x[None]), pst, sizes,
                                 prm)[0].numpy()
        got = block_model(x, mst["rings"], mst["idx"], mst["fs"], sizes, prm)
        assert same_bits(got, want)
        for key in ("rings", "idx", "fs"):
            assert same_bits(mst[key], pst[key][0].numpy()), key


def _split_run(parse, buffer_cls, desc, bufs, k, states=None, **kw):
    """bufs[:k] through `desc`, one tick each; or, with `states` loaded
    after PLAYING, bufs[k:] to EOS.  Returns (pipeline, samples)."""
    pipe = parse(desc, **kw)
    part = bufs[:k] if states is None else bufs[k:]
    src = pipe.get_by_name("in")
    for b in part:
        src.push_buffer(buffer_cls(**dict(b, data=np.array(b["data"]))))
    if states is not None:
        src.end_of_stream()
    pipe.set_state("playing")
    if states is not None:
        interop.load_element_states(pipe, states)
    out, sink = [], pipe.get_by_name("out")
    for _ in range(len(part) + (states is not None)):
        if not pipe.tick():
            break
        while (s := sink.pull_sample()) is not None:
            out.append(s)
    return pipe, out


@pytest.mark.parametrize("fmt,ch", [("F32LE", 2), ("S16LE", 1)])
def test_freeverb_continues_from_jax_state(fmt, ch):
    """The JAX element's rings, indices and filterstores after two pushes,
    carried into the port: its next two pushes stay within the JAX
    package's tolerance of the JAX run's, and the port's own carry
    continues bit for bit."""
    rate = 44100
    desc = desc_of(fmt, ch, "freeverb name=fv level=0.7", rate)
    bufs = freeverb_pushes(fmt, ch, rate, frames=400, ticks=4, seed=3)
    jfull = _cat(_split_run(jparse_launch, JBuffer, desc, bufs, 4)[1])
    jhalf, _ = _split_run(jparse_launch, JBuffer, desc, bufs, 2)
    states = interop.element_states(jhalf)
    fv = states["fv"]["freeverb"]
    assert fv["rings"].shape == (sum(fk.ring_sizes(rate)),)
    assert fv["idx"].tolist() == [800 % n for n in fk.ring_sizes(rate)]
    _, cont = _split_run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                         bufs, 2, states=states, device="cpu")
    dist = np.abs(_cat(cont).astype(np.float64)
                  - jfull[800:].astype(np.float64))
    assert dist.max() <= (1 if fmt == "S16LE" else 2e-5)
    # the port's own carry: bit for bit against one uninterrupted run
    tfull = _cat(_split_run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                            bufs, 4, device="cpu")[1])
    thalf, _ = _split_run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                          bufs, 2, device="cpu")
    _, tcont = _split_run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                          bufs, 2, states=interop.element_states(thalf),
                          device="cpu")
    assert same_bits(_cat(tcont), tfull[800:])
    assert same_bits(tfull, gold_out(np.concatenate(
        [b["data"] for b in bufs]), rate, level=0.7))


# -- removesilence ------------------------------------------------------------

def test_vad_power_plain_exact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 1000)) * 9000).astype(np.int16)
    x[1, :10] = -32768
    p0 = torch.tensor([0, 123456789, 2**32], dtype=torch.int64)
    got = vk.vad_power(torch.from_numpy(x), p0)
    assert got.tolist() == [gold_vad_power(int(p), row)
                            for p, row in zip(p0.tolist(), x)]


NALPHA = vk.NALPHA


@settings(max_examples=3000, deadline=None, database=None)
@given(st.integers(0, 2**48 - 1), st.integers(0, 0xFFFF))
def test_vad_split_form_equals_compact(p, u):
    """Below 2^48 the reference's split form is (0xF7FF*p) >> 16, and
    below 2^32 that is the high word of p * 0xF7FF0000."""
    split = NALPHA * (p >> 16) + ((NALPHA * (p & 0xFFFF)) >> 16)
    assert split == (NALPHA * p) >> 16
    assert NALPHA * p < 2**64
    if p < 2**32:
        assert split == (p * (NALPHA << 16)) >> 32


@settings(max_examples=3000, deadline=None, database=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 0xFFFF))
def test_vad_32bit_invariant(p, u):
    """p < 2^32 implies p' < 2^32: the 32-bit phase never wraps."""
    nxt = vk.ALPHA * u + ((NALPHA * p) >> 16)
    assert nxt < 2**32
    assert vk.ALPHA * 0xFFFF + ((NALPHA * (2**32 - 1)) >> 16) \
        == 4294899711 < 2**32


def vad_phase_model(p, samples):
    """csrc/vad.cu's chain in Python: the split form while p >= 2^48, the
    compact form in 64 bits while p >= 2^32, then the 32-bit multiply-high
    and add, each phase a prefix of the loop."""
    a = [(((int(s) * int(s)) >> 14) & 0xFFFF) << 11 for s in samples]
    i = 0
    while i < len(a) and p >= 2**48:
        p = a[i] + NALPHA * (p >> 16) + ((NALPHA * (p & 0xFFFF)) >> 16)
        i += 1
    while i < len(a) and p >= 2**32:
        p = a[i] + ((NALPHA * p) >> 16)
        assert p < 2**64
        i += 1
    for v in a[i:]:
        p = (((p * (NALPHA << 16)) >> 32) + v)
        assert p < 2**32
    return p


VAD_P0 = (0, 5, 2**32, 2**33 - 1, 2**40, 2**62)


@pytest.mark.parametrize("n", [1, 7, 960, 24000])
def test_vad_phase_model_equals_plain(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((len(VAD_P0), n)) * 12000).astype(np.int16)
    x[0, :3] = -32768
    want = vk.vad_power_plain(torch.from_numpy(x),
                              torch.tensor(VAD_P0, dtype=torch.int64))
    assert [vad_phase_model(p, row) for p, row in zip(VAD_P0, x)] \
        == want.tolist()


def test_vad_states_match_reference():
    from gstreamer_tpu.elements.removesilence import Vad as JVad
    rng = np.random.default_rng(2)
    t = np.arange(4000)
    loud = (np.sin(2 * np.pi * 30 * t / 8000) * 20000).astype(np.int16)
    seq = [np.zeros(1000, np.int16), loud, np.zeros(100, np.int16),
           np.zeros(1000, np.int16),
           (rng.standard_normal(700) * 3000).astype(np.int16), loud[:300]]
    j, p = JVad(480, -60), Vad(480, -60)
    for x in seq:
        assert p.update(torch.from_numpy(x)) == j.update(x)
        assert (p.power, p.state, p.samples, p.head, p.filled) == \
            (j.power, j.state, j.samples, j.head, j.filled)
        assert np.array_equal(p.ring, j.ring)


def voice_bufs(rate, frames, ticks, seed=0):
    """Speech-band noise and near silence in turns of five buffers."""
    rng = np.random.default_rng(seed)
    dur = frames * 10**9 // rate
    out = []
    for t in range(ticks):
        loud = (t // 5) % 2 == 0
        x = rng.standard_normal((frames, 1)) * (6000 if loud else 3)
        if loud:
            x = np.sin(2 * np.pi * 200 * np.arange(frames) / rate)[:, None] \
                * 9000 + x
        out.append(dict(data=x.astype(np.int16), pts=t * dur, duration=dur))
    return out


@pytest.mark.parametrize("props", [
    "remove=true squash=true silent=false",
    "remove=true silent=false minimum-silence-buffers=2",
    "remove=true squash=true minimum-silence-time=30000000 hysteresis=200",
    "remove=false silent=false threshold=-40",
])
def test_removesilence_against_jax_package(props):
    _, out, msgs = both(desc_of("S16LE", 1, f"removesilence {props}", 16000),
                        voice_bufs(16000, 320, 30))
    if "remove=true" in props:
        assert len(out) < 30
    if "silent=false" in props:
        assert msgs and all(m[2]["name"] == "removesilence" for m in msgs)


def test_removesilence_continues_from_jax_state():
    desc = desc_of("S16LE", 1, "removesilence name=rs remove=true "
                               "squash=true silent=false", 16000)
    bufs = voice_bufs(16000, 320, 20, seed=4)
    jfull = _split_run(jparse_launch, JBuffer, desc, bufs, 20)[1]
    jhalf, jfirst = _split_run(jparse_launch, JBuffer, desc, bufs, 7)
    states = interop.element_states(jhalf)
    assert states["rs"]["vad"]["power"] == jhalf.get_by_name("rs")._vad.power
    _, cont = _split_run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                         bufs, 7, states=states, device="cpu")
    want = jfull[len(jfirst):]
    assert [s.buffer.pts for s in cont] == [s.buffer.pts for s in want]
    assert same_bits(_cat(cont), _cat(want))


# -- the build ----------------------------------------------------------------

def test_library_hash_follows_a_sources_flags(monkeypatch):
    """freeverb builds with -fmad=false; its library name changes with its
    own flags and no other source's does."""
    assert "-fmad=false" in _build.flags("freeverb")
    assert "-fmad=false" not in _build.flags("vad")
    assert {"freeverb", "vad"} <= set(_build.SOURCES)
    before = {n: _build.library_path(n) for n in ("freeverb", "vad")}
    monkeypatch.setitem(_build.SOURCE_FLAGS, "freeverb", ())
    assert _build.library_path("freeverb") != before["freeverb"]
    assert _build.library_path("vad") == before["vad"]


def test_wrappers_refuse_bad_arguments():
    sizes = fk.ring_sizes(8000)
    st = fk.fresh_state(1, sizes, "cpu")
    prm = fk.params(0.5, 0.2, 1.0, 0.5)
    with pytest.raises(ValueError):
        fk.freeverb(torch.zeros((1, 10, 3)), st, sizes, prm)
    with pytest.raises(ValueError):
        fk.freeverb(torch.zeros((2, 10, 1)), st, sizes, prm)
    with pytest.raises(ValueError):
        vk.vad_power(torch.zeros((1, 10), dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        fk.layout(sizes[:-1])


# -- card only ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("rate", [1, 1000, 8000, 44100, 48000, 96000,
                                  192000, 384000, 768000])
@pytest.mark.parametrize("ch", [1, 2])
def test_freeverb_kernel_matches_plain(cuda, rate, ch):
    rng = np.random.default_rng(rate + ch)
    sizes = fk.ring_sizes(rate)
    # the kernel's own schedule is the one block_model walks
    assert fk.kernel_schedule(sizes) == fk.schedule(sizes)
    prm = fk.params(0.6, 0.3, 0.8, 0.4)
    kst = fk.fresh_state(2, sizes, cuda)
    pst = fk.fresh_state(2, sizes, "cpu")
    for frames in (1200, 777):
        x = torch.from_numpy((rng.standard_normal((2, frames, ch)) * 0.3)
                             .astype(np.float32))
        k = fk.freeverb(x.to(cuda), kst, sizes, prm)
        p = fk.freeverb_plain(x, pst, sizes, prm)
        assert same_bits(k.cpu().numpy(), p.numpy())
    for key in ("rings", "idx", "fs"):
        assert same_bits(kst[key].cpu().numpy(), pst[key].numpy())


@pytest.mark.parametrize("n", [1, 7, 960, 24000])
def test_vad_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.standard_normal((len(VAD_P0), n)) * 12000)
                         .astype(np.int16))
    p0 = torch.tensor(VAD_P0, dtype=torch.int64)
    k = vk.vad_power(x.to(cuda), p0.to(cuda))
    assert k.cpu().tolist() == vk.vad_power_plain(x, p0).tolist()


def test_cuda_sources_pass_the_syntax_check():
    """tools/check_cuda_syntax.py: every source _build builds compiles with
    g++ -fsyntax-only against the stub runtime header."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tool = Path(__file__).resolve().parent.parent / "tools" / \
        "check_cuda_syntax.py"
    res = subprocess.run([sys.executable, str(tool)], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count(": ok") == len(_build.SOURCES)
