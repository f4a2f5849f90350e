"""The port's LC3 (``codecs/entenc.py``, ``codecs/lc3.py``,
``elements/lc3_elements.py``: lc3enc, lc3dec) against the JAX package.

The codec modules are copies: their code equals the JAX modules' statement
for statement (docstrings aside), and seeded signals give the same frames
and PCM across rates, frame durations, budgets and channel counts.  The
elements run the same launch strings in both packages (samples, caps and
bus messages equal, tolerance 0), apart from one reference fault the port
does not copy: at end of stream the JAX package's lc3enc drops the samples
short of a whole frame, the port zero-pads and codes them as gstlc3enc
does (``test_lc3enc_eos_partial_frame_is_a_reference_fault``).  The JAX
package's ``tests/test_lc3.py`` runs again on the port (``on_port``).
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from gstreamer_tpu.codecs import entenc as jentenc
from gstreamer_tpu.codecs import lc3 as jlc3
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse

import gstreamer_tpu_torch
from gstreamer_tpu_torch.codecs import entenc as tentenc
from gstreamer_tpu_torch.codecs import lc3 as tlc3
from gstreamer_tpu_torch.core.buffer import Buffer

import test_lc3
from test_torch_analytics import same_spec
from test_torch_captions import drain, pair
from test_torch_flx import sha, vectors
from test_torch_rtp import reference_tests, run_on_port



def expand(cases):
    """``reference_tests`` cases with every stacked ``parametrize`` mark
    of a test expanded (``reference_tests`` reads the first one only)."""
    out = []
    for case_id, fn, names, values in cases:
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if len(marks) < 2:
            out.append((case_id, fn, names, values))
            continue
        if not case_id.endswith("[0]"):
            continue
        grid = [([], ())]
        for m in marks:
            keys = [k.strip() for k in m.args[0].split(",")]
            grid = [(ks + keys, vs + (tuple(v) if len(keys) > 1 else (v,)))
                    for ks, vs in grid for v in m.args[1]]
        base = case_id[:-3]
        out += [(f"{base}[{k}]", fn, ks, vs)
                for k, (ks, vs) in enumerate(grid)]
    return out


REFERENCE = expand(reference_tests(test_lc3))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


def _body(mod):
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(inspect.getsource(mod))
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
    return ast.dump(tree)


@pytest.mark.parametrize("pair_", [(tentenc, jentenc), (tlc3, jlc3)],
                         ids=["entenc", "lc3"])
def test_codec_is_the_references_code(pair_):
    """Statement for statement the JAX module (its docstring aside): the
    noise level read before the budget truncation included (ROADMAP.md
    section 3)."""
    assert _body(pair_[0]) == _body(pair_[1])


@pytest.mark.parametrize("factory", ["lc3enc", "lc3dec"])
def test_factory_spec_matches(factory):
    same_spec(factory)


def signal(rate, n, ch, seed):
    """Seeded S16 (n, ch): a tone per channel, a chirp and noise, with a
    burst of full-scale clipping."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None] / rate
    x = 0.4 * np.sin(2 * np.pi * (300 + 170 * np.arange(ch)) * t)
    x += 0.2 * np.sin(2 * np.pi * (500 + 0.2 * rate * t) * t)
    x += rng.normal(0, 0.03, (n, ch))
    x[n // 3:n // 3 + n // 10] *= 4
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


CONFIGS = [(8000, 10000, 20, 1), (16000, 7500, 40, 1),
           (24000, 10000, 60, 2), (32000, 7500, 100, 1),
           (48000, 10000, 120, 2), (48000, 7500, 400, 1),
           (48000, 10000, 20, 1), (16000, 10000, 155, 2)]


@pytest.mark.parametrize("rate,dur,fb,ch", CONFIGS)
def test_encode_decode_match(rate, dur, fb, ch):
    """Frames byte for byte, then PCM sample for sample, over eight
    frames of a seeded signal, then two lost frames (concealment)."""
    x = signal(rate, tlc3.frame_samples(rate, dur) * 8, ch, rate + fb)
    te, je = tlc3.Lc3Encoder(rate, ch, dur, fb), jlc3.Lc3Encoder(
        rate, ch, dur, fb)
    td, jd = tlc3.Lc3Decoder(rate, ch, dur, fb), jlc3.Lc3Decoder(
        rate, ch, dur, fb)
    nf = te.nf
    for k in range(8):
        frame = te.encode_frame(x[k * nf:(k + 1) * nf])
        assert frame == je.encode_frame(x[k * nf:(k + 1) * nf])
        np.testing.assert_array_equal(td.decode_frame(frame),
                                      jd.decode_frame(frame))
    for _ in range(2):
        np.testing.assert_array_equal(td.decode_frame(None),
                                      jd.decode_frame(None))


def test_range_coder_matches():
    """Seeded symbol streams through both RangeEncoders: the same bytes
    and tell() after every symbol."""
    rng = np.random.default_rng(9)
    for size in (8, 40, 120):
        te, je = tentenc.RangeEncoder(size), jentenc.RangeEncoder(size)
        while te.tell() < size * 8 - 40:
            ft = int(rng.integers(2, 300))
            fl = int(rng.integers(0, ft - 1))
            fh = int(rng.integers(fl + 1, ft + 1))
            bits = int(rng.integers(1, 12))
            v = int(rng.integers(0, 1 << bits))
            for e in (te, je):
                e.encode(fl, fh, ft)
                e.enc_bits(v, bits)
            assert te.tell() == je.tell()
        assert te.done() == je.done()


def test_garbage_frames_match():
    rng = np.random.default_rng(4)
    td = tlc3.Lc3Decoder(48000, 1, 10000, 60)
    jd = jlc3.Lc3Decoder(48000, 1, 10000, 60)
    for _ in range(20):
        f = rng.integers(0, 256, 60, dtype=np.uint8).tobytes()
        np.testing.assert_array_equal(td.decode_frame(f), jd.decode_frame(f))


def raw_src(rate, ch):
    return (f"appsrc name=in caps=audio/x-raw,format=S16LE,rate={rate},"
            f"channels={ch},layout=interleaved")


def pushes(x, rate, block):
    return {"in": [dict(data=x[k:k + block], pts=k * 10**9 // rate,
                        duration=len(x[k:k + block]) * 10**9 // rate)
                   for k in range(0, len(x), block)]}


@pytest.mark.parametrize("rate,ch,block,tail", [
    (48000, 2, 480, ""), (48000, 1, 700, ""),
    (16000, 1, 160, " frame-duration-us=7500"),
    (24000, 2, 1000, " frame-bytes=80"),
    (48000, 2, 480, " ! audio/x-lc3,frame-bytes=40")])
def test_elements_match(rate, ch, block, tail):
    """lc3enc, then lc3enc ! lc3dec, on pushes that hold whole frames
    only at the end of the stream (no partial frame is left there)."""
    nf = tlc3.frame_samples(rate, 7500 if "7500" in tail else 10000)
    x = signal(rate, nf * 12, ch, 3)
    pair(f"{raw_src(rate, ch)} ! lc3enc{tail} ! appsink name=out",
         pushes(x, rate, block))
    _, ref, _, _ = pair(f"{raw_src(rate, ch)} ! lc3enc{tail} ! lc3dec ! "
                        "appsink name=out", pushes(x, rate, block))
    assert sum(s.buffer.data.shape[0] for s in ref["out"]) == len(x)


@pytest.mark.parametrize("extra", [1, 200, 479])
def test_lc3enc_eos_partial_frame_is_a_reference_fault(extra):
    """`extra` samples past the last whole frame: the JAX package's lc3enc
    drops them at end of stream (gstreamer_tpu/elements/lc3_elements.py
    host_process), the port codes them zero-padded into one more frame,
    as gstlc3enc does.  Every earlier frame is the same bytes."""
    rate, ch, nf = 48000, 2, 480
    x = signal(rate, nf * 4 + extra, ch, extra)
    desc = f"{raw_src(rate, ch)} ! lc3enc ! appsink name=out"

    def frames(parse, buffer_cls, **kw):
        pipe = parse(desc, **kw)
        src = pipe.get_by_name("in")
        for b in pushes(x, rate, 500)["in"]:
            src.push_buffer(buffer_cls(**b))
        src.end_of_stream()
        pipe.run()
        got = drain(pipe.get_by_name("out"))
        return [bytes(f) for s in got for f in s.buffer.data], got
    ref, _ = frames(jparse, JBuffer)
    got, samples = frames(gstreamer_tpu_torch.parse_launch, Buffer,
                          device="cpu")
    assert len(ref) == 4 and len(got) == 5
    assert got[:4] == ref
    enc = jlc3.Lc3Encoder(rate, ch, 10000, 120)
    padded = np.concatenate([x, np.zeros((nf - extra, ch), np.int16)])
    want = [enc.encode_frame(padded[k * nf:(k + 1) * nf]) for k in range(5)]
    assert got == want
    last = samples[-1].buffer
    assert (last.pts, last.duration) == (4 * nf * 10**9 // rate,
                                         extra * 10**9 // rate)



def test_committed_lc3_digest_matches():
    """chip_smoke.py's lc3_stereo input through lc3enc and lc3enc ! lc3dec:
    the port on the CPU gives the committed sha256 the card is held to,
    and the JAX package the same frames and PCM (whole frames only)."""
    _d, dig, cs = vectors()
    rate, ch, n, per = cs.CT_LC3
    x = cs.ct_lc3_input(cs.CT_SEED)
    cpu = torch.device("cpu")
    src = raw_src(rate, ch)
    frames = cs.ct_blobs(cs.codec_run(f"{src} ! lc3enc ! appsink name=a",
                                      cpu, 1, "a",
                                      {"in": cs.ct_lc3_pushes(x, cpu)}))
    assert (len(frames), sha([b"".join(frames)])[0]) == \
        (dig["lc3"]["frames"], dig["lc3"]["bytes"])
    _, ref, _, out = pair(f"{src} ! lc3enc ! lc3dec ! appsink name=out",
                          pushes(x, rate, per))
    pcm = np.concatenate([s.buffer.data.numpy() for s in out["out"]])
    assert sha([pcm.tobytes()])[0] == dig["lc3"]["pcm"]
