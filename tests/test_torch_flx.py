"""The port's FLIC decoder (``codecs/flic.py``; ``elements/flxdec.py``)
against the JAX package.

The codec module is a copy: its code equals the JAX module's statement for
statement (docstring aside), but for one reference fault it does not copy:
a palette pack of 256 colours (count byte 0), which the JAX package reads
as none and then fails on (``test_full_palette_is_a_reference_fault``).
Seeded animations (``flc_bytes``: a BRUN key
frame with run-length rows, SS2 word deltas of moving boxes, an FLI line
delta, a partial palette change, BLACK and COPY frames) decode to the same
index frames and palettes in both packages, and flxdec gives the same
samples and caps, alone and through videoconvertscale to I420.  The JAX
package's ``tests/test_flx.py`` runs again on the port (``on_port``).
"""

import ast
import hashlib
import importlib.util
import inspect
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from gstreamer_tpu.codecs import flic as jflic

from gstreamer_tpu_torch.codecs import flic as tflic

import test_flx
from test_flx import _color256, _frame, _header
from test_torch_analytics import same_spec
from test_torch_captions import pair
from test_torch_rtp import reference_tests, run_on_port

REFERENCE = reference_tests(test_flx)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


def test_codec_is_the_references_code():
    """Statement for statement the JAX module, its docstring and the
    palette pack's decode aside."""
    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        tree.body = [n for n in tree.body if not (
            isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)
            or getattr(n, "name", "") == "_decode_color")]
        return ast.dump(tree)
    assert body(tflic) == body(jflic)


@pytest.mark.parametrize("scale,magic", [(0, "COLOR256"), (2, "COLOR64")])
def test_full_palette_is_a_reference_fault(scale, magic):
    """A pack of 256 colours (its count byte 0, gstflxdec.c's
    flx_decode_color reads 768 bytes): the JAX package reads no colour and
    raises; the port sets the whole palette."""
    rgb = np.random.default_rng(scale).integers(0, 256 >> scale, 768,
                                                dtype=np.uint8)
    chunk = (getattr(tflic, magic),
             struct.pack("<H", 1) + bytes([0, 0]) + rgb.tobytes())
    data = bytes(_header(4, 2, 1)) + _frame(chunk, (tflic.BLACK, b""))
    with pytest.raises(ValueError):
        jflic.decode(data)
    frames, palettes, _, _ = tflic.decode(data)
    np.testing.assert_array_equal(palettes[0].reshape(-1),
                                  (rgb.astype(np.uint16) << scale)
                                  .astype(np.uint8))
    assert (frames[0] == 0).all()


def test_factory_spec_matches():
    same_spec("flxdec")


# -- a FLIC writer ------------------------------------------------------------

def brun(img):
    """BRUN (byte run-length) rows: runs of equal bytes, literals
    between them."""
    out = bytearray()
    for row in img:
        out.append(1)                           # legacy packet count
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 127 and row[x + run] == row[x]:
                run += 1
            if run > 2:
                out += struct.pack("b", run) + bytes([row[x]])
                x += run
                continue
            lit = 1
            while (x + lit < w and lit < 127
                   and not (x + lit + 2 < w
                            and row[x + lit] == row[x + lit + 1]
                            == row[x + lit + 2])):
                lit += 1
            out += struct.pack("b", -lit) + bytes(row[x:x + lit])
            x += lit
    return (tflic.BRUN, bytes(out))


def ss2(prev, cur):
    """SS2 (FLC word delta): for each changed line, literal words from the
    first changed word to the last, lines between skipped by opcode."""
    h, w = cur.shape
    body, lines, skip = bytearray(), 0, 0
    for y in range(h):
        d = np.nonzero(prev[y] != cur[y])[0]
        if not len(d):
            skip += 1
            continue
        if skip:
            body += struct.pack("<H", 0x10000 - skip)
            skip = 0
        x0, x1 = int(d[0]) & ~1, min(w, (int(d[-1]) + 2) & ~1)
        pkts, pos = bytearray(), 0
        n = 0
        while x0 - pos > 255:
            pkts += bytes([255, 0])
            pos += 255
            n += 1
        first = True
        while pos < x1:
            start = x0 if first else pos
            words = min(127, (x1 - start) // 2)
            pkts += bytes([start - pos]) + struct.pack("b", words)
            pkts += cur[y, start:start + 2 * words].tobytes()
            pos = start + 2 * words
            first = False
            n += 1
        body += struct.pack("<H", n) + pkts
        lines += 1
    return (tflic.SS2, struct.pack("<H", lines) + bytes(body))


def lc(prev, cur):
    """LC (FLI line delta) over the lines from the first changed to the
    last: one literal packet a line where it changed."""
    h, w = cur.shape
    rows = [y for y in range(h) if (prev[y] != cur[y]).any()]
    if not rows:
        return (tflic.LC, struct.pack("<HH", 0, 0))
    body = bytearray(struct.pack("<HH", rows[0], rows[-1] - rows[0] + 1))
    for y in range(rows[0], rows[-1] + 1):
        d = np.nonzero(prev[y] != cur[y])[0]
        if not len(d):
            body.append(0)
            continue
        x0, x1 = int(d[0]), int(d[-1]) + 1
        pkts, pos, n = bytearray(), 0, 0
        while pos < x1:
            skip = min(255, max(0, x0 - pos)) if n == 0 or pos < x0 else 0
            count = min(127, x1 - pos - skip)
            pkts += bytes([skip]) + struct.pack("b", count)
            pkts += cur[y, pos + skip:pos + skip + count].tobytes()
            pos += skip + count
            n += 1
        body += bytes([n]) + pkts
    return (tflic.LC, bytes(body))


def flc_bytes(w, h, n, seed, speed=40):
    """A seeded FLC animation of `n` frames: a key frame of flat tiles
    with a gradient band (BRUN), then boxes moving over it (SS2), one frame
    by FLI line delta, a palette change, and where n allows a BLACK and a
    COPY frame.  Returns (the file's bytes, the index frames written)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = ((xx // 40 + yy // 30) * 7 % 200).astype(np.uint8)
    band = min(24, h - h // 3)
    img[h // 3:h // 3 + band] = (xx[:band] * 255 // max(w - 1, 1)).astype(
        np.uint8)
    pal = [tuple(int(v) for v in rng.integers(0, 256, 3))
           for _ in range(255)]
    frames = [img]
    chunks = [[_color256(pal), brun(img)]]
    bh, bw = min(32, h // 2), min(48, w // 2)
    boxes = rng.integers(0, [w - bw + 1, h - bh + 1], (3, 2))
    for k in range(1, n):
        prev = frames[-1]
        if k == n - 2 and n > 4:
            frames.append(np.zeros((h, w), np.uint8))
            chunks.append([(tflic.BLACK, b"")])
            continue
        if k == n - 1 and n > 4:
            cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
            frames.append(cur)
            chunks.append([(tflic.COPY, cur.tobytes())])
            continue
        cur = prev.copy()
        for j, (bx, by) in enumerate(boxes):
            x, y = (bx + 8 * k * (j + 1)) % (w - bw + 1), by
            cur[y:y + bh, x:x + bw] = rng.integers(200, 256, (bh, bw))
        frames.append(cur)
        cs = [lc(prev, cur) if k == 3 else ss2(prev, cur)]
        if k == 2:
            cs.insert(0, (tflic.COLOR256, struct.pack("<H", 1) + bytes(
                [16, 8]) + bytes(range(24))))
        chunks.append(cs)
    data = bytes(_header(w, h, n, speed=speed)) + b"".join(
        _frame(*c) for c in chunks)
    return data, frames


@pytest.mark.parametrize("w,h,n,seed", [(64, 48, 4, 1), (96, 64, 8, 2),
                                        (320, 200, 8, 3), (62, 40, 6, 4)])
def test_decode_matches(w, h, n, seed):
    """Index frames, palettes, speed and size: the port's decode, the JAX
    package's and the frames written."""
    data, written = flc_bytes(w, h, n, seed)
    t, j = tflic.decode(data), jflic.decode(data)
    for a, b in zip(t[0] + t[1], j[0] + j[1]):
        np.testing.assert_array_equal(a, b)
    assert t[2:] == j[2:] == (40, (w, h))
    assert len(t[0]) == n
    for a, b in zip(t[0], written):
        np.testing.assert_array_equal(a, b)


def test_fli_magic_and_errors_match():
    data, _ = flc_bytes(32, 16, 3, 5)
    fli = bytearray(data)
    struct.pack_into("<HI", fli, 4, tflic.FLI_MAGIC, 0)
    struct.pack_into("<I", fli, 16, 7)
    assert tflic.decode(bytes(fli))[2] == jflic.decode(bytes(fli))[2] == 100
    for bad in (data[:100], bytes(_header(4, 4, 0, magic=0x1234))):
        with pytest.raises(ValueError) as t:
            tflic.decode(bad)
        with pytest.raises(ValueError) as j:
            jflic.decode(bad)
        assert str(t.value) == str(j.value)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("tail", [
    "", " ! videoconvertscale ! video/x-raw,format=I420,width=48,height=32",
    " ! videoconvertscale ! video/x-raw,format=I420"])
def test_flxdec_matches(tmp_path, batch, tail):
    data, _ = flc_bytes(96, 64, 8, 6)
    path = tmp_path / "a.flc"
    path.write_bytes(data)
    _, ref, _, _ = pair(f"flxdec location={path}{tail} ! appsink name=out",
                        batch=batch)
    assert sum(s.buffer.batch for s in ref["out"]) == 8


def vectors():
    """The committed vectors' directory, its digests, and chip_smoke.py as
    a module (its input makers)."""
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    d = root / "tests" / "data" / "torch_codecs"
    return d, json.loads((d / "digests.json").read_text()), cs


def sha(chunks):
    return [hashlib.sha256(c).hexdigest() for c in chunks]


def test_committed_flc_matches_digests():
    """tests/data/torch_codecs/anim_320x200.flc is flc_bytes' animation,
    and the port's flxdec (RGB, and I420 640x400 after videoconvertscale)
    gives the JAX package's committed sha256, which the card is held to."""
    d, dig, cs = vectors()
    path = d / "anim_320x200.flc"
    assert path.read_bytes() == flc_bytes(320, 200, 8, 2020)[0]
    cpu = torch.device("cpu")
    rgb = cs.ct_planes(cs.codec_run(f"flxdec location={path} ! appsink "
                                    "name=a", cpu, 4, "a"))
    assert [sha([p.tobytes() for p in f]) for f in rgb] == dig["flic"]["rgb"]
    i420 = cs.ct_planes(cs.codec_run(
        f"flxdec location={path} ! videoconvertscale ! {cs.CT_FLIC_I420} ! "
        "appsink name=a", cpu, 4, "a"))
    assert [sha([p.tobytes() for p in f]) for f in i420] == \
        dig["flic"]["i420"]
