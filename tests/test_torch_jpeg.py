"""The port's JPEG and PNG codecs and their elements against the JAX package.

``jpeg_encode`` output equals the JAX package's byte for byte for gray,
4:2:0 and 4:4:4 at qualities 50, 85 and 95, at 8-aligned and odd sizes, on
inputs with flat regions: there the float64 DCT lands on rounding ties,
which only the reference's order of products and sums rounds the same way
(``codecs/jpeg.py``'s docstring; ``test_flat_blocks_need_the_ordered_sums``
shows a torch matmul would not).  ``jpeg_decode`` planes equal the JAX
package's on both entropy paths (native and Python), also on Pillow's files
with restart markers.  The launched ``multifilesrc ! jpegdec !
videoconvertscale`` string, jpegenc, pngenc and pngdec match.  The JAX side
runs with the audio stack imported (x64 on, as every launch string).
Tolerance 0.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import gstreamer_tpu.audio  # noqa: F401  (x64 on, as in every launch string)
from gstreamer_tpu.codecs import jpeg as rj
from gstreamer_tpu.codecs import png as rp
from gstreamer_tpu.core.parse import parse_launch as jparse

from gstreamer_tpu_torch import parse_launch as tparse
from gstreamer_tpu_torch.codecs import jpeg as tj
from gstreamer_tpu_torch.codecs import png as tp
from gstreamer_tpu_torch.native import jpeg as njpeg

SIZES = [(64, 48), (37, 29)]


def image(sub, w, h, seed):
    """Seeded noise with a flat band and a flat odd-valued block area (the
    DCT's rounding ties), in the planes jpeg_encode takes."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw):
        p = rng.integers(0, 256, (ph, pw), dtype=np.uint8)
        p[: ph // 3] = 129                   # flat: DC on a tie at q50
        p[ph // 3: ph // 2, : pw // 2] = 77
        return p
    y = plane(h, w)
    if sub == "gray":
        return (y,)
    if sub == "420":
        ch, cw = -(-h // 2), -(-w // 2)
        return (y, plane(ch, cw), plane(ch, cw))
    return (y, plane(h, w), plane(h, w))


@pytest.fixture
def python_coder(monkeypatch):
    """The Python entropy coder (what runs without g++)."""
    monkeypatch.setattr(njpeg, "get_lib", lambda: None)


def _eq_planes(ref, own):
    assert len(ref) == len(own)
    for r, o in zip(ref, own):
        r = np.asarray(r)
        assert isinstance(o, torch.Tensor) and o.dtype == torch.uint8
        assert tuple(o.shape) == r.shape and np.array_equal(o.numpy(), r)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 85, 95])
@pytest.mark.parametrize("sub", ["gray", "420", "444"])
def test_encode_matches_reference(sub, quality, size):
    w, h = size
    planes = image(sub, w, h, quality + w)
    mode = "420" if sub == "gray" else sub
    ref = rj.jpeg_encode(planes, w, h, quality=quality, subsampling=mode)
    own = tj.jpeg_encode(planes, w, h, quality=quality, subsampling=mode,
                         device="cpu")
    assert own == ref
    # tensors in, on their own device, give the same file
    assert tj.jpeg_encode(tuple(torch.from_numpy(p) for p in planes), w, h,
                          quality=quality, subsampling=mode) == ref
    # and it decodes to the reference's planes
    rplanes, rw, rh, rsub = rj.jpeg_decode(ref)
    oplanes, ow, oh, osub = tj.jpeg_decode(own, device="cpu")
    assert (ow, oh, osub) == (rw, rh, rsub) == (w, h, sub)
    _eq_planes(rplanes, oplanes)


@pytest.mark.parametrize("sub", ["gray", "420", "444"])
def test_python_coder_equals_native(sub, python_coder):
    w, h = 37, 29
    planes = image(sub, w, h, 5)
    mode = "420" if sub == "gray" else sub
    ref = rj.jpeg_encode(planes, w, h, quality=85, subsampling=mode)
    assert not njpeg.available()
    assert tj.jpeg_encode(planes, w, h, quality=85, subsampling=mode,
                          device="cpu") == ref
    coded = tj.decode_entropy(ref)
    assert not coded.native
    _eq_planes(rj.jpeg_decode(ref)[0], tj.jpeg_decode(ref, device="cpu")[0])


def pillow_jpeg(mode, w, h, seed, **kw):
    rng = np.random.default_rng(seed)
    shape = (h, w) if mode == "L" else (h, w, 3)
    img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


PILLOW = {
    "420_restart_blocks": ("RGB", 53, 37, dict(quality=80,
                                               restart_marker_blocks=3)),
    "420_restart_rows": ("RGB", 40, 40, dict(quality=60,
                                             restart_marker_rows=1)),
    "444_restart": ("RGB", 33, 17, dict(quality=90, subsampling=0,
                                        restart_marker_blocks=2)),
    "gray_restart": ("L", 29, 31, dict(quality=75, restart_marker_blocks=5)),
    "444": ("RGB", 24, 16, dict(quality=95, subsampling=0)),
}


@pytest.mark.parametrize("entropy", ["native", "python"])
@pytest.mark.parametrize("name", list(PILLOW))
def test_decode_matches_reference(name, entropy, monkeypatch):
    mode, w, h, kw = PILLOW[name]
    data = pillow_jpeg(mode, w, h, len(name), **kw)
    if "restart" in name:
        assert b"\xff\xdd" in data        # DRI: restart markers present
    if entropy == "python":
        monkeypatch.setattr(njpeg, "get_lib", lambda: None)
    assert tj.decode_entropy(data).native == (entropy == "native")
    ref = rj.jpeg_decode(data)
    own = tj.jpeg_decode(data, device="cpu")
    assert own[1:] == ref[1:]
    _eq_planes(ref[0], own[0])


def test_one_transform_for_many_images_equals_one_each():
    blobs = [rj.jpeg_encode(image(sub, w, h, k), w, h, quality=q,
                            subsampling="420" if sub == "gray" else sub)
             for k, (sub, w, h, q) in enumerate([
                 ("420", 37, 29, 50), ("444", 16, 8, 95), ("gray", 9, 30, 85),
                 ("420", 64, 48, 85)])]
    coded = [tj.decode_entropy(b) for b in blobs]
    many = tj.decode_transform(coded, torch.device("cpu"))
    for b, got in zip(blobs, many):
        one = tj.jpeg_decode(b, device="cpu")
        assert got[1:] == one[1:]
        assert all(torch.equal(x, y) for x, y in zip(got[0], one[0]))


def test_flat_blocks_need_the_ordered_sums():
    """On these inputs a torch matmul rounds some DCT ties the other way;
    the ordered products equal the reference (the test inputs do reach
    ties)."""
    blocks = np.repeat(np.arange(256, dtype=np.uint8), 4)[:, None, None] \
        * np.ones((1, 8, 8), np.uint8)
    q = np.full((8, 8), 16, np.float32)
    ref = np.asarray(rj._device_fdct()(blocks, q))
    own = tj._fdct(torch.from_numpy(blocks), torch.from_numpy(q)).numpy()
    assert np.array_equal(own, ref)
    a = torch.from_numpy(tj._A)
    x = torch.from_numpy(blocks).double() - 128.0
    naive = torch.round((a @ x @ a.T) / 16.0).to(torch.int32).numpy()
    assert not np.array_equal(naive, ref)


def test_decode_raises_on_a_bad_stream():
    with pytest.raises(ValueError, match="not a JPEG"):
        tj.jpeg_decode(b"\x00\x01", device="cpu")


# -- elements ---------------------------------------------------------------

def _write_jpegs(tmp_path, n, w, h, fmt="I420", quality=85):
    caps = f"video/x-raw,format={fmt},width={w},height={h},framerate=30/1"
    for pkg, d in ((jparse, "j"), (tparse, "t")):
        (tmp_path / d).mkdir()
        kw = {} if pkg is jparse else {"device": "cpu"}
        pkg(f"videotestsrc num-buffers={n} pattern=snow ! {caps} ! "
            f"jpegenc quality={quality} ! multifilesink "
            f"location={tmp_path / d}/f%03d.jpg", **kw).run()
    return [(tmp_path / "t" / f"f{k:03d}.jpg").read_bytes() for k in range(n)]


def _samples(pipe):
    pipe.set_state("playing")
    while pipe.tick():
        pass
    out = []
    while (s := pipe.get_by_name("out").pull_sample()) is not None:
        out.append(s)
    return out


@pytest.mark.parametrize("fmt", ["I420", "Y444", "GRAY8"])
def test_jpegenc_writes_reference_files(tmp_path, fmt):
    blobs = _write_jpegs(tmp_path, 3, 40, 24, fmt)
    for k, b in enumerate(blobs):
        assert b == (tmp_path / "j" / f"f{k:03d}.jpg").read_bytes()


@pytest.mark.parametrize("fmt", ["I420", "Y444", "GRAY8"])
def test_launched_decode_string_matches_reference(tmp_path, fmt):
    _write_jpegs(tmp_path, 3, 40, 24, fmt)
    desc = (f"multifilesrc location={tmp_path}/t/f%03d.jpg ! jpegdec name=d "
            "! videoconvertscale add-borders=false ! "
            "video/x-raw,format=RGB,width=16,height=12 ! appsink name=out")
    ref = _samples(jparse(desc))
    own_p = tparse(desc, device="cpu")
    own = _samples(own_p)
    assert len(ref) == len(own) == 3
    for r, o in zip(ref, own):
        assert (r.buffer.pts, r.buffer.batch) == (o.buffer.pts, o.buffer.batch)
        for x, y in zip(r.buffer.data, o.buffer.data):
            assert np.array_equal(np.asarray(x), y.numpy())
    assert own_p.get_by_name("d").native_decodes == 3


def test_jpegdec_at_batch_above_one_decodes_every_file(tmp_path):
    """The port's multifilesrc hands jpegdec all n files of a tick (the
    JAX package's emits one in n: ROADMAP.md section 3); each image is held
    to its own decode."""
    blobs = _write_jpegs(tmp_path, 5, 24, 16)
    p = tparse(f"multifilesrc location={tmp_path}/t/f%03d.jpg ! jpegdec ! "
               "appsink name=out", batch=2, device="cpu")
    got = _samples(p)
    assert [s.buffer.batch for s in got] == [2, 2, 1]
    frames = [tuple(pl[k] for pl in s.buffer.data)
              for s in got for k in range(s.buffer.batch)]
    for blob, planes in zip(blobs, frames):
        ref = rj.jpeg_decode(blob)[0]
        want = (ref[0], ref[1][:8, :12], ref[2][:8, :12])
        assert all(np.array_equal(np.asarray(r), o.numpy())
                   for r, o in zip(want, planes))


@pytest.mark.parametrize("fmt", ["RGB", "RGBA", "GRAY8"])
def test_png_elements_match_reference(tmp_path, fmt):
    caps = f"video/x-raw,format={fmt},width=20,height=10,framerate=30/1"
    for pkg, d in ((jparse, "j"), (tparse, "t")):
        (tmp_path / d).mkdir()
        kw = {} if pkg is jparse else {"device": "cpu"}
        pkg(f"videotestsrc num-buffers=2 pattern=smpte ! {caps} ! pngenc ! "
            f"multifilesink location={tmp_path / d}/f%d.png", **kw).run()
    for k in range(2):
        assert (tmp_path / "t" / f"f{k}.png").read_bytes() == \
            (tmp_path / "j" / f"f{k}.png").read_bytes()
    desc = f"multifilesrc location={tmp_path}/t/f%d.png ! pngdec ! " \
           "appsink name=out"
    ref, own = _samples(jparse(desc)), _samples(tparse(desc, device="cpu"))
    assert len(ref) == len(own) == 2
    for r, o in zip(ref, own):
        for x, y in zip(r.buffer.data, o.buffer.data):
            assert np.array_equal(np.asarray(x), y.numpy())


def test_png_codec_is_the_reference(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (9, 13, 3),
                                            dtype=np.uint8)
    assert tp.png_encode(img, "RGB") == rp.png_encode(img, "RGB")
    fmt, back = tp.png_decode(tp.png_encode(img, "RGB"))
    assert fmt == "RGB" and np.array_equal(back, img)
