"""The port's overlay family against the JAX package, bit for bit.

``video/overlay.py``'s blend (every OVERxy operator, 8 and 16 bits, YUV
and RGB destinations, placements that clip on every side, global alpha 0,
0.5 and 1, a run of frames), ``scale_linear_rgba``, the QR encoder and
``decode_image`` are held to the JAX package's functions; each overlay
factory runs through a launch string in both packages (samples and
negotiated caps equal, ``test_torch_compositor.run_both``), the callback
elements and the decoders through the same driver with their callbacks set
in both.  Tolerance 0.  Every factory keeps the reference's properties and
pad templates.
"""

import io
import time

import numpy as np
import pytest
import torch

from gstreamer_tpu.core import element as jelement
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import pixbuf_overlay as jpix
from gstreamer_tpu.ops import qrencode as jqr
from gstreamer_tpu.video import overlay as jov

import gstreamer_tpu_torch
from gstreamer_tpu_torch.codecs.jpeg import jpeg_encode
from gstreamer_tpu_torch.codecs.png import png_encode
from gstreamer_tpu_torch.core import element as telement
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements import pixbuf_overlay as tpix
from gstreamer_tpu_torch.interop import negotiated_caps
from gstreamer_tpu_torch.ops import qrencode as tqr
from gstreamer_tpu_torch.video import format as tformat
from gstreamer_tpu_torch.video import overlay as tov

from test_torch_compositor import (DUR, _copy, assert_same_samples,
                                   video_pushes)
from test_torch_filters import one_input, src
from test_torch_flow import _spec
from test_torch_pipeline import _name_elements

W, H = 64, 48
OVERLAY_FACTORIES = (
    "overlaycomposition", "textoverlay", "timeoverlay", "clockoverlay",
    "textrender", "gdkpixbufdec", "gdkpixbufoverlay", "cairooverlay",
    "qroverlay", "debugqroverlay", "gdkpixbufsink", "rsvgdec", "rsvgoverlay")
SVG = ("<svg width='40' height='30'>"
       "<rect x='4' y='4' width='20' height='10' fill='#ff0000' "
       "stroke='blue' stroke-width='2'/>"
       "<circle cx='28' cy='18' r='8' fill='#00ff0080'/>"
       "<polygon points='2,28 12,20 20,28' fill='yellow'/>"
       "<line x1='0' y1='0' x2='39' y2='29' stroke='white'/>"
       "<text x='2' y='12' fill='black'>Hi</text></svg>")


@pytest.mark.parametrize("factory", OVERLAY_FACTORIES)
def test_factory_matches_reference(factory):
    jelement._ensure_elements_loaded()
    telement._ensure_elements_loaded()
    assert _spec(telement._REGISTRY[factory][0]) == \
        _spec(jelement._REGISTRY[factory][0])


# -- video_blend ---------------------------------------------------------------

def _dest(seed, bits, batch=2, alpha=True):
    rng = np.random.default_rng(seed)
    top = 256 if bits == 8 else 65536
    chans = [rng.integers(0, top, (batch, 20, 24)).astype(np.int32)
             for _ in range(4)]
    a = chans[0]
    r = rng.random(a.shape)
    a[r < 0.2] = 0                          # transparent and opaque pixels
    a[r > 0.8] = top - 1
    if not alpha:
        chans[0] = None
    return chans


def _src(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 256, (9, 11, 4)).astype(np.uint8)
    s[..., 0][rng.random(s.shape[:2]) < 0.25] = 0     # asrc == 0: kept
    s[0, 0, 0] = 255
    return s


def _both(chans, *args, frames=None, **kw):
    ref = jov.video_blend(np, tuple(chans), *args, **kw)
    if frames is not None:
        ref = tuple(None if r is None else
                    np.where(np.arange(r.shape[0])[:, None, None]
                             == frames.start, r, c)
                    for r, c in zip(ref, chans))
    got = [None if c is None else torch.as_tensor(c.copy()) for c in chans]
    out = tov.video_blend(got, *args, frames=frames, **kw)
    assert out is got                     # written in place
    for o, r in zip(out, ref):
        assert (o is None) == (r is None)
        if o is not None:
            assert o.dtype == torch.int32
            assert np.array_equal(o.numpy(), r)
    return ref


PLACES = [(3, 5), (-4, -3), (17, 14), (-10, 12), (20, -8), (24, 0), (0, -9)]


@pytest.mark.parametrize("dest_is_rgb", [True, False])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("src_pre,dest_pre", [
    (False, False), (True, False), (False, True), (True, True)])
def test_video_blend(src_pre, dest_pre, bits, dest_is_rgb):
    """Every OVERxy, inside and clipped on each side (and wholly
    outside: (24, 0), (0, -9)), at global alpha 0, 0.5 and 1; on a YUV
    destination the source goes through the fixed matrix first (and an
    unpremultiply where it is premultiplied)."""
    chans = _dest(1, bits)
    src_argb = _src(2)
    changed = 0
    for x, y in PLACES:
        for ga in (0.0, 0.5, 1.0):
            ref = _both(chans, dest_is_rgb, src_argb, x, y, ga,
                        src_premultiplied=src_pre,
                        dest_premultiplied=dest_pre, bits=bits)
            changed += not all(np.array_equal(r, c)
                               for r, c in zip(ref, chans))
    assert changed == 2 * 5                 # alpha 0 and outside: no-ops


def test_video_blend_without_alpha_plane():
    chans = _dest(3, 8, alpha=False)
    _both(chans, False, _src(4), -2, 3, 0.7, width=24, height=20)


def test_video_blend_frames_run():
    """A run of frames blends as the reference blends those frames."""
    chans = _dest(5, 8, batch=3)
    _both(chans, True, _src(6), 2, 2, 1.0, frames=slice(1, 2))


def test_prepared_source_goes_to_the_device_once():
    rect = tov.VideoOverlayRectangle(_src(7), render_x=-2, render_y=1)
    comp = tov.VideoOverlayComposition([rect])
    for seed in (8, 9):
        got = [torch.as_tensor(c) for c in _dest(seed, 8)]
        comp.blend(got, False, 24, 20)
    assert len(rect._device) == 1
    (_, _, asrc, keep, cols), = rect._device.values()
    assert asrc.dtype == torch.int64 and keep.dtype == torch.bool
    assert tuple(asrc.shape) == (9, 9)


def test_owned_chans_clones_shared_planes():
    """A gray plane's two neutral chroma channels are one tensor, and a
    16-bit container handed in as int32 unpacks to itself: both are
    cloned before a blend writes into them."""
    y = torch.full((1, 4, 6), 40000, dtype=torch.int32)
    fmt = tformat.format_info("GRAY16_LE")
    chans = tformat.unpack_planes(torch, fmt, (y,), 6, 4)
    assert chans[1] is y and chans[2] is chans[3]
    own = tov.owned_chans(chans, (y,))
    ptrs = {c.untyped_storage().data_ptr() for c in own}
    assert len(ptrs) == 4 and y.untyped_storage().data_ptr() not in ptrs
    assert all(torch.equal(a, b) for a, b in zip(own, chans))


@pytest.mark.parametrize("fmt", ["I420", "Y444", "RGB", "RGBA", "BGRx",
                                 "RGBx", "AYUV", "NV12"])
def test_unpack_pack_is_the_identity(fmt):
    """The pixbuf overlays unpack and pack a whole batch when only some
    of its frames carry an overlay (the reference touches only those):
    for every format of their caps that is the identity on the others."""
    from test_torch_compositor import planes
    p = tuple(torch.as_tensor(x) for x in planes(fmt, 10, 6, 2, 11))
    info = tformat.format_info(fmt)
    back = tformat.pack_planes(
        torch, info, tformat.unpack_planes(torch, info, p, 10, 6), 10, 6)
    assert all(torch.equal(a, b) for a, b in zip(back, p))


# -- host copies -----------------------------------------------------------------

@pytest.mark.parametrize("size", [(7, 6), (13, 9), (3, 17), (1, 5), (24, 2)])
def test_scale_linear_rgba(size):
    img = np.random.default_rng(12).integers(0, 256, (6, 7, 4)) \
        .astype(np.uint8)
    want = jov.scale_linear_rgba(img, *size)
    got = tov.scale_linear_rgba(img, *size)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("ec", "LMQH")
def test_qr_encode(ec):
    texts = [b"short", b"a longer payload 1234567890" * 2]
    if ec in "LM":
        texts.append(b"v" * 130)            # version 7 and up
    for text in texts:
        assert np.array_equal(tqr.qr_encode(text, ec),
                              jqr.qr_encode(text, ec))


def _encoded(kind):
    rng = np.random.default_rng(13)
    rgb = rng.integers(0, 256, (21, 30, 3), np.uint8)
    if kind == "png_rgb":
        return png_encode(rgb)
    if kind == "png_rgba":
        return png_encode(np.concatenate(
            [rgb, rng.integers(0, 256, (21, 30, 1), np.uint8)], -1))
    if kind == "png_gray":
        return png_encode(rgb[..., 0])
    if kind == "jpeg":
        yuv = (rgb[..., 0], rgb[:11, :15, 1], rgb[:11, :15, 2])
        return jpeg_encode(yuv, 30, 21, quality=85, device="cpu")
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(rgb).save(bio, "BMP")
    return bio.getvalue()


@pytest.mark.parametrize("kind", ["png_rgb", "png_rgba", "png_gray", "jpeg",
                                  "bmp"])
def test_decode_image(kind):
    data = _encoded(kind)
    want = jpix.decode_image(data)
    got = tpix.decode_image(data)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


# -- the elements through launch strings -------------------------------------

@pytest.mark.parametrize("fmt,desc", [
    ("I420", "timeoverlay"),
    ("RGBA", "timeoverlay halignment=right font-size=12"),
    ("I420_10LE", "timeoverlay valignment=bottom"),
    ("I420", "textoverlay text=Hello shaded-background=true"),
    ("NV12", "textoverlay text=Hi halignment=left valignment=top xpad=30"),
    ("AYUV", "textoverlay text=ab halignment=position valignment=position "
             "xpos=0.9 ypos=0.1"),
    ("GRAY8", "textoverlay text=X valignment=center"),
    ("I420", "textoverlay text=silent silent=true"),
])
def test_text_overlays(fmt, desc):
    _, out = one_input(fmt, desc, w=W, h=H)
    assert changed(out, fmt) != ("silent=true" in desc)


def changed(out, fmt, batch=2):
    """Does the first sample differ from one_input's first input?"""
    pushed = video_pushes({"in": (fmt, W, H)}, batch, 1)["in"][0]["data"]
    return any(not np.array_equal(o.numpy(), p) for o, p in
               zip(out["out"][0].buffer.data, pushed))


def test_timeoverlay_blends_each_frame_into_one_copy(monkeypatch):
    """A bitmap a frame, written into one unpacked copy of the batch: the
    blend sees every frame's rectangle once, nothing is concatenated."""
    calls = []
    real = tov.video_blend

    def spy(chans, *a, frames=None, **kw):
        calls.append((frames, chans[1].data_ptr()))
        return real(chans, *a, frames=frames, **kw)

    monkeypatch.setattr(tov, "video_blend", spy)
    one_input("I420", "timeoverlay", batch=4, ticks=1, w=W, h=H)
    assert [f for f, _ in calls] == [slice(k, k + 1) for k in range(4)]
    assert len({p for _, p in calls}) == 1


def test_clockoverlay(monkeypatch):
    fixed = time.struct_time((2026, 10, 17, 12, 34, 56, 5, 290, 0))
    monkeypatch.setattr(time, "localtime", lambda *a: fixed)
    one_input("I420", "clockoverlay", w=W, h=H)
    one_input("Y444", "clockoverlay time-format=%Y-%m-%d halignment=center "
              "shaded-background=true", w=W, h=H)


@pytest.mark.parametrize("fmt,desc", [
    ("I420", "qroverlay data=hello pixel-size=2"),
    ("NV12", "qroverlay data=hello-qr x=0 y=100 "
             "qrcode-error-correction=H"),
    ("RGB", "debugqroverlay"),
    ("AYUV", "debugqroverlay span-buffer=3 extra-data-name=k "
             "extra-data-array=a,b pixel-size=1"),
])
def test_qr_overlays(fmt, desc):
    _, out = one_input(fmt, desc, batch=3, w=W, h=H)
    assert len(out["out"]) == 2 and changed(out, fmt, 3)


def _logo(tmp_path, channels=4):
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (10, 14, channels), np.uint8)
    path = tmp_path / f"logo{channels}.png"
    path.write_bytes(png_encode(img))
    return path


@pytest.mark.parametrize("fmt,args", [
    ("I420", "offset-x=-3 offset-y=-2"),
    ("RGBx", "overlay-width=30 overlay-height=20 alpha=0.5 relative-x=0.1"),
    ("Y444", "offset-x=-20 offset-y=-40 relative-y=0.2"),
    ("BGRx", "offset-x=58 offset-y=44 alpha=0"),
])
def test_gdkpixbufoverlay(tmp_path, fmt, args):
    _, out = one_input(fmt, f"gdkpixbufoverlay location={_logo(tmp_path)} "
                       f"{args}", w=W, h=H)
    assert changed(out, fmt) != ("alpha=0" in args.split())


@pytest.mark.parametrize("args", ["x=3 y=-4", "fit-to-frame=true"])
def test_rsvgoverlay(tmp_path, args):
    path = tmp_path / "a.svg"
    path.write_text(SVG)
    _, out = one_input("I420", f"rsvgoverlay location={path} {args}", w=W,
                       h=H)
    assert changed(out, "I420")


def _run_set(parse, buffer_cls, desc, pushes, setup, **kw):
    pipe = parse(desc, batch=2, **kw)
    _name_elements(pipe)
    setup(pipe)
    for b in pushes:
        pipe.get_by_name("in").push_buffer(buffer_cls(**dict(
            b, data=_copy(b["data"]))))
    pipe.get_by_name("in").end_of_stream()
    pipe.run()
    out = []
    while (s := pipe.get_by_name("out").pull_sample()) is not None:
        out.append(s)
    return pipe, {"out": out}


def run_both_set(desc, pushes, jsetup, tsetup):
    """run_both with a setup step (callbacks, compositions) on each
    package's pipeline before it runs."""
    jpipe, ref = _run_set(jparse_launch, JBuffer, desc, pushes["in"],
                          jsetup)
    tpipe, out = _run_set(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                          pushes["in"], tsetup, device="cpu")
    assert_same_samples(out, ref, ("out",))
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)
    return out


@pytest.mark.parametrize("fmt", ["RGBA", "I420"])
def test_overlaycomposition(fmt):
    """The meta, then the draw callback, then the static composition."""
    px = np.random.default_rng(15).integers(0, 256, (6, 9, 4)) \
        .astype(np.uint8)
    pushes = video_pushes({"in": (fmt, W, H)}, 2, 3)

    def setup(mod):
        def fn(pipe):
            oc = pipe.get_by_name("oc")
            oc.composition = mod.VideoOverlayComposition([
                mod.VideoOverlayRectangle(px, render_x=-3, render_y=40,
                                          render_width=12, global_alpha=0.6)])
            oc.draw = lambda buf: (mod.VideoOverlayComposition([
                mod.VideoOverlayRectangle(px, render_x=50, render_y=2,
                                          premultiplied=True)])
                if buf.pts else None)
        return fn

    out = run_both_set(src(fmt, W, H) + "overlaycomposition name=oc ! "
                       "appsink name=out", pushes, setup(jov), setup(tov))
    assert len(out["out"]) == 3


def test_cairooverlay():
    seen = {}

    def setup(key):
        def fn(pipe):
            c = pipe.get_by_name("c")

            def draw(surface, pts, dur):
                seen.setdefault(key, []).append(pts)
                if pts % 3:
                    surface[10:20, 10:30] = (0, 255, 0, 200)
            c.draw = draw
            c.on_caps = lambda info: seen.setdefault(key + "caps",
                                                     info.width)
        return fn

    run_both_set(src("RGB", W, H) + "cairooverlay name=c ! appsink name=out",
                 video_pushes({"in": ("RGB", W, H)}, 2, 2),
                 setup("j"), setup("t"))
    assert seen["j"] == seen["t"] and seen["jcaps"] == seen["tcaps"] == W


def test_textrender():
    """A buffer of two texts (host bytes, not staged) -> two ARGB
    frames."""
    desc = ("appsrc name=in ! text/x-raw,format=utf8 ! textrender ! "
            "video/x-raw,format=ARGB,width=160,height=60 ! appsink name=out")

    def push(pipe, buffer_cls):
        pipe.get_by_name("in").push_buffer(buffer_cls(
            data=[b"Hello", b"two\nlines"], pts=0, duration=DUR))
        pipe.get_by_name("in").end_of_stream()

    jp = jparse_launch(desc)
    tp = gstreamer_tpu_torch.parse_launch(desc, device="cpu")
    out = {}
    for key, pipe, buffer_cls in (("j", jp, JBuffer), ("t", tp, Buffer)):
        _name_elements(pipe)
        push(pipe, buffer_cls)
        pipe.run()
        out[key] = {"out": [pipe.get_by_name("out").pull_sample()]}
    assert_same_samples(out["t"], out["j"], ("out",))
    assert negotiated_caps(tp) == negotiated_caps(jp)
    assert out["t"]["out"][0].buffer.batch == 2


@pytest.mark.parametrize("factory,kinds", [
    ("gdkpixbufdec", ["png_rgb", "jpeg", "bmp", "png_rgba"]),
    ("rsvgdec", ["svg"]),
])
def test_decoders(factory, kinds):
    blobs = [SVG.encode() if k == "svg" else _encoded(k) for k in kinds]
    for blob in blobs:
        ref = jelement.element_factory_make(factory).host_process(
            JBuffer(data=np.frombuffer(blob, np.uint8), batch=1))
        e = telement.element_factory_make(factory)
        e.device = torch.device("cpu")
        got = e.host_process(Buffer(data=np.frombuffer(blob, np.uint8),
                                    batch=1))
        assert got.batch == ref.batch == 1
        for g, r in zip(got.data, ref.data):
            assert g.dtype == torch.uint8
            assert np.array_equal(g.numpy(), np.asarray(r))


def test_gdkpixbufsink():
    desc = src("RGB", 16, 8) + "gdkpixbufsink name=s"
    pushes = video_pushes({"in": ("RGB", 16, 8)}, 2, 2)
    got = []
    for parse, buffer_cls, kw in ((jparse_launch, JBuffer, {}),
                                  (gstreamer_tpu_torch.parse_launch, Buffer,
                                   {"device": "cpu"})):
        p = parse(desc, batch=2, **kw)
        for b in pushes["in"]:
            p.get_by_name("in").push_buffer(buffer_cls(**dict(
                b, data=_copy(b["data"]))))
        p.get_by_name("in").end_of_stream()
        p.run()
        msgs = [m.data["pixbuf"] for m in iter(p.bus.pop, None)
                if m.type == "element" and m.data.get("name") == "pixbuf"]
        got.append((p.get_by_name("s").last_pixbuf, msgs))
    (jl, jm), (tl, tm) = got
    assert len(tm) == len(jm) == 4
    for a, b in zip([tl] + tm, [jl] + jm):
        assert a.dtype == np.uint8 and np.array_equal(a, np.asarray(b))
