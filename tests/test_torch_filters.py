"""The port's video filters against the JAX package, bit for bit.

gamma, videoflip, videocrop, videobox, videomedian and alpha: the same
launch string goes through the JAX ``parse_launch`` and the port's
(``device="cpu"``), fed the same seeded numpy frames through ``appsrc``
(``test_torch_compositor.run_both``); every appsink sample and every pad's
negotiated caps must be equal.  Tolerance 0.  Last, ``chip_smoke.py``'s
portrait tee string at a small size, with the converter's kernel calls
counted.
"""

import itertools

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements.videofilter import _median5
from gstreamer_tpu_torch.interop import negotiated_caps

from test_torch_compositor import (_run, _spy, assert_same_samples,
                                   run_both, video_pushes)

W, H = 37, 29          # odd: every subsampled plane rounds up


def src(fmt, w=W, h=H):
    return (f"appsrc name=in caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=30/1 ! ")


def one_input(fmt, desc, batch=2, ticks=2, w=W, h=H):
    """`desc` after an appsrc of `fmt` frames, into appsink "out", through
    both packages."""
    return run_both(src(fmt, w, h) + desc + " ! appsink name=out",
                    video_pushes({"in": (fmt, w, h)}, batch, ticks),
                    batch=batch)


METHODS = ("none", "clockwise", "rotate-180", "counterclockwise",
           "horizontal-flip", "vertical-flip", "upper-left-diagonal",
           "upper-right-diagonal")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fmt", ["I420", "RGB"])
def test_videoflip(method, fmt):
    tpipe, out = one_input(fmt, f"videoflip method={method}")
    y = out["out"][0].buffer.data[0]
    turned = method in ("clockwise", "counterclockwise",
                        "upper-left-diagonal", "upper-right-diagonal")
    assert tuple(y.shape[-2:]) == ((W, H) if turned else (H, W))


@pytest.mark.parametrize("crop", [(1, 2, 3, 4), (3, 0, 0, 5), (0, -3, -3, 1),
                                  (-2, 1, 2, -1)])
@pytest.mark.parametrize("fmt", ["I420", "NV12", "RGB"])
def test_videocrop(crop, fmt):
    t, b, l, r = crop
    one_input(fmt, f"videocrop top={t} bottom={b} left={l} right={r}")


@pytest.mark.parametrize("box,fill", [((1, 2, 3, 4), "black"),
                                      ((-3, -2, -5, -4), "green"),
                                      ((-3, 2, 5, -1), "blue"),
                                      ((2, -1, -1, 3), "black")])
@pytest.mark.parametrize("fmt", ["I420", "NV12", "YUY2"])
def test_videobox(box, fill, fmt):
    """Odd and negative sides: a negative side on a subsampled plane
    shifts with Python's floor (-3 >> 1 == -2), a border is the fill."""
    t, b, l, r = box
    one_input(fmt, f"videobox top={t} bottom={b} left={l} right={r} "
              f"fill={fill}")


def test_videobox_pads_on_uint8():
    _, out = one_input("I420", "videobox top=-4 left=-4 fill=green")
    y, u, v = out["out"][0].buffer.data
    assert y.dtype == u.dtype == torch.uint8
    assert (y[:, :4] == 145).all() and (u[:, :2] == 54).all() \
        and (v[:, :, :2] == 34).all()


@pytest.mark.parametrize("lum_only", [True, False])
@pytest.mark.parametrize("size", [(W, H), (2, 5), (5, 2)])
def test_videomedian(lum_only, size):
    w, h = size
    one_input("I420", f"videomedian lum-only={str(lum_only).lower()}",
              w=w, h=h)


def test_median5_is_the_third_smallest():
    """By the 0-1 principle a compare-exchange network that selects the
    median of every 0/1 input selects it of every input; every 5-tuple of
    0..4 covers that and more."""
    t = np.array(list(itertools.product(range(5), repeat=5)), np.uint8)
    got = _median5(*(torch.from_numpy(t[:, k].copy()) for k in range(5)))
    assert np.array_equal(got.numpy(),
                          np.median(t.astype(np.int32), axis=1))


@pytest.mark.parametrize("gamma", [0.5, 1.2, 2.2])
def test_gamma(gamma):
    one_input("I420", f"gamma gamma={gamma}")


def test_gamma_lut_is_made_once():
    """The LUT goes to the device when the function is made, not per
    tick."""
    pipe = gstreamer_tpu_torch.parse_launch(
        src("I420") + "gamma gamma=2.2 ! appsink name=out", device="cpu")
    pipe.compile(batch=1)
    fn = pipe._fns[next(e for e in pipe.iterate_elements()
                        if e.FACTORY == "gamma")]
    lut = next(c.cell_contents for c in fn.__closure__
               if isinstance(c.cell_contents, torch.Tensor))
    assert lut.dtype == torch.uint8 and lut.shape == (256,)


@pytest.mark.parametrize("method,alpha", [("set", 0.5), ("set", 1.0),
                                          ("green", 0.7), ("blue", 1.0)])
@pytest.mark.parametrize("out", ["AYUV", "ARGB"])
def test_alpha(method, alpha, out):
    """The chroma key against random chroma: about a tenth of the samples
    lie inside the default angle's tolerance."""
    _, got = one_input("I420", f"alpha method={method} alpha={alpha} ! "
                       f"video/x-raw,format={out}", w=36, h=28)
    a = got["out"][0].buffer.data[3]
    assert (a == int(alpha * 255)).any()
    if method != "set":
        assert (a == 0).any()


def tee_desc(w, h, ow, oh, pw, ph):
    """chip_smoke.py's filters_tee at (w, h) in: two branches to RGB
    (ow, oh), one to RGB (pw, ph), one through a closed valve."""
    return (src("I420", w, h) + "videocrop top=4 bottom=4 ! "
            "videoflip method=clockwise ! videomedian ! gamma gamma=1.2 ! "
            "tee name=t "
            f"t. ! queue ! videoconvertscale add-borders=false ! "
            f"video/x-raw,format=RGB,width={ow},height={oh} ! appsink name=out "
            f"t. ! queue2 ! videoconvertscale method=catrom "
            f"add-borders=false ! video/x-raw,format=RGB,width={ow},"
            f"height={oh} ! appsink name=out_cubic "
            f"t. ! queue ! videoconvertscale method=catrom "
            f"add-borders=false ! video/x-raw,format=RGB,width={pw},"
            f"height={ph} ! appsink name=out_portrait "
            f"t. ! queue ! valve drop=true ! fakesink name=drop")


def upstream(e):
    return e.sink_pads()[0].peer.element


def test_portrait_tee(monkeypatch):
    """The portrait tee at 64x48 -> 40x64: all three branches equal the
    JAX package's.  To a square (16x16) the plan scales v before h
    (scale_order "vh": the output is relatively wider than the input), so
    both square branches take the generic route and call no kernel; to a
    portrait of the input's aspect (10x16, "hv") the catrom branch runs
    yscale on Y and chroma420 on U and V: 1 and 2 calls a tick.  The
    port's valve drops every buffer (the JAX package's passes them:
    ROADMAP.md section 3); the valve makes the graph per-element, so the
    queues hold a tick and flush at EOS."""
    calls = _spy(monkeypatch)
    batch, ticks = 2, 3
    pushes = video_pushes({"in": ("I420", 64, 48)}, batch, ticks)
    desc = tee_desc(64, 48, 16, 16, 10, 16)
    sinks = ("out", "out_cubic", "out_portrait")
    jpipe, ref = _run(jparse_launch, JBuffer, desc, pushes, sinks, batch)
    tpipe, got = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, pushes,
                      sinks, batch, device="cpu")
    assert_same_samples(got, ref, sinks)
    assert [len(got[s]) for s in sinks] == [ticks] * 3
    order = {s: upstream(upstream(tpipe.get_by_name(s)))
             ._converter.plan["scale_order"] for s in sinks}
    assert order == {"out": "vh", "out_cubic": "vh", "out_portrait": "hv"}
    assert calls == {"yscale_hv": ticks, "chroma420_scale": 2 * ticks}
    assert not tpipe._fused and jpipe._fused
    assert tpipe.get_by_name("drop").n_rendered == 0
    assert jpipe.get_by_name("drop").n_rendered == batch * ticks
    # the links of the valve are host memory in the port (a host gate),
    # device memory in the JAX package; every other pad agrees
    tc, jc = negotiated_caps(tpipe), negotiated_caps(jpipe)
    differ = {k for k in tc if tc[k] != jc[k]}
    valve = next(e for e in tpipe.iterate_elements()
                 if e.FACTORY == "valve")
    feed = valve.sink_pads()[0].peer
    assert differ == {f"{valve.name}:sink", f"{valve.name}:src",
                      "drop:sink", f"{feed.element.name}:{feed.name}"}
    for k in differ:
        assert tc[k] == jc[k].replace("memory:HBM", "memory:SystemMemory")
