"""The port's audio visualizers against the JAX package, bit for bit:
visualizers (the AudioVisualizerElement base and its shaders, wavescope,
spectrascope, spacescope, synaescope), monoscope and goom2k1.

The drawing primitives, shaders and goom's state machine are held to the
JAX package's on seeded canvases; each scope runs the same launch string on
the same seeded S16 pushes in both packages (the port with
``device="cpu"``): frames, timestamps, caps and negotiation equal,
tolerance 0.  A tick's frames leave the element as three planes of one
tensor (one copy to the samples' device).
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.elements import goom2k1 as jgoom
from gstreamer_tpu.elements import monoscope as jmono
from gstreamer_tpu.elements import visualizers as jvis

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.elements import goom2k1 as tgoom
from gstreamer_tpu_torch.elements import monoscope as tmono
from gstreamer_tpu_torch.elements import visualizers as tvis

from test_torch_analytics import same_spec
from test_torch_captions import CPU, host_element, pair, plain

FACTORIES = ("wavescope", "spectrascope", "spacescope", "synaescope",
             "monoscope", "goom2k1")


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


# -- primitives and shaders ---------------------------------------------------

def canvas(w, h, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, h * w + w + 2, dtype=np.uint64).astype(
        np.uint32)


def test_draw_primitives():
    """draw_dot / draw_dot_c on seeded coordinates (repeats included),
    draw_dot_aa, draw_line_aa in every octant, add_pixel saturating."""
    w, h = 37, 21
    rng = np.random.default_rng(0)
    xs, ys = rng.integers(0, w, 300), rng.integers(0, h, 300)
    for fn in ("draw_dot", "draw_dot_c"):
        a, b = canvas(w, h, 1), canvas(w, h, 1)
        getattr(tvis, fn)(a, xs, ys, w, 0x00FF00FF)
        getattr(jvis, fn)(b, xs, ys, w, 0x00FF00FF)
        assert np.array_equal(a, b)
    a, b = canvas(w, h, 2), canvas(w, h, 2)
    for k in range(50):
        f = float(rng.random())
        tvis.draw_dot_aa(a, int(xs[k]), int(ys[k]), w, 0x00C0FFEE, f)
        jvis.draw_dot_aa(b, int(xs[k]), int(ys[k]), w, 0x00C0FFEE, f)
        tvis.add_pixel(a, int(ys[k]) * w + int(xs[k]), 0x7F7F7F7F)
        jvis.add_pixel(b, int(ys[k]) * w + int(xs[k]), 0x7F7F7F7F)
    for x1, x2, y1, y2 in ((0, 30, 0, 10), (30, 0, 10, 0), (5, 6, 0, 19),
                           (20, 3, 15, 2), (4, 4, 4, 4)):
        tvis.draw_line_aa(a, x1, x2, y1, y2, w, 0x00FFFFFF)
        jvis.draw_line_aa(b, x1, x2, y1, y2, w, 0x00FFFFFF)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("shader", jvis.SHADERS)
@pytest.mark.parametrize("w,h", [(8, 6), (9, 7), (1, 3)])
def test_shaders(shader, w, h):
    """Each of the ten shaders byte for byte into a seeded temp frame
    (the regions a shader leaves keep the old bytes)."""
    rng = np.random.default_rng(w * h)
    frame = rng.integers(0, 256, (h, w * 4), dtype=np.uint8)
    a = rng.integers(0, 256, (h, w * 4), dtype=np.uint8)
    b = a.copy()
    tvis.apply_shader(shader, frame, a, 0x00102030)
    jvis.apply_shader(shader, frame, b, 0x00102030)
    assert np.array_equal(a, b)


def test_tables_and_filter():
    assert np.array_equal(tvis._SYNAE_COLORS, jvis._SYNAE_COLORS)
    assert np.array_equal(tvis._SYNAE_SHADE, jvis._SYNAE_SHADE)
    a, b = np.zeros(6), np.zeros(6)
    for v in np.random.default_rng(1).normal(0, 9000, 200):
        tvis._three_band_filter(a, float(v))
        jvis._three_band_filter(b, float(v))
    assert np.array_equal(a, b)


# -- the scopes through launch strings ----------------------------------------

def s16_pushes(ch, rate, frames, pushes, seed, kind="noise"):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(pushes):
        n = np.arange(t * frames, (t + 1) * frames)
        if kind == "sine":
            x = np.stack([12000 * np.sin(2 * np.pi * (440 + 660 * c) * n
                                         / rate) for c in range(ch)], -1)
        else:
            x = rng.normal(0, 6000, (frames, ch))
        out.append(dict(data=np.clip(x, -32768, 32767).astype(np.int16),
                        pts=t * frames * 10 ** 9 // rate,
                        duration=frames * 10 ** 9 // rate))
    return out


def scope_desc(ch, rate, chain, caps="video/x-raw,width=32,height=24,"
               "framerate=30/1"):
    return (f"appsrc name=in caps=audio/x-raw,format=S16LE,rate={rate},"
            f"channels={ch},layout=interleaved ! {chain} ! {caps} ! "
            f"appsink name=out")


@pytest.mark.parametrize("style", ["dots", "lines", "color-dots",
                                   "color-lines"])
@pytest.mark.parametrize("ch", [1, 2])
def test_wavescope(style, ch):
    _, _, _, out = pair(scope_desc(ch, 8000, f"wavescope style={style}"),
                        {"in": s16_pushes(ch, 8000, 700, 3, ch)})
    assert sum(s.buffer.batch for s in out["out"]) >= 6


@pytest.mark.parametrize("shader", ["none", "fade-and-move-up",
                                    "fade-and-move-horiz-in",
                                    "fade-and-move-vert-out"])
def test_wavescope_shaders(shader):
    pair(scope_desc(2, 8000, f"wavescope shader={shader} "
                    f"shade-amount={0x00203040}", "video/x-raw,width=33,"
                    "height=17,framerate=25/1"),
         {"in": s16_pushes(2, 8000, 1000, 2, 3, "sine")})


@pytest.mark.parametrize("ch", [1, 2])
def test_spectrascope(ch):
    pair(scope_desc(ch, 8000, "spectrascope", "video/x-raw,width=40,"
                    "height=30,framerate=30/1"),
         {"in": s16_pushes(ch, 8000, 900, 3, 5, "sine")})


@pytest.mark.parametrize("style", ["dots", "lines", "color-dots",
                                   "color-lines"])
def test_spacescope(style):
    pair(scope_desc(2, 8000, f"spacescope style={style}",
                    "video/x-raw,width=32,height=32,framerate=30/1"),
         {"in": s16_pushes(2, 8000, 600, 2, 7)})


def test_synaescope():
    pair(scope_desc(2, 8000, "synaescope", "video/x-raw,width=64,height=64,"
                    "framerate=30/1"),
         {"in": s16_pushes(2, 8000, 800, 3, 11, "sine")})


def test_scope_default_caps():
    """Without a capsfilter the base fixates 320x200 at 25/1."""
    _, _, _, out = pair(
        "appsrc name=in caps=audio/x-raw,format=S16LE,rate=8000,channels=1,"
        "layout=interleaved ! wavescope ! appsink name=out",
        {"in": s16_pushes(1, 8000, 400, 1, 0)})
    assert (out["out"][0].caps[0]["width"],
            out["out"][0].caps[0]["height"]) == (320, 200)


def test_scope_one_copy_a_tick():
    """A tick's frames go to the samples' device once: three planes of one
    tensor, each contiguous; the samples are read, not written."""
    e = host_element("wavescope")
    e.set_info(Caps.from_string(
        "audio/x-raw,format=S16LE,rate=8000,channels=1"), Caps.from_string(
        "video/x-raw,format=BGRx,width=16,height=8,framerate=50/1"))
    x = torch.from_numpy(s16_pushes(1, 8000, 800, 1, 4)[0]["data"])
    before = x.clone()
    out = e.host_process(Buffer(data=x, pts=0))
    assert out.batch == 5 and all(p.device == CPU and p.is_contiguous()
                                  for p in out.data)
    ptrs = {p.untyped_storage().data_ptr() for p in out.data}
    assert len(ptrs) == 1 and torch.equal(x, before)


# -- monoscope ----------------------------------------------------------------

def test_monoscope_tables():
    assert np.array_equal(tmono._colors(), jmono._colors())
    rng = np.random.default_rng(1)
    base = (rng.standard_normal(tmono.SMALL) * 1000).astype(np.int64)
    for shift in (0, 10, 200, 256):
        window = np.zeros(tmono.BIG, np.int64)
        window[shift:shift + tmono.SMALL] = base
        window += rng.integers(-50, 50, tmono.BIG)
        assert tmono.convolve_match(base, window) == \
            jmono.convolve_match(base, window)


@pytest.mark.parametrize("ch,rate", [(1, 44100), (2, 8000)])
def test_monoscope(ch, rate):
    pair(f"appsrc name=in caps=audio/x-raw,format=S16LE,rate={rate},"
         f"channels={ch},layout=interleaved ! monoscope ! appsink name=out",
         {"in": s16_pushes(ch, rate, 2048, 3, ch, "sine")})


# -- goom2k1 ------------------------------------------------------------------

def test_goom_tables():
    assert np.array_equal(tgoom._SINTABLE, jgoom._SINTABLE)
    for v in (0, 17, 255, 128):
        for p in range(4):
            assert tgoom._lighten(v, p) == jgoom._lighten(v, p)
    assert tgoom._lighten_word(0x33AABBDD, 2) == \
        jgoom._lighten_word(0x33AABBDD, 2)
    for a in (-7, 7, -1600, 3201):
        assert tgoom._tdiv(a, 1600) == jgoom._tdiv(a, 1600)


def _goom_state(g):
    d = {k: v for k, v in vars(g).items()}
    return plain(d)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("w,h", [(32, 24), (17, 11)])
def test_goom_state(seed, w, h):
    """GoomState over 40 updates of quiet, loud and seeded audio: every
    frame and the whole state (tables, maps, RNG position, counters)."""
    a, b = tgoom.GoomState(w, h, seed), jgoom.GoomState(w, h, seed)
    rng = np.random.default_rng(seed)
    for k in range(40):
        if k % 10 < 3:
            d = np.zeros((2, 512), np.int64)
        elif k % 10 < 6:
            d = np.full((2, 512), 30000, np.int64)
        else:
            d = rng.integers(-30000, 30000, (2, 512)).astype(np.int64)
        assert np.array_equal(a.update(d.copy()), b.update(d.copy()))
    assert _goom_state(a) == _goom_state(b)


def test_goom_water_mode():
    a, b = tgoom.GoomState(24, 16, 5), jgoom.GoomState(24, 16, 5)
    for g in (a, b):
        g.zf["mode"] = 4
        g.zf["middleX"], g.zf["middleY"] = 12, 8
        g._gen_map()
        g._zoom_apply()
    assert _goom_state(a) == _goom_state(b)


@pytest.mark.parametrize("ch", [1, 2])
def test_goom2k1(ch):
    pair(scope_desc(ch, 22050, "goom2k1 seed=1", "video/x-raw,width=48,"
                    "height=32,framerate=25/1"),
         {"in": s16_pushes(ch, 22050, 1764 * 3, 3, ch)})
