"""The port's device video effects against the JAX package, bit for bit.

coloreffects, chromahold, the gaudieffects, the geometrictransform family
(every off-edge-pixels mode) and bayer2rgb / rgb2bayer (every pattern and
depth, both byte orders): the same launch string and the same seeded numpy
frames go through both packages (``test_torch_compositor.run_both``),
samples and negotiated caps equal.  Tolerance 0, the two float cases
included:

* chromahold's float32 keep test is a table over all 65 536 (u, v) pairs
  in the port; it equals the JAX element's jitted output on every pair at
  several property sets (a failure names the first differing pair);
* gaussianblur rounds ``acc + x * k`` once, as XLA's fused multiply-add on
  the CPU does, and equals the JAX package; a sum rounded twice (product,
  then sum) differs from it on the same input, which shows the test can
  tell them apart.

Every factory keeps the reference's properties and pad templates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstreamer_tpu.core import element as jelement
from gstreamer_tpu.core.caps import Caps as JCaps

from gstreamer_tpu_torch.core import element as telement
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.elements.bayer import BAYER_FORMATS
from gstreamer_tpu_torch.elements.coloreffects import chromahold_table
from gstreamer_tpu_torch.elements.gaudieffects import (edge_sums,
                                                       gaussian_kernel)

from test_torch_compositor import run_both
from test_torch_filters import one_input
from test_torch_flow import _spec

W, H = 40, 30
GAUDI = ("burn", "chromium", "dilate", "dodge", "exclusion", "gaussianblur",
         "solarize")
GEOMETRIC = ("bulge", "circle", "diffuse", "fisheye", "kaleidoscope",
             "marble", "mirror", "perspective", "pinch", "rotate", "sphere",
             "square", "stretch", "tunnel", "twirl", "waterripple")
EFFECT_FACTORIES = ("coloreffects", "chromahold") + GAUDI + GEOMETRIC + (
    "bayer2rgb", "rgb2bayer")


@pytest.mark.parametrize("factory", EFFECT_FACTORIES)
def test_factory_matches_reference(factory):
    jelement._ensure_elements_loaded()
    telement._ensure_elements_loaded()
    assert _spec(telement._REGISTRY[factory][0]) == \
        _spec(jelement._REGISTRY[factory][0])


# -- coloreffects, chromahold ------------------------------------------------

@pytest.mark.parametrize("preset", ["none", "heat", "sepia", "xray", "xpro",
                                    "yellowblue"])
def test_coloreffects(preset):
    one_input("AYUV", f"coloreffects preset={preset}", w=W, h=H)


@pytest.mark.parametrize("props", ["", "target-r=0 target-g=255 target-b=0 "
                                       "tolerance=45",
                                   "target-r=30 target-g=60 target-b=200 "
                                   "tolerance=5"])
def test_chromahold(props):
    one_input("AYUV", f"chromahold {props}", w=W, h=H)


CHROMAHOLD_PROPS = [
    {}, {"tolerance": 0}, {"tolerance": 10}, {"tolerance": 90},
    {"tolerance": 180}, {"target-r": 0, "target-g": 255, "target-b": 0,
                         "tolerance": 45},
    {"target-r": 30, "target-g": 60, "target-b": 200, "tolerance": 5},
    {"target-r": 128, "target-g": 128, "target-b": 128, "tolerance": 20}]


def test_chromahold_table_on_every_pair():
    """All 65 536 (u, v) pairs through the JAX element's jitted function
    (XLA's own float32 atan2) against the port's table (float64 atan2
    rounded to float32): the same output chroma everywhere."""
    u, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    u, v = u.astype(np.uint8)[None], v.astype(np.uint8)[None]
    zero = jnp.zeros(u.shape, jnp.uint8)
    jelement._ensure_elements_loaded()
    for props in CHROMAHOLD_PROPS:
        e = jelement._REGISTRY["chromahold"][0](**props)
        out = jax.jit(e.make_fn())([zero, jnp.asarray(u), jnp.asarray(v),
                                    zero])
        want = np.stack([np.asarray(out[1])[0], np.asarray(out[2])[0]])
        keep = chromahold_table(e.props["target-r"], e.props["target-g"],
                                e.props["target-b"], e.props["tolerance"])
        got = np.stack([np.where(keep, u[0], 128), np.where(keep, v[0], 128)])
        bad = np.argwhere((got != want).any(0))
        assert not len(bad), (f"{props}: {len(bad)} pairs differ, the "
                              f"first (u, v) = {tuple(bad[0])}")
        assert 0 < keep.sum() < keep.size or props.get("tolerance") == 180


# -- gaudieffects ------------------------------------------------------------

@pytest.mark.parametrize("fmt,desc", [
    ("RGBx", "burn"), ("BGRA", "burn adjustment=0"),
    ("RGBx", "chromium"), ("RGBA", "chromium edge-a=17 edge-b=200"),
    ("BGRx", "dilate"), ("RGBA", "dilate erode=true"),
    ("RGBx", "dodge"),
    ("RGBx", "exclusion"), ("BGRA", "exclusion factor=1"),
    ("RGBx", "solarize"), ("RGBA", "solarize threshold=30 start=200 end=10"),
    ("BGRx", "solarize threshold=0 start=0 end=0"),
])
def test_gaudi(fmt, desc):
    one_input(fmt, desc, w=W, h=H)


@pytest.mark.parametrize("sigma", [1.2, -1.0, 0.3, 0.0, 3.3])
def test_gaussianblur(sigma):
    one_input("AYUV", f"gaussianblur sigma={sigma}", w=W, h=H)


def _blur_pair(sigma, planes, w, h):
    caps = f"video/x-raw, format=AYUV, width={w}, height={h}"
    jelement._ensure_elements_loaded()
    telement._ensure_elements_loaded()
    e = jelement._REGISTRY["gaussianblur"][0](sigma=sigma)
    e.set_info(JCaps.from_string(caps), JCaps.from_string(caps))
    want = [np.asarray(x) for x in
            jax.jit(e.make_fn())([jnp.asarray(p) for p in planes])]
    t = telement._REGISTRY["gaussianblur"][0](sigma=sigma)
    t.device = torch.device("cpu")
    t.set_info(Caps.from_string(caps), Caps.from_string(caps))
    got = [x.numpy() for x in t.make_fn()([torch.from_numpy(p)
                                           for p in planes])]
    return want, got


def _blur_rounded_twice(sigma, planes):
    """The separable sum with the product and the sum each rounded to
    float32."""
    center, kernel, ksum = gaussian_kernel(sigma)

    def axis(x, ax):
        n = x.shape[ax]
        pad = [(0, 0)] * x.ndim
        pad[ax] = (center, center)
        xp = np.pad(x, pad)
        acc = np.zeros(x.shape, np.float32)
        for k, tap in enumerate(kernel):
            acc = acc + np.take(xp, np.arange(k, k + n), axis=ax) * tap
        s = edge_sums(n, center, ksum)
        return acc / (s if ax == -1 else s[:, None])

    return [np.clip(axis(axis(p.astype(np.float32), -1), -2)
                    + np.float32(0.5), 0, 255).astype(np.uint8)
            for p in planes]


def test_gaussianblur_rounds_once_like_xla():
    """At 333x217 the two roundings differ: the port equals the JAX
    package everywhere, the twice-rounded sum does not."""
    rng = np.random.default_rng(0)
    planes = [rng.integers(0, 256, (2, 217, 333), dtype=np.uint8)
              for _ in range(4)]
    want, got = _blur_pair(2.5, planes, 333, 217)
    for c, (g, wnt) in enumerate(zip(got, want)):
        bad = np.argwhere(g != wnt)
        assert not len(bad), (f"plane {c}: {len(bad)} samples differ, the "
                              f"first at {tuple(bad[0])}")
    twice = _blur_rounded_twice(2.5, planes)
    assert sum(int((t != wnt).sum()) for t, wnt in zip(twice, want)) > 0


# -- geometrictransform ------------------------------------------------------

GEOM_ARGS = {"kaleidoscope": "sides=5 angle=0.3", "marble": "seed=3",
             "diffuse": "seed=2 scale=6", "mirror": "mode=bottom",
             "rotate": "angle=0.3", "twirl": "radius=0.6",
             "waterripple": "phase=1.5", "circle": "height=30"}
FORMATS = ("AYUV", "ARGB", "BGRA", "ABGR", "RGBA")


@pytest.mark.parametrize("factory", GEOMETRIC)
def test_geometric(factory):
    """Every off-edge-pixels mode, on one of the five formats each."""
    fmt = FORMATS[GEOMETRIC.index(factory) % len(FORMATS)]
    for mode in ("ignore", "clamp", "wrap"):
        one_input(fmt, f"{factory} off-edge-pixels={mode} "
                  f"{GEOM_ARGS.get(factory, '')}", w=W, h=H)


def test_perspective_matrix():
    """perspective takes its matrix as an object property: set it on the
    element of each package."""
    from test_torch_overlay import run_both_set
    from test_torch_compositor import video_pushes
    m = [1.1, 0.2, -3.0, -0.1, 0.9, 2.0, 0.001, 0.002, 1.0]

    def setup(pipe):
        pipe.get_by_name("p").props["matrix"] = m

    run_both_set(f"appsrc name=in caps=video/x-raw,format=AYUV,width={W},"
                 f"height={H},framerate=30/1 ! perspective name=p "
                 f"off-edge-pixels=clamp ! appsink name=out",
                 video_pushes({"in": ("AYUV", W, H)}, 2, 2), setup, setup)


def test_geometric_maps_go_to_the_device_once():
    e = telement.element_factory_make("rotate", angle=0.3)
    e.device = torch.device("cpu")
    caps = Caps.from_string(f"video/x-raw, format=AYUV, width={W}, "
                            f"height={H}")
    e.set_info(caps, caps)
    fn = e.make_fn()
    consts = [c.cell_contents for c in fn.__closure__
              if isinstance(c.cell_contents, torch.Tensor)]
    assert sorted(tuple(c.shape) for c in consts) == [(H, W), (H * W,)]


# -- bayer -------------------------------------------------------------------

BW, BH = 16, 12


def bayer_pushes(fmt, batch=2, ticks=2, seed=0):
    rng = np.random.default_rng(seed)
    bpp = 8 if len(fmt) == 4 else int(fmt[4:-2])
    dt = np.uint8 if bpp == 8 else np.uint16
    return {"in": [dict(data=rng.integers(0, 1 << bpp, (batch, BH, BW))
                        .astype(dt), pts=t * batch * 33333333,
                        duration=33333333, batch=batch)
                   for t in range(ticks)]}


def bayer_src(fmt):
    return (f"appsrc name=in caps=video/x-bayer,format={fmt},width={BW},"
            f"height={BH},framerate=30/1 ! ")


@pytest.mark.parametrize("pattern", ["bggr", "gbrg", "grbg", "rggb"])
def test_bayer2rgb(pattern):
    """Every depth and byte order of the pattern into its default output
    (RGBA, or RGBA64_LE above 8 bits), then 8 bits into RGBA64_LE and 12
    into RGBA."""
    for fmt in (f for f in BAYER_FORMATS if f.startswith(pattern)):
        run_both(bayer_src(fmt) + "bayer2rgb ! appsink name=out",
                 bayer_pushes(fmt), batch=2)
    for fmt, out in ((pattern, "RGBA64_LE"), (f"{pattern}12le", "BGRx")):
        run_both(bayer_src(fmt) + f"bayer2rgb ! video/x-raw,format={out} ! "
                 "appsink name=out", bayer_pushes(fmt), batch=2)


@pytest.mark.parametrize("pattern", ["bggr", "gbrg", "grbg", "rggb"])
def test_rgb2bayer(pattern):
    """ARGB into every depth and byte order of the pattern, and back
    through bayer2rgb at 8 bits."""
    src = (f"appsrc name=in caps=video/x-raw,format=ARGB,width={BW},"
           f"height={BH},framerate=30/1 ! ")
    from test_torch_compositor import video_pushes
    pushes = video_pushes({"in": ("ARGB", BW, BH)}, 2, 2)
    for fmt in (f for f in BAYER_FORMATS if f.startswith(pattern)):
        _, out = run_both(src + f"rgb2bayer ! video/x-bayer,format={fmt} ! "
                          "appsink name=out", pushes, batch=2)
        want = torch.uint8 if fmt == pattern else torch.uint16
        assert out["out"][0].buffer.data.dtype == want
    run_both(src + f"rgb2bayer ! video/x-bayer,format={pattern} ! bayer2rgb "
             "! video/x-raw,format=RGBA ! appsink name=out", pushes, batch=2)
