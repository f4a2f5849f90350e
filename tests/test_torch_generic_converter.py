"""The torch port's VideoConverter on every route of the reference's.

The same stored planes, made from a seed with numpy, go through the JAX
package (its numpy gold ``convert_ref`` and its pipeline jitted on the CPU
backend) and through the port (``device="cpu"`` and its own numpy gold
``convert_ref``).  All four must agree in dtype, shape and every value:
these are integer paths and the tolerance is 0.  Sizes stay at or under
192x108 (one 16-bit case at 270x135) and batches at 1-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstreamer_tpu.video import color as jcolor
from gstreamer_tpu.video.converter import VideoConverter as JConverter
from gstreamer_tpu.video.info import Colorimetry as JColorimetry
from gstreamer_tpu.video.info import VideoInfo as JInfo

from gstreamer_tpu_torch import VideoConverter, VideoInfo
from gstreamer_tpu_torch.interop import plan_arrays, plan_from_reference
from gstreamer_tpu_torch.ops import chroma420_kernel as tck
from gstreamer_tpu_torch.ops import yscale_kernel as tysk
from gstreamer_tpu_torch.video import color as tcolor
from gstreamer_tpu_torch.video.info import Colorimetry

from test_torch_format import stored_planes
from test_video_convert import CONVERSION_CASES, HIGH_DEPTH_CASES


def pair(fi, isz, fo, osz, cfg=None, in_kw=None, out_kw=None):
    """The same conversion in both packages."""
    in_kw, out_kw = in_kw or {}, out_kw or {}

    def infos(info_cls, col_cls):
        def kw(d):
            d = dict(d)
            if "colorimetry" in d:
                d["colorimetry"] = col_cls(*d["colorimetry"])
            return d
        return (info_cls(format=fi, width=isz[0], height=isz[1], **kw(in_kw)),
                info_cls(format=fo, width=osz[0], height=osz[1],
                         **kw(out_kw)))

    conv = VideoConverter(*infos(VideoInfo, Colorimetry), cfg, device="cpu")
    jconv = JConverter(*infos(JInfo, JColorimetry), cfg)
    return conv, jconv


def frames(conv, batch, seed):
    info = conv.in_info
    return stored_planes(info.finfo, info.plane_shapes(), (batch,),
                         np.random.default_rng(seed))


def check(conv, jconv, planes, jit=True):
    gold = jconv.convert_ref(planes)
    if jit:
        dev = jax.jit(jconv.trace_fn())(tuple(jnp.asarray(p) for p in planes))
    else:       # the serial dithers cannot be traced
        dev = jconv.convert(planes)
    port = conv.convert(planes)
    port_gold = conv.convert_ref(planes)
    want = np.uint16 if conv.out_info.finfo.bits == 16 else np.uint8
    assert len(port) == len(port_gold) == len(gold) == \
        len(conv.out_info.plane_shapes())
    for p, pg, g, d, shape in zip(port, port_gold, gold, dev,
                                  conv.out_info.plane_shapes()):
        g = np.asarray(g)
        assert isinstance(p, torch.Tensor)
        assert p.numpy().dtype == pg.dtype == g.dtype == want
        assert p.shape[1:] == shape
        assert np.array_equal(g, np.asarray(d))
        assert np.array_equal(p.numpy(), g)
        assert np.array_equal(pg, g)


def case_id(c):
    return f"{c[0]}-{c[1][0]}x{c[1][1]}-{c[2]}-{c[3][0]}x{c[3][1]}"


# -- the reference's own case lists ------------------------------------------

@pytest.mark.parametrize("case", CONVERSION_CASES + HIGH_DEPTH_CASES,
                         ids=case_id)
def test_reference_case_lists(case):
    conv, jconv = pair(*case)
    check(conv, jconv, frames(conv, 2, 1))


# -- chroma siting and chroma-mode -------------------------------------------

@pytest.mark.parametrize("mode", ["full", "upsample-only", "downsample-only",
                                  "none"])
@pytest.mark.parametrize("site", ["mpeg2", "none", "cosited"])
@pytest.mark.parametrize("fi,fo", [("I420", "Y444"), ("Y444", "I420"),
                                   ("I420", "Y41B")])
def test_chroma_sites_and_modes(fi, fo, site, mode):
    conv, jconv = pair(fi, (34, 22), fo, (34, 22), {"chroma-mode": mode},
                       {"chroma_site": site}, {"chroma_site": site})
    check(conv, jconv, frames(conv, 1, 2))


@pytest.mark.parametrize("site_in,site_out", [("mpeg2", "cosited"),
                                              ("none", "mpeg2"),
                                              ("cosited", "none")])
def test_chroma_resite_same_format(site_in, site_out):
    conv, jconv = pair("I420", (32, 24), "I420", (32, 24), None,
                       {"chroma_site": site_in}, {"chroma_site": site_out})
    assert conv.plan["upsample"] and conv.plan["downsample"]
    check(conv, jconv, frames(conv, 1, 3))


@pytest.mark.parametrize("mode", ["full", "input-only", "output-only",
                                  "none"])
@pytest.mark.parametrize("fi,fo", [("I420", "RGB"), ("RGB", "I420"),
                                   ("Y444", "Y444_16LE")])
def test_matrix_modes(fi, fo, mode):
    conv, jconv = pair(fi, (32, 24), fo, (32, 24), {"matrix-mode": mode},
                       {"colorimetry": ("16-235", "bt601", "bt601",
                                        "smpte170m")} if fi != "RGB" else {},
                       {"colorimetry": ("16-235", "bt709", "bt709",
                                        "bt709")} if fo != "RGB" else {})
    check(conv, jconv, frames(conv, 1, 4))


# -- src-rect crop and dest-rect embed ---------------------------------------

@pytest.mark.parametrize("fi,fo", [("I420", "RGB"), ("I420", "I420"),
                                   ("RGB", "AYUV"), ("I420", "ARGB64"),
                                   ("I420_10LE", "I420_10LE"),
                                   ("AYUV64", "BGRA")])
def test_crop_and_embed(fi, fo):
    cfg = {"src-x": 7, "src-y": 5, "src-width": 40, "src-height": 30,
           "dest-x": 9, "dest-y": 3, "dest-width": 36, "dest-height": 24,
           "border-argb": 0x80C04020}
    conv, jconv = pair(fi, (64, 48), fo, (56, 32), cfg)
    assert conv.plan["rect_active"]
    check(conv, jconv, frames(conv, 2, 5))


@pytest.mark.parametrize("fo", ["RGB", "Y42B"])
def test_crop_only_upscale(fo):
    cfg = {"src-x": 16, "src-y": 8, "src-width": 24, "src-height": 20}
    conv, jconv = pair("I420", (64, 48), fo, (64, 48), cfg)
    check(conv, jconv, frames(conv, 1, 6))


# -- gamma remap -------------------------------------------------------------

TRANSFERS = ["unknown", "gamma10", "gamma18", "gamma20", "gamma22", "bt709",
             "smpte240m", "srgb", "gamma28", "log100", "log316", "bt2020-12",
             "adobergb", "bt2020-10", "smpte2084", "arib-std-b67", "bt601"]


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("transfer", TRANSFERS)
def test_gamma_tables_entry_for_entry(transfer, bits):
    for fn in ("gamma_decode_table", "gamma_encode_table"):
        ref = getattr(jcolor, fn)(transfer, bits)
        own = getattr(tcolor, fn)(transfer, bits)
        assert own.dtype == ref.dtype and own.shape == ref.shape
        assert np.array_equal(own, ref)


BT709 = ("16-235", "bt709", "bt709", "bt709")
SRGB = ("0-255", "rgb", "srgb", "bt709")
SRGB_2020 = ("0-255", "rgb", "srgb", "bt2020")
BT2020 = ("16-235", "bt2020", "bt2020-10", "bt2020")


@pytest.mark.parametrize("fi,fo,osz,cin,cout,prim", [
    ("I420", "RGB", (48, 32), BT709, SRGB, "none"),
    ("I420", "RGB", (48, 32), BT709, SRGB_2020, "fast"),
    ("I420", "RGB", (48, 32), BT709, SRGB_2020, "merge-only"),
    ("I420", "AYUV64", (64, 32), BT709, BT709, "none"),
    ("I420", "I420", (80, 40), BT709, BT2020, "fast"),
    ("I420_10LE", "RGB", (48, 32), BT2020, SRGB, "fast"),
    ("RGB", "I420", (64, 32), SRGB, BT709, "none"),
    ("ARGB64", "ARGB64", (40, 24), SRGB, SRGB_2020, "fast"),
    ("AYUV", "RGB16", (64, 32), BT709, SRGB, "none"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_gamma_remap(fi, fo, osz, cin, cout, prim):
    conv, jconv = pair(fi, (64, 32), fo, osz,
                       {"gamma-mode": "remap", "primaries-mode": prim},
                       {"colorimetry": cin}, {"colorimetry": cout})
    assert conv.plan["do_gamma"]
    assert (conv.plan["matrix"] is None) == (jconv._plan["matrix"] is None)
    check(conv, jconv, frames(conv, 2, 7))


def test_primaries_without_gamma():
    conv, jconv = pair("I420", (64, 32), "RGB", (64, 32),
                       {"primaries-mode": "merge-only"},
                       {"colorimetry": BT709}, {"colorimetry": SRGB_2020})
    assert not conv.plan["do_gamma"]
    check(conv, jconv, frames(conv, 1, 8))


def test_heavy_taps_at_16_bits_equal_the_gold():
    # lanczos held to 2 taps has large negative lobes (a row's sum of |taps|
    # reaches 57418): at 16 bits the sums pass 2**31, so the port widens its
    # accumulator.  The reference's jitted path leaves its exact limb
    # product there (a tap above 2**13) for a float32 one and differs from
    # its own numpy gold by 1 (ROADMAP.md section 3); the port is held to
    # the gold.
    conv, jconv = pair("Y444_16LE", (270, 135), "Y444_16LE", (56, 28),
                       {"resampler-method": "lanczos", "resampler-taps": 2})
    rng = np.random.default_rng(1)
    planes = tuple(np.where(rng.random(p.shape) < 0.5, 65535, p)
                   .astype(np.uint16) for p in frames(conv, 1, 3))
    gold = jconv.convert_ref(planes)
    for p, pg, g in zip(conv.convert(planes), conv.convert_ref(planes), gold):
        assert p.dtype == torch.uint16
        assert np.array_equal(p.numpy(), g) and np.array_equal(pg, g)


# -- dither through the converter --------------------------------------------

@pytest.mark.parametrize("quant", [1, 8])
@pytest.mark.parametrize("method", ["none", "bayer", "verterr",
                                    "floyd-steinberg", "sierra-lite"])
@pytest.mark.parametrize("fi,fo", [("I420", "RGB16"),
                                   ("AYUV64", "I420_10LE")])
def test_dither_through_the_converter(fi, fo, method, quant):
    conv, jconv = pair(fi, (40, 24), fo, (32, 20),
                       {"dither-method": method,
                        "dither-quantization": quant})
    assert (conv.plan["dither"] is None) == (method == "none")
    check(conv, jconv, frames(conv, 2, 9),
          jit=method not in ("floyd-steinberg", "sierra-lite"))


def test_default_config_dithers_low_depth_output():
    conv, jconv = pair("I420", (64, 48), "BGR15", (64, 48))
    assert conv.plan["dither"].method == "bayer"
    check(conv, jconv, frames(conv, 1, 10))


# -- interlaced --------------------------------------------------------------

@pytest.mark.parametrize("h", [48, 50, 54])
@pytest.mark.parametrize("fi,fo,scale", [
    ("I420", "RGB", "down"), ("I420", "RGB", "up"), ("I420", "Y444", "down"),
    ("Y42B", "Y42B", "down"), ("Y42B", "Y42B", "up"), ("Y42B", "RGB", "same"),
    ("I420", "Y42B", "same"),
])
def test_interlaced_matches_reference(fi, fo, scale, h):
    osz = {"down": (40, h * 2 // 3), "up": (80, h * 3 // 2),
           "same": (64, h)}[scale]
    conv, jconv = pair(fi, (64, h), fo, osz, None,
                       {"interlace_mode": "interleaved"},
                       {"interlace_mode": "interleaved"})
    assert conv.plan["interlaced"]
    check(conv, jconv, frames(conv, 2, 11))


@pytest.mark.parametrize("h", [48, 50, 54])
@pytest.mark.parametrize("scale", ["down", "up"])
def test_interlaced_to_420_output(scale, h):
    # The reference cannot run this plan: its down2_interlaced names a
    # module it does not import (NameError).  The port is held to its own
    # numpy gold, to the output's plane shapes, to the reference on the
    # luma plane, which the chroma downsample does not touch, and to rows
    # picked from the reference's 4:2:2 output on the chroma planes.
    osz = (40, h * 2 // 3) if scale == "down" else (80, h * 3 // 2)
    kw = {"interlace_mode": "interleaved"}
    conv, jconv = pair("I420", (64, h), "I420", osz, None, kw, kw)
    planes = frames(conv, 2, 12)
    with pytest.raises(NameError):
        jconv.convert_ref(planes)
    port, gold = conv.convert(planes), conv.convert_ref(planes)
    for p, g, shape in zip(port, gold, conv.out_info.plane_shapes()):
        assert p.dtype == torch.uint8 and p.shape[1:] == shape
        assert np.array_equal(p.numpy(), g)
    # Independent gold for chroma: the reference's 4:2:2 output of the same
    # conversion has the chroma planes before any vertical downsample (at
    # the stored width already; picking rows commutes with the horizontal
    # filter).  Stored chroma row c is full row (c & ~1) * 2 + (c & 1), the
    # 4:2:0 pack's rule for interlaced frames.  Tolerance 0.
    _, j422 = pair("I420", (64, h), "Y42B", osz, None, kw, kw)
    full = j422.convert_ref(planes)
    cs = np.arange(port[1].shape[-2])
    rows = np.minimum((cs & ~1) * 2 + (cs & 1), osz[1] - 1)
    for i in (1, 2):
        assert np.array_equal(port[i].numpy(), full[i][..., rows, :])
    luma, jluma = pair("I420", (64, h), "Y444", osz, None, kw, kw)
    assert np.array_equal(port[0].numpy(), jluma.convert_ref(planes)[0])
    assert np.array_equal(port[0].numpy(), luma.convert_ref(planes)[0])


# -- routes of the port held against each other ------------------------------

@pytest.mark.parametrize("w,h,ow,oh,fmt", [
    (64, 32, 48, 24, "I420"),
    (63, 31, 48, 24, "I420"),     # odd input dims
    (64, 32, 40, 32, "I420"),     # h-scale only
    (64, 32, 48, 24, "YUY2"),     # 4:2:2 (no vertical phases)
    (64, 32, 48, 24, "NV12"),
])
def test_phase_split_equals_generic(w, h, ow, oh, fmt):
    fast, _ = pair(fmt, (w, h), "RGB", (ow, oh))
    slow, jconv = pair(fmt, (w, h), "RGB", (ow, oh))
    slow._disable_phase_split = True
    planes = frames(fast, 2, 13)
    for xp_call in ("convert", "convert_ref"):
        a = getattr(fast, xp_call)(planes)
        b = getattr(slow, xp_call)(planes)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    check(slow, jconv, planes)


ROUTES = {
    "chroma_kernel": ("I420", (96, 64), "RGB", (32, 32),
                      {"resampler-method": "cubic"}, {}),
    "gather": ("I420", (96, 64), "RGB", (32, 32),
               {"resampler-method": "linear", "resampler-taps": 2}, {}),
    "phase_split": ("NV12", (96, 54), "RGB", (32, 32), None, {}),
    "generic_up": ("I420", (32, 24), "RGB", (80, 60), None, {}),
    "generic_vh": ("I420", (65, 62), "BGRx", (50, 20),
                   {"resampler-method": "lanczos"}, {}),
    "high_depth": ("P010_10LE", (64, 48), "RGB", (32, 32), None, {}),
    "dither": ("I420", (64, 48), "RGB16", (40, 30), None, {}),
    "gamma": ("I420", (64, 32), "I420", (48, 32),
              {"gamma-mode": "remap", "primaries-mode": "fast"},
              {"in": BT709, "out": BT2020}),
    "interlaced": ("I420", (64, 50), "RGB", (40, 33), None,
                   {"interlaced": True}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_port_runs_on_the_reference_plan(route):
    fi, isz, fo, osz, cfg, extra = ROUTES[route]
    in_kw, out_kw = {}, {}
    if "in" in extra:
        in_kw["colorimetry"], out_kw["colorimetry"] = extra["in"], extra["out"]
    if extra.get("interlaced"):
        in_kw["interlace_mode"] = out_kw["interlace_mode"] = "interleaved"
    conv, jconv = pair(fi, isz, fo, osz, cfg, in_kw, out_kw)
    ref, own = plan_arrays(jconv._plan), plan_arrays(conv.plan)
    assert ref.keys() == own.keys()
    for k in ref:
        assert np.array_equal(ref[k], own[k]), k
    # a converter planned for another method and other colorimetry, then
    # loaded with exactly the reference's plan
    other, _ = pair(fi, isz, fo, osz,
                    {"resampler-method": "nearest", "dither-method": "none"},
                    {k: v for k, v in in_kw.items() if k != "colorimetry"},
                    {k: v for k, v in out_kw.items() if k != "colorimetry"})
    other.load_plan(plan_from_reference(ref))
    check(other, jconv, frames(conv, 2, 14))


# -- the kernel switches -----------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    calls = {"yscale": 0, "chroma": 0}
    real_y, real_c = tysk.yscale_hv, tck.chroma420_scale

    def spy_y(*a, **k):
        calls["yscale"] += 1
        return real_y(*a, **k)

    def spy_c(*a, **k):
        calls["chroma"] += 1
        return real_c(*a, **k)

    monkeypatch.setattr(tysk, "yscale_hv", spy_y)
    monkeypatch.setattr(tck, "chroma420_scale", spy_c)
    return calls


@pytest.mark.parametrize("yscale,chroma,want", [
    (None, None, {"yscale": 1, "chroma": 2}),
    ("1", "1", {"yscale": 1, "chroma": 2}),
    ("0", None, {"yscale": 0, "chroma": 2}),
    (None, "0", {"yscale": 0, "chroma": 0}),     # falls to phase-split
    ("0", "0", {"yscale": 0, "chroma": 0}),
    (None, "interpret", {"yscale": 1, "chroma": 2}),
])
def test_switches_change_the_route_not_the_bytes(monkeypatch, spies, yscale,
                                                 chroma, want):
    for name, val in (("GTPU_PALLAS_YSCALE", yscale),
                      ("GTPU_PALLAS_CHROMA", chroma)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    conv, _ = pair("I420", (96, 64), "RGB", (32, 32))     # cubic: > 2 taps
    planes = frames(conv, 2, 15)
    out = conv.convert(planes)
    assert spies == want
    for o, g in zip(out, conv.convert_ref(planes)):
        assert np.array_equal(o.numpy(), g)


def test_two_tap_gather_is_chosen_before_the_chroma_switch(monkeypatch,
                                                           spies):
    monkeypatch.setenv("GTPU_PALLAS_CHROMA", "0")
    conv, _ = pair("I420", (96, 64), "RGB", (32, 32),
                   {"resampler-method": "linear", "resampler-taps": 2})
    planes = frames(conv, 1, 16)
    out = conv.convert(planes)
    # the gather route: luma still goes through yscale_hv, no chroma kernel
    assert spies == {"yscale": 1, "chroma": 0}
    monkeypatch.setenv("GTPU_PALLAS_YSCALE", "0")
    again = conv.convert(planes)
    assert spies == {"yscale": 1, "chroma": 0}
    for o, a, g in zip(out, again, conv.convert_ref(planes)):
        assert np.array_equal(o.numpy(), g) and torch.equal(o, a)


@pytest.mark.parametrize("method", ["floyd-steinberg", "sierra-lite"])
def test_serial_dither_keeps_the_route(monkeypatch, spies, method):
    # only the dither step visits the host: the scale kernels' wrappers are
    # still called, and the bytes are the reference's
    for name in ("GTPU_PALLAS_YSCALE", "GTPU_PALLAS_CHROMA"):
        monkeypatch.delenv(name, raising=False)
    conv, jconv = pair("I420", (96, 64), "RGB16", (32, 32),
                       {"dither-method": method})
    planes = frames(conv, 2, 17)
    out = conv.convert(planes)
    assert spies == {"yscale": 1, "chroma": 2}
    assert all(isinstance(o, torch.Tensor) for o in out)
    check(conv, jconv, planes, jit=False)


def test_no_route_is_left_for_a_later_slice():
    import pathlib
    import gstreamer_tpu_torch.video as video
    for path in pathlib.Path(video.__file__).parent.glob("*.py"):
        assert "later slice" not in path.read_text(), path
    assert not hasattr(video.format, "check_supported")
