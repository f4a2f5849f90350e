"""The torch port's VideoConverter vs the JAX package's, bit for bit.

Same numpy frames through the JAX converter (jitted on the CPU, and its
numpy gold ``convert_ref``) and through the port's converter on the CPU
(``device="cpu"``: the plain version beside each kernel) and the port's own
numpy gold.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstreamer_tpu.video.converter import VideoConverter as JConverter
from gstreamer_tpu.video.info import VideoInfo as JInfo

from gstreamer_tpu_torch import VideoConverter, VideoInfo
from gstreamer_tpu_torch.interop import plan_arrays, plan_from_reference
from gstreamer_tpu_torch.ops import chroma420_kernel as tck
from gstreamer_tpu_torch.ops import yscale_kernel as tysk

# chip_smoke.py's three configurations of the headline 1080p -> RGB 224x224
HEADLINE = {
    "linear2": {"resampler-method": "linear", "resampler-taps": 2},
    "cubic": None,
    "add_borders": {"resampler-method": "linear", "resampler-taps": 2,
                    "dest-x": 0, "dest-y": 49, "dest-width": 224,
                    "dest-height": 126},
}


def _frames(info, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n,) + s, dtype=np.uint8)
                 for s in info.plane_shapes())


def _reference(jconv, planes):
    gold = jconv.convert_ref(planes)
    dev = jax.jit(jconv.trace_fn())(tuple(jnp.asarray(p) for p in planes))
    return [np.asarray(g, np.int64) for g in gold], \
        [np.asarray(d, np.int64) for d in dev]


def _check(conv, jconv, planes):
    gold, dev = _reference(jconv, planes)
    port = conv.convert(planes)
    port_gold = conv.convert_ref(planes)
    assert len(port) == len(gold)
    for p, pg, g, d in zip(port, port_gold, gold, dev):
        assert isinstance(p, torch.Tensor) and p.dtype == torch.uint8
        assert np.array_equal(g, d)
        assert np.array_equal(p.numpy().astype(np.int64), g)
        assert np.array_equal(np.asarray(pg, np.int64), g)


@pytest.mark.parametrize("name", list(HEADLINE))
def test_headline_1080p_matches_reference(name):
    cfg = HEADLINE[name]
    ii, oi = (VideoInfo(format="I420", width=1920, height=1080),
              VideoInfo(format="RGB", width=224, height=224))
    conv = VideoConverter(ii, oi, cfg, device="cpu")
    jconv = JConverter(JInfo(format="I420", width=1920, height=1080),
                       JInfo(format="RGB", width=224, height=224), cfg)
    counts = (tysk.yscale_hv.launches, tck.chroma420_scale.launches)
    _check(conv, jconv, _frames(ii, 1, 31))
    # the CPU runs the plain versions: no kernel launch is counted
    assert (tysk.yscale_hv.launches, tck.chroma420_scale.launches) == counts


@pytest.mark.parametrize("cfg", [
    # (in_w, in_h, out_w, out_h, method, taps): test_chroma_kernel.py's
    (480, 270, 112, 112, "linear", 2),      # headline shape /4
    (64, 48, 32, 24, "cubic", 0),
    (256, 128, 64, 256, "linear", 0),       # vertical upscale branch
])
@pytest.mark.parametrize("out_format", ["RGB", "I420"])
def test_chroma_kernel_shapes_match_reference(monkeypatch, cfg, out_format):
    # the JAX side runs its Pallas chroma kernel in interpret mode
    monkeypatch.setenv("GTPU_PALLAS_CHROMA", "interpret")
    w, h, ow, oh, method, taps = cfg
    opts = {"resampler-method": method, "resampler-taps": taps}
    conv = VideoConverter(VideoInfo(format="I420", width=w, height=h),
                          VideoInfo(format=out_format, width=ow, height=oh),
                          opts, device="cpu")
    jconv = JConverter(JInfo(format="I420", width=w, height=h),
                       JInfo(format=out_format, width=ow, height=oh), opts)
    _check(conv, jconv, _frames(conv.in_info, 2, 42))


def test_generic_route_is_not_ported_yet():
    # (the name dates from the slice that raised here)  130x62 -> 100x40
    # scales "vh" (v first): the generic line pipeline, equal to the
    # reference like every other route
    opts = {"resampler-method": "lanczos"}
    conv = VideoConverter(VideoInfo(format="I420", width=130, height=62),
                          VideoInfo(format="RGB", width=100, height=40),
                          opts, device="cpu")
    jconv = JConverter(JInfo(format="I420", width=130, height=62),
                       JInfo(format="RGB", width=100, height=40), opts)
    assert conv.plan["scale_order"] == "vh"
    _check(conv, jconv, _frames(conv.in_info, 1, 5))


@pytest.mark.parametrize("site", ["mpeg2", "none", "cosited"])
def test_plan_carried_from_reference(site):
    w, h, ow, oh = 480, 270, 112, 112
    opts = {"resampler-method": "cubic"}
    jconv = JConverter(JInfo(format="I420", width=w, height=h,
                             chroma_site=site),
                       JInfo(format="RGB", width=ow, height=oh), opts)
    conv = VideoConverter(VideoInfo(format="I420", width=w, height=h,
                                    chroma_site=site),
                          VideoInfo(format="RGB", width=ow, height=oh),
                          opts, device="cpu")
    ref = plan_arrays(jconv._plan)
    own = plan_arrays(conv.plan)
    assert ref.keys() == own.keys()
    for k in ref:
        assert np.array_equal(ref[k], own[k]), k
    # run the port on exactly the reference's plan
    plain = VideoConverter(VideoInfo(format="I420", width=w, height=h),
                           VideoInfo(format="RGB", width=ow, height=oh),
                           {"resampler-method": "linear"}, device="cpu")
    plain.load_plan(plan_from_reference(ref))
    _check(plain, jconv, _frames(conv.in_info, 2, 43))
