"""playback_extra in the port against the JAX package: decodebin3, parsebin,
playbin3 and playsink over the port's playback bins, y4mdec over its
filesrc, alphacolor as int32 torch, and dtmfdetect on the host; with the
properties and pad templates of the slice's 38 factories.

alphacolor: seeded uint8 planes that span the whole range (so the AYUV to
RGB matrices clamp at both ends) go through both packages in all five
formats and both directions; every byte equals, tolerance 0.  dtmfdetect:
seeded DTMF tones (the 697-1633 Hz pairs at 8 kHz, with noise) give the
same dtmf-event bus messages and the same passthrough samples.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.core import element as jelement
from gstreamer_tpu.core.element import element_factory_make as jmake

from gstreamer_tpu_torch import parse_launch as tparse_launch
from gstreamer_tpu_torch.core import element as telement
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.element import element_factory_make as tmake

from test_torch_captions import _run, drain, pair, sample_rows
from test_torch_file_formats import write_both
from test_torch_flow import VPX_TRANSPORT_FACTORIES, _spec
from test_torch_vpx import pushes as vpx_pushes, vsrc as vpx_vsrc

RGBA = ("RGBA", "BGRA", "ARGB", "ABGR")
W, H = 40, 30
KEYS = "123A456B789C*0#D"
ROW = (697, 770, 852, 941)
COL = (1209, 1336, 1477, 1633)


@pytest.mark.parametrize("factory", VPX_TRANSPORT_FACTORIES)
def test_factory_matches_reference(factory):
    """Property names, types, defaults and pad templates as the JAX
    package's class of the same factory."""
    jelement._ensure_elements_loaded()
    telement._ensure_elements_loaded()
    assert _spec(telement._REGISTRY[factory][0]) == \
        _spec(jelement._REGISTRY[factory][0])


# -- alphacolor ------------------------------------------------------------

def planes(n=2, seed=0, ticks=2):
    """Full-range seeded planes, with the corners that clamp set
    explicitly (0 and 255 in every combination)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        p = [rng.integers(0, 256, (n, H, W), np.uint8) for _ in range(4)]
        for k, bits in enumerate(range(16)):
            for c in range(4):
                p[c][0, 0, k] = 255 if bits >> c & 1 else 0
        out.append(dict(data=tuple(p), batch=n, pts=t * n * 33_333_333,
                        duration=33_333_333))
    return out


def asrc(fmt):
    return (f"appsrc name=in caps=video/x-raw,format={fmt},width={W},"
            f"height={H},framerate=30/1")


@pytest.mark.parametrize("fmt", RGBA)
def test_alphacolor_to_ayuv(fmt):
    _, _, _, out = pair(f"{asrc(fmt)} ! alphacolor ! appsink name=out",
                        {"in": planes(seed=RGBA.index(fmt))}, batch=2)
    assert out["out"][0].caps[0]["format"] == "AYUV"


@pytest.mark.parametrize("fmt", RGBA)
def test_alphacolor_from_ayuv(fmt):
    _, _, _, out = pair(f"{asrc('AYUV')} ! alphacolor ! "
                        f"video/x-raw,format={fmt} ! appsink name=out",
                        {"in": planes(seed=10 + RGBA.index(fmt))}, batch=2)
    assert out["out"][0].caps[0]["format"] == fmt


def test_alphacolor_matrices_by_hand():
    """gstalphacolor.c's integer formulas on the same planes: the RGB to
    AYUV direction masks into a byte, AYUV to RGB clamps."""
    e = tmake("alphacolor")
    x = [torch.from_numpy(p) for p in planes(1, 3, 1)[0]["data"]]
    e._to_yuv = True
    got = [t.numpy() for t in e.make_fn()(tuple(x))]
    r, g, b, a = [p.numpy().astype(np.int64) for p in x]
    for c, (k0, k1, k2, k3) in zip(got[:3], e._RGB2YUV):
        np.testing.assert_array_equal(
            c, ((r * k0 + g * k1 + b * k2 + k3) >> 8 & 0xFF).astype(np.uint8))
    np.testing.assert_array_equal(got[3], a.astype(np.uint8))
    e._to_yuv = False
    got = [t.numpy() for t in e.make_fn()(tuple(x))]
    for c, (k0, k1, k2, k3) in zip(got[:3], e._YUV2RGB):
        np.testing.assert_array_equal(c, np.clip(
            (r * k0 + g * k1 + b * k2 + k3) >> 8, 0, 255).astype(np.uint8))
    assert all(t.dtype == np.uint8 for t in got)


# -- the bins, y4mdec and playsink -----------------------------------------

@pytest.fixture
def y4m(tmp_path):
    return write_both(f"{vpx_vsrc()} ! y4menc location={{loc}}",
                      {"in": vpx_pushes(4, 2)}, tmp_path, "y4m", batch=2)


def test_y4mdec(y4m):
    pair(f"y4mdec location={y4m} ! appsink name=out", batch=2)
    pair(f"y4mdec location={y4m} ! videoconvertscale ! video/x-raw,"
         f"format=RGB,width=32,height=24 ! appsink name=out", batch=2)


@pytest.mark.parametrize("factory", ["decodebin3", "parsebin"])
def test_decodebin3_parsebin(factory, y4m):
    pair(f"{factory} uri=file://{y4m} ! appsink name=out", batch=2)


def test_playbin3_build_pipeline(y4m):
    rows = {}
    for k, make in (("j", jmake), ("t", tmake)):
        pb = make("playbin3", uri=f"file://{y4m}")
        pb.device = torch.device("cpu")
        pipe, sink = pb.build_pipeline()
        pipe.run()
        rows[k] = sample_rows(drain(sink))
    assert rows["t"] == rows["j"] and rows["t"]


def test_playsink_counts():
    jp, _, tp, _ = pair(f"{vpx_vsrc()} ! playsink name=ps",
                        {"in": vpx_pushes(6, 2)}, sinks=(), batch=2)
    assert tp.get_by_name("ps").rendered == \
        jp.get_by_name("ps").rendered == {"video": 6, "audio": 0, "text": 0}


# -- dtmfdetect ------------------------------------------------------------

def dtmf(keys, seed, tone=0.1, gap=0.05, rate=8000):
    """Seeded S16 8 kHz mono: each key's tone pair, a gap, light noise."""
    rng = np.random.default_rng(seed)
    out = []
    for k in keys:
        i = KEYS.index(k)
        t = np.arange(int(tone * rate)) / rate
        x = 0.3 * (np.sin(2 * np.pi * ROW[i // 4] * t)
                   + np.sin(2 * np.pi * COL[i % 4] * t))
        out += [x, np.zeros(int(gap * rate))]
    x = np.concatenate(out) + rng.normal(0, 0.005, sum(len(o) for o in out))
    return np.clip(np.round(x * 16000), -32768, 32767).astype(np.int16)


def dpushes(x, n=800):
    return [dict(data=x[k:k + n, None].copy(), pts=k * 125_000,
                 duration=len(x[k:k + n]) * 125_000)
            for k in range(0, len(x), n)]


DSRC = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=8000,channels=1,"
        "layout=interleaved")


@pytest.mark.parametrize("keys", ["1", "0*#A", "159D", ""])
def test_dtmfdetect(keys):
    """The same dtmf-event messages (pair compares the bus) and the
    samples passed through unchanged."""
    x = dtmf(keys, len(keys)) if keys else \
        np.random.default_rng(1).integers(-30, 30, 4000).astype(np.int16)
    _, _, tp, out = pair(f"{DSRC} ! dtmfdetect ! appsink name=out",
                         {"in": dpushes(x)})
    got = np.concatenate([s.buffer.data.numpy() for s in out["out"]])
    np.testing.assert_array_equal(got[:, 0], x)
    tp, _ = _run(tparse_launch, Buffer, f"{DSRC} ! dtmfdetect ! fakesink",
                 {"in": dpushes(x)}, (), 1, None, device="cpu")
    events = [m.data["number"] for m in iter(tp.bus.pop, None)
              if m.type == "element" and m.data.get("name") == "dtmf-event"]
    assert events == ["0123456789*#ABCD".index(k) for k in keys]
