"""The port's OpenCV camera and cascade elements, and faceoverlay, against
the JAX package, bit for bit.

dewarp and cameraundistort (the device remap: host maps, gathers on the
device, the bilinear sum in XLA's rounding), cameracalibrate, facedetect,
faceblur, handdetect and faceoverlay (host copies over ``ops/haar.py``, on
the synthetic cascade ``tests/test_opencv_camera.py`` writes) through
launch strings in both packages: samples, negotiated caps and bus
messages.  Tolerance 0.
"""

import numpy as np
import pytest

from gstreamer_tpu.codecs.png import png_encode
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import opencv_camera as jcam
from gstreamer_tpu.ops import haar as jhaar

import gstreamer_tpu_torch
from gstreamer_tpu_torch._xp import fma32
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements import opencv_camera as tcam
from gstreamer_tpu_torch.ops import haar as thaar

import test_torch_compositor as tc
from test_opencv_camera import DIST, K, SYNTH_CASCADE

FACTORIES = ("dewarp", "cameraundistort", "cameracalibrate", "facedetect",
             "faceblur", "handdetect", "faceoverlay")


@pytest.fixture
def cascade(tmp_path):
    p = tmp_path / "synth.xml"
    p.write_text(SYNTH_CASCADE)
    return str(p)


@pytest.fixture
def overlay_png(tmp_path):
    img = np.zeros((8, 8, 4), np.uint8)
    img[..., 1] = 255
    img[..., 3] = 255
    p = tmp_path / "overlay.png"
    p.write_bytes(png_encode(img, "RGBA"))
    return str(p)


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    from gstreamer_tpu.core.element import get_factory_class as jget
    from gstreamer_tpu_torch.core.element import get_factory_class as tget
    j, t = jget(factory), tget(factory)
    assert t.PROPERTIES == j.PROPERTIES
    assert [(p.name, p.direction, str(p.caps)) for p in t.PAD_TEMPLATES] \
        == [(p.name, p.direction, str(p.caps)) for p in j.PAD_TEMPLATES]
    assert t.DESCRIPTION == j.DESCRIPTION
    assert getattr(t, "HOST_ELEMENT", False) \
        == getattr(j, "HOST_ELEMENT", False)


def both(desc, pushes, batch=1):
    """run_both with the bus's element messages compared too."""
    jp, ref = tc._run(jparse_launch, JBuffer, desc, pushes, ("out",), batch)
    tp, out = tc._run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                      pushes, ("out",), batch, device="cpu")
    tc.assert_same_samples(out, ref, ("out",))
    assert tc.negotiated_caps(tp) == tc.negotiated_caps(jp)

    def msgs(p):
        return [(m.type, m.src, m.data) for m in iter(p.bus.pop, None)
                if m.type == "element"]
    jm, tm = msgs(jp), msgs(tp)
    assert tm == jm
    return tp, out, tm


def _random(fmt, w, h, n, planes, seed=7):
    d = np.random.default_rng(seed).integers(0, 256, (planes, n, h, w),
                                              dtype=np.uint8)
    return {"in": [dict(data=tuple(d), batch=n)]}


def _src(fmt, w, h):
    return (f"appsrc name=in caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=30/1 ! ")


# -- the device remap -----------------------------------------------------------

@pytest.mark.parametrize("props", [
    "", "interpolation-method=nearest", "display-mode=double-panorama",
    "display-mode=quad-view x-center=0.45 y-remap-correction=1.1",
    "interpolation-method=cubic outer-radius=0.45"])
def test_dewarp(props):
    desc = (_src("RGBA", 96, 64) + "dewarp inner-radius=0.1 outer-radius=0.4 "
            + props + " ! appsink name=out")
    both(desc, _random("RGBA", 96, 64, 2, 4))


def test_dewarp_passthrough():
    both(_src("RGBA", 32, 24) + "dewarp ! appsink name=out",
         _random("RGBA", 32, 24, 2, 4))


@pytest.mark.parametrize("props", ["", "alpha=0.5 crop=true",
                                   "alpha=1.0", "undistort=false"])
def test_cameraundistort(props):
    s = jcam.serialize_undistort_settings(K, DIST)
    assert tcam.serialize_undistort_settings(K, DIST) == s
    quoted = s.replace('"', '\\"')         # the XML's quotes, escaped
    pushes = _random("RGB", 320, 240, 1, 3)
    tp, out, _ = both(_src("RGB", 320, 240) + "cameraundistort name=u "
                      f"settings=\"{quoted}\" {props} ! appsink name=out",
                      pushes)
    assert tp.get_by_name("u").props["settings"] == s
    moved = (out["out"][0].buffer.data[0].numpy()
             != pushes["in"][0]["data"][0]).any()
    assert moved == ("undistort=false" not in props)


def test_bilinear_rounds_as_xla(monkeypatch):
    """The remap's four-product sum rounds as the jitted reference does
    (its products fused into the sum): four 640x480 fisheye frames dewarp
    to the reference's bytes, and the same sum rounded product by product
    gives other bytes."""
    d = np.random.default_rng(1).integers(0, 256, (4, 4, 480, 640),
                                          dtype=np.uint8)
    desc = (_src("RGBA", 640, 480) + "dewarp inner-radius=0.05 "
            "outer-radius=0.45 ! appsink name=out")
    pushes = {"in": [dict(data=tuple(d), batch=4)]}
    _, out, _ = both(desc, pushes, batch=4)

    def twice(f00, f01, f10, f11, fx, fy):
        gy, gx = 1 - fy, 1 - fx
        return (((f00 * gy) * gx + (f01 * gy) * fx) + (f10 * fy) * gx) \
            + (f11 * fy) * fx
    monkeypatch.setattr(tcam, "_bilinear", twice)
    _, other = tc._run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                       pushes, ("out",), 4, device="cpu")
    diff = sum(int((a.numpy() != b.numpy()).sum()) for a, b in zip(
        other["out"][0].buffer.data, out["out"][0].buffer.data))
    print(f"rounded twice: {diff} bytes differ")
    assert diff > 0


def test_bilinear_one_frame_rounds_as_xla(monkeypatch):
    """With one frame the jitted reference multiplies the two weights
    first (f * (wy * wx)): three 640x480 undistorted frames, one a tick,
    give the reference's bytes, and the batch's form (f * wy) * wx gives
    other bytes."""
    s = jcam.serialize_undistort_settings(K, DIST).replace('"', '\\"')
    desc = (_src("RGB", 640, 480) + f"cameraundistort settings=\"{s}\" "
            "alpha=1.0 ! appsink name=out")
    d = np.random.default_rng(2).integers(0, 256, (3, 3, 480, 640),
                                          dtype=np.uint8)
    pushes = {"in": [dict(data=tuple(d[:, k:k + 1]), batch=1)
                     for k in range(3)]}
    _, out, _ = both(desc, pushes)

    def batch_form(f00, f01, f10, f11, fx, fy):
        gy, gx = 1 - fy, 1 - fx
        v = fma32(f00 * gy, gx, (f01 * gy) * fx)
        v = fma32(f10 * fy, gx, v)
        return fma32(f11 * fy, fx, v)
    monkeypatch.setattr(tcam, "_bilinear", batch_form)
    _, other = tc._run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                       pushes, ("out",), 1, device="cpu")
    diff = sum(int((a.numpy() != b.numpy()).sum())
               for o, r in zip(other["out"], out["out"])
               for a, b in zip(o.buffer.data, r.buffer.data))
    print(f"batch form on single frames: {diff} bytes differ")
    assert diff > 0


def test_settings_wire_and_event():
    s = tcam.serialize_undistort_settings(K, DIST)
    k2, d2 = tcam.deserialize_undistort_settings(s)
    jk, jd = jcam.deserialize_undistort_settings(s)
    assert np.array_equal(k2, jk) and np.array_equal(d2, jd)
    ev = tcam.new_calibrated_event(s)
    assert tcam.parse_calibrated_event(ev) == s
    assert tcam.deserialize_undistort_settings("<not xml") is None


def test_undistort_takes_the_calibrated_event():
    s = tcam.serialize_undistort_settings(K, DIST)
    p = gstreamer_tpu_torch.parse_launch(
        _src("RGB", 64, 48) + "cameraundistort name=u ! appsink name=out",
        device="cpu")
    u = p.get_by_name("u")
    assert u._kd is None
    assert u.src_event(u.src_pads()[0], tcam.new_calibrated_event(s))
    assert u.props["settings"] == s and u._kd is not None


# -- host elements: calibration and cascades -----------------------------------

def _board(bw=5, bh=4, sq=12):
    h, w = (bh + 3) * sq, (bw + 3) * sq
    img = np.full((h, w), 255, np.uint8)
    for i in range(bh + 1):
        for j in range(bw + 1):
            if (i + j) % 2 == 0:
                img[sq + i * sq:sq + (i + 1) * sq,
                    sq + j * sq:sq + (j + 1) * sq] = 0
    return img


def test_cameracalibrate():
    b = _board()
    h, w = b.shape
    d = np.repeat(np.stack([b] * 3)[:, None], 3, 1)
    tp, _, msgs = both(_src("RGB", w, h) + "cameracalibrate board-width=5 "
                       "board-height=4 frame-count=2 ! appsink name=out",
                       {"in": [dict(data=tuple(d), batch=3)]}, batch=3)
    assert [m[2]["name"] for m in msgs] == ["camera-calibration"]
    assert tp.get_by_name(next(e.name for e in tp.iterate_elements()
                               if e.FACTORY == "cameracalibrate")) \
        .props["settings"].startswith("<?xml")


def _blobs(n, h=64, w=96):
    d = np.full((3, n, h, w), 40, np.uint8)
    for k in range(n):
        d[:, k, 20 + k:32 + k, 30 + 2 * k:42 + 2 * k] = 250
    return {"in": [dict(data=tuple(d), batch=n, pts=0, duration=n * 33333333)]}


@pytest.mark.parametrize("desc", [
    "facedetect profile={c} min-neighbors=1 min-size-width=8 "
    "min-size-height=8",
    "facedetect profile={c} nose-profile={c} eyes-profile={c} "
    "mouth-profile={c} min-neighbors=1 min-size-width=8 min-size-height=8 "
    "updates=on_change",
    "faceblur profile={c} min-neighbors=1 min-size-width=8 "
    "min-size-height=8",
    "handdetect profile-fist={c} profile-palm={c} ROI-X=4 ROI-WIDTH=80",
    "facedetect profile=/nonexistent.xml",
])
def test_cascade_elements(desc, cascade):
    _, out, msgs = both(_src("RGB", 96, 64) + desc.format(c=cascade)
                        + " ! appsink name=out", _blobs(2), batch=2)
    if "nonexistent" not in desc and "faceblur" not in desc:
        assert msgs


def test_faceblur_changes_the_face(cascade):
    pushes = _blobs(1)
    _, out, _ = both(_src("RGB", 96, 64) + f"faceblur profile={cascade} "
                     "min-neighbors=1 min-size-width=8 min-size-height=8 ! "
                     "appsink name=out", pushes)
    got = out["out"][0].buffer.data[0].numpy()
    assert (got != pushes["in"][0]["data"][0]).any()


@pytest.mark.parametrize("props", ["", "w=2.0 h=2.0", "x=0.5 y=-0.25 w=0.5"])
def test_faceoverlay(props, cascade, overlay_png):
    _, out, _ = both(_src("RGB", 96, 64) + f"faceoverlay profile={cascade} "
                     f"min-neighbors=1 location={overlay_png} {props} ! "
                     "appsink name=out", _blobs(2), batch=2)
    r, g = (out["out"][0].buffer.data[c].numpy() for c in (0, 1))
    assert ((g > 180) & (r < 80)).any()


def test_haar_copy_detects_as_the_reference(cascade):
    rng = np.random.default_rng(1)
    img = np.full((80, 120), 40, np.uint8)
    img[20:34, 30:44] = 250
    img[50:60, 80:90] = 240
    img = np.clip(img + rng.integers(0, 5, img.shape), 0, 255).astype(np.uint8)
    for sf, mn in ((1.1, 1), (1.25, 2), (1.5, 0)):
        assert thaar.HaarCascade(cascade).detect_multi_scale(img, sf, mn) \
            == jhaar.HaarCascade(cascade).detect_multi_scale(img, sf, mn)
    rects = [(10, 10, 20, 20), (11, 10, 20, 21), (50, 50, 8, 8)]
    assert thaar.group_rectangles(rects, 1) == jhaar.group_rectangles(rects, 1)


def test_calibration_math_is_the_reference_math():
    rng = np.random.default_rng(2)
    pts = [rng.random((20, 2)) * 100 for _ in range(3)]
    obj = np.concatenate([rng.random((20, 2)) * 50, np.zeros((20, 1))], 1)
    for a, b in zip(tcam.calibrate_camera([obj] * 3, pts, 320, 240),
                    jcam.calibrate_camera([obj] * 3, pts, 320, 240)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tcam._optimal_new_camera_matrix(K, DIST, 320, 240, 0.3),
                    jcam._optimal_new_camera_matrix(K, DIST, 320, 240, 0.3)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
