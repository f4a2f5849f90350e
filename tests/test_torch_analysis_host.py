"""The port's video-analysis host elements against the JAX package, bit for
bit.

simplevideomark / simplevideomarkdetect, iqa, fieldanalysis, interlace,
zebrastripe, scenechange, videodiff, accurip, imagefreeze, webrtcechoprobe
and webrtcdsp: each runs the JAX package's numpy code on a host copy of
the tick (imagefreeze stays on the device).  The same launch string and
the same seeded buffers go through both packages; samples, negotiated
caps, buffer flags, per-frame metas and bus messages equal, tolerance 0.
"""

import numpy as np
import pytest

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse_launch

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.interop import negotiated_caps

from test_torch_analytics import same_spec
from test_torch_audiofx import both, desc_of, pushes
from test_torch_compositor import (_run, assert_same_samples, planes,
                                   run_both, video_pushes)

FACTORIES = ("simplevideomark", "simplevideomarkdetect", "iqa",
             "fieldanalysis", "interlace", "zebrastripe", "scenechange",
             "videodiff", "accurip", "imagefreeze", "webrtcechoprobe",
             "webrtcdsp")
DUR = 33333333


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


def vsrc(fmt, w, h, rate="30/1"):
    return (f"appsrc name=in caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate={rate} ! ")


def both_video(desc, push, batch, sinks=("out",)):
    """run_both, plus every sample's flags and metas other than the
    analytics' and the bus messages' data, in order."""
    jpipe, ref = _run(jparse_launch, JBuffer, desc, push, sinks, batch)
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, push,
                      sinks, batch, device="cpu")
    assert_same_samples(out, ref, sinks)
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)
    for s in sinks:
        for o, r in zip(out[s], ref[s]):
            assert o.buffer.flags == r.buffer.flags
            assert o.buffer.meta == r.buffer.meta
    msgs = [[(m.type, m.data) for m in iter(p.bus.pop, None)
             if m.type in ("element", "tag")] for p in (jpipe, tpipe)]
    assert msgs[0] == msgs[1]
    return out, msgs[1]


def scene(fmt, w, h, batch, ticks, seed, cut_every=None):
    """Seeded frames with slow motion and, every `cut_every` frames, a
    scene cut (a new random background)."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (h, w))
    shapes = [p.shape[1:] for p in planes(fmt, w, h, 1, 0)]
    out = []
    for t in range(ticks):
        tick = [np.empty((batch,) + s, np.uint8) for s in shapes]
        for k in range(batch):
            f = t * batch + k
            if cut_every and f and f % cut_every == 0:
                bg = rng.integers(0, 256, (h, w))
            y = np.roll(bg, f, axis=1) + rng.integers(-3, 4, (h, w))
            tick[0][k] = np.clip(y, 0, 255)
            for p in tick[1:]:
                p[k] = rng.integers(0, 256, p.shape[1:])
        out.append(dict(data=tuple(tick), pts=t * batch * DUR, duration=DUR,
                        batch=batch))
    return {"in": out}


# -- videosignal ------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["I420", "NV12", "GRAY8", "Y444"])
@pytest.mark.parametrize("props", [
    "", "pattern-width=6 pattern-height=8 pattern-data=27 "
    "pattern-data-count=7 left-offset=3 bottom-offset=2",
    "pattern-count=3 pattern-data=1 left-offset=40"])
def test_videomark_roundtrip(fmt, props):
    """simplevideomark ! simplevideomarkdetect: the marked frames and the
    detector's messages (have-pattern, the decoded word)."""
    det = props.replace("pattern-data=27 ", "").replace("pattern-data=1 ",
                                                        "")
    desc = (vsrc(fmt, 48, 32) + f"simplevideomark {props} ! "
            f"simplevideomarkdetect {det} ! appsink name=out")
    _, msgs = both_video(desc, video_pushes({"in": (fmt, 48, 32)}, 2, 2), 2)
    assert len(msgs) == 4 and msgs[0][1]["have-pattern"]


def test_videomarkdetect_unmarked():
    _, msgs = both_video(vsrc("I420", 48, 32) + "simplevideomarkdetect ! "
                         "appsink name=out",
                         video_pushes({"in": ("I420", 48, 32)}, 3, 1), 3)
    assert not any(m[1]["have-pattern"] for m in msgs)


# -- iqa ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["I420", "GRAY8"])
def test_iqa(fmt):
    """sink_0 the reference, sink_1 the same frames, sink_2 with noise:
    the reference pad's frames out, the DSSIM per pad in the meta."""
    base = video_pushes({"a": (fmt, 64, 48)}, 1, 2)["a"]
    rng = np.random.default_rng(1)
    noisy = [dict(b, data=tuple(
        np.clip(p.astype(int) + rng.integers(-20, 21, p.shape), 0,
                255).astype(np.uint8) for p in b["data"])) for b in base]
    desc = ("iqa name=q ! appsink name=out "
            + "".join(f"appsrc name=i{k} caps=video/x-raw,format={fmt},"
                      f"width=64,height=48,framerate=30/1 ! q.sink_{k} "
                      for k in range(3)))
    out, _ = both_video(desc, {"i0": base, "i1": base, "i2": noisy}, 1)
    m = out["out"][0].buffer.meta["iqa-dssim"]
    assert m["sink_1"] < 1e-9 < m["sink_2"]


def test_iqa_threshold_raises_in_both():
    ref = np.random.default_rng(0).integers(0, 255, (1, 48, 64), np.uint8)
    other = 255 - ref
    for make, B in ((jmake, JBuffer), (tmake, Buffer)):
        q = make("iqa", **{"dssim-error-threshold": 0.1})
        with pytest.raises(ValueError, match="over threshold"):
            q.host_aggregate({"sink_0": B(data=(ref,), batch=1),
                              "sink_1": B(data=(other,), batch=1)})


# -- fieldanalysis -------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["I420", "GRAY8"])
@pytest.mark.parametrize("thr,ratio", [(80.0, 0.02), (20.0, 0.3)])
def test_fieldanalysis(fmt, thr, ratio):
    """Progressive frames and frames with the odd lines of another
    picture (combing): the modes in the meta."""
    push = video_pushes({"in": (fmt, 32, 24)}, 4, 2)
    for b in push["in"]:
        y = b["data"][0]
        y[:2] //= 8                       # flat, progressive
        y[2:, 1::2] = 255 - y[2:, 1::2]
    both_video(vsrc(fmt, 32, 24) + f"fieldanalysis spatial-threshold={thr} "
               f"comb-ratio={ratio} ! appsink name=out", push, 4)


# -- interlace -------------------------------------------------------------------------

PATTERNS = ("1:1", "2:2", "2:3", "2:3:3:2", "2-11:3", "3:4-3", "3-7:4",
            "3:3:4", "3:3", "3:2-4", "1:2-4")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_interlace_patterns(pattern):
    """Every pulldown pattern: woven frames, pts, durations, the flags of
    the first frame and the per-frame decorations."""
    both_video(vsrc("I420", 16, 12, "24000/1001") + f"interlace "
               f"field-pattern={pattern} ! appsink name=out",
               video_pushes({"in": ("I420", 16, 12)}, 3, 4), 3)


@pytest.mark.parametrize("props", ["top-field-first=true allow-rff=true",
                                   "pattern-offset=1 allow-rff=true",
                                   "field-pattern=3:2-4 pattern-offset=3"])
def test_interlace_options(props):
    both_video(vsrc("NV12", 16, 12, "24/1") + f"interlace {props} ! "
               "appsink name=out",
               video_pushes({"in": ("NV12", 16, 12)}, 4, 3), 4)


# -- videofilters_bad ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["I420", "Y444", "Y41B"])
@pytest.mark.parametrize("thr", [90, 40])
def test_zebrastripe(fmt, thr):
    both_video(vsrc(fmt, 32, 24) + f"zebrastripe threshold={thr} ! "
               "appsink name=out", video_pushes({"in": (fmt, 32, 24)}, 3, 2),
               3)


@pytest.mark.parametrize("cut_every", [None, 7, 3])
def test_scenechange(cut_every):
    _, msgs = both_video(vsrc("I420", 32, 24) + "scenechange ! "
                         "appsink name=out",
                         scene("I420", 32, 24, 4, 6, 5, cut_every), 4)
    if cut_every == 7:
        assert msgs


@pytest.mark.parametrize("fmt", ["I420", "Y42B"])
@pytest.mark.parametrize("thr", [10, 2])
def test_videodiff(fmt, thr):
    both_video(vsrc(fmt, 32, 24) + f"videodiff threshold={thr} ! "
               "appsink name=out", scene(fmt, 32, 24, 3, 3, 8, 4), 3)


@pytest.mark.parametrize("first,last", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_accurip(first, last):
    """The CRCs (v1 and v2) posted as a tag at EOS, over pushes that
    straddle the 5-sector skip and rollback."""
    both(desc_of("S16LE", 2, f"accurip first-track={first} "
                 f"last-track={last}", rate=44100),
         pushes("S16LE", 2, ticks=3, frames=2500, rate=44100))


# -- imagefreeze ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [-1, 5, 2])
def test_imagefreeze(n):
    out, _ = both_video(vsrc("I420", 16, 12) + f"imagefreeze num-buffers={n}"
                        " ! appsink name=out",
                        video_pushes({"in": ("I420", 16, 12)}, 3, 3), 3)
    assert all(o.buffer.data[0].device.type == "cpu" for o in out["out"])


# -- webrtcdsp ---------------------------------------------------------------------------

RATE = 16000


def voice(n, seed):
    """Noise with a 300 Hz tone that starts and stops every 0.2 s."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    gate = (t // 0.2) % 2
    return 0.02 * rng.standard_normal(n) + 0.3 * gate * np.sin(
        2 * np.pi * 300 * t)


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
@pytest.mark.parametrize("props", [
    "echo-cancel=false",
    "echo-cancel=false noise-suppression-level=very-high "
    "voice-detection=true voice-detection-frame-size-ms=20",
    "echo-cancel=false gain-control-mode=fixed-digital limiter=false "
    "high-pass-filter=false",
    "echo-cancel=false noise-suppression=false target-level-dbfs=12 "
    "voice-detection=true voice-detection-likelihood=high"])
def test_webrtcdsp(fmt, props):
    x = voice(RATE, 3)
    data = (np.round(x * 20000).astype(np.int16) if fmt == "S16LE"
            else x.astype(np.float32))
    n = RATE // 10
    bufs = [dict(data=data[b:b + n, None], pts=b * 10**9 // RATE,
                 duration=n * 10**9 // RATE) for b in range(0, RATE, n)]
    both(desc_of(fmt, 1, f"webrtcdsp {props}", rate=RATE), bufs)


def test_webrtc_echo_cancel():
    """webrtcechoprobe on the far end, webrtcdsp on the near end (a
    delayed copy of it): the cancelled output."""
    n = RATE
    rng = np.random.default_rng(1)
    far = 0.5 * rng.standard_normal(n)
    near = 0.6 * np.concatenate([np.zeros(80), far[:-80]])
    caps = (f"audio/x-raw, format=F32LE, rate={RATE}, channels=1, "
            "layout=interleaved")
    desc = (f"appsrc name=far ! {caps} ! webrtcechoprobe name=probe ! "
            f"fakesink appsrc name=near ! {caps} ! webrtcdsp probe=probe "
            "noise-suppression=false gain-control=false "
            "high-pass-filter=false ! appsink name=out")
    chunk = RATE // 10
    push = {"far": [], "near": []}
    for b in range(0, n, chunk):
        for name, sig in (("far", far), ("near", near)):
            push[name].append(dict(data=sig[b:b + chunk, None].astype(
                np.float32), pts=b * 10**9 // RATE))
    _, out = run_both(desc, push)
    assert len(out["out"]) == 10
