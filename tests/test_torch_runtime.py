"""The port's runtime pieces against the JAX package: tracer hooks, the dot
dump, meta transforms, and the host sinks and debug elements.

The tracers' reports (all but their host times), the dot text, crop metas
through ``videoconvertscale``, fakevideosink's and fakeaudiosink's state,
breakmydata's corrupted bytes and downloadbuffer's spool must equal the JAX
package's on the same launch string and seeded inputs, tolerance 0.
"""

import os

import numpy as np
import pytest
import torch

from gstreamer_tpu.core import tracer as jtracer
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.meta import VideoCropMeta as JCropMeta
from gstreamer_tpu.core.meta import VideoMeta as JVideoMeta
from gstreamer_tpu.core.meta import frame_map_strided as jframe_map_strided
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.utils.dot import pipeline_to_dot as jpipeline_to_dot
from gstreamer_tpu.video.format import format_info as jformat_info

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core import tracer
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.meta import VideoCropMeta, VideoMeta
from gstreamer_tpu_torch.core.meta import frame_map_strided
from gstreamer_tpu_torch.utils.dot import pipeline_to_dot
from gstreamer_tpu_torch.video.format import format_info

from test_torch_compositor import _run, run_both, video_pushes

VSRC = ("appsrc name=in caps=video/x-raw,format=I420,width=32,height=24,"
        "framerate=30/1 ! ")
FUSED = (VSRC + "videoflip method=clockwise ! gamma gamma=1.5 ! "
         "videoconvertscale ! video/x-raw,format=RGB,width=12,height=16 ! "
         "appsink name=out")
PER_ELEMENT = (VSRC + "progressreport silent=true ! videomedian ! "
               "tee name=t t. ! queue ! appsink name=out "
               "t. ! fakevideosink name=v")


def _reset(hooks):
    """Forget every installed tracer; GTPU_TRACERS is read again at the
    next compile."""
    hooks.handlers.clear()
    hooks.tracers.clear()
    hooks._env_loaded = False


@pytest.fixture
def tracers(monkeypatch):
    monkeypatch.setenv("GTPU_TRACERS", "stats;latency;factories;leaks;log")
    _reset(jtracer.hooks)
    tracer.hooks.reset()
    yield
    monkeypatch.delenv("GTPU_TRACERS")
    _reset(jtracer.hooks)
    tracer.hooks.reset()


def _reports(hooks):
    rep = hooks.reports()
    # the latency tracer's times are host times: keep its counts
    rep["latency"] = {k: v["n"] for k, v in rep["latency"].items()}
    return rep


@pytest.mark.parametrize("desc", [FUSED, PER_ELEMENT])
def test_tracer_reports_match(tracers, desc, capsys):
    """The same hooks fire at the same points in both packages: equal
    stats (ticks, frames by element), latency counts, factories and leaks
    reports; the log tracer prints the same hook names."""
    pushes = video_pushes({"in": ("I420", 32, 24)}, 2, 3)
    jpipe, _ = _run(jparse_launch, JBuffer, desc, pushes, ("out",), 2)
    jlog = [ln.split(":")[0] for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("TRACE")]
    tpipe, _ = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, pushes,
                    ("out",), 2, device="cpu")
    tlog = [ln.split(":")[0] for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("TRACE")]
    assert _reports(tracer.hooks) == _reports(jtracer.hooks)
    stats = tracer.hooks.reports()["stats"]
    assert stats["ticks"] == 3 and stats["frames"]["out"] == 6
    assert tlog == jlog and "TRACE tick-post" in tlog


def test_no_tracer_no_hook():
    tracer.hooks.reset()
    tracer.hooks.load_env()
    assert not tracer.hooks.active


def test_dot_text_and_dump(tmp_path, monkeypatch):
    """The dot text of a negotiated pipeline equals the JAX package's; with
    GTPU_DEBUG_DUMP_DOT_DIR set, compile writes it to <name>.dot."""
    monkeypatch.setenv("GTPU_DEBUG_DUMP_DOT_DIR", str(tmp_path))
    pushes = video_pushes({"in": ("I420", 32, 24)}, 2, 1)
    jpipe, _ = _run(jparse_launch, JBuffer, FUSED, pushes, ("out",), 2)
    tpipe, _ = _run(gstreamer_tpu_torch.parse_launch, Buffer, FUSED, pushes,
                    ("out",), 2, device="cpu")
    text = pipeline_to_dot(tpipe)
    assert text == jpipeline_to_dot(jpipe)
    # an edge label is the first 60 characters of the pad's caps, whose
    # field order follows the process's string hashing: the whole label of
    # the last edge is in the text, and the caps hold format=RGB
    caps = str(tpipe.get_by_name("out").sink_pads()[0].caps)
    assert "videoflip" in text and f'[label="{caps[:60]}"' in text
    assert "format=RGB" in caps
    tpipe.name = "port"
    tpipe.compile(batch=2)
    assert (tmp_path / "port.dot").read_text() == text


def _crop_run(parse, buffer_cls, crop_cls, **kw):
    p = parse("appsrc name=in caps=video/x-raw,format=I420,width=64,"
              "height=48,framerate=30/1 ! videoscale ! "
              "video/x-raw,width=32,height=24 ! appsink name=s", **kw)
    rng = np.random.default_rng(0)
    data = (rng.integers(0, 256, (1, 48, 64), np.uint8),
            rng.integers(0, 256, (1, 24, 32), np.uint8),
            rng.integers(0, 256, (1, 24, 32), np.uint8))
    p.get_by_name("in").push_buffer(buffer_cls(
        data=data, pts=0, batch=1,
        meta={"video-crop": crop_cls(8, 8, 32, 16), "free-form": 7,
              "video": (JVideoMeta if crop_cls is JCropMeta else VideoMeta)(
                  "I420", 64, 48, (64, 32, 32), (0, 3072, 3840))}))
    p.set_state("playing")
    assert p.tick()
    return p.get_by_name("s").pull_sample().buffer.meta


def test_crop_meta_scales_through_videoconvertscale():
    """tests/test_meta.py's case: the crop rect scales with the frame, a
    strided layout meta drops, a free-form entry passes."""
    jm = _crop_run(jparse_launch, JBuffer, JCropMeta)
    tm = _crop_run(gstreamer_tpu_torch.parse_launch, Buffer, VideoCropMeta,
                   device="cpu")
    c = tm["video-crop"]
    assert (c.x, c.y, c.width, c.height) == (4, 4, 16, 8)
    assert sorted(tm) == sorted(jm) == ["free-form", "video-crop"]
    j = jm["video-crop"]
    assert (j.x, j.y, j.width, j.height) == (4, 4, 16, 8)


def test_frame_map_strided_takes_a_tensor():
    """A strided I420 frame handed over as a tensor maps to the same host
    planes as the JAX package's from the numpy bytes."""
    rng = np.random.default_rng(3)
    w, h, pad = 32, 16, 7
    strides = (w + pad, w // 2 + pad, w // 2 + pad)
    offsets = (0, h * strides[0], h * strides[0] + h // 2 * strides[1])
    data = rng.integers(0, 256, offsets[2] + h // 2 * strides[2], np.uint8)
    got = frame_map_strided(format_info("I420"), torch.from_numpy(data),
                            VideoMeta("I420", w, h, strides, offsets))
    want = jframe_map_strided(jformat_info("I420"), data,
                              JVideoMeta("I420", w, h, strides, offsets))
    for g, x in zip(got, want):
        assert isinstance(g, np.ndarray) and np.array_equal(g, x)


def test_fakevideosink_and_autovideosink():
    pushes = video_pushes({"in": ("I420", 32, 24)}, 2, 3)
    for desc in (PER_ELEMENT, PER_ELEMENT.replace("fakevideosink",
                                                  "autovideosink")):
        jpipe, _ = _run(jparse_launch, JBuffer, desc, pushes, ("out",), 2)
        tpipe, _ = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                        pushes, ("out",), 2, device="cpu")
        tv, jv = tpipe.get_by_name("v"), jpipe.get_by_name("v")
        assert type(tv).__name__ == "FakeVideoSink"
        assert tv.rendered == jv.rendered == 6
        for a, b in zip(tv.last_sample.data, jv.last_sample.data):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("sink", ["fakeaudiosink", "autoaudiosink"])
def test_fakeaudiosink_ring(sink):
    """audiotestsrc into the ring-buffer sink: the same sample counter,
    resyncs and ring contents."""
    desc = (f"audiotestsrc num-buffers=4 samplesperbuffer=480 ! {sink} "
            "name=s")
    sinks = []
    for parse, kw in ((jparse_launch, {}),
                      (gstreamer_tpu_torch.parse_launch, {"device": "cpu"})):
        p = parse(desc, **kw)
        p.compile(batch=1)
        p.set_state("playing")
        while p.tick():
            pass
        sinks.append(p.get_by_name("s"))
    t, j = sinks
    assert type(t).__name__ == "FakeAudioSink"
    assert t._next_sample == j._next_sample == 4 * 480
    assert t.resync_count == j.resync_count == 0
    assert np.array_equal(t.ring._data, j.ring._data)
    assert t.ring._data.any()


@pytest.mark.parametrize("caps,shape,dtype", [
    ("audio/x-raw,format=S16LE,rate=48000,channels=2,layout=interleaved",
     (480, 2), np.int16),
    ("video/x-raw,format=RGB,width=16,height=8,framerate=30/1", None,
     np.uint8)])
def test_breakmydata_with_a_seed(caps, shape, dtype):
    """The same bytes corrupted in both packages (the RGB planes come back
    stacked into one array, as the reference's np.asarray makes them), on
    the data's device with the same dtype."""
    rng = np.random.default_rng(5)
    if shape is None:
        pushes = video_pushes({"in": ("RGB", 16, 8)}, 2, 2)
    else:
        pushes = {"in": [dict(data=rng.integers(-999, 999, shape, dtype),
                              pts=t * 10**7, duration=10**7)
                         for t in range(2)]}
    _, out = run_both(f"appsrc name=in caps={caps} ! breakmydata seed=7 "
                      "probability=0.1 skip=10 ! appsink name=out", pushes,
                      batch=2 if shape is None else 1)
    first = out["out"][0].buffer.data
    want = pushes["in"][0]["data"]
    want = np.asarray(want)
    assert first.dtype == torch.from_numpy(want).dtype
    assert first.shape == want.shape
    flat, orig = first.numpy().view(np.uint8).ravel(), want.view(
        np.uint8).ravel()
    assert (flat[:10] == orig[:10]).all() and (flat != orig).any()


def test_downloadbuffer_spool():
    """Every buffer's bytes in the spool, in order, as in the JAX
    package's."""
    desc = ("appsrc name=in caps=application/octet-stream ! downloadbuffer "
            "name=d ! appsink name=out")
    rng = np.random.default_rng(9)
    pushes = {"in": [dict(data=rng.integers(0, 256, 4096, np.uint8))
                     for _ in range(3)]}
    spools = []
    for parse, cls, kw in ((jparse_launch, JBuffer, {}),
                           (gstreamer_tpu_torch.parse_launch, Buffer,
                            {"device": "cpu"})):
        p, got = _run(parse, cls, desc, pushes, ("out",), 1, **kw)
        d = p.get_by_name("d")
        assert d.downloaded_bytes == 3 * 4096 and len(got["out"]) == 3
        spools.append(d.read_range(0, 3 * 4096))
        os.remove(d.temp_location)
    assert spools[0] == spools[1] == b"".join(
        b["data"].tobytes() for b in pushes["in"])


def test_taginject_capssetter_cpureport():
    """The tags go out once as a TAG event, capssetter's field reaches the
    sample caps, cpureport posts a message a tick after the first, in both
    packages."""
    desc = (VSRC + 'taginject tags="title=Foo,artist=Bar" name=ti ! '
            "capssetter caps=video/x-raw,pixel-aspect-ratio=2/1 ! "
            "cpureport ! appsink name=out")
    tpipe, out = run_both(desc, video_pushes({"in": ("I420", 32, 24)}, 2, 3),
                          batch=2)
    assert "pixel-aspect-ratio=2/1" in str(out["out"][0].caps)
    assert tpipe.get_by_name("ti")._sent
    reports = [m for m in tpipe.bus.messages()
               if m.type == "element" and m.data["name"] == "cpu-report"]
    assert len(reports) == 2


@pytest.mark.parametrize("stall", [False, True])
def test_watchdog(stall):
    """Armed on the first buffer; a stall longer than the timeout posts an
    error on the bus, as the JAX package's does."""
    import time

    # 100 ms against a 400 ms stall; without a stall a timeout no busy
    # machine reaches between a tick and the stop
    desc = VSRC + (f"watchdog name=w timeout={100 if stall else 5000} ! "
                   "appsink name=out")
    errors = []
    for parse, cls, kw in ((jparse_launch, JBuffer, {}),
                           (gstreamer_tpu_torch.parse_launch, Buffer,
                            {"device": "cpu"})):
        p = parse(desc, batch=2, **kw)
        src = p.get_by_name("in")
        for b in video_pushes({"in": ("I420", 32, 24)}, 2, 2)["in"]:
            src.push_buffer(cls(**b))
        src.end_of_stream()
        p.set_state("playing")
        assert p.tick()
        if stall:
            time.sleep(0.4)
        w = p.get_by_name("w")
        triggered = w.triggered
        p.set_state("null")
        errors.append((triggered, [m.data.get("error") for m in
                                   p.bus.messages() if m.type == "error"]))
    assert errors[0] == errors[1]
    assert errors[1] == ((True, ["Watchdog triggered"]) if stall
                         else (False, []))
