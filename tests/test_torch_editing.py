"""The port's ``editing/timeline.py`` against the JAX package, bit for bit:
Timeline, layers and clips (TestClip, UriClip, TitleClip,
NestedTimelineClip), Effect with keyframes, Group, the tracks, and the two
sources ``timelinevideosrc`` and ``timelineaudiosrc``.

Two kinds of case.  The JAX package's own ``tests/test_editing.py`` runs
again on the port (``test_torch_webrtc.reference_cases`` / ``run_case``:
its names bound to the port's, pipelines on the CPU).  And the same
timelines render through both packages at 32x24 at 10/1 (and 8 kHz audio),
as ``tests/test_editing.py`` does: every frame, every sample, the buffers'
timestamps and the negotiated caps equal, tolerance 0.  The port keeps the
frames and samples as tensors on the source's device (the CPU here): the
black of a gap, the int32 crossfade and the stack are made there.  The
timeline of ``chip_smoke.py``'s timeline_crossfade_1080p runs here at a
small size against the JAX package too.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu import editing as jed
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.pipeline import Pipeline as JPipeline
from gstreamer_tpu.core.pipeline import link as jlink
from gstreamer_tpu.core.value import Fraction as JFraction

from gstreamer_tpu_torch import editing as ted
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.core.pipeline import Pipeline
from gstreamer_tpu_torch.core.pipeline import link as tlink
from gstreamer_tpu_torch.core.value import Fraction

import chip_smoke as cs
import test_editing
from test_torch_captions import drain, plain
from test_torch_tail_modules import stacked_cases
from test_torch_webrtc import run_case

CPU = torch.device("cpu")
NS = 1_000_000_000
REFERENCE = stacked_cases(test_editing)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    run_case(case, tmp_path)


# -- both packages on one timeline ----------------------------------------------
def _pkg(jax):
    return (jed, JFraction, jmake, JPipeline, jlink, {}) if jax else \
        (ted, Fraction, tmake, Pipeline, tlink, {"device": CPU})


def render(build, kind="video", batch=4, blocksize=None):
    """`build(ed, Fraction)`'s timeline through each package's timeline
    source into an appsink: [(pts, duration, batch, plain data)] and the
    negotiated caps of each."""
    out = []
    for jax in (True, False):
        ed, frac, make, pipe_cls, link, kw = _pkg(jax)
        tl = build(ed, frac)
        props = {"timeline": tl}
        if blocksize is not None:
            props["blocksize"] = blocksize
        src = make(f"timeline{kind}src", **props)
        sink = make("appsink", name="out")
        p = pipe_cls(**kw)
        p.default_batch = batch
        p.add(src, sink)
        link(src, sink)
        p.run()
        rows = []
        for s in drain(sink):
            data = s.buffer.data
            if not jax:
                leaves = data if isinstance(data, tuple) else (data,)
                assert all(x.device == CPU for x in leaves)
            rows.append((s.buffer.pts, s.buffer.duration, s.buffer.batch,
                         plain(data)))
        out.append((rows, str(src.src_pads()[0].caps)))
    assert out[1] == out[0]
    assert out[0][0]
    return out[0][0]


def tracks(ed, frac, fmt="I420"):
    return (ed.VideoTrack(width=32, height=24, fps=frac(10, 1), format=fmt),
            ed.AudioTrack(rate=8000, channels=1))


@pytest.mark.parametrize("fmt", ["I420", "RGB", "Y42B"])
def test_crossfade_and_gap_match_reference(fmt):
    """A gap (black), a crossfade of two same-layer clips ((b*alpha +
    a*(256 - alpha)) >> 8 in int32) and a clip under a higher layer."""
    def build(ed, frac):
        tl = ed.Timeline(*tracks(ed, frac, fmt))
        top, under = tl.append_layer(), tl.append_layer()
        top.add_clip(ed.TestClip(start=NS // 5, duration=NS, pattern="snow"))
        top.add_clip(ed.TestClip(start=7 * NS // 10, duration=NS,
                                 pattern="ball"))
        under.add_clip(ed.TestClip(start=NS // 10, duration=2 * NS,
                                   pattern="smpte"))
        top.add_clip(ed.TestClip(start=2 * NS + NS // 2, duration=NS // 2,
                                 pattern="white"))
        return tl
    rows = render(build, batch=6)
    assert sum(r[2] for r in rows) == 30


@pytest.mark.parametrize("batch", [1, 7])
def test_title_effect_keyframes_inpoint_match_reference(batch):
    """A TitleClip over a gap, an effect with keyframes (videobalance's
    saturation and brightness animated) on a clip with an inpoint."""
    def build(ed, frac):
        tl = ed.Timeline(ed.VideoTrack(width=64, height=48, fps=frac(10, 1)))
        layer = tl.append_layer()
        layer.add_clip(ed.TitleClip(start=0, duration=NS // 2, text="HI",
                                    background="black", font_size=20))
        clip = ed.TestClip(start=NS // 2, duration=NS, inpoint=3 * NS // 10,
                           pattern="snow")
        fx = ed.Effect("videobalance")
        fx.set_keyframe("saturation", 0, 1.0)
        fx.set_keyframe("saturation", NS, 0.0)
        fx.set_keyframe("brightness", 0, -0.2)
        fx.set_keyframe("brightness", NS // 2, 0.3)
        clip.add_effect(fx)
        clip.add_effect(ed.Effect("videoflip method=horizontal-flip"))
        layer.add_clip(clip)
        return tl
    rows = render(build, batch=batch)
    assert sum(r[2] for r in rows) == 15


def test_groups_and_nested_timelines_match_reference():
    """A group moved across layers, an ungrouped clip, and a nested
    timeline (with its own inpoint and effect) as a clip."""
    def build(ed, frac):
        inner = ed.Timeline(ed.VideoTrack(width=16, height=16,
                                          fps=frac(10, 1)))
        il = inner.append_layer()
        il.add_clip(ed.TestClip(start=0, duration=NS, pattern="gradient"))
        il.add_clip(ed.TestClip(start=NS // 2, duration=NS,
                                pattern="checkers-4"))
        tl = ed.Timeline(*tracks(ed, frac))
        l0, l1 = tl.append_layer(), tl.append_layer()
        a = l0.add_clip(ed.TestClip(start=0, duration=NS // 2,
                                    pattern="white"))
        b = l1.add_clip(ed.TestClip(start=NS // 5, duration=NS,
                                    pattern="red"))
        g = ed.Group.group([a, b])
        g.start = NS // 2
        g.shift(-NS // 10)
        nested = ed.NestedTimelineClip(start=3 * NS // 2, duration=NS,
                                       inpoint=NS // 5, timeline=inner)
        nested.add_effect(ed.Effect("videobalance saturation=0.0"))
        l0.add_clip(nested)
        assert g.ungroup() == [a, b] and not g.clips
        return tl
    rows = render(build)
    assert sum(r[2] for r in rows) == 25


def test_audio_crossfade_and_keyframes_match_reference():
    """timelineaudiosrc: a gap of silence, a linear crossfade summed in
    float64 and rounded half to even to S16, a keyframed volume, an
    inpoint, and a nested audio timeline."""
    def build(ed, frac):
        inner = ed.Timeline(audio=ed.AudioTrack(rate=8000, channels=2))
        inner.append_layer().add_clip(ed.TestClip(
            start=0, duration=NS, wave="square", freq=300.0, volume=0.7))
        tl = ed.Timeline(audio=ed.AudioTrack(rate=8000, channels=2))
        layer = tl.append_layer()
        clip = ed.TestClip(start=NS // 10, duration=NS, wave="sine",
                           freq=440.0, volume=0.9, inpoint=NS // 4)
        fx = ed.Effect("volume")
        fx.set_keyframe("volume", 0, 1.0)
        fx.set_keyframe("volume", NS, 0.1)
        clip.add_effect(fx)
        layer.add_clip(clip)
        layer.add_clip(ed.TestClip(start=NS // 2, duration=NS,
                                   wave="triangle", freq=1000.0))
        layer.add_clip(ed.NestedTimelineClip(start=2 * NS, duration=NS // 2,
                                             inpoint=NS // 10,
                                             timeline=inner))
        return tl
    rows = render(build, kind="audio", batch=1, blocksize=700)
    assert sum(r[3][2][0] for r in rows) == 20000


def test_audio_float_track_matches_reference(tmp_path):
    """An F32LE track keeps the float64 mix as the JAX package does (no
    rounding): two 8 kHz stereo WAV clips (the sub-pipelines convert and
    resample nothing, so they are exact) crossfading, one keyframed."""
    import wave
    rng = np.random.default_rng(8)
    paths = []
    for k in range(2):
        path = tmp_path / f"c{k}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(rng.integers(-20000, 20000, (8000, 2),
                                       dtype=np.int16).tobytes())
        paths.append(str(path))

    def build(ed, frac):
        tl = ed.Timeline(audio=ed.AudioTrack(rate=8000, channels=2,
                                             format="F32LE"))
        layer = tl.append_layer()
        a = ed.UriClip(start=0, duration=NS, location=paths[0])
        fx = ed.Effect("volume")
        fx.set_keyframe("volume", 0, 0.5)
        fx.set_keyframe("volume", NS, 1.0)
        a.add_effect(fx)
        layer.add_clip(a)
        layer.add_clip(ed.UriClip(start=3 * NS // 5, duration=NS,
                                  inpoint=NS // 8, location=paths[1]))
        return tl
    rows = render(build, kind="audio", batch=1, blocksize=500)
    assert rows[0][3][1] == "<f8"


def test_timeline_model_matches_reference():
    """stack_at, transition_at, duration and the launch fragments of every
    clip kind, effects named for keyframes included."""
    def model(ed, frac):
        tl = ed.Timeline(*tracks(ed, frac))
        l0, l1 = tl.append_layer(), tl.append_layer()
        c = [l0.add_clip(ed.TestClip(start=0, duration=NS)),
             l0.add_clip(ed.TestClip(start=NS // 2, duration=NS,
                                     pattern="ball")),
             l1.add_clip(ed.UriClip(start=0, duration=2 * NS,
                                    location="/x/a.mkv")),
             l1.add_clip(ed.TitleClip(start=NS, duration=NS, text='say "hi"'))]
        fx = ed.Effect("videobalance hue=0.1")
        fx.set_keyframe("hue", 0, 0.1)
        c[0].add_effect(fx)
        c[0].add_effect(ed.Effect("identity name=mine"))
        uris = [ed.UriClip(location=f"/x/a.{e}").video_launch(None)
                for e in ("avi", "webm", "mp4", "ts", "oga", "y4m")]
        uris.append(ed.UriClip(location="/x/a.wav").audio_launch(None))
        times = [k * NS // 7 for k in range(16)]
        return ([[(tl.layers.index(la), la.clips.index(cl))
                  for la, cl in tl.stack_at(t)] for t in times],
                [None if (tr := tl.transition_at(t)) is None else
                 (tr[0].start, tr[1].start, tr[2]) for t in times],
                tl.duration, [x.video_launch(tl.video_track) for x in c],
                [x.audio_launch(tl.audio_track) for x in c], uris,
                tl.video_track.caps_string(), tl.audio_track.caps_string())
    assert model(ted, Fraction) == model(jed, JFraction)


def test_timeline_sources_need_a_card(monkeypatch):
    """Outside a pipeline a timeline source takes the card; without one it
    raises rather than run on the CPU."""
    tl = ted.Timeline(*tracks(ted, Fraction))
    tl.append_layer().add_clip(ted.TestClip(start=0, duration=NS))
    src = tmake("timelinevideosrc", timeline=tl)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        src.create(2)


# -- chip_smoke.py's timeline_crossfade_1080p at a small size ----------------------
@pytest.fixture
def small_tail(monkeypatch):
    monkeypatch.setattr(cs, "TM_CLIPS", (960, 540, 6, 2))
    monkeypatch.setattr(cs, "TM_TRACK", (96, 54, 2, 4))
    monkeypatch.setattr(cs, "TM_AUDIO", (8000, 2, 800))


def test_chip_smoke_timeline_matches_reference(small_tail, tmp_path):
    """timeline_crossfade_1080p's timelines (two Matroska UriClips that
    overlap, a TitleClip under them, two square waves) at 960x540 into a
    96x54 RGB track: the port's frames and samples are the JAX package's,
    and each clip's sub-pipeline converts a frame with yscale_hv a tick."""
    from gstreamer_tpu_torch.ops import yscale_kernel as ysk
    paths = cs.tm_write_clips(str(tmp_path), CPU)
    calls = []
    plain_fn = ysk.yscale_hv_plain

    def spy(*a, **k):
        calls.append(1)
        return plain_fn(*a[:3])
    orig = ysk.yscale_hv
    ysk.yscale_hv = spy
    try:
        got = cs.tm_timeline_run("gstreamer_tpu_torch", paths, CPU)
    finally:
        ysk.yscale_hv = orig
    want = cs.tm_timeline_run("gstreamer_tpu", paths, None)
    assert len(calls) == 12
    assert cs.ts_sha(got[0]) == cs.ts_sha(want[0]) and got[1] == want[1]
    assert got[0][0].shape == (12, 54, 96)
    got = cs.tm_timeline_run("gstreamer_tpu_torch", paths, CPU, "audio")
    want = cs.tm_timeline_run("gstreamer_tpu", paths, None, "audio")
    assert got[0].dtype == want[0].dtype == np.int16
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
