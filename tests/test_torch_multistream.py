"""Multi-stream execution of the port's Pipeline against the JAX package.

Mirrors ``tests/test_multistream_demux.py`` (one parse feeding both
branches, per-pad caps, a convert chain, the single-stream ``stream=``
mode, qtdemux A/V, uridecodebin, playbin's A/V build) on raw tracks (its
libav cases run on the port in ``test_torch_libav.py``), and adds the
pipeline's behaviour: ``select_streams`` mid-stream, tracks of unequal
length ending on different ticks, prefetch, a flushing seek, the
per-element path that a text track forces, a pad whose peer takes host
bytes left unstaged, and ``compile(mesh=...)``.  The
same seeded files go through both packages (the port on the CPU); samples,
caps and bus messages equal, tolerance 0.
"""

import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse
from gstreamer_tpu.elements import container_elements as jce
from gstreamer_tpu.elements import isomp4 as jiso

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.elements import container_elements as tce
from gstreamer_tpu_torch.elements import isomp4 as tiso
from gstreamer_tpu_torch.interop import negotiated_caps

from test_torch_captions import _run, drain, pair, sample_rows
from test_torch_containers import (apushes, asrc, rm_bytes, text_pushes,
                                   vpushes, vsrc)
from test_torch_pipeline import _name_elements

tparse = gstreamer_tpu_torch.parse_launch


def write_jax(desc, pushes, batch=2):
    """A file written by the JAX package's muxer from seeded pushes."""
    _run(jparse, JBuffer, desc, pushes, (), batch, None)


@pytest.fixture
def av_mkv(tmp_path):
    """I420 32x24 at 25/1, 8 frames in ticks of 2, and 48 kHz stereo S16LE
    in 4 blocks of 1024."""
    path = tmp_path / "av.mkv"
    write_jax(f"matroskamux name=m location={path} ! fakesink "
              f"{vsrc('I420')} ! m.video_0 {asrc()} ! m.audio_0",
              {"v": vpushes("I420", ticks=4), "a": apushes(1024, ticks=4)})
    return path


def _count_parses(monkeypatch, module, fn):
    calls = []
    orig = getattr(module, fn)

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(module, fn, counting)
    return calls


def test_single_parse_feeds_av_branches(av_mkv, monkeypatch):
    """One matroskademux drives both sinks from ONE file read and parse,
    in both packages; a tick gives `batch` video frames and one audio
    block."""
    jcalls = _count_parses(monkeypatch, jce, "_parse_matroska")
    tcalls = _count_parses(monkeypatch, tce, "_parse_matroska")
    _, ref, tpipe, out = pair(
        f"matroskademux name=d location={av_mkv} d.video_0 ! appsink name=v "
        f"d.audio_0 ! appsink name=a", sinks=("v", "a"), batch=2)
    assert len(jcalls) == len(tcalls) == 1
    assert sum(s.buffer.data[0].shape[0] for s in out["v"]) == 8
    assert sum(s.buffer.data.shape[0] for s in out["a"]) == 4 * 1024
    assert tpipe._fused


def test_multistream_caps_per_pad(av_mkv):
    _, _, tpipe, _ = pair(f"matroskademux name=d location={av_mkv} "
                          f"d.video_0 ! appsink name=v d.audio_0 ! "
                          f"appsink name=a", sinks=("v", "a"))
    d = tpipe.get_by_name("d")
    v, a = d.get_pad("video_0").caps[0], d.get_pad("audio_0").caps[0]
    assert (v.name, v["width"], a.name, a["rate"], a["channels"]) == \
        ("video/x-raw", 32, "audio/x-raw", 48000, 2)


def test_multistream_through_convert_chain(av_mkv):
    """Each exposed stream negotiates on its own: the video to RGB 16x16
    through the converter, the audio to mono at 16 kHz (S16LE: the
    resampler's integer path is bit for bit, its float path within the
    reference's ULP contract)."""
    pair(f"matroskademux name=d location={av_mkv} d.video_0 ! "
         f"videoconvertscale add-borders=false ! video/x-raw,format=RGB,"
         f"width=16,height=16 ! appsink name=v d.audio_0 ! audioconvert ! "
         f"audioresample ! audio/x-raw,format=S16LE,rate=16000,channels=1 ! "
         f"appsink name=a", sinks=("v", "a"), batch=4)


@pytest.mark.parametrize("stream", ["video", "audio", "1", "2"])
def test_single_stream_mode_still_works(av_mkv, stream):
    pair(f"matroskademux location={av_mkv} stream={stream} ! "
         f"appsink name=out", batch=3)


def _tick_run(parse, buffer_cls, desc, sinks, batch, at=None, prefetch=False,
              **kw):
    """Tick a pipeline to EOS, `at(pipe, k)` before tick k; returns
    (pipeline, {sink: samples}, ticks, values `at` returned)."""
    pipe = parse(desc, batch=batch, **kw)
    _name_elements(pipe)
    pipe.compile(batch=batch, prefetch=prefetch)
    pipe.set_state("playing")
    k, said = 0, []
    while True:
        if at is not None:
            said.append(at(pipe, k))
        if not pipe.tick():
            break
        k += 1
    pipe.set_state("null")
    return pipe, {s: drain(pipe.get_by_name(s)) for s in sinks}, k, said


def tick_pair(desc, sinks, batch, at=None, prefetch=False):
    j = _tick_run(jparse, JBuffer, desc, sinks, batch, at, prefetch)
    t = _tick_run(tparse, Buffer, desc, sinks, batch, at, prefetch,
                  device="cpu")
    for s in sinks:
        assert sample_rows(t[1][s]) == sample_rows(j[1][s]), s
    assert negotiated_caps(t[0]) == negotiated_caps(j[0])
    assert (t[2], t[3]) == (j[2], j[3])
    return j, t


AV = ("matroskademux name=d location={p} d.video_0 ! appsink name=v "
      "d.audio_0 ! appsink name=a")


def test_select_streams_mid_stream(av_mkv):
    """Audio deselected before tick 1 and reselected before tick 3: its
    blocks keep their shape and timestamps and come as zeros meanwhile;
    then only the audio selected."""
    def at(pipe, k):
        d = pipe.get_by_name("d")
        if k == 1:
            d.select_streams(["video_0"])
        elif k == 3:
            d.select_streams(None)
        return d.stream_selected("audio_0")
    _, (tpipe, out, ticks, _) = tick_pair(AV.format(p=av_mkv), ("v", "a"), 2,
                                          at)
    audio = [s.buffer.data for s in out["a"]]
    assert ticks == 4 and len(audio) == 4
    assert [bool(torch.any(a)) for a in audio] == [True, False, False, True]
    tick_pair(AV.format(p=av_mkv), ("v", "a"), 2,
              lambda pipe, k: pipe.get_by_name("d").select_streams(
                  ["audio_0"]))


@pytest.fixture
def uneven_mkv(tmp_path):
    """8 video frames (the muxer's ticks of 4) and 2 audio blocks."""
    path = tmp_path / "uneven.mkv"
    write_jax(f"matroskamux name=m location={path} ! fakesink "
              f"{vsrc('I420')} ! m.video_0 {asrc()} ! m.audio_0",
              {"v": vpushes("I420", batch=4, ticks=2),
               "a": apushes(1024, ticks=2)}, batch=4)
    return path


@pytest.mark.parametrize("batch,ticks,nv,na", [(2, 4, 4, 2), (3, 3, 3, 2),
                                               (8, 2, 1, 2)])
def test_tracks_of_unequal_length(batch, ticks, nv, na, uneven_mkv):
    """The video pad gives `batch` frames a tick and the audio pad one
    block: at a small batch the audio ends first and its sink gets nothing
    on the later ticks, at a large one the video does; the source is EOS
    when both have ended (the fused path in both packages)."""
    j, t = tick_pair(AV.format(p=uneven_mkv), ("v", "a"), batch)
    assert t[2] == ticks and (len(t[1]["v"]), len(t[1]["a"])) == (nv, na)
    assert t[0]._fused


def test_prefetch(av_mkv):
    """compile(prefetch=True) stages every pad of the next tick after the
    step: the same samples as the JAX package's prefetch."""
    j, t = tick_pair(AV.format(p=av_mkv), ("v", "a"), 2, prefetch=True)
    assert t[0]._prefetch and t[2] == 4


def test_flushing_seek(av_mkv):
    """A flushing seek mid-stream, under prefetch: the demuxers have no
    `do_seek` in either package, so it returns False and the stream goes
    on from where it was (the staged tick kept)."""
    def at(pipe, k):
        return pipe.seek(0) if k == 2 else None
    j, t = tick_pair(AV.format(p=av_mkv), ("v", "a"), 2, at, prefetch=True)
    assert t[3][2] is False and t[2] == 4


@pytest.fixture
def avs_mkv(tmp_path):
    """Video, audio and an S_TEXT/UTF8 track."""
    path = tmp_path / "avs.mkv"
    write_jax(f"matroskamux name=m location={path} ! fakesink "
              f"{vsrc('I420')} ! m.video_0 {asrc()} ! m.audio_0 appsrc "
              f"name=s caps=text/x-raw,format=utf8 ! m.subtitle_0",
              {"v": vpushes("I420", ticks=3), "a": apushes(1024, ticks=3),
               "s": text_pushes()})
    return path


def test_text_track_runs_per_element(avs_mkv):
    """A linked subtitle pad makes the demuxer a host element: the graph
    runs per element in both packages, the text stays host data and the
    media pads still reach the card's path (here the CPU)."""
    j, t = tick_pair(f"matroskademux name=d location={avs_mkv} d.video_0 ! "
                     f"videoconvertscale add-borders=false ! video/x-raw,"
                     f"format=RGB,width=16,height=16 ! appsink name=v "
                     f"d.audio_0 ! appsink name=a d.subtitle_0 ! "
                     f"appsink name=s", ("v", "a", "s"), 2)
    tpipe = t[0]
    assert not tpipe._fused and not j[0]._fused
    assert [s.buffer.data for s in t[1]["s"]][0] == ["hello"]
    # without the text pad the same file runs fused
    j, t = tick_pair(AV.format(p=avs_mkv), ("v", "a"), 2)
    assert t[0]._fused


def test_host_bytes_pad_is_not_staged(tmp_path):
    """A demuxer pad whose peer takes host bytes (jpegdec) is handed over
    unstaged; the other pad is staged."""
    path = tmp_path / "mjpeg.mkv"
    write_jax(f"matroskamux name=m location={path} ! fakesink "
              f"{vsrc('I420')} ! jpegenc ! m.video_0 {asrc()} ! m.audio_0",
              {"v": vpushes("I420", ticks=2), "a": apushes(1024, ticks=2)})
    j, t = tick_pair(f"matroskademux name=d location={path} d.video_0 ! "
                     f"jpegdec ! appsink name=v d.audio_0 ! appsink name=a",
                     ("v", "a"), 2)
    assert t[0]._host_fed_pads == {"d:video_0"} and not t[0]._host_fed


@pytest.fixture
def av_mov(tmp_path):
    path = tmp_path / "av.mov"
    write_jax(f"qtmux name=m location={path} ! fakesink {vsrc('UYVY')} ! "
              f"m.video_0 {asrc()} ! m.audio_0",
              {"v": vpushes("UYVY", ticks=3), "a": apushes(800, ticks=3)})
    return path


def test_qtdemux_one_parse_av(av_mov, monkeypatch):
    """qtdemux: one moov parse drives the UYVY video and the 'sowt' audio;
    the audio track comes whole in the first tick and ends."""
    jcalls = _count_parses(monkeypatch, jiso, "_parse_qt")
    tcalls = _count_parses(monkeypatch, tiso, "_parse_qt")
    _, _, tpipe, out = pair(
        f"qtdemux name=d location={av_mov} d.video_0 ! videoconvertscale "
        f"add-borders=false ! video/x-raw,format=RGB,width=16,height=16 ! "
        f"appsink name=v d.audio_0 ! appsink name=a", sinks=("v", "a"),
        batch=2)
    assert len(jcalls) == len(tcalls) == 1
    assert [s.buffer.batch for s in out["v"]] == [2, 2, 2]
    assert [s.buffer.data.shape[0] for s in out["a"]] == [2400]


def test_mxfdemux_multi(tmp_path):
    path = tmp_path / "av.mxf"
    write_jax(f"mxfmux name=m location={path} ! fakesink {vsrc('UYVY')} ! "
              f"m.video_0 {asrc()} ! m.audio_0",
              {"v": vpushes("UYVY", ticks=2), "a": apushes(1920, ticks=2)})
    pair(f"mxfdemux name=d location={path} d.video_0 ! videoconvertscale ! "
         f"video/x-raw,format=I420,width=16,height=12 ! appsink name=v "
         f"d.audio_0 ! appsink name=a", sinks=("v", "a"), batch=2)


def test_uridecodebin_multistream(av_mkv):
    """uridecodebin exposes per-track pads from ONE internal demuxer; its
    internal pipeline runs at batch 1, so the outer ticks replay one frame
    and one block each.  The replayed caps keep the internal appsink's
    memory:SystemMemory feature, which the outer graph takes for an
    explicit host demand: each frame goes to the host and back before the
    next element, in both packages (ROADMAP.md section 3)."""
    jpipe, _, tpipe, out = pair(
        f"uridecodebin name=u uri=file://{av_mkv} u.video_0 ! identity "
        f"name=iv ! appsink name=v u.audio_0 ! identity name=ia ! "
        f"appsink name=a", sinks=("v", "a"), batch=4)
    assert sum(s.buffer.data[0].shape[0] for s in out["v"]) == 8
    assert sum(s.buffer.data.shape[0] for s in out["a"]) == 4 * 1024
    forced = {e.name for e in tpipe._forced_host_elems}
    assert forced == {"iv", "ia"} == \
        {e.name for e in jpipe._forced_host_elems}
    caps = tpipe.get_by_name("u").get_pad("video_0").caps
    assert "memory:SystemMemory" in str(caps)


def test_playbin_av(av_mkv):
    """playbin's A/V build: both raw tracks from one parse, the same
    samples in both packages."""
    rows = {}
    for key, make in (("j", jmake), ("t", tmake)):
        pb = make("playbin", uri=f"file://{av_mkv}")
        pb.device = torch.device("cpu")
        pipe, sinks = pb.build_pipeline_av()
        assert set(sinks) == {"video", "audio"}
        rows[key] = {k: sample_rows(drain(s)) for k, s in sinks.items()}
    assert rows["t"] == rows["j"]
    assert len(rows["t"]["video"]) == 8


def test_compile_multistream_sources(av_mkv, av_mov, tmp_path):
    """compile no longer raises on a graph of any ported demuxer; a mesh
    still does."""
    rm = tmp_path / "a.rm"
    rm.write_bytes(rm_bytes())
    mxf = tmp_path / "a.mxf"
    write_jax(f"mxfmux name=m location={mxf} ! fakesink {vsrc('UYVY')} ! "
              f"m.video_0", {"v": vpushes("UYVY", ticks=1)})
    for desc in (f"matroskademux name=d location={av_mkv}",
                 f"qtdemux name=d location={av_mov}",
                 f"mxfdemux name=d location={mxf}",
                 f"rmdemux name=d location={rm}",
                 f"uridecodebin name=d uri=file://{av_mkv}"):
        p = tparse(f"{desc} d.video_0 ! fakesink", device="cpu")
        p.compile(batch=2)
        assert p._plan
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            p.compile(mesh=object())
