"""The port's last host modules against the JAX package, bit for bit:
``video/hdr.py`` (``convert_sample`` on the port's converter, the HDR
strings, the navigation events), ``check/harness.py``,
``validate/monitor.py``, ``video/timecode.py``, ``video/anc.py``,
``video/multiview.py``, ``video/dma.py``, ``video/codecbase.py``,
``audio/iec61937.py``, ``audio/streamalign.py`` and the four tools
(``typefind``, ``stats``, ``dotsviewer``, ``logviewer``).  The editing
timeline has a file of its own, ``test_torch_editing.py``.

Two kinds of case.  The JAX package's own tests of these modules run again
on the port (``test_torch_webrtc.reference_cases`` / ``run_case``: every
name they take from the JAX package bound to the port's, pipelines,
harnesses and ``convert_sample`` on the CPU; a case fails if it builds a
JAX element), with the element classes those test modules define rebuilt
on the port's bases (``port_test_classes``).  And the same seeded inputs go
through both packages: timecodes, ANC lines and packets, multiview
geometry, DRM maps, IEC 61937 bursts, aligned timestamps, converted
planes, harness outputs, monitor reports and the tools' output equal,
tolerance 0.  The host items of ``chip_smoke.py``'s phase 26
(``tm_rows``) are held to the committed digests, and the registries of
both packages are compared whole in a fresh process.
"""

import inspect
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gstreamer_tpu.check.harness import Harness as JHarness
from gstreamer_tpu.core.parse import parse_launch as jparse
from gstreamer_tpu.utils.dot import pipeline_to_dot as jdot
from gstreamer_tpu.validate.monitor import PipelineMonitor as JMonitor
from gstreamer_tpu.validate.monitor import Scenario as JScenario
from gstreamer_tpu.video import hdr as jhdr

from gstreamer_tpu_torch.check.harness import Harness
from gstreamer_tpu_torch.core import element as telement
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.core.parse import parse_launch as tparse
from gstreamer_tpu_torch.utils.dot import pipeline_to_dot as tdot
from gstreamer_tpu_torch.validate.monitor import PipelineMonitor, Scenario
from gstreamer_tpu_torch.video import hdr as thdr

import chip_smoke as cs
import test_anc_multiview
import test_audio
import test_codecbase
import test_dma_dsd_iec
import test_dotsviewer
import test_harness_extras
import test_logviewer
import test_peripheral_video
import test_validate
from test_torch_captions import drain, i420, plain
from test_torch_rtp import _port_globals, _port_of, on_port
from test_torch_webrtc import reference_cases, run_case

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


# -- running the JAX package's tests on the port ------------------------------
def stacked_cases(module, only=None, exclude=()):
    """``reference_cases`` with a test under several ``parametrize`` marks
    expanded into every combination of their values (``reference_cases``
    takes the first mark only)."""
    out = []
    for case in reference_cases(module, only, exclude):
        _id, mod, cls, fn, names, values = case
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if len(marks) < 2:
            out.append(case)
            continue
        if not _id.endswith("[0]"):
            continue                    # the first case stands for all
        base = _id[:-3]
        keys, grids = [], []
        for m in marks:
            ks = m.args[0]
            ks = [k.strip() for k in ks.split(",")] if isinstance(
                ks, str) else list(ks)
            keys += ks
            grids.append([v if len(ks) > 1 else (v,) for v in m.args[1]])
        for k, combo in enumerate(itertools.product(*grids)):
            out.append((f"{base}[{k}]", mod, cls, fn, keys,
                        tuple(itertools.chain(*combo))))
    return out


def port_test_classes(module, *names, register=False):
    """Rebuild classes a JAX test module defines on the JAX package's bases
    (a toy codec, a deliberately broken element) on the port's: its bases
    through ``_port_of``, its methods through ``on_port``.  The copies
    replace the originals in the module's port globals; with `register`
    each is registered in the port's registry under its FACTORY."""
    g = _port_globals(module.__dict__)
    for n in names:
        cls = getattr(module, n)
        body = {k: on_port(v) if inspect.isfunction(v) else v
                for k, v in vars(cls).items()
                if k not in ("__dict__", "__weakref__")}
        body.pop("pytestmark", None)
        new = type(n, tuple(_port_of(b) for b in cls.__bases__), body)
        if register and new.FACTORY not in telement._REGISTRY:
            telement.register_element(new)
        g[n] = new


REFERENCE = (
    stacked_cases(test_peripheral_video) + stacked_cases(test_codecbase)
    + stacked_cases(test_anc_multiview)
    + stacked_cases(test_dma_dsd_iec, only=("TestDrmFourcc",
                                            "TestIec61937"))
    + stacked_cases(test_harness_extras) + stacked_cases(test_validate)
    + stacked_cases(test_dotsviewer) + stacked_cases(test_logviewer)
    + stacked_cases(test_audio, only=("TestAudioMix::test_harness_volume",)))


@pytest.fixture(scope="module")
def port_classes():
    port_test_classes(test_codecbase, "ToyEncoder", "ToyDecoder")
    port_test_classes(test_validate, "_BrokenPtsElement", register=True)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path, port_classes):
    run_case(case, tmp_path)


# -- chip_smoke.py's phase 26: the host items, both packages, the digests ------
FILES = {n: os.path.join(cs.CODEC_DIR, n) for n in cs.TM_VECTORS}
ROWS = cs.tm_rows(FILES)


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_tm_rows_match_the_reference(row, tmp_path):
    """Each host item of phase 26 (timecode, ANC, multiview, DMA, IEC 61937,
    stream align, codec base, the four tools) gives the same plain data in
    both packages (the port on the CPU)."""
    name, fn = row
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = fn("gstreamer_tpu", None, str(tmp_path / "j"))
    got = fn("gstreamer_tpu_torch", CPU, str(tmp_path / "t"))
    assert got == want


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_tm_rows_match_the_committed_digests(row, tmp_path):
    """... and the digest the card's run is held to (digests.json,
    tail/rows)."""
    name, fn = row
    dig = cs.codec_vectors(cs.TM_FILES)[1]["tail"]["rows"]
    assert cs.lv_digest(fn("gstreamer_tpu_torch", CPU, str(tmp_path))) == \
        dig[name]


# -- video/hdr.py: convert_sample, the HDR strings, navigation ----------------
@pytest.mark.parametrize("w, h, ow, oh, fmt, config", [
    (64, 48, 32, 24, "RGB", None),
    (64, 48, 96, 72, "BGRA", {"resampler-method": "lanczos"}),
    (64, 48, 64, 48, "NV12", None),
    (1920, 1080, 224, 224, "RGB", None),
    (1920, 1080, 224, 224, "RGB", {"resampler-method": "linear",
                                   "resampler-taps": 2}),
])
def test_convert_sample_matches_reference(w, h, ow, oh, fmt, config):
    """convert_sample on the port's converter (CPU) equals the JAX
    package's numpy gold byte for byte, at 64x48 and at 1080p to 224x224
    (cubic, the default, and bilinear); the planes are tensors on the
    device asked for."""
    planes = cs.ct_frames(2, w, h, 11)
    src = f"video/x-raw,format=I420,width={w},height={h}"
    dst = f"video/x-raw,format={fmt},width={ow},height={oh}"
    want = jhdr.convert_sample(planes, src, dst, config)
    got = thdr.convert_sample(planes, Caps.from_string(src), dst, config,
                              device="cpu")
    assert all(isinstance(g, torch.Tensor) and g.device == CPU for g in got)
    assert [plain(g) for g in got] == [plain(np.asarray(x)) for x in want]


def test_convert_sample_takes_tensors_and_needs_a_card(monkeypatch):
    planes = cs.ct_frames(1, 64, 48, 12)
    src = "video/x-raw,format=I420,width=64,height=48"
    dst = "video/x-raw,format=RGB,width=32,height=24"
    a = thdr.convert_sample(planes, src, dst, device="cpu")
    b = thdr.convert_sample(tuple(torch.from_numpy(p) for p in planes), src,
                            dst, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        thdr.convert_sample(planes, src, dst)


def test_hdr_strings_and_navigation_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        v = [int(x) for x in rng.integers(0, 50001, 10)]
        s = ":".join(map(str, v))
        t, j = (thdr.MasteringDisplayInfo.from_string(s),
                jhdr.MasteringDisplayInfo.from_string(s))
        assert t.to_string() == j.to_string() == s
        c = f"{v[0]}:{v[1]}"
        assert thdr.ContentLightLevel.from_string(c).to_string() == \
            jhdr.ContentLightLevel.from_string(c).to_string() == c
    for mod in (thdr, jhdr):
        with pytest.raises(ValueError):
            mod.MasteringDisplayInfo.from_string("1:2:3")
    for name, args in (("navigation_key_event", ("key-press", "Left")),
                       ("navigation_mouse_event",
                        ("mouse-button-press", 10.5, 20.0, 1)),
                       ("navigation_mouse_event", ("mouse-move", 1.0, 2.0))):
        t, j = getattr(thdr, name)(*args), getattr(jhdr, name)(*args)
        assert (t.type, t.data) == (j.type, j.data)


# -- check/harness.py -------------------------------------------------------------
I420_CAPS = "video/x-raw,format=I420,width=64,height=48,framerate=30/1"


def _both_harness(desc, caps, sink_caps=None, **props):
    return (JHarness(desc, **props).set_caps(caps, sink_caps),
            Harness(desc, device="cpu", **props).set_caps(caps, sink_caps))


@pytest.mark.parametrize("desc, sink_caps", [
    ("videoconvert", "video/x-raw,format=RGB,width=64,height=48"),
    ("videoconvertscale add-borders=false",
     "video/x-raw,format=RGB,width=32,height=32"),
    ("videoflip method=clockwise ! videobalance saturation=0.5", None),
    ("videoscale", "video/x-raw,width=24,height=16"),
])
def test_harness_push_matches_reference(desc, sink_caps):
    """Harness around one element or a launch line: every push (batches of
    1 and 3) gives the JAX harness's output, on the harness's device; the
    pad caps and the received count agree."""
    j, t = _both_harness(desc, I420_CAPS, sink_caps)
    for k, n in enumerate((1, 3, 1)):
        planes = i420(64, 48, n, 40 + k)
        want = j.push(planes, pts=k * 10**8, duration=10**8 // 3, batch=n)
        got = t.push(planes, pts=k * 10**8, duration=10**8 // 3, batch=n)
        assert all(g.device == CPU for g in got)
        assert plain(tuple(got)) == plain(tuple(want))
    assert str(t.sinkpad_caps) == str(j.sinkpad_caps)
    assert str(t.srcpad_caps) == str(j.srcpad_caps)
    assert t.buffers_received == j.buffers_received
    assert t.device == t.pipeline.device == CPU


def test_harness_sub_harnesses_match_reference():
    """add_src / push_from_src and add_sink / push_to_sink on the harness's
    device, as the JAX package's."""
    j, t = _both_harness("videoconvert", I420_CAPS,
                         "video/x-raw,format=RGB,width=64,height=48")
    src = f"videotestsrc num-buffers=3 pattern=gradient ! {I420_CAPS}"
    assert t.add_src(src).device == CPU
    j.add_src(src)
    for _ in range(4):
        want, got = j.push_from_src(), t.push_from_src()
        assert (got is None) == (want is None)
        if got is not None:
            assert plain(tuple(got.data)) == plain(tuple(want.data))
            assert got.pts == want.pts
    acaps = "audio/x-raw,format=S16LE,rate=8000,channels=1,layout=interleaved"
    j, t = _both_harness("identity", acaps)
    j.add_sink("volume volume=0.25")
    assert t.add_sink("volume volume=0.25").device == CPU
    x = (np.arange(96, dtype=np.int16) * 97).reshape(96, 1)
    assert j.push(x, pts=0) is None and t.push(x, pts=0) is None
    want, got = j.push_to_sink(), t.push_to_sink()
    assert plain(got.data) == plain(want.data)
    assert [e.type for e in t.sink_harness.events] == \
        [e.type for e in j.sink_harness.events]


def test_harness_testclock_and_events_match_reference():
    """use_testclock / crank_single_clock_wait gate clocksync as the JAX
    harness does; push_event reaches the element and its sink's events."""
    from gstreamer_tpu.core import events as jev
    from gstreamer_tpu_torch.core import events as tev
    acaps = "audio/x-raw,format=S16LE,rate=8000,channels=1,layout=interleaved"
    out = []
    for h, ev in ((JHarness("clocksync sync=true"), jev),
                  (Harness("clocksync sync=true", device="cpu"), tev)):
        clock = h.use_testclock()
        h.set_caps(acaps)
        a = h.push(np.ones((16, 1), np.int16), pts=10**9)
        cranked = h.crank_single_clock_wait()
        b = h.push(np.full((16, 1), 2, np.int16), pts=2 * 10**9)
        pushed = h.push_event(ev.eos_event())
        out.append((a is None, cranked, clock.get_time(), plain(b), pushed,
                    [e.type for e in h.events]))
    assert out[0] == out[1]


def test_harness_runs_on_the_card_by_default(monkeypatch):
    """No device named: the card, and without one the harness raises; the
    port's top-level package exposes Harness."""
    import gstreamer_tpu_torch
    assert gstreamer_tpu_torch.Harness is Harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Harness("identity")


# -- validate/monitor.py ----------------------------------------------------------
@pytest.fixture(scope="module")
def broken_pts():
    port_test_classes(test_validate, "_BrokenPtsElement", register=True)


def _monitored(parse, monitor_cls, desc, actions=None, max_ticks=None,
               setup=None, **kw):
    p = parse(desc, **kw)
    if setup is not None:
        setup(p)
    mon = monitor_cls(p)
    if actions is None:
        p.set_state("playing")
        p.run()
    else:
        sc_cls = Scenario if monitor_cls is PipelineMonitor else JScenario
        sc_cls(actions=actions(sc_cls, p), max_ticks=max_ticks).run(p, mon)
    rows = []
    for e in p.iterate_elements():
        if e.FACTORY == "appsink":
            rows += [(s.buffer.pts, s.buffer.batch, plain(s.buffer.data))
                     for s in drain(e)]
    return mon.report(), mon.ok, rows


def _both_monitored(desc, actions=None, max_ticks=None, setup=None,
                    batch=1):
    want = _monitored(jparse, JMonitor, desc, actions, max_ticks, setup,
                      batch=batch)
    got = _monitored(tparse, PipelineMonitor, desc, actions, max_ticks,
                     setup, batch=batch, device="cpu")
    return want, got


SNOW = ("videotestsrc name=src pattern=snow num-buffers=12 ! "
        "video/x-raw,format=I420,width=64,height=48,framerate=30/1 ! "
        "videobalance name=vb ! videoconvertscale add-borders=false ! "
        "video/x-raw,format=RGB,width=32,height=32 ! appsink name=s")


@pytest.mark.parametrize("name, actions", [
    ("plain", None),
    ("seek_set_eos", lambda S, p: [
        (1, S.seek(4 * 10**9 // 30)), (2, S.set_property("vb", "hue", 0.25)),
        (3, S.eos_injection())]),
    ("pause_play_flush", lambda S, p: [
        (1, S.pause(2)), (2, S.play()), (3, S.flush()), (4, S.wait(2))]),
    ("rate_seek_state", lambda S, p: [
        (1, S.seek(0, rate=2.0)), (2, S.set_state("playing")),
        (5, S.stop())]),
])
def test_monitor_and_scenario_match_reference(name, actions):
    """PipelineMonitor's report and the samples a Scenario lets through are
    the JAX package's, for each action of the reference's scenario
    vocabulary on a snow pipeline at batch 2."""
    want, got = _both_monitored(SNOW, actions, 12, batch=2)
    assert got == want


def test_monitor_reports_faults_as_the_reference(broken_pts):
    """A deliberately broken element, a misordered event and an invalid
    flow return give the JAX package's violations."""
    desc = ("videotestsrc name=v num-buffers=4 ! testbrokenpts name=b ! "
            "appsink name=s")
    want, got = _both_monitored(desc)
    assert got[:2] == want[:2] and not got[1]
    reports = []
    for parse, mon_cls, kw in ((jparse, JMonitor, {}),
                               (tparse, PipelineMonitor, {"device": "cpu"})):
        p = parse("videotestsrc name=v num-buffers=2 ! appsink name=s", **kw)
        mon = mon_cls(p)
        p.get_by_name("s").render = lambda buf: "banana"
        p.set_state("playing")
        p.tick()
        reports.append(mon.report())
    assert reports[0] == reports[1] != {"violations": []}


def test_scenario_appsrc_and_selector_actions_match_reference():
    """appsrc-push (numpy planes or tensors), appsrc-eos, check-position,
    switch-pad on an input-selector and set-caps, as the JAX package's."""
    desc = ("appsrc name=in caps=video/x-raw,format=I420,width=32,height=32,"
            "framerate=30/1 ! videoconvert ! video/x-raw,format=RGB ! "
            "appsink name=s")
    f0, f1 = i420(32, 32, 1, 5), i420(32, 32, 1, 6)

    def acts(S, p):
        tensor = p.__class__.__module__.startswith("gstreamer_tpu_torch")
        frame = tuple(torch.from_numpy(x) for x in f1) if tensor else f1
        return [(0, S.appsrc_push("in", f0, pts=0)),
                (1, S.appsrc_push("in", frame, pts=33_333_333)),
                (2, S.check_position(66_666_666, tolerance_ns=70_000_000)),
                (2, S.appsrc_eos("in"))]
    want, got = _both_monitored(desc, acts, 10)
    assert got == want and len(got[2]) == 2
    caps = "video/x-raw,format=I420,width=32,height=24,framerate=30/1"
    sel = (f"input-selector name=sel ! appsink name=s "
           f"videotestsrc num-buffers=6 pattern=ball ! {caps} ! sel.sink_0 "
           f"videotestsrc num-buffers=6 pattern=snow ! {caps} ! sel.sink_1")
    want, got = _both_monitored(
        sel, lambda S, p: [(2, S.switch_pad("sel", "sink_1"))], 10)
    assert got == want


def test_monitor_reads_no_device_data():
    """The monitor checks host integers only: a buffer whose data refuses
    every access passes its hooks."""
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"the monitor read the data ({name})")

        def __array__(self, *a, **k):
            raise AssertionError("the monitor read the data")
    from gstreamer_tpu_torch.core.buffer import Buffer
    p = tparse(SNOW, device="cpu")
    mon = PipelineMonitor(p)
    vb = p.get_by_name("vb")
    for pts in (0, 10, 5):
        buf = Buffer(data=Untouchable(), pts=pts, duration=3, batch=2)
        mon._on_buffer_pre(vb, buf)
        mon._on_buffer(vb, buf)
    assert [v.kind for v in mon.violations].count(
        "timestamp-regression") == 1


# -- the four tools -----------------------------------------------------------------
def test_typefind_cli_matches_reference(capsys):
    """tools.typefind over every committed vector and a missing file: the
    same lines and exit code."""
    from gstreamer_tpu.tools import typefind as jtf
    from gstreamer_tpu_torch.tools import typefind as ttf
    args = [FILES[n] for n in cs.TM_VECTORS] + [FILES["mp3_10s.mp3"] + ".x"]
    out = []
    for mod in (jtf, ttf):
        rc = mod.main(args)
        out.append((rc, capsys.readouterr()))
    assert out[0] == out[1] and out[0][0] == 1
    assert ttf.main([]) == 2


def test_stats_cli_runs_on_the_card_unless_told(monkeypatch, capsys):
    """tools.stats --cpu reports the JAX package's tracers and counts; with
    no --cpu it asks for the card and raises without one."""
    rc, rep = cs.tm_stats_run("gstreamer_tpu_torch", CPU)
    jrc, jrep = cs.tm_stats_run("gstreamer_tpu", None)
    assert rc == jrc == 0
    assert sorted(rep) == sorted(jrep) == ["latency", "rusage", "stats"]
    assert rep["stats"] == jrep["stats"]
    assert {k: v["n"] for k, v in rep["latency"].items()} == \
        {k: v["n"] for k, v in jrep["latency"].items()}
    assert "GTPU_TRACERS" not in os.environ
    from gstreamer_tpu_torch.tools import stats
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with cs.switches(GTPU_TRACERS=None):
            stats.main([cs.TM_STATS])
    assert stats.main([]) == 2


def test_dotsviewer_matches_reference(tmp_path):
    """The dot text of a negotiated pipeline with a tee and its page through
    dotsviewer's CLI: equal in both packages."""
    from gstreamer_tpu.tools import dotsviewer as jdv
    from gstreamer_tpu_torch.tools import dotsviewer as tdv
    desc = ("videotestsrc name=v num-buffers=1 ! videoconvert name=c ! "
            "tee name=t t. ! queue name=q ! fakesink name=f1 t. ! "
            "videoscale name=s ! capsfilter name=cf caps=\"video/x-raw,"
            "width=8,height=8\" ! fakesink name=f2")
    pages = []
    for parse, dot, dv, kw in ((jparse, jdot, jdv, {}),
                               (tparse, tdot, tdv, {"device": "cpu"})):
        p = parse(desc, **kw)
        p.negotiate()
        cs.tm_sort_caps(p)
        d = tmp_path / dv.__name__.split(".")[0] / "dots"
        d.mkdir(parents=True)
        (d / "a.dot").write_text(dot(p))
        out = d.parent / "page.html"
        assert dv.main([str(d), "-o", str(out)]) == 0
        pages.append((dot(p), dv.parse_dot(dot(p)), out.read_text()))
    assert pages[0] == pages[1]


def test_logviewer_matches_reference(tmp_path, capsys):
    """Both dialects, every filter, the terminal view and the page: equal."""
    from gstreamer_tpu.tools import logviewer as jlv
    from gstreamer_tpu_torch.tools import logviewer as tlv
    log = tmp_path / "run.log"
    log.write_text(cs.tm_log_text(5))
    for args in ([], ["--level", "WARNING"], ["--level", "trace",
                                              "--category", "tracer.*"],
                 ["--grep", "buffer 3"]):
        out = []
        for mod in (jlv, tlv):
            out.append((mod.main([str(log)] + args), capsys.readouterr()))
        assert out[0] == out[1]
    pages = []
    for mod in (jlv, tlv):
        page = tmp_path / f"{mod.__name__.split('.')[0]}.html"
        mod.main([str(log), "-o", str(page), "--level", "INFO"])
        pages.append(page.read_text())
    assert pages[0] == pages[1]


def test_logviewer_reads_the_ports_own_log(tmp_path):
    """A log the port writes (GTPU_DEBUG into GTPU_DEBUG_FILE, its loggers
    under gtpu_torch) parses line by line, each line's category as the JAX
    package's log of the same run gives it."""
    from gstreamer_tpu_torch.tools import logviewer as tlv
    cats = {}
    for pkg, kw in (("gstreamer_tpu_torch", ", device='cpu'"),
                    ("gstreamer_tpu", "")):
        log = tmp_path / f"{pkg}.log"
        code = (f"import {pkg} as g; g.parse_launch('videotestsrc "
                f"num-buffers=2 ! fakesink'{kw}).run()")
        env = dict(os.environ, GTPU_DEBUG="*:5", GTPU_DEBUG_FILE=str(log),
                   JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, "-c", code], env=env, check=True,
                       cwd=ROOT, timeout=300)
        lines = tlv.parse_log(str(log))
        raw = [ln for ln in log.read_text().splitlines() if ln.strip()]
        assert lines and len(lines) == len(raw)
        cats[pkg] = {ln.category for ln in lines}
    assert cats["gstreamer_tpu_torch"] == cats["gstreamer_tpu"]


# -- the registries, whole -------------------------------------------------------
def test_registries_with_editing_are_equal():
    """In a fresh process with the libav shim loaded and both editing
    packages imported, the two registries hold the same factories: every
    element factory and the two timeline sources (708 on a machine whose
    libavcodec gives the 56 libav factories)."""
    code = (
        "import json, sys; sys.path.insert(0, 'tests')\n"
        "from test_torch_libav import load_jax_av\n"
        "load_jax_av()\n"
        "import gstreamer_tpu.editing, gstreamer_tpu_torch.editing\n"
        "from gstreamer_tpu.core import element as j\n"
        "from gstreamer_tpu_torch.core import element as t\n"
        "j._ensure_elements_loaded(); t._ensure_elements_loaded()\n"
        "print(json.dumps([sorted(r) for r in (j._REGISTRY, t._REGISTRY)]"
        " + [sorted(f for f, (c, _r) in r.items() if '.editing.' in "
        "c.__module__) for r in (j._REGISTRY, t._REGISTRY)]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=600,
                       capture_output=True, text=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    jall, tall, jed, ted = json.loads(p.stdout.splitlines()[-1])
    assert jall == tall
    assert jed == ted == ["timelineaudiosrc", "timelinevideosrc"]
    from test_torch_flow import port_element_factories
    assert len(tall) == len(port_element_factories()) + 2
