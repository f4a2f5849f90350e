"""The port's last leaves against the JAX package, bit for bit:
``audio/dsd.py`` with ``elements/dsd_elements.py`` (dsdconvert,
fakevideodec), ``elements/camerabin.py``, ``mse.py`` (MediaSource,
SourceBuffer, msesrc), ``elements/splitmux.py`` (splitmuxsink,
splitmuxsrc), ``elements/midi_irtsp.py`` (midiparse, irtspparse,
unixfdsink, unixfdsrc), ``elements/gio_dv.py`` (giostreamsrc,
giostreamsink, dvdemux), ``elements/de265.py`` (libde265dec),
``elements/ogm.py`` (the three OGM parsers, oggaviparse),
``elements/xingmux.py``, ``elements/aes_misc.py`` (aesenc, aesdec,
tonegeneratesrc), ``elements/bz2_elements.py``,
``elements/chromaprint.py``, ``elements/ext_music.py`` (gmedec,
openmptdec) and ``elements/shout2.py`` (shout2send).

Two kinds of case.  The JAX package's own tests of these modules run
again on the port (``test_torch_webrtc.reference_cases`` / ``run_case``:
every name they take from the JAX package bound to the port's, elements
on the CPU; a case fails if it builds a JAX element).  And the same
seeded inputs go through both packages (``test_torch_captions.pair``, or
the elements called directly): bytes, samples, caps, timestamps and bus
messages equal, tolerance 0.  The chains of ``chip_smoke.py``'s phase 25
run here at 64x48, and its host items (``lv_rows``) are held to the
committed digests.  Every socket case runs under a deadline of its own
(``within``).  Where the JAX package is at fault (an OGM parser in a
launch string) a test states both behaviours (ROADMAP.md section 3).
"""

import glob
import io
import os
import struct
import tempfile
import threading

import numpy as np
import pytest
import torch

from gstreamer_tpu.audio import dsd as jdsd
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse
from gstreamer_tpu.elements import midi_irtsp as jmidi
from gstreamer_tpu.mse import MediaSource as JMediaSource

import gstreamer_tpu_torch
from gstreamer_tpu_torch.audio import dsd as tdsd
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.core.parse import parse_launch as tparse
from gstreamer_tpu_torch.elements import midi_irtsp as tmidi
from gstreamer_tpu_torch.mse import MediaSource

import chip_smoke as cs
import test_aes_dash_tone
import test_audioparsers
import test_camerabin
import test_chromaprint
import test_dsd_elements
import test_fieldanalysis_shout
import test_gio_dv
import test_midi_irtsp
import test_misc_elements2
import test_mse
import test_splitmux
import test_tail_elements
import test_xing_ape
from test_torch_analytics import same_spec
from test_torch_captions import drain, pair, plain
from test_torch_flow import LEAVES_FACTORIES, port_element_factories
from test_torch_rtp import _port_globals, on_port
from test_torch_webrtc import reference_cases, run_case

CPU = torch.device("cpu")
DEADLINE = 30.0          # seconds a socket case may take
VECTORS = os.path.join(os.path.dirname(__file__), "data", "torch_codecs")
RGB = ("videoconvertscale add-borders=false ! video/x-raw,format=RGB,"
       "width=32,height=32")
W, H = 64, 48
VCAPS = f"video/x-raw,format=I420,width={W},height={H},framerate=25/1"

REFERENCE = (
    reference_cases(test_camerabin) + reference_cases(test_splitmux)
    + reference_cases(test_mse) + reference_cases(test_dsd_elements)
    + reference_cases(test_chromaprint) + reference_cases(test_gio_dv)
    + reference_cases(test_midi_irtsp)
    + reference_cases(test_xing_ape, only=("TestXingMux",))
    + reference_cases(test_aes_dash_tone, only=("test_aes",
                                                "test_tonegeneratesrc"))
    + reference_cases(test_misc_elements2, only=(
        "test_bz2", "test_openmptdec", "test_libde265dec"))
    + reference_cases(test_tail_elements, only=("TestOgmParse",
                                                "TestOggAvi"))
    + reference_cases(test_fieldanalysis_shout, only=("TestShout2Send",)))
SOCKETS = ("TestUnixFd", "TestShout2Send")


def within(seconds, fn, *a, **kw):
    """fn(*a, **kw) on a thread of its own: its result, or the failure of a
    case that took longer than `seconds` (a socket case that would hang)."""
    out, err = [], []

    def body():
        try:
            out.append(fn(*a, **kw))
        except BaseException as e:          # re-raised below
            err.append(e)
    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"{fn.__name__} ran over {seconds} s"
    if err:
        raise err[0]
    return out[0]


@pytest.fixture(scope="module")
def webm_bytes(tmp_path_factory):
    """test_mse's fixture (x264enc into matroskamux) run on the port."""
    return on_port(test_mse.webm_bytes)(tmp_path_factory)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path, request):
    """The JAX package's cases on the port's modules, the MP3 frames of
    test_xing_ape and test_tail_elements made with the port's header
    parser."""
    for m in (test_xing_ape, test_tail_elements):
        _port_globals(m.__dict__)["make_mp3_frame"] = on_port(
            test_audioparsers.make_mp3_frame)
    fixtures = ({"webm_bytes": request.getfixturevalue("webm_bytes")}
                if "webm_bytes" in case[3].__code__.co_varnames else {})
    if any(s in case[0] for s in SOCKETS):
        within(DEADLINE, run_case, case, tmp_path)
    else:
        run_case(case, tmp_path, **fixtures)


@pytest.mark.parametrize("factory", LEAVES_FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


def test_registries_are_equal():
    """Every factory the JAX package's element packages register, the port's
    register, and no other (libav's and chromaprint's where their system
    libraries are).  Left out of both registries: what a module outside
    them registers when some test imports it (``editing/timeline.py``'s
    two, a test's own element), which a worker may or may not have
    imported; ``test_torch_tail_modules.py`` compares the registries whole
    in a fresh process."""
    from gstreamer_tpu.core import element as jelement
    from gstreamer_tpu_torch.core import element as telement
    from test_torch_libav import load_jax_av
    load_jax_av()
    jax = {f for f, (c, _r) in jelement._REGISTRY.items()
           if c.__module__.startswith(("gstreamer_tpu.elements.",
                                       "gstreamer_tpu.net."))
           or c.__module__ == "gstreamer_tpu.mse"}
    port = port_element_factories()
    assert set(port) == jax
    assert len(port) == len(jax)


def test_mse_is_imported_by_the_elements_package():
    from gstreamer_tpu_torch.core.element import get_factory_class
    assert get_factory_class("msesrc").__module__ == "gstreamer_tpu_torch.mse"


# -- DSD ----------------------------------------------------------------------
LAYOUTS = ("interleaved", "non-interleaved")


@pytest.mark.parametrize("fi", tdsd.FORMATS)
@pytest.mark.parametrize("fo", tdsd.FORMATS)
def test_dsd_convert_matches_reference(fi, fo):
    """gst_dsd_convert over every layout pair, with and without the bit
    reversal, at 1, 2 and 6 channels: the same bytes."""
    rng = np.random.default_rng(7)
    for ch in (1, 2, 6):
        data = rng.integers(0, 256, ch * 4 * 37, dtype=np.uint8)
        for li in LAYOUTS:
            for lo in LAYOUTS:
                for rev in (False, True):
                    got = tdsd.dsd_convert(data, fi, fo, ch, li, lo, rev)
                    want = jdsd.dsd_convert(data, fi, fo, ch, li, lo, rev)
                    assert got.dtype == want.dtype == np.uint8
                    assert got.tobytes() == want.tobytes(), (ch, li, lo, rev)


@pytest.mark.parametrize("fmt", tdsd.FORMATS)
def test_dsd_info_caps_round_trip(fmt):
    for layout in LAYOUTS:
        for rev in (False, True):
            kw = dict(format=fmt, rate=tdsd.dsd_rate_48x(2), channels=3,
                      layout=layout, reversed_bytes=rev)
            t, j = tdsd.DsdInfo(**kw), jdsd.DsdInfo(**kw)
            ts, js = t.to_caps_structure(), j.to_caps_structure()
            assert str(ts) == str(js)
            assert tdsd.DsdInfo.from_caps_structure(ts) == t
    assert tdsd.BIT_REVERSE.tobytes() == jdsd.BIT_REVERSE.tobytes()
    assert [tdsd.format_width(f) for f in tdsd.FORMATS] == \
        [jdsd.format_width(f) for f in jdsd.FORMATS]
    assert tdsd.dsd_rate_44x(4) == jdsd.dsd_rate_44x(4)


@pytest.mark.parametrize("fi", tdsd.FORMATS)
@pytest.mark.parametrize("li", LAYOUTS)
def test_dsdconvert_element(fi, li):
    """appsrc ! dsdconvert ! every format and layout, both packages."""
    data = np.random.default_rng(3).integers(0, 256, 512, dtype=np.uint8)
    for fo in tdsd.FORMATS:
        for lo in LAYOUTS:
            pair(f"appsrc name=in ! audio/x-dsd,format={fi},rate=2822400,"
                 f"channels=2,layout={li} ! dsdconvert ! audio/x-dsd,format="
                 f"{fo},layout={lo} ! appsink name=out",
                 {"in": [dict(data=data, pts=0)]})


def test_fakevideodec():
    dur = 10**9 // 25
    _j, _r, tpipe, out = pair(
        f"appsrc name=in caps=video/x-fake,width={W},height={H},framerate="
        f"25/1 ! fakevideodec ! {RGB} ! appsink name=out",
        {"in": [dict(data=np.zeros(1, np.uint8), pts=k * 2 * dur,
                     duration=dur, batch=2) for k in range(3)]}, batch=2)
    assert sum(s.buffer.batch for s in out["out"]) == 6
    assert tpipe.get_by_name("in") in tpipe._host_fed


# -- camerabin, msesrc, splitmux: the card's chains at 64x48 ---------------------
def _camera(make, tmp, mode, **kw):
    cam = make("camerabin", mode=mode, location=os.path.join(tmp, "c_%d"),
               **{"camera-source": f"videotestsrc num-buffers=1 pattern=ball "
                  f"! {VCAPS}"})
    if type(cam).__module__.startswith("gstreamer_tpu_torch"):
        cam.device = CPU
    if mode == 1:
        return cam.start_capture()
    cam.start_capture()
    return cam.stop_capture()


@pytest.mark.parametrize("mode", [1, 2])
def test_camerabin_writes_the_same_file(mode, tmp_path):
    os.mkdir(tmp_path / "t")
    os.mkdir(tmp_path / "j")
    t = _camera(tmake, str(tmp_path / "t"), mode)
    j = _camera(jmake, str(tmp_path / "j"), mode)
    assert os.path.basename(t) == os.path.basename(j)
    assert open(t, "rb").read() == open(j, "rb").read()


def test_camerabin_runs_on_its_device():
    """camerabin's inner pipelines take its device: with none set they run
    on CUDA, which raises without a card instead of falling back to the
    CPU."""
    cam = tmake("camerabin", mode=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cam.start_capture()


def _attach(ms_cls, blob):
    def setup(pipe):
        ms = ms_cls()
        ms.attach(pipe.get_by_name("m"))
        ms.add_source_buffer("video/x-matroska").append_buffer(blob)
        ms.end_of_stream()
    return setup


def test_camerabin_into_msesrc(tmp_path):
    """camerabin's recording appended to a MediaSource, msesrc ! RGB: the
    same frames in both packages, and the frames matroskademux gives."""
    path = _camera(tmake, str(tmp_path), 2)
    blob = open(path, "rb").read()
    _j, ref, _t, out = pair(f"msesrc name=m ! {RGB} ! appsink name=out",
                            batch=4, setup=_attach(MediaSource, blob),
                            jsetup=_attach(JMediaSource, blob))
    assert sum(s.buffer.batch for s in out["out"]) == 10
    demux = tparse(f"matroskademux location={path} stream=video ! {RGB} ! "
                   "appsink name=out", batch=4, device="cpu")
    demux.run()
    a = torch.cat([s.buffer.data[0] for s in out["out"]])
    b = torch.cat([s.buffer.data[0] for s in drain(demux.get_by_name("out"))])
    assert torch.equal(a, b)


def test_media_source_state_matches_reference(tmp_path):
    path = _camera(tmake, str(tmp_path), 2)
    blob = open(path, "rb").read()
    states = []
    for ms_cls, make in ((MediaSource, tmake), (JMediaSource, jmake)):
        ms = ms_cls()
        src = make("msesrc")
        row = [ms.ready_state]
        ms.attach(src)
        sb = ms.add_source_buffer("video/x-matroska")
        row += [ms.ready_state, sb.buffered, len(ms.active_source_buffers)]
        sb.append_buffer(blob[:len(blob) // 2])
        sb.append_buffer(blob[len(blob) // 2:])
        row += [sb.buffered, sb.bytes() == blob, src.ready_state]
        ms.end_of_stream()
        row += [ms.ready_state, ms.duration]
        sb.remove(0.0, 1e9)
        row += [sb.buffered, len(ms.active_source_buffers)]
        ms.detach()
        row.append((ms.ready_state, src.ready_state))
        states.append(row)
    assert states[0] == states[1]


def test_msesrc_inner_chain_takes_its_device(tmp_path):
    path = _camera(tmake, str(tmp_path), 2)
    src = tmake("msesrc")
    src.device = CPU
    ms = MediaSource()
    ms.attach(src)
    ms.add_source_buffer("video/x-matroska").append_buffer(
        open(path, "rb").read())
    src.start()
    assert src._inner.device == CPU
    b = src.create(1)
    assert b.data[0].device == CPU
    src.stop()


def _jpegs(tmp, n=16):
    os.makedirs(tmp, exist_ok=True)
    tparse(f"videotestsrc num-buffers={n} pattern=ball ! {VCAPS} ! jpegenc "
           f"! multifilesink location={tmp}/cam_%05d.jpg", device="cpu").run()
    return tmp


def test_splitmuxsink_fragments_match_reference(tmp_path):
    """imagesequencesrc's JPEGs into splitmuxsink (qtmux, 4 frames a
    fragment): the same four files and fragment messages."""
    jdir = _jpegs(str(tmp_path / "jpg"))
    files, msgs = {}, {}
    for tag, parse, kw in (("t", tparse, {"device": "cpu"}), ("j", jparse, {})):
        pat = str(tmp_path / f"{tag}%05d.mov")
        p = parse(f"imagesequencesrc location={jdir}/cam_%05d.jpg framerate="
                  f"25/1 ! image/jpeg ! splitmuxsink location={pat} "
                  "max-size-time=160000000", **kw)
        p.run()
        files[tag] = [open(f, "rb").read() for f in sorted(glob.glob(
            str(tmp_path / f"{tag}0*.mov")))]
        msgs[tag] = [(m.data["name"], os.path.basename(m.data["location"])[1:],
                      m.data["fragment-id"], m.data["running-time"])
                     for m in iter(p.bus.pop, None) if m.type == "element"]
    assert len(files["t"]) == 4 and files["t"] == files["j"]
    assert msgs["t"] == msgs["j"] and len(msgs["t"]) == 8


def test_splitmuxsrc_camera_chain(tmp_path):
    """splitmuxsrc ! jpegdec ! RGB at batch 8 over four fragments: equal
    in both packages and to multifilesrc of the same JPEGs, the PTS
    running on across the fragments."""
    jdir = _jpegs(str(tmp_path / "jpg"))
    tparse(f"imagesequencesrc location={jdir}/cam_%05d.jpg framerate=25/1 ! "
           f"image/jpeg ! splitmuxsink location={tmp_path}/f%05d.mov "
           "max-size-time=160000000", device="cpu").run()
    _j, _r, tpipe, out = pair(
        f"splitmuxsrc location={tmp_path}/f*.mov ! jpegdec ! {VCAPS} ! {RGB} "
        "! appsink name=out", batch=8)
    assert [(s.buffer.pts, s.buffer.batch) for s in out["out"]] == [
        (k * 160_000_000, 4) for k in range(4)]
    ref = tparse(f"multifilesrc location={jdir}/cam_%05d.jpg caps=image/jpeg,"
                 f"framerate=25/1 ! jpegdec ! {VCAPS} ! {RGB} ! appsink "
                 "name=out", batch=8, device="cpu")
    ref.run()
    assert torch.equal(
        torch.cat([s.buffer.data[0] for s in out["out"]]),
        torch.cat([s.buffer.data[0] for s in drain(ref.get_by_name("out"))]))


# -- unixfd -------------------------------------------------------------------
def _unixfd(parse_sink, parse_src, tmp, n=4, batch=2, **kw):
    """A sender pipeline (unixfdsink, a record a plane) on a thread and a
    receiver (unixfdsrc ! rawvideoparse ! RGB): the receiver's samples."""
    sock = cs.lv_socket(tmp, "u.sock")
    err = []

    def send():
        try:
            parse_sink(f"videotestsrc num-buffers={n} pattern=ball ! {VCAPS} "
                       f"! unixfdsink socket-path={sock}", **kw).run()
        except BaseException as e:          # re-raised below
            err.append(e)
    th = threading.Thread(target=send, daemon=True)
    th.start()
    p = parse_src(f"unixfdsrc socket-path={sock} timeout=5.0 ! rawvideoparse "
                  f"format=I420 width={W} height={H} ! {RGB} ! appsink "
                  "name=out", batch=batch, **kw)
    p.run()
    th.join(DEADLINE)
    assert not th.is_alive() and not err, err
    return drain(p.get_by_name("out"))


def test_unixfd_camera_chain(tmp_path):
    """The port's unixfdsrc ! rawvideoparse joins the sink's plane records
    into the frames the JAX package's does, and into the direct
    conversion's."""
    got = within(DEADLINE, _unixfd, tparse, tparse, str(tmp_path),
                 device="cpu")
    want = within(DEADLINE, _unixfd, jparse, jparse, str(tmp_path))
    assert [plain(s.buffer.data) for s in got] == \
        [plain(s.buffer.data) for s in want]
    ref = tparse(f"videotestsrc num-buffers=4 pattern=ball ! {VCAPS} ! {RGB} "
                 "! appsink name=out", batch=2, device="cpu")
    ref.run()
    assert torch.equal(
        torch.cat([s.buffer.data[0] for s in got]),
        torch.cat([s.buffer.data[0] for s in drain(ref.get_by_name("out"))]))


def test_unixfd_wire_format_matches_reference(tmp_path):
    """The JAX package's unixfdsink to the port's unixfdsrc: the records
    arrive whole (read into one buffer each)."""
    sock = cs.lv_socket(str(tmp_path), "w.sock")
    blobs = [bytes(range(256)) * 40, b"x", np.random.default_rng(1).integers(
        0, 256, 70000, dtype=np.uint8).tobytes()]

    def send():
        p = jparse(f"appsrc name=in ! application/octet-stream ! unixfdsink "
                   f"socket-path={sock}")
        for b in blobs:
            p.get_by_name("in").push_buffer(
                JBuffer(data=np.frombuffer(b, np.uint8), pts=0))
        p.get_by_name("in").end_of_stream()
        p.run()

    def receive():
        th = threading.Thread(target=send, daemon=True)
        th.start()
        p = tparse(f"unixfdsrc socket-path={sock} timeout=5.0 ! appsink "
                   "name=out", device="cpu")
        p.run()
        th.join(DEADLINE)
        return [np.asarray(s.buffer.data).tobytes()
                for s in drain(p.get_by_name("out"))]
    assert within(DEADLINE, receive) == blobs


# -- libde265dec ----------------------------------------------------------------
@pytest.fixture(scope="module")
def hevc_64x48(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hevc") / "a.hevc")
    tparse(f"videotestsrc num-buffers=6 pattern=ball ! {VCAPS} ! x265enc ! "
           f"filesink location={path}", device="cpu").run()
    return path


@pytest.mark.parametrize("batch", [1, 4])
def test_libde265dec_matches_reference(hevc_64x48, batch):
    """An x265enc stream made here through both packages' libde265dec:
    every plane equal, then on to RGB."""
    head = (f"filesrc location={hevc_64x48} blocksize=700 ! video/x-h265,"
            "stream-format=byte-stream ! libde265dec")
    _j, _r, _t, out = pair(f"{head} ! appsink name=out", batch=batch)
    assert sum(s.buffer.batch for s in out["out"]) == 6
    pair(f"{head} ! {VCAPS} ! {RGB} ! appsink name=out", batch=batch)


def test_libde265dec_committed_vector():
    """The committed 1080p stream: the JAX package's planes, as
    digests.json keeps them."""
    dig = cs.codec_vectors(cs.LV_FILES)[1]["leaves"]
    p = tparse(f"filesrc location={VECTORS}/h265_1080p.hevc ! video/x-h265,"
               "stream-format=byte-stream ! libde265dec ! appsink name=a",
               batch=4, device="cpu")
    p.run()
    frames = cs.ct_planes(drain(p.get_by_name("a")))
    assert [cs.ct_sha([np.ascontiguousarray(x).tobytes() for x in f])
            for f in frames] == dig["hevc_planes"]


def test_libde265dec_emits_on_its_device():
    e = tmake("libde265dec")
    e.device = CPU
    e.start()
    with open(os.path.join(VECTORS, "h265_1080p.hevc"), "rb") as f:
        out = e.host_process(Buffer(data=np.frombuffer(f.read(), np.uint8)))
    tail = e.host_process(None)
    got = [b for b in (out, tail) if b is not None]
    assert sum(b.batch for b in got) == 8
    assert all(isinstance(p, torch.Tensor) and p.device == CPU
               for b in got for p in b.data)


# -- the byte parsers and muxers ------------------------------------------------
def _blob(b, pts=0, **kw):
    return dict(data=np.frombuffer(b, np.uint8), pts=pts, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_midiparse_matches_reference(seed, tmp_path):
    smf = cs.lv_smf(seed)
    assert tmidi.parse_smf(smf) == jmidi.parse_smf(smf)
    assert tmidi.smf_events_with_time(smf) == jmidi.smf_events_with_time(smf)
    path = tmp_path / "a.mid"
    path.write_bytes(smf)
    pair(f"midiparse location={path} ! appsink name=out", batch=3)


def _interleaved(seed):
    rng = np.random.default_rng(seed)
    stream = b"junk\x00"
    for k in range(10):
        pkt = struct.pack(">BBHII", 0x80, 96, k, 90 * k, 7) + rng.integers(
            0, 256, int(rng.integers(1, 300)), dtype=np.uint8).tobytes()
        stream += bytes([0x24, k % 3]) + struct.pack(">H", len(pkt)) + pkt
    return stream


@pytest.mark.parametrize("channel", [0, 1, 2])
@pytest.mark.parametrize("cut", [None, 97])
def test_irtspparse_matches_reference(channel, cut):
    s = _interleaved(channel)
    pushes = [s] if cut is None else [s[k:k + cut]
                                      for k in range(0, len(s), cut)]
    pair(f"appsrc name=in caps=application/octet-stream ! irtspparse "
         f"channel-id={channel} ! appsink name=out",
         {"in": [_blob(b, k) for k, b in enumerate(pushes)]})


@pytest.mark.parametrize("pal", [False, True])
def test_dvdemux_matches_reference(pal):
    rng = np.random.default_rng(int(pal))
    frames = []
    for k in range(3):
        f = bytearray(rng.integers(0, 256, 144000 if pal else 120000,
                                   dtype=np.uint8).tobytes())
        f[0:4] = b"\x1f\x07\x00" + bytes([0x80 if pal else 0])
        frames.append(bytes(f))
    s = b"".join(frames) + b"\x1f\x07\x00\x00tail"
    pair("appsrc name=in caps=application/octet-stream ! dvdemux ! appsink "
         "name=out", {"in": [_blob(s[k:k + 100000], k)
                             for k in range(0, len(s), 100000)]})


@pytest.mark.parametrize("blocksize", [1, 1000, 65536])
def test_giostreams_match_reference(blocksize):
    payload = np.random.default_rng(blocksize).integers(
        0, 256, 5000, dtype=np.uint8).tobytes()
    out = []
    for parse, kw in ((tparse, {"device": "cpu"}), (jparse, {})):
        dst = io.BytesIO()
        p = parse(f"giostreamsrc name=s blocksize={blocksize} ! application/"
                  "octet-stream ! tee name=t ! queue ! giostreamsink name=k "
                  "t. ! queue ! appsink name=out", **kw)
        p.get_by_name("s").props["stream"] = io.BytesIO(payload)
        p.get_by_name("k").props["stream"] = dst
        p.run()
        out.append((dst.getvalue(), [plain(s.buffer.data) for s in drain(
            p.get_by_name("out"))]))
    assert out[0] == out[1] and out[0][0] == payload


def _ogm_streams(seed):
    rng = np.random.default_rng(seed)
    pay = [rng.integers(1, 255, int(rng.integers(1, 400)),
                        dtype=np.uint8).tobytes() for _ in range(5)]
    return {
        "video": [cs.lv_ogm_header(b"video\x00\x00\x00", sub, 1, struct.pack(
            "<ii", 176, 144)) for sub in (b"DIVX",)] + [
            cs.lv_ogm_packet(p, 1, k % 3 == 0) for k, p in enumerate(pay)],
        "audio": [cs.lv_ogm_header(b"audio\x00\x00\x00", b"2000", 48000,
                                   struct.pack("<hhi", 6, 4, 1000))] + [
            b"\x03comment"] + [cs.lv_ogm_packet(p, 300 + k) for k, p in
                               enumerate(pay)],
        "text": [b"\x00before the header"] + [cs.lv_ogm_header(
            b"text\x00\x00\x00\x00", b"\0\0\0\0", 1, bytes(8))] + [
            cs.lv_ogm_packet(p + b"\0\0", 40 * k) for k, p in enumerate(pay)]}


@pytest.mark.parametrize("kind", ["video", "audio", "text"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ogm_parsers_match_reference(kind, seed):
    """Packets one at a time and all in one buffer: outputs, timestamps,
    flags and caps equal."""
    pk = _ogm_streams(seed)[kind]
    rows = []
    for make, buf in ((tmake, Buffer), (jmake, JBuffer)):
        e = make(f"ogm{kind}parse")
        e.device = CPU
        e.start()
        one = [e.host_process(buf(data=np.frombuffer(p, np.uint8)))
               for p in pk]
        e.start()
        whole = e.host_process(buf(data=[np.frombuffer(p, np.uint8)
                                         for p in pk], batch=len(pk)))
        rows.append([str(e._caps), [None if b is None else (
            b.pts, b.batch, int(b.flags), plain(b.data))
            for b in one + [whole]]])
    assert rows[0] == rows[1]


def test_ogm_parser_in_a_launch_string_is_a_reference_fault():
    """An OGM parser's caps come from its header packet; at negotiation it
    has none and answers ANY, which no downstream caps narrow: both
    packages fail ``cannot fixate ANY caps`` (JAX package
    ``elements/ogm.py:60-66``; ROADMAP.md section 3)."""
    desc = ("appsrc name=in caps=application/x-ogm-video ! ogmvideoparse ! "
            "video/mpeg,mpegversion=4 ! appsink name=out")
    for parse, kw in ((tparse, {"device": "cpu"}), (jparse, {})):
        with pytest.raises(ValueError, match="cannot fixate ANY caps"):
            parse(desc, **kw).run()


@pytest.mark.parametrize("seed", [0, 1])
def test_oggaviparse_matches_reference(seed):
    rng = np.random.default_rng(seed)
    h1 = b"\x01vorbis" + rng.integers(0, 256, 250 + 300 * seed,
                                      dtype=np.uint8).tobytes()
    h2, h3 = b"\x03vorbis" + b"c" * 40, b"\x05vorbis" + b"b" * 90
    lace = bytes([255] * (len(h1) // 255) + [len(h1) % 255, len(h2)])
    pair("appsrc name=in caps=application/x-ogg-avi ! oggaviparse ! appsink "
         "name=out", {"in": [_blob(bytes([2]) + lace + h1 + h2 + h3),
                             _blob(b"packet one", 1), _blob(b"two", 2)]})


@pytest.mark.parametrize("head", ["plain", "xing", "info"])
def test_xingmux_matches_reference(head):
    """The committed MP3 (and a stream that starts with a Xing or Info
    frame, dropped) through mpegaudioparse ! xingmux."""
    from gstreamer_tpu_torch.elements.xingmux import generate_xing_frame
    with open(os.path.join(VECTORS, "mp3_10s.mp3"), "rb") as f:
        data = f.read()
    if head != "plain":
        frame = bytearray(generate_xing_frame(data[:4], 9, 999, None))
        if head == "info":
            off = frame.index(b"Xing")
            frame[off:off + 4] = b"Info"
        data = bytes(frame) + data
    pair("appsrc name=in caps=application/octet-stream ! mpegaudioparse ! "
         "xingmux ! appsink name=out",
         {"in": [_blob(data[k:k + 40000], k)
                 for k in range(0, len(data), 40000)]})


@pytest.mark.parametrize("key", [cs.LV_KEY, cs.LV_KEY * 2])
@pytest.mark.parametrize("serialize", [True, False])
def test_aes_matches_reference(key, serialize):
    data = np.random.default_rng(5).integers(0, 256, 4099, dtype=np.uint8)
    iv = f"iv={cs.LV_IV} serialize-iv={str(serialize).lower()}"
    for tail in (f"aesenc key={key} {iv}",
                 f"aesenc key={key} {iv} ! aesdec key={key} {iv}"):
        _j, ref, _t, out = pair(
            f"appsrc name=in caps=application/octet-stream ! {tail} ! "
            "appsink name=out", {"in": [dict(data=data, pts=0),
                                         dict(data=data[:17], pts=1)]})
    assert [np.asarray(s.buffer.data).tobytes() for s in out["out"]] == \
        [data.tobytes(), data[:17].tobytes()]


def test_aes_wrong_key_raises_alike():
    desc = (f"appsrc name=in caps=application/octet-stream ! aesenc "
            f"key={cs.LV_KEY} iv={cs.LV_IV} ! aesdec key={'ff' * 16} ! "
            "appsink name=out")
    for parse, buf, kw in ((tparse, Buffer, {"device": "cpu"}),
                           (jparse, JBuffer, {})):
        p = parse(desc, **kw)
        p.get_by_name("in").push_buffer(buf(data=np.zeros(64, np.uint8)))
        p.get_by_name("in").end_of_stream()
        with pytest.raises(ValueError, match="aes: final failed"):
            p.run()


@pytest.mark.parametrize("block", [1, 9])
def test_bz2_matches_reference(block):
    data = (b"leaves " * 3000) + np.random.default_rng(block).integers(
        0, 256, 5000, dtype=np.uint8).tobytes()
    pushes = {"in": [_blob(data[k:k + 7000], k)
                     for k in range(0, len(data), 7000)]}
    pair(f"appsrc name=in caps=application/octet-stream ! bz2enc "
         f"block-size={block} ! appsink name=out", pushes)
    _j, _r, _t, out = pair(
        f"appsrc name=in caps=application/octet-stream ! bz2enc block-size="
        f"{block} ! bz2dec ! application/octet-stream ! appsink name=out",
        pushes)
    assert b"".join(np.asarray(s.buffer.data).tobytes()
                    for s in out["out"]) == data


@pytest.mark.parametrize("props", [
    "", "freq=697 freq2=1209 num-buffers=4",
    "freq=350 freq2=440 off-time=0 volume=-12 samplesperbuffer=800",
    "on-time=300 off-time=200 num-buffers=6"])
def test_tonegeneratesrc_matches_reference(props):
    pair(f"tonegeneratesrc {props} ! appsink name=out")


def test_chromaprint_matches_reference():
    from gstreamer_tpu_torch.elements import chromaprint
    if chromaprint._LIB is None:
        pytest.skip("libchromaprint missing")
    _j, _r, tpipe, _o = pair(
        "audiotestsrc num-buffers=50 samplesperbuffer=4410 wave=ticks "
        "volume=0.6 ! audio/x-raw,format=S16LE,rate=44100,channels=2 ! "
        "chromaprint name=cp ! appsink name=out")
    assert tpipe.get_by_name("cp").props["fingerprint"]


@pytest.mark.parametrize("seed", [0, 1])
def test_gmedec_matches_reference(seed):
    from gstreamer_tpu_torch.elements import ext_music
    if ext_music._get_gme() is None:
        pytest.skip("libgme missing")
    pair("appsrc name=in caps=audio/x-vgm ! gmedec duration=0.5 ! appsink "
         "name=out", {"in": [_blob(cs.lv_vgm(seed))]})


@pytest.mark.parametrize("which", ["minimal", "seeded"])
def test_openmptdec_matches_reference(which):
    from gstreamer_tpu_torch.elements import ext_music
    if ext_music._get_mpt() is None:
        pytest.skip("libopenmpt missing")
    mod = (test_misc_elements2._minimal_mod() if which == "minimal"
           else cs.lv_mod(3))
    pair("appsrc name=in caps=audio/x-mod ! openmptdec ! appsink name=out",
         {"in": [_blob(mod[:500]), _blob(mod[500:], 1)]})


def _shout(parse, buf, kw):
    srv = cs.LvIcecast()
    p = parse(f"appsrc name=in caps=audio/mpeg ! shout2send ip=127.0.0.1 "
              f"port={srv.port} mount=radio.mp3 streamname=Leaves "
              "description=seeded genre=test public=true", **kw)
    for k in range(3):
        p.get_by_name("in").push_buffer(buf(data=np.full(999, k, np.uint8)))
    p.get_by_name("in").end_of_stream()
    p.run()
    srv.join()
    return srv.lines, srv.payload


def test_shout2send_matches_reference():
    """Both packages' shout2send to a loopback listener: the same request
    and the same bytes."""
    t = within(DEADLINE, _shout, tparse, Buffer, {"device": "cpu"})
    j = within(DEADLINE, _shout, jparse, JBuffer, {})
    assert t == j and len(t[1]) == 3 * 999
    assert t[0][0] == "PUT /radio.mp3 HTTP/1.1"


# -- phase 25's host items: the committed digests --------------------------------
ROWS = cs.lv_rows({n: os.path.join(VECTORS, n) for n in cs.LV_FILES})


@pytest.mark.parametrize("row", ROWS, ids=["/".join(r[0]) for r in ROWS])
def test_lv_rows_match_the_committed_digests(row):
    """Each run of chip_smoke.py's lv_rows on the port's CPU path gives the
    digest the card's run is held to."""
    names, _lib, fn = row
    dig = cs.codec_vectors(cs.LV_FILES)[1]["leaves"]["rows"]
    with tempfile.TemporaryDirectory() as tmp:
        got = within(DEADLINE, fn, CPU, tmp)
    assert cs.lv_digest(got) == dig["/".join(names)]
