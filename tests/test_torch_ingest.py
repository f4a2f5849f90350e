"""Ingest from disk in the torch port against the JAX package.

filesrc (y4m typefind, raw video and audio through ``caps=``, the native
mmap + prefetch reader and the Python reader), the device-side plane split
of the six splittable formats, ``Pipeline.compile(prefetch=True)``,
``seek``, the five pipeline queries, rawvideoparse / rawaudioparse,
multifilesrc, multifilesink, y4menc, filesink and the small sources and
sinks.  Inputs are written from a seed with numpy; every launch string runs
in both packages (the JAX side with the audio stack imported, as launch
strings do) and the samples' bytes, pts, offsets, batches and tick counts
must be equal.  Tolerance 0.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import gstreamer_tpu.audio  # noqa: F401  (x64 on, as in every launch string)
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse
from gstreamer_tpu.core.query import Query as JQuery
from gstreamer_tpu.video import format as jf

import gstreamer_tpu_torch
from gstreamer_tpu_torch import parse_launch as tparse
from gstreamer_tpu_torch.core.buffer import Buffer as TBuffer
from gstreamer_tpu_torch.core.query import Query, QueryType
from gstreamer_tpu_torch.native import io as native_io

W, H = 32, 24
Y4M_TAGS = {"420jpeg": "I420", "420mpeg2": "I420", "422": "Y42B",
            "444": "Y444", "mono": "GRAY8"}
SPLITTABLE = ("I420", "YV12", "Y42B", "Y444", "GRAY8", "NV12")
CONVERT = ("videoconvertscale add-borders=false ! "
           "video/x-raw,format=RGB,width=16,height=12")


def write_y4m(path, tag, frames, w=W, h=H, fps="30:1", seed=0):
    """A y4m of `frames` random frames; returns their bytes (frames, n)."""
    fmt = jf.format_info(Y4M_TAGS[tag])
    n = jf.frame_size(fmt, w, h)
    raw = np.random.default_rng(seed).integers(0, 256, (frames, n),
                                               dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps} Ip A1:1 C{tag}\n".encode())
        for k in range(frames):
            f.write(b"FRAME\n" + raw[k].tobytes())
    return raw


def write_raw(path, fmt_name, frames, w=W, h=H, seed=0):
    n = jf.frame_size(jf.format_info(fmt_name), w, h)
    raw = np.random.default_rng(seed).integers(0, 256, (frames, n),
                                               dtype=np.uint8)
    Path(path).write_bytes(raw.tobytes())
    return raw


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(data):
    if isinstance(data, (tuple, list)):
        return [leaf for x in data for leaf in _leaves(x)]
    return [_np(data)]


def sample_list(sink):
    out = []
    while (s := sink.pull_sample()) is not None:
        b = s.buffer
        out.append((b.pts, b.offset, b.batch, b.duration, _leaves(b.data)))
    return out


def run(pipe, batch=4, prefetch=False, seek_to=None, first_ticks=None):
    """compile + play + tick to EOS; with `seek_to`, seek there after
    `first_ticks` ticks.  Returns (samples, ticks, pipe)."""
    pipe.compile(batch=batch, prefetch=prefetch)
    pipe.set_state("playing")
    ticks = 0
    if seek_to is not None:
        for _ in range(first_ticks or 0):
            assert pipe.tick()
            ticks += 1
        assert pipe.seek(seek_to)
    while pipe.tick():
        ticks += 1
    return sample_list(pipe.get_by_name("out")), ticks, pipe


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:4] == y[:4]
        assert len(x[4]) == len(y[4])
        for u, v in zip(x[4], y[4]):
            # the same kind and width; the reference's host elements keep
            # a big-endian numpy view, the port's samples are tensors
            assert u.dtype.newbyteorder("=") == v.dtype.newbyteorder("=")
            assert u.shape == v.shape and np.array_equal(u, v)


def both(desc, **kw):
    """The same launch string through both packages (the port on the
    CPU): (JAX samples, ticks), (port samples, ticks)."""
    ref, jt, _ = run(jparse(desc), **kw)
    own, tt, _ = run(tparse(desc, device="cpu"), **kw)
    assert jt == tt
    assert_same(ref, own)
    return own, tt


@pytest.fixture
def python_reader(monkeypatch):
    """filesrc's Python reader (what runs without g++)."""
    monkeypatch.setattr(native_io, "get_lib", lambda: None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned staging and the copy stream")


# -- filesrc ---------------------------------------------------------------

@pytest.mark.parametrize("tag", list(Y4M_TAGS))
def test_filesrc_y4m_matches_reference(tmp_path, tag):
    path = tmp_path / "a.y4m"
    raw = write_y4m(path, tag, 10, seed=len(tag))
    own, ticks = both(f"filesrc location={path} ! appsink name=out")
    assert ticks == 3 and [s[2] for s in own] == [4, 4, 2]
    got = np.concatenate([np.concatenate([p.reshape(p.shape[0], -1)
                                          for p in s[4]], 1) for s in own])
    assert np.array_equal(got, raw)     # planes in storage order: I420


@pytest.mark.parametrize("tag", ["420jpeg", "444", "mono"])
def test_filesrc_ingest_string_matches_reference(tmp_path, tag):
    path = tmp_path / "a.y4m"
    write_y4m(path, tag, 7, seed=3)
    both(f"filesrc location={path} ! {CONVERT} ! appsink name=out")


def test_native_and_python_readers_agree(tmp_path, monkeypatch):
    path = tmp_path / "a.y4m"
    write_y4m(path, "420jpeg", 9, seed=5)
    desc = f"filesrc name=src location={path} ! {CONVERT} ! appsink name=out"
    native, _, p = run(tparse(desc, device="cpu"), batch=4)
    assert p.get_by_name("src").native_batches == 3
    monkeypatch.setattr(native_io, "get_lib", lambda: None)
    plain, _, p = run(tparse(desc, device="cpu"), batch=4)
    assert p.get_by_name("src").native_batches == 0
    assert_same(native, plain)


@pytest.mark.parametrize("fmt", SPLITTABLE + ("YUY2", "RGB"))
def test_filesrc_raw_caps_matches_reference(tmp_path, fmt):
    path = tmp_path / "a.raw"
    write_raw(path, fmt, 6, seed=len(fmt))
    caps = f"video/x-raw,format={fmt},width={W},height={H},framerate=25/1"
    own, ticks = both(f"filesrc location={path} caps={caps} ! "
                      "appsink name=out", batch=4)
    assert ticks == 2
    # the splittable formats are split on the device as views of one
    # contiguous tick; the others arrive as planes from from_bytes
    src = tparse(f"filesrc location={path} caps={caps} ! appsink name=out",
                 device="cpu")
    src.compile(batch=4)
    assert (src._fns[src._order[0]] is not None) == (fmt in SPLITTABLE)


def test_filesrc_raw_audio_matches_reference(tmp_path):
    path = tmp_path / "a.raw"
    samples = np.random.default_rng(4).integers(-32768, 32767, (9000, 2),
                                                dtype=np.int16)
    path.write_bytes(samples.astype("<i2").tobytes())
    caps = "audio/x-raw,format=S16LE,rate=48000,channels=2,layout=interleaved"
    own, ticks = both(f"filesrc location={path} caps={caps} ! "
                      "appsink name=out", batch=1)
    assert np.array_equal(np.concatenate([s[4][0] for s in own]), samples)


def test_split_planes_are_views_of_one_staged_tick(tmp_path):
    path = tmp_path / "a.y4m"
    write_y4m(path, "420jpeg", 4)
    p = tparse(f"filesrc name=src location={path} ! appsink name=out",
               device="cpu")
    p.compile(batch=4)
    p.set_state("playing")
    buf = p.get_by_name("src").create(4)
    assert isinstance(buf.data, np.ndarray) and buf.data.shape[0] == 4
    raw = torch.from_numpy(buf.data)
    y, u, v = p._fns[p.get_by_name("src")](raw)
    assert all(t.data_ptr() >= raw.data_ptr() and t._base is raw
               for t in (y, u, v))


def test_python_reader_matches_reference(tmp_path, python_reader):
    path = tmp_path / "a.y4m"
    write_y4m(path, "422", 6, seed=8)
    both(f"filesrc location={path} ! appsink name=out", batch=4)


# -- prefetch --------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3, 4])
def test_prefetch_equals_no_prefetch(tmp_path, batch):
    path = tmp_path / "a.y4m"
    write_y4m(path, "420jpeg", 10, seed=batch)
    desc = f"filesrc location={path} ! {CONVERT} ! appsink name=out"
    off, t_off, _ = run(tparse(desc, device="cpu"), batch=batch)
    on, t_on, p = run(tparse(desc, device="cpu"), batch=batch, prefetch=True)
    assert t_on == t_off == -(-10 // batch)
    assert_same(off, on)
    ref, t_ref, _ = run(jparse(desc), batch=batch, prefetch=True)
    assert t_ref == t_on
    assert_same(ref, on)


def _appsrc_pipe(pkg):
    return pkg("appsrc name=in caps=video/x-raw,format=I420,width=64,"
               "height=48,framerate=30/1 ! videoconvert ! videoscale ! "
               "video/x-raw,format=RGB,width=32,height=24 ! appsink name=out",
               **({} if pkg is jparse else {"device": "cpu"}))


def _push_with_caps_switch(p, buffer_cls):
    src = p.get_by_name("in")
    rng = np.random.default_rng(9)
    src.push_buffer(buffer_cls(data=(
        rng.integers(0, 256, (2, 48, 64), np.uint8),
        rng.integers(0, 256, (2, 24, 32), np.uint8),
        rng.integers(0, 256, (2, 24, 32), np.uint8)), pts=0, batch=2))
    src.set_caps("video/x-raw,format=I420,width=128,height=96,"
                 "framerate=30/1")
    src.push_buffer(buffer_cls(data=(
        rng.integers(0, 256, (2, 96, 128), np.uint8),
        rng.integers(0, 256, (2, 48, 64), np.uint8),
        rng.integers(0, 256, (2, 48, 64), np.uint8)), pts=1, batch=2))
    src.end_of_stream()


@pytest.mark.parametrize("prefetch", [False, True])
def test_caps_switch_mid_stream_matches_reference(prefetch):
    ref_p, own_p = _appsrc_pipe(jparse), _appsrc_pipe(tparse)
    _push_with_caps_switch(ref_p, JBuffer)
    _push_with_caps_switch(own_p, TBuffer)
    ref, jt, _ = run(ref_p, batch=2, prefetch=prefetch)
    own, tt, p = run(own_p, batch=2, prefetch=prefetch)
    assert jt == tt == 2 and len(own) == 2
    assert_same(ref, own)
    assert all(x.shape[-2:] == (24, 32) for s in own for x in s[4])
    assert p.get_by_name("in").props["caps"][0]["width"] == 128


def test_location_switch_renegotiates_under_prefetch(tmp_path):
    a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
    write_y4m(a, "420jpeg", 2, 64, 32, seed=1)
    write_y4m(b, "420jpeg", 2, 128, 64, seed=2)
    outs = []
    for prefetch in (False, True):
        p = tparse(f"filesrc name=f location={a} ! {CONVERT} ! "
                   "appsink name=out", device="cpu")
        p.compile(batch=2, prefetch=prefetch)
        p.set_state("playing")
        assert p.tick()
        p.get_by_name("f").set_property("location", str(b))
        assert p.tick()
        outs.append(sample_list(p.get_by_name("out")))
    assert_same(outs[0], outs[1])
    assert len(outs[0]) == 2


# -- seek and queries ---------------------------------------------------------

@pytest.mark.parametrize("seek_ns,first_ticks", [
    (0, 2), (5 * 10**9 // 30, 1), (7 * 10**9 // 30, 0), (3 * 10**9 // 30, 3)])
def test_seek_matches_reference(tmp_path, seek_ns, first_ticks):
    path = tmp_path / "a.y4m"
    write_y4m(path, "420jpeg", 10, seed=11)
    desc = f"filesrc location={path} ! {CONVERT} ! appsink name=out"
    own, _ = both(desc, batch=3, seek_to=seek_ns, first_ticks=first_ticks)
    frame = seek_ns * 30 // 10**9
    assert own[first_ticks][0] == frame * 10**9 // 30
    assert own[first_ticks][1] == frame
    assert sum(s[2] for s in own[first_ticks:]) == 10 - frame


@pytest.mark.parametrize("first_ticks", [1, 2])
def test_seek_under_prefetch_drops_the_staged_tick(tmp_path, first_ticks):
    """A flushing seek after a prefetched tick: the port drops the tick
    staged from the old position and equals the run without prefetch (the
    JAX package emits the stale tick first: ROADMAP.md section 3)."""
    path = tmp_path / "a.y4m"
    write_y4m(path, "420jpeg", 10, seed=12)
    desc = f"filesrc location={path} ! {CONVERT} ! appsink name=out"
    kw = dict(batch=3, seek_to=0, first_ticks=first_ticks)
    off, _, _ = run(tparse(desc, device="cpu"), **kw)
    on, _, _ = run(tparse(desc, device="cpu"), prefetch=True, **kw)
    assert_same(off, on)
    ref_off, _, _ = run(jparse(desc), **kw)
    assert_same(ref_off, on)
    ref_on, _, _ = run(jparse(desc), prefetch=True, **kw)
    stale = ref_on[first_ticks]
    assert stale[0] == first_ticks * 3 * 10**9 // 30     # not the seek's 0
    assert len(ref_on) == len(on) + 1


def _queries(p):
    out = {"position": p.query_position(), "duration": p.query_duration(),
           "latency": p.query_latency()}
    for qt in (QueryType.SEEKING, QueryType.ALLOCATION):
        q = (Query if p.__module__.startswith("gstreamer_tpu_torch")
             else JQuery)(qt)
        assert p.query(q)
        out[qt] = q.result
    return out


@pytest.mark.parametrize("prefetch", [False, True])
def test_queries_match_reference(tmp_path, prefetch):
    path = tmp_path / "a.y4m"
    write_y4m(path, "420jpeg", 10, fps="25:1", seed=13)
    desc = f"filesrc location={path} ! {CONVERT} ! appsink name=out"
    res = []
    for pipe in (jparse(desc), tparse(desc, device="cpu")):
        pipe.compile(batch=4, prefetch=prefetch)
        pipe.set_state("playing")
        before = _queries(pipe)
        assert pipe.tick()
        mid = _queries(pipe)
        while pipe.tick():
            pass
        res.append((before, mid, _queries(pipe)))
    assert res[0] == res[1]
    before, mid, end = res[1]
    assert before["duration"] == 10 * 10**9 // 25
    assert (before["position"], mid["position"], end["position"]) == (
        0, 4 * 10**9 // 25, 10 * 10**9 // 25)
    assert end["latency"]["min-latency"] == 4 * 10**9 // 25
    assert end[QueryType.SEEKING]["seekable"] is True
    assert end[QueryType.ALLOCATION] == {
        "device-staging": True, "donate-inputs": False,
        "prefetch": prefetch, "batch": 4}


def test_allocation_reports_donation():
    p = _appsrc_pipe(tparse)
    p.compile(batch=2, donate_inputs=True, prefetch=True)
    q = Query(QueryType.ALLOCATION)
    assert p.query(q)
    assert q.result["donate-inputs"] and q.result["prefetch"]
    assert q.result["device-staging"]


def test_raw_audio_duration_and_seek(tmp_path):
    path = tmp_path / "a.raw"
    samples = np.random.default_rng(4).integers(-32768, 32767, (9600, 2),
                                                dtype=np.int16)
    path.write_bytes(samples.astype("<i2").tobytes())
    caps = "audio/x-raw,format=S16LE,rate=48000,channels=2,layout=interleaved"
    desc = f"filesrc location={path} caps={caps} ! appsink name=out"
    own, _ = both(desc, batch=1, seek_to=100_000_000, first_ticks=0)
    assert np.array_equal(np.concatenate([s[4][0] for s in own]),
                          samples[4800:])
    p = tparse(desc, device="cpu")
    p.set_state("playing")
    assert p.query_duration() == 200_000_000


# -- rawparse ----------------------------------------------------------------

@pytest.mark.parametrize("fmt,blocksize", [("I420", 100), ("NV12", 1152),
                                           ("YUY2", 333), ("RGB", 4096)])
def test_rawvideoparse_matches_reference(tmp_path, fmt, blocksize):
    path = tmp_path / "a.raw"
    raw = write_raw(path, fmt, 3, 16, 8, seed=len(fmt))
    path.write_bytes(raw.tobytes() + bytes(7))       # trailing partial frame
    own, _ = both(f"filesrc location={path} blocksize={blocksize} ! "
                  f"rawvideoparse width=16 height=8 format={fmt} "
                  "framerate=10/1 ! appsink name=out", batch=1)
    assert sum(s[2] for s in own) == 3
    assert [s[0] for s in own][0] == 0


@pytest.mark.parametrize("fmt", ["S16LE", "S16BE", "S24LE", "F32LE", "U8"])
def test_rawaudioparse_matches_reference(tmp_path, fmt):
    path = tmp_path / "a.raw"
    width = {"S16LE": 2, "S16BE": 2, "S24LE": 3, "F32LE": 4, "U8": 1}[fmt]
    raw = np.random.default_rng(6).integers(0, 256, 2 * width * 301,
                                            dtype=np.uint8)
    if fmt == "F32LE":
        raw = np.random.default_rng(6).standard_normal(602).astype(
            "<f4").view(np.uint8)
    path.write_bytes(raw.tobytes())
    own, _ = both(f"filesrc location={path} blocksize=64 ! rawaudioparse "
                  f"pcm-format={fmt} sample-rate=8000 num-channels=2 ! "
                  "appsink name=out", batch=1)
    assert sum(s[4][0].shape[0] for s in own) == 301


# -- sinks and multi-file sources --------------------------------------------

def test_y4menc_writes_reference_bytes(tmp_path):
    for pkg, name in ((jparse, "j.y4m"), (tparse, "t.y4m")):
        kw = {} if pkg is jparse else {"device": "cpu"}
        pkg(f"videotestsrc num-buffers=5 pattern=ball ! video/x-raw,"
            f"format=I420,width={W},height={H},framerate=30/1 ! y4menc "
            f"location={tmp_path / name}", batch=2, **kw).run()
    data = (tmp_path / "t.y4m").read_bytes()
    assert data == (tmp_path / "j.y4m").read_bytes()
    assert data.startswith(b"YUV4MPEG2 C420jpeg W32 H24 Ip F30:1 A1:1\n")
    # and reads back through filesrc
    own, ticks = both(f"filesrc location={tmp_path / 't.y4m'} ! "
                      "appsink name=out", batch=2)
    assert ticks == 3


@pytest.mark.parametrize("fmt", ["I420", "YUY2", "v210"])
def test_filesink_round_trip_matches_reference(tmp_path, fmt):
    caps = f"video/x-raw,format={fmt},width=48,height=8,framerate=30/1"
    for pkg, name in ((jparse, "j.raw"), (tparse, "t.raw")):
        kw = {} if pkg is jparse else {"device": "cpu"}
        pkg(f"videotestsrc num-buffers=4 pattern=smpte ! {caps} ! "
            f"filesink location={tmp_path / name}", batch=2, **kw).run()
    data = (tmp_path / "t.raw").read_bytes()
    assert data == (tmp_path / "j.raw").read_bytes()
    assert len(data) == 4 * jf.frame_size(jf.format_info(fmt), 48, 8)
    both(f"filesrc location={tmp_path / 't.raw'} caps={caps} ! "
         "appsink name=out", batch=2)


def test_audio_filesink_matches_reference(tmp_path):
    for pkg, name in ((jparse, "j.raw"), (tparse, "t.raw")):
        kw = {} if pkg is jparse else {"device": "cpu"}
        pkg("audiotestsrc num-buffers=3 samplesperbuffer=480 ! "
            "audio/x-raw,format=S24LE,rate=48000,channels=2 ! "
            f"filesink location={tmp_path / name}", **kw).run()
    data = (tmp_path / "t.raw").read_bytes()
    assert data == (tmp_path / "j.raw").read_bytes() and len(data) == 8640


def test_multifilesink_and_multifilesrc_round_trip(tmp_path):
    caps = f"video/x-raw,format=I420,width={W},height={H},framerate=30/1"
    for pkg, d in ((jparse, "j"), (tparse, "t")):
        (tmp_path / d).mkdir()
        kw = {} if pkg is jparse else {"device": "cpu"}
        pkg(f"videotestsrc num-buffers=5 pattern=snow ! {caps} ! "
            f"multifilesink location={tmp_path / d}/f%03d.raw", batch=2,
            **kw).run()
    for k in range(5):
        assert (tmp_path / "t" / f"f{k:03d}.raw").read_bytes() == \
            (tmp_path / "j" / f"f{k:03d}.raw").read_bytes()
    own, ticks = both(f"multifilesrc location={tmp_path}/t/f%03d.raw "
                      f"caps={caps} ! appsink name=out", batch=2)
    assert ticks == 3 and [s[2] for s in own] == [2, 2, 1]


def test_multifilesrc_blobs_at_batch_one_match_reference(tmp_path):
    blobs = [np.random.default_rng(k).integers(0, 256, 50 + k,
                                               dtype=np.uint8).tobytes()
             for k in range(3)]
    for k, b in enumerate(blobs):
        (tmp_path / f"b{k}.bin").write_bytes(b)
    own, ticks = both(f"multifilesrc location={tmp_path}/b%d.bin ! "
                      "appsink name=out", batch=1)
    assert ticks == 3 and [s[4][0].tobytes() for s in own] == blobs


def test_multifilesrc_blobs_at_batch_above_one_are_every_file(tmp_path):
    """The JAX multifilesrc reads n files and emits only the first
    (ROADMAP.md section 3); the port emits all n, held to the files."""
    blobs = [np.random.default_rng(k).integers(0, 256, 40 + k,
                                               dtype=np.uint8).tobytes()
             for k in range(5)]
    for k, b in enumerate(blobs):
        (tmp_path / f"b{k}.bin").write_bytes(b)
    own, ticks, _ = run(tparse(f"multifilesrc location={tmp_path}/b%d.bin "
                               "! appsink name=out", device="cpu"), batch=2)
    assert ticks == 3 and [s[2] for s in own] == [2, 2, 1]
    assert [leaf.tobytes() for s in own for leaf in s[4]] == blobs
    ref, _, _ = run(jparse(f"multifilesrc location={tmp_path}/b%d.bin ! "
                           "appsink name=out"), batch=2)
    assert [s[4][0].tobytes() for s in ref] == blobs[0::2]


def test_multifilesrc_stop_index(tmp_path):
    for k in range(6):
        (tmp_path / f"b{k}.bin").write_bytes(bytes([k]) * 4)
    own, ticks = both(f"multifilesrc location={tmp_path}/b%d.bin index=2 "
                      "stop-index=4 ! appsink name=out", batch=1)
    assert [s[4][0][0] for s in own] == [2, 3, 4]


def test_dataurisrc_fdsrc_fdsink_and_gio(tmp_path):
    own, _ = both("dataurisrc uri=data:;base64,AAECAwQ= ! appsink name=out")
    assert own[0][4][0].tolist() == [0, 1, 2, 3, 4]
    (tmp_path / "x.bin").write_bytes(bytes(range(10)))
    own, _ = both(f"giosrc location=file://{tmp_path}/x.bin blocksize=4 ! "
                  "appsink name=out", batch=1)
    assert [s[4][0].tolist() for s in own] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                                [8, 9]]
    with pytest.raises(ValueError):
        tparse("giosrc location=data:,x ! fakesink", device="cpu")
    r, w = os.pipe()
    os.write(w, bytes(range(6)))
    os.close(w)
    try:
        got, _, _ = run(tparse(f"fdsrc fd={r} blocksize=4 ! appsink name=out",
                               device="cpu"), batch=1)
    finally:
        os.close(r)
    assert [s[4][0].tolist() for s in got] == [[0, 1, 2, 3], [4, 5]]
    path = tmp_path / "out.bin"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT)
    try:
        tparse(f"dataurisrc uri=data:,hello ! fdsink fd={fd}",
               device="cpu").run()
        tparse(f"dataurisrc uri=data:,world ! giosink "
               f"location=file://{tmp_path}/g.bin", device="cpu").run()
    finally:
        os.close(fd)
    assert path.read_bytes() == b"hello"
    assert (tmp_path / "g.bin").read_bytes() == b"world"


# -- the card: pinned staging and the copy stream ----------------------------

def test_prefetch_on_the_card_equals_the_cpu(tmp_path, cuda):
    path = tmp_path / "a.y4m"
    write_y4m(path, "420jpeg", 10, seed=21)
    desc = f"filesrc location={path} ! {CONVERT} ! appsink name=out"
    cpu, _, _ = run(tparse(desc, device="cpu"), batch=4)
    for prefetch in (False, True):
        card, _, _ = run(tparse(desc), batch=4, prefetch=prefetch)
        assert_same(cpu, card)


# -- imports --------------------------------------------------------------

NEW_MODULES = ("native/__init__.py", "native/_build.py", "native/io.py",
               "native/jpeg.py", "codecs/__init__.py", "codecs/jpeg.py",
               "codecs/png.py", "core/adapter.py", "core/staging.py",
               "elements/file_elements.py", "elements/rawparse.py",
               "elements/image_codecs.py")


def test_new_modules_import_no_jax_and_no_reference_package():
    pkg = Path(gstreamer_tpu_torch.__file__).parent
    files = [pkg / m for m in NEW_MODULES] + [
        pkg.parent / "examples" / "ml_ingest_torch.py"]
    for path in files:
        assert path.exists(), path
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for mod in mods:
                assert mod.split(".")[0] not in (
                    "jax", "jaxlib", "gstreamer_tpu"), f"{path}: {mod}"


def test_native_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    from gstreamer_tpu_torch.native import _build
    src = tmp_path / "native"
    src.mkdir()
    (src / "t.cpp").write_text('extern "C" int f() { return 7; }\n')
    monkeypatch.setattr(_build, "NATIVE_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    first = _build.library_path("t")
    if _build.build("t") is None:
        pytest.skip("g++ is not installed")
    assert first.exists() and not list((tmp_path / "build").glob("*.tmp"))
    assert _build.load("t").f() == 7
    (src / "t.cpp").write_text('extern "C" int f() { return 8; }\n')
    assert _build.library_path("t") != first
    (src / "bad.cpp").write_text("not c++\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        _build.build("bad")
