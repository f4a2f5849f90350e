"""The port's playback autoplugging against the JAX package: typefind,
uridecodebin and decodebin (single-stream routes, a seek), playbin's
``build_pipeline``, and ``_decoder_for_caps``.

The same seeded files go through both packages (the port on the CPU);
samples, caps and bus messages equal, tolerance 0.  Every factory the JAX
package autoplugs is ported; where a libav decoder is not registered (the
system libavcodec lacks its codec), the JAX package passes the coded stream
on undecoded and the port raises ``RuntimeError`` naming that codec: each
case has a test.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse
from gstreamer_tpu.elements import playback as jpb

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.core.element import factory_exists
from gstreamer_tpu_torch.elements import playback as tpb

from test_torch_captions import _run, drain, pair, sample_rows
from test_torch_containers import (H264, apushes, asrc, blob_pushes,
                                   coded_src, nals, vpushes, vsrc)
from test_torch_multistream import tick_pair, write_jax

tparse = gstreamer_tpu_torch.parse_launch


@pytest.fixture
def media(tmp_path):
    """Seeded files of every raw route: y4m, wav, aiff, and A/V mkv, avi,
    mov."""
    files = {}
    v, a = vsrc("I420"), asrc()
    for key, desc, pushes in (
            ("y4m", "y4menc location={p}", {"v": vpushes("I420")}),
            ("wav", "wavenc location={p}", {"a": apushes(800)}),
            ("aiff", "aiffmux location={p}", {"a": apushes(800)}),
            ("mkv", None, {"v": vpushes("I420"), "a": apushes(800)}),
            ("avi", None, {"v": vpushes("I420"), "a": apushes(800)}),
            ("mov", None, {"v": vpushes("UYVY"), "a": apushes(800)})):
        path = tmp_path / f"f.{key}"
        files[key] = path
        if desc is not None:
            src = v if "v" in pushes else (asrc("S16BE") if key == "aiff"
                                           else a)
            write_jax(f"{src} ! " + desc.format(p=path), pushes)
            continue
        mux = {"mkv": "matroskamux", "avi": "avimux", "mov": "qtmux"}[key]
        desc = f"{mux} name=m location={path} ! fakesink"
        if "v" in pushes:
            desc += f" {vsrc('UYVY' if key == 'mov' else 'I420')} ! m.video_0"
        desc += f" {a} ! m.audio_0"
        write_jax(desc, pushes)
    return files


def test_typefind_element():
    """The typefind element sniffs the first buffer's bytes (a tensor in
    the port) and fires its callback once."""
    head = np.frombuffer(b"\x1a\x45\xdf\xa3 matroska here" + bytes(40),
                         np.uint8)
    pushes = {"in": [dict(data=head.copy(), batch=1)] * 2}
    found = {}
    for key, parse, B, kw in (("j", jparse, JBuffer, {}),
                              ("t", tparse, Buffer, {"device": "cpu"})):
        def setup(pipe, key=key):
            tf = next(e for e in pipe.iterate_elements()
                      if e.FACTORY == "typefind")
            tf.have_type_cb = lambda caps, prob: found.setdefault(
                key, []).append((caps, prob))
        pipe, out = _run(parse, B, "appsrc name=in caps=application/x-raw ! "
                         "typefind ! appsink name=out", pushes, ("out",), 1,
                         setup, **kw)
        assert len(out["out"]) == 2
    assert found["t"] == found["j"] == [("video/x-matroska", 100)]


@pytest.mark.parametrize("key", ["y4m", "wav", "aiff", "mkv", "avi", "mov"])
@pytest.mark.parametrize("factory", ["uridecodebin", "decodebin"])
def test_uridecodebin_single_stream(key, factory, media):
    """The sniffed route's source, proxied on the plain src pad."""
    pair(f"{factory} uri=file://{media[key]} ! appsink name=out", batch=2)


def test_uridecodebin_seek(media):
    """A flushing seek through uridecodebin reaches the y4m reader
    (filesrc's `do_seek`) in both packages."""
    def at(pipe, k):
        return pipe.seek(40_000_000) if k == 1 else None
    j, t = tick_pair(f"uridecodebin uri=file://{media['y4m']} ! "
                     f"appsink name=out", ("out",), 1, at)
    assert t[3][1] is True


@pytest.mark.parametrize("key", ["y4m", "wav", "mkv", "avi", "mov"])
def test_playbin_build_pipeline(key, media):
    """playbin's single-stream build: video to RGB through videoconvert,
    audio through audioconvert."""
    rows = {}
    for k, make in (("j", jmake), ("t", tmake)):
        pb = make("playbin", uri=f"file://{media[key]}")
        pb.device = torch.device("cpu")
        pipe, sink = pb.build_pipeline()
        pipe.run()
        rows[k] = sample_rows(drain(sink))
    assert rows["t"] == rows["j"] and rows["t"]


def test_audio_only_matroska_is_a_reference_fault(tmp_path):
    """uridecodebin's single-stream route builds matroskademux with its
    default stream=video: an audio-only file gives ANY caps and fails to
    fixate in both packages (ROADMAP.md section 3)."""
    path = tmp_path / "audio.mkv"
    write_jax(f"matroskamux name=m location={path} ! fakesink {asrc()} ! "
              f"m.audio_0", {"a": apushes(800)})
    for parse, kw in ((jparse, {}), (tparse, {"device": "cpu"})):
        with pytest.raises(ValueError, match="cannot fixate ANY caps"):
            parse(f"uridecodebin uri=file://{path} ! appsink name=out",
                  **kw).run()


CODED = [
    ("video/x-h264, stream-format=byte-stream", "avdec_h264"),
    ("video/x-h265, stream-format=byte-stream", "avdec_h265"),
    ("video/x-av1", "avdec_av1"),
    ("video/mpeg, mpegversion=2, systemstream=false", "avdec_mpeg2video"),
    ("video/mpeg, mpegversion=4, systemstream=false", "avdec_mpeg4"),
    ("audio/x-ac3", "a52dec"), ("audio/x-dts", "dtsdec"),
    ("audio/mpeg, mpegversion=1", "mpg123audiodec"),
    ("audio/mpeg, mpegversion=4", "faad")]


@pytest.mark.parametrize("caps,decoder", CODED, ids=[d for _, d in CODED])
def test_decoder_for_caps_raises_where_the_port_lacks_it(caps, decoder):
    """The JAX package appends its decoder; the port appends the same
    decoder where it is registered (the libav ones since the libav slice)
    and, where the system libavcodec lacks its codec, raises naming that
    codec instead of passing the coded stream on."""
    assert jpb._decoder_for_caps(JCaps.from_string(caps)) == decoder
    if factory_exists(decoder):
        assert tpb._decoder_for_caps(Caps.from_string(caps)) == decoder
        return
    with pytest.raises(RuntimeError, match="system libavcodec"):
        tpb._decoder_for_caps(Caps.from_string(caps))


@pytest.mark.parametrize("caps", ["image/jpeg", "video/x-raw", "ANY", None])
def test_decoder_for_caps_ported(caps):
    j = None if caps is None else JCaps.from_string(caps)
    t = None if caps is None else Caps.from_string(caps)
    assert tpb._decoder_for_caps(t) == jpb._decoder_for_caps(j)


def test_uridecodebin_h264_track_raises(tmp_path):
    """An mkv whose video is H.264 of seeded NAL units (no picture
    decodes): both packages splice avdec_h264 in, and uridecodebin raises
    alike in both modes (no frame, so no caps to fixate) where playbin's
    pipeline builds and runs to its end."""
    path = tmp_path / "h264.mkv"
    write_jax(f"matroskamux name=m location={path} ! fakesink "
              f"{coded_src('video/x-h264,stream-format=byte-stream,alignment=au')}"
              f" ! m.video_0", {"v": blob_pushes(nals(1, 4, H264))})
    for parse, make, kw in ((jparse, jmake, {}),
                            (tparse, tmake, {"device": "cpu"})):
        for desc in (f"uridecodebin uri=file://{path} ! fakesink",
                     f"uridecodebin name=u uri=file://{path} u.video_0 ! "
                     f"fakesink"):
            with pytest.raises(ValueError, match="cannot fixate ANY caps"):
                parse(desc, **kw).compile()
        pb = make("playbin", uri=f"file://{path}")
        if kw:
            pb.device = torch.device("cpu")
        pipe, _sink = pb.build_pipeline()
        assert "avdec_h264" in [e.FACTORY for e in pipe.iterate_elements()]
        pipe.run()


@pytest.mark.parametrize("head,factory", [
    (b"OggS\x00\x02" + bytes(100), "oggdemux"),
    (b"fLaC\x00\x00\x00\x22" + bytes(100), "flacdec"),
    (b"ID3\x04\x00" + bytes(100), "mpegaudioparse"),
    (b"FLV\x01\x05" + bytes(100), "flvdemux")])
def test_unported_routes_raise(head, factory, tmp_path):
    """Routes of DECODABLE whose factories are not ported: uridecodebin
    and playbin raise naming the factory and ROADMAP.md.  A route the port
    has since ported (oggdemux, flacdec, mpegaudioparse: the codec slice)
    fails on these truncated files as the JAX package's does."""
    path = tmp_path / "x.bin"
    path.write_bytes(head)
    if factory_exists(factory):
        def outcomes(parse, make, **kw):
            """uridecodebin's compile and playbin's build: "ok" or the
            error's first words (element names differ between runs)."""
            pb = make("playbin", uri=f"file://{path}")
            if kw:
                pb.device = torch.device(kw["device"])
            got = []
            for fn in (lambda: parse(f"uridecodebin uri=file://{path} ! "
                                     f"fakesink", **kw).compile(),
                       pb.build_pipeline):
                try:
                    fn()
                    got.append("ok")
                except ValueError as e:
                    got.append(str(e).split(":")[0].split()[:2])
            return got
        got = outcomes(tparse, tmake, device="cpu")
        assert got == outcomes(jparse, jmake) and got[0] != "ok"
        return
    with pytest.raises(NotImplementedError, match=factory):
        tparse(f"uridecodebin uri=file://{path} ! fakesink",
               device="cpu").compile()
    pb = tmake("playbin", uri=f"file://{path}")
    pb.device = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pb.build_pipeline()
