"""Opus and AAC in the port's containers against the JAX package, bit for
bit: matroskamux's Opus track (``audio/x-opus`` under an OpusHead) and AAC
track, matroskademux's A_OPUS and A_AAC, qtmux / qtdemux's AAC 'mp4a'
track, alone and beside a video track, and uridecodebin, decodebin and
playbin on .opus, .aac, .m4a and .mkv files.

Packets come from seeded numpy through the system libopus and libavcodec
(the JAX package's oracles); files are written by both packages (the same
bytes) and read by both: samples, caps, negotiation and bus messages equal
(``test_torch_captions.pair``), tolerance 0.  Video stays at or under
96x64 and audio at or under 1 s.  matroskamux writes its OpusHead with a
pre-skip of 0, so the demuxed PCM keeps the encoder's lookahead that
Ogg-Opus trims (ROADMAP.md section 3).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import aac_oracle as ao  # noqa: E402

from gstreamer_tpu.codecs import opus as jopus  # noqa: E402
from gstreamer_tpu.core.element import element_factory_make as jmake  # noqa: E402
from gstreamer_tpu.elements import container_elements as jce  # noqa: E402

from gstreamer_tpu_torch.codecs import aac as taac  # noqa: E402
from gstreamer_tpu_torch.codecs import opus as topus  # noqa: E402
from gstreamer_tpu_torch.core.element import element_factory_make as tmake  # noqa: E402
from gstreamer_tpu_torch.elements import container_elements as tce  # noqa: E402
from gstreamer_tpu_torch.elements.ogg import parse_ogg_pages  # noqa: E402

from test_torch_captions import drain, pair, sample_rows  # noqa: E402
from test_torch_file_formats import write_both  # noqa: E402
from test_torch_xiph import vpushes, vsrc  # noqa: E402

needs_opus = pytest.mark.skipif(not jopus.available(),
                                reason="system libopus unavailable")
needs_aac = pytest.mark.skipif(not ao.have_aac(),
                               reason="system libavcodec missing")
AV = "d.video_0 ! appsink name=v d.audio_0 ! appsink name=out"
OPUS_SRC = "appsrc name=a caps=audio/x-opus,rate=48000,channels={ch}"
AAC_SRC = ("appsrc name=a caps=audio/mpeg,mpegversion=4,stream-format=raw,"
           "rate={rate},channels={ch}")


def pcm16(n, ch, seed, rate=48000):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None] / rate
    x = 0.4 * np.sin(2 * np.pi * (300 + 150 * np.arange(ch)) * t) \
        + rng.normal(0, 0.03, (n, ch))
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)


def opus_packets(ch, seed, n=24000, bitrate=64000):
    """The Ogg-Opus file of n seeded samples (the JAX package's encoder)
    and its packets."""
    blob = jopus.encode_ogg(pcm16(n, ch, seed), 48000, bitrate)
    pkts = [p for _, _, ps in parse_ogg_pages(blob) for p in ps][2:]
    return blob, pkts


def aac_units(rate, ch, seed, seconds=0.5):
    blob = ao.aac_encode_adts(pcm16(int(rate * seconds), ch, seed, rate),
                              rate, 64000 * ch, "aac_pns=0")
    assert blob is not None
    units, pos = [], 0
    while pos + 7 <= len(blob):
        flen, _s, _c, _p, hlen = taac.parse_adts_header(blob, pos)
        units.append(blob[pos + hlen:pos + flen])
        pos += flen
    return blob, units


def blob_pushes(blobs, per, dur):
    """Coded blobs pushed `per` a buffer (a list of uint8 arrays)."""
    return [dict(data=[np.frombuffer(b, np.uint8).copy()
                       for b in blobs[k:k + per]],
                 batch=len(blobs[k:k + per]), pts=k * dur,
                 duration=dur * len(blobs[k:k + per]))
            for k in range(0, len(blobs), per)]


# -- Matroska --------------------------------------------------------------------

@needs_opus
@pytest.mark.parametrize("ch", [1, 2])
def test_matroska_opus_track(ch, tmp_path):
    """matroskamux writes the JAX package's file (A_OPUS, OpusHead
    CodecPrivate, 20 ms blocks); matroskademux decodes it through both
    entry points alike."""
    _, pkts = opus_packets(ch, ch)
    path = write_both(f"matroskamux name=m location={{loc}} ! fakesink "
                      f"{OPUS_SRC.format(ch=ch)} ! m.audio_0",
                      {"a": blob_pushes(pkts, 5, 20_000_000)}, tmp_path,
                      "mkv")
    tracks, _, _ = tce._parse_matroska(str(path))
    assert tracks[0]["codec"] == "A_OPUS"
    assert tracks[0]["codec_private"] == topus.opus_head(ch, 0, 48000)
    pair(f"matroskademux location={path} stream=audio ! appsink name=out")
    pair(f"matroskademux name=d location={path} d.audio_0 ! "
         f"appsink name=out")


@needs_opus
def test_matroskamux_opus_pre_skip_0_is_a_reference_fault(tmp_path):
    """matroskamux writes OpusHead(channels, pre-skip 0, rate) (the JAX
    package's container_elements.py:989) whatever the encoder's lookahead,
    with the channel count of its caps (2 when they carry none).
    GStreamer's matroskamux takes the OpusHead opusenc puts in its caps'
    streamheader, with the encoder's pre-skip (CodecDelay).  So the
    demuxed PCM starts with the lookahead that Ogg-Opus trims: the same
    packets give the Ogg decode shifted by its pre-skip, in both packages.
    The port copies the muxer."""
    blob, pkts = opus_packets(2, 3)
    _ch, pre_skip, _rate, _gain = topus.parse_opus_head(
        parse_ogg_pages(blob)[0][2][0])
    assert pre_skip > 0
    path = write_both(f"matroskamux name=m location={{loc}} ! fakesink "
                      f"{OPUS_SRC.format(ch=2)} ! m.audio_0",
                      {"a": blob_pushes(pkts, 5, 20_000_000)}, tmp_path,
                      "mkv")
    ogg, _, _ = topus.decode_ogg(blob)
    for mod in (tce, jce):
        d = mod.MatroskaDemux(location=str(path), stream="audio")
        d._load()
        pcm = np.asarray(d._adata)
        assert len(pcm) == len(pkts) * 960
        assert np.array_equal(pcm[pre_skip:pre_skip + len(ogg)], ogg)
    # opusenc's caps carry no channel count: mono through opusenc !
    # matroskamux gets a two-channel OpusHead, pre-skip 0, in both
    mono = pcm16(9600, 1, 4)
    path = write_both("appsrc name=in caps=audio/x-raw,format=S16LE,"
                      "rate=48000,channels=1,layout=interleaved ! opusenc ! "
                      "matroskamux location={loc} ! fakesink",
                      {"in": [dict(data=mono, pts=0, duration=2 * 10**8)]},
                      tmp_path, "mkv")
    assert tce._parse_matroska(str(path))[0][0]["codec_private"] == \
        topus.opus_head(2, 0, 48000)


@needs_aac
@pytest.mark.parametrize("rate,ch", [(48000, 2), (44100, 1)])
def test_matroska_aac_track(rate, ch, tmp_path):
    """AAC access units through matroskamux (A_AAC, the ASC in
    CodecPrivate) and back through matroskademux's decode."""
    _, units = aac_units(rate, ch, 4)
    path = write_both(f"matroskamux name=m location={{loc}} ! fakesink "
                      f"{AAC_SRC.format(rate=rate, ch=ch)} ! m.audio_0",
                      {"a": blob_pushes(units, 4, 21_333_333)}, tmp_path,
                      "mkv")
    assert tce._parse_matroska(str(path))[0][0]["codec"] == "A_AAC"
    pair(f"matroskademux location={path} stream=audio ! appsink name=out")


@needs_opus
def test_matroska_video_and_opus(tmp_path):
    """A WebM-like file: I420 frames and Opus packets in one Matroska
    file, both pads read at once and one stream at a time."""
    _, pkts = opus_packets(2, 5, n=19200)
    pushes = {"in": vpushes(64, 48, 8, 2, 5),
              "a": blob_pushes(pkts, 5, 20_000_000)}
    path = write_both(f"matroskamux name=m location={{loc}} ! fakesink "
                      f"{vsrc(64, 48)} ! m.video_0 {OPUS_SRC.format(ch=2)} "
                      f"! m.audio_0", pushes, tmp_path, "mkv", batch=2)
    pair(f"matroskademux name=d location={path} {AV}", sinks=("v", "out"),
         batch=2)
    pair(f"matroskademux location={path} stream=audio ! appsink name=out",
         batch=2)


def test_matroska_opus_and_aac_errors(tmp_path):
    """A_AAC without an ASC and A_OPUS without an OpusHead: the same
    errors in both packages."""
    from test_torch_flow import _mkv_track
    for codec, priv, msg in (("A_AAC", b"", "A_AAC without ASC"),
                             ("A_OPUS", b"", "bad OpusHead"),
                             ("A_OPUS", b"OpusHead\x01\x02" + bytes(8)
                              + b"\x01", "mapping family 0")):
        _mkv_track(tmp_path / "x.mkv", codec, "audio", priv)
        for mod in (tce, jce):
            d = mod.MatroskaDemux(location=str(tmp_path / "x.mkv"),
                                  stream="audio")
            with pytest.raises(ValueError, match=msg):
                d._load()


# -- MP4 -------------------------------------------------------------------------

@needs_aac
@pytest.mark.parametrize("rate,ch", [(48000, 2), (32000, 1), (22050, 2)])
def test_qtdemux_aac_track(rate, ch, tmp_path):
    """qtmux writes the AAC access units ('mp4a' with an esds) as the JAX
    package does; qtdemux decodes them alike."""
    _, units = aac_units(rate, ch, rate)
    path = write_both("qtmux name=m location={loc} ! fakesink "
                      + AAC_SRC.format(rate=rate, ch=ch) + " ! m.audio_0",
                      {"a": blob_pushes(units, 4, 21_333_333)}, tmp_path,
                      "m4a")
    _, _, _, out = pair(f"qtdemux location={path} stream=audio ! "
                        f"appsink name=out")
    s = out["out"][0].caps[0]
    assert (s["rate"], s["channels"], s["format"]) == (rate, ch, "F32LE")


@needs_aac
def test_qtdemux_video_and_aac(tmp_path):
    """UYVY frames and AAC access units in one MP4, both pads at once."""
    from test_torch_containers import planes
    _, units = aac_units(48000, 2, 6, seconds=0.3)
    y = planes("UYVY", 6, 7, 48, 32)
    pushes = {"in": [dict(data=tuple(p[k:k + 2] for p in y), batch=2,
                          pts=k * 40_000_000, duration=40_000_000)
                     for k in range(0, 6, 2)],
              "a": blob_pushes(units, 5, 21_333_333)}
    path = write_both("qtmux name=m location={loc} ! fakesink appsrc "
                      "name=in caps=video/x-raw,format=UYVY,width=48,"
                      "height=32,framerate=25/1 ! m.video_0 "
                      + AAC_SRC.format(rate=48000, ch=2) + " ! m.audio_0",
                      pushes, tmp_path, "mp4", batch=2)
    pair(f"qtdemux name=d location={path} {AV}", sinks=("v", "out"),
         batch=2)


@needs_aac
def test_qtdemux_he_aac(tmp_path):
    """HE-AAC access units under an LC ASC (implicit SBR signalling): the
    decode doubles the rate in both packages."""
    from sbr_writer import splice_sbr_adts
    from gstreamer_tpu_torch.codecs.sbr import SbrHeader
    blob, _ = aac_units(24000, 1, 8)
    he = splice_sbr_adts(blob, SbrHeader(amp_res=1, start_freq=5,
                                         stop_freq=3), env_q=[70],
                         noise_q=[25], invf_mode=0)
    units, pos = [], 0
    while pos + 7 <= len(he):
        flen, _s, _c, _p, hlen = taac.parse_adts_header(he, pos)
        units.append(he[pos + hlen:pos + flen])
        pos += flen
    path = write_both("qtmux name=m location={loc} ! fakesink "
                      + AAC_SRC.format(rate=24000, ch=1) + " ! m.audio_0",
                      {"a": blob_pushes(units, 4, 42_666_666)}, tmp_path,
                      "m4a")
    _, _, _, out = pair(f"qtdemux location={path} stream=audio ! "
                        f"appsink name=out")
    assert out["out"][0].caps[0]["rate"] == 48000


# -- uridecodebin, decodebin, playbin ----------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One file of each kind, written by the JAX package."""
    from gstreamer_tpu.core.buffer import Buffer as JBuffer
    from gstreamer_tpu.core.parse import parse_launch as jparse
    from test_torch_captions import _run
    tmp = tmp_path_factory.mktemp("opus_aac")
    out = {}
    if jopus.available():
        blob, pkts = opus_packets(2, 9)
        out["opus"] = tmp / "a.opus"
        out["opus"].write_bytes(blob)
        out["mkv"] = tmp / "av.mkv"
        _run(jparse, JBuffer, f"matroskamux name=m location={out['mkv']} ! "
             f"fakesink {vsrc(96, 64)} ! m.video_0 {OPUS_SRC.format(ch=2)} "
             f"! m.audio_0", {"in": vpushes(96, 64, 6, 2, 9),
                              "a": blob_pushes(pkts, 5, 20_000_000)},
             (), 2, None)
    if ao.have_aac():
        blob, units = aac_units(44100, 2, 10)
        out["aac"] = tmp / "a.aac"
        out["aac"].write_bytes(blob)
        out["m4a"] = tmp / "a.m4a"
        _run(jparse, JBuffer, "qtmux name=m location=" + str(out["m4a"])
             + " ! fakesink " + AAC_SRC.format(rate=44100, ch=2)
             + " ! m.audio_0", {"a": blob_pushes(units, 4, 23_219_954)},
             (), 1, None)
    return out


def _need(files, key):
    if key not in files:
        pytest.skip(f"the system encoder for .{key} is missing")
    return files[key]


@pytest.mark.parametrize("key", ["opus", "aac"])
@pytest.mark.parametrize("factory", ["uridecodebin", "decodebin"])
def test_uridecodebin_audio_files(key, factory, files):
    """typefind's route for each file (oggdemux; aacparse ! faad): the
    same samples and caps."""
    path = _need(files, key)
    pair(f"{factory} uri=file://{path} ! appsink name=out")


@pytest.mark.parametrize("factory", ["uridecodebin", "decodebin"])
def test_audio_only_mp4_is_a_reference_fault(factory, files):
    """An audio-only MP4 through the single-stream route: qtdemux is built
    with its default stream=video, gives ANY caps and fails to fixate in
    both packages, as an audio-only Matroska file does (ROADMAP.md section
    3); its stream=audio decodes alike."""
    from gstreamer_tpu.core.parse import parse_launch as jparse
    from gstreamer_tpu_torch import parse_launch as tparse
    path = _need(files, "m4a")
    for parse, kw in ((jparse, {}), (tparse, {"device": "cpu"})):
        with pytest.raises(ValueError, match="cannot fixate ANY caps"):
            parse(f"{factory} uri=file://{path} ! appsink name=out",
                  **kw).run()
    pair(f"qtdemux location={path} stream=audio ! appsink name=out")


def test_uridecodebin_video_and_opus_mkv(files):
    """Both tracks of the .mkv through uridecodebin's pads: video to RGB
    through the converter, the Opus track as it decodes."""
    path = _need(files, "mkv")
    pair(f"uridecodebin name=d uri=file://{path} d.video_0 ! "
         f"videoconvertscale add-borders=false ! video/x-raw,format=RGB,"
         f"width=48,height=32 ! appsink name=v d.audio_0 ! appsink name=out",
         sinks=("v", "out"), batch=2)


@pytest.mark.parametrize("key", ["opus", "aac"])
def test_playbin_audio_files(key, files):
    """playbin's single-stream build over each file."""
    path = _need(files, key)
    rows = {}
    for k, make in (("j", jmake), ("t", tmake)):
        pb = make("playbin", uri=f"file://{path}")
        if k == "t":
            pb.device = torch.device("cpu")
        pipe, sink = pb.build_pipeline()
        pipe.run()
        rows[k] = sample_rows(drain(sink))
    assert rows["t"] == rows["j"] and rows["t"]


def test_playbin_av_build_with_opus(files):
    """playbin's A/V build of the .mkv: the same frames and PCM."""
    path = _need(files, "mkv")
    rows = {}
    for k, make in (("j", jmake), ("t", tmake)):
        pb = make("playbin", uri=f"file://{path}")
        if k == "t":
            pb.device = torch.device("cpu")
        _pipe, sinks = pb.build_pipeline_av()
        rows[k] = {s: sample_rows(drain(sink)) for s, sink in sinks.items()}
    assert rows["t"] == rows["j"] and rows["t"]["audio"]
