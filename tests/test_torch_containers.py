"""The port's container elements against the JAX package, byte for byte:
avimux / avidemux, matroskamux / webmmux / matroskademux, mxfmux / mxfdemux,
qtmux / qtdemux / cmafmux / fmp4mux / qtmoovrecover, rmdemux / rademux /
pnmsrc.

Every muxer runs in both packages on the same seeded pushes (the port on
the CPU) and writes the same file (``write_both``; MXF with both packages'
``_uuid`` replaced by one seeded sequence).  Every demuxer reads the JAX
package's file in both packages and gives the same samples, caps and bus
messages (``test_torch_captions.pair``), and reads the port's own file.  The
coded branches that need a codec module the port does not have yet raise
``NotImplementedError`` naming ROADMAP.md, each with a test; those of the
codec slice's decoders are held to the JAX package here on malformed input
and in ``test_torch_coded_containers.py`` on real coded files.  RealMedia
runs on a hand-packed file (``rm_file``), since the JAX package's own
RealMedia tests need libavformat.
"""

import re
import struct

import numpy as np
import pytest

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import isomp4 as jiso
from gstreamer_tpu.elements import mxf as jmxf
from gstreamer_tpu.video import format as jvf

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements import container_elements as tce
from gstreamer_tpu_torch.elements import isomp4 as tiso
from gstreamer_tpu_torch.elements import mxf as tmxf

from test_torch_analytics import same_spec
from test_torch_captions import pair, plain
from test_torch_file_formats import write_both
from test_torch_flow import CONTAINER_FACTORIES

W, H = 32, 24
DUR = 40_000_000                     # 25/1


# -- seeded inputs --------------------------------------------------------------

def planes(fmt, n, seed, w=W, h=H):
    """`n` frames of `fmt` as component planes: seeded bytes of the
    format's layout through the JAX package's ``from_bytes``."""
    fi = jvf.format_info(fmt)
    size = jvf.frame_size(fi, w, h)
    raw = np.random.default_rng(seed).integers(0, 256, (n, size), np.uint8)
    return tuple(np.ascontiguousarray(p)
                 for p in jvf.from_bytes(fi, raw, w, h))


def vpushes(fmt, batch=2, ticks=2, seed=0, w=W, h=H):
    return [dict(data=planes(fmt, batch, seed + t, w, h), batch=batch,
                 pts=t * batch * DUR, duration=DUR) for t in range(ticks)]


def apushes(n, ch=2, ticks=2, seed=10, dtype=np.int16, rate=48000):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        data = [rng.integers(0, 256, (n, ch), np.uint8) for _ in range(ticks)]
    else:
        data = [rng.integers(-20000, 20000, (n, ch)).astype(dtype)
                for _ in range(ticks)]
    dur = n * 1_000_000_000 // rate
    return [dict(data=d, pts=t * dur, duration=dur) for t, d in
            enumerate(data)]


def vsrc(fmt, name="v", w=W, h=H):
    return (f"appsrc name={name} caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=25/1")


def asrc(fmt="S16LE", ch=2, rate=48000, name="a"):
    return (f"appsrc name={name} caps=audio/x-raw,format={fmt},rate={rate},"
            f"channels={ch},layout=interleaved")


def nals(seed, n, kinds):
    """Annex-B access units of seeded NAL bodies (no zero bytes, so no
    start code inside); `kinds` the first header bytes of the NALs."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        au = b""
        for head in (kinds if k == 0 else kinds[-1:]):
            body = rng.integers(1, 256, 20, np.uint8).tobytes()
            au += b"\x00\x00\x00\x01" + bytes(head) + body
        out.append(np.frombuffer(au, np.uint8).copy())
    return out


H264 = (b"\x67\x42\x00\x1e", b"\x68", b"\x65")       # SPS, PPS, IDR slice
H265 = (b"\x40\x01", b"\x42\x01", b"\x44\x01", b"\x26\x01")


def av1_units(seed, n):
    rng = np.random.default_rng(seed)
    seq = bytes([0x0A, 6]) + rng.integers(1, 256, 6, np.uint8).tobytes()
    return [np.frombuffer((seq if k == 0 else b"")
                          + bytes([0x32, 10])
                          + rng.integers(1, 256, 10, np.uint8).tobytes(),
                          np.uint8).copy() for k in range(n)]


def blob_pushes(units, per=2):
    return [dict(data=units[i:i + per], batch=len(units[i:i + per]),
                 pts=i * DUR, duration=DUR)
            for i in range(0, len(units), per)]


def same_outcome(desc, batch=1):
    """`desc` through both packages: the same samples and caps, or the
    same error."""
    try:
        jparse_launch(desc, batch=batch).run()
    except Exception as e:
        with pytest.raises(type(e), match=re.escape(str(e))):
            gstreamer_tpu_torch.parse_launch(desc, batch=batch,
                                             device="cpu").run()
        return
    pair(desc, batch=batch)


def coded_src(caps, name="v"):
    return f"appsrc name={name} caps={caps},width={W},height={H},framerate=25/1"


# -- every factory ----------------------------------------------------------------

@pytest.mark.parametrize("factory", CONTAINER_FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


@pytest.mark.parametrize("factory", CONTAINER_FACTORIES)
def test_factory_builds_through_parse_launch(factory):
    """Each factory alone in a launch string, in both packages: the same
    class name and property values."""
    from gstreamer_tpu.core.parse import parse_launch as jparse
    j = next(iter(jparse(factory).iterate_elements()))
    t = next(iter(gstreamer_tpu_torch.parse_launch(
        factory, device="cpu").iterate_elements()))
    assert (type(t).__name__, t.FACTORY) == (type(j).__name__, j.FACTORY)
    assert plain(t.props) == plain(j.props)


# -- AVI --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["I420", "YUY2", "UYVY", "RGB"])
@pytest.mark.parametrize("with_audio", [True, False])
def test_avi_raw(fmt, with_audio, tmp_path):
    desc = f"avimux name=m location={{loc}} ! fakesink {vsrc(fmt)} ! m.video_0"
    pushes = {"v": vpushes(fmt)}
    if with_audio:
        desc += f" {asrc()} ! m.audio_0"
        pushes["a"] = apushes(960)
    own = write_both(desc, pushes, tmp_path, "avi", batch=2)
    jfile = tmp_path / "jax.avi"
    for f in (jfile, own):
        pair(f"avidemux location={f} ! appsink name=out", batch=2)
    if with_audio:
        pair(f"avidemux location={jfile} stream=audio ! appsink name=out")
        pair(f"avidemux location={jfile} stream=1 ! appsink name=out")


def test_avi_audio_only(tmp_path):
    write_both(f"avimux name=m location={{loc}} ! fakesink {asrc(ch=1)} ! "
               f"m.audio_0", {"a": apushes(500, ch=1, ticks=3)}, tmp_path,
               "avi")
    pair(f"avidemux location={tmp_path / 'jax.avi'} stream=audio ! "
         f"appsink name=out")


def test_avi_h264_passthrough(tmp_path):
    """H.264 byte-stream AUs go into '00dc' chunks and come back as the
    same blobs: no codec."""
    caps = "video/x-h264,stream-format=byte-stream,alignment=au"
    write_both(f"avimux name=m location={{loc}} ! fakesink {coded_src(caps)}"
               f" ! m.video_0", {"v": blob_pushes(nals(1, 5, H264))},
               tmp_path, "avi")
    pair(f"avidemux location={tmp_path / 'jax.avi'} ! appsink name=out",
         batch=2)


def test_avi_mjpeg(tmp_path):
    write_both(f"avimux name=m location={{loc}} ! fakesink {vsrc('I420')} ! "
               f"jpegenc ! m.video_0", {"v": vpushes("I420")}, tmp_path,
               "avi", batch=2)
    pair(f"avidemux location={tmp_path / 'jax.avi'} ! jpegdec ! "
         f"appsink name=out", batch=2)


def test_avidemux_mp3_raises(tmp_path):
    """An AVI whose audio is tagged WAVE_FORMAT_MPEGLAYER3 (0x55) but holds
    PCM: both packages decode it with codecs/mp3.py (the port since the
    codec slice, before which it raised), resyncing on what looks like
    frames, with the same samples (a real MP3 track:
    test_torch_coded_containers.py)."""
    write_both(f"avimux name=m location={{loc}} ! fakesink {asrc()} ! "
               f"m.audio_0", {"a": apushes(480)}, tmp_path, "avi")
    data = bytearray((tmp_path / "port.avi").read_bytes())
    strf = data.index(b"strf", data.index(b"auds"))
    data[strf + 8:strf + 10] = struct.pack("<H", 0x55)
    (tmp_path / "mp3.avi").write_bytes(bytes(data))
    pair(f"avidemux location={tmp_path / 'mp3.avi'} stream=audio ! "
         f"appsink name=out")


# -- Matroska -----------------------------------------------------------------------

def mkv_desc(fmt=None, ch=None, mux="matroskamux", extra=""):
    desc = f"{mux} name=m location={{loc}} {extra}! fakesink"
    if fmt:
        desc += f" {vsrc(fmt)} ! m.video_0"
    if ch:
        desc += f" {asrc(ch=ch)} ! m.audio_0"
    return desc


@pytest.mark.parametrize("fmt,ch", [("I420", 2), ("YUY2", 1), ("UYVY", 2),
                                    ("I420", None), (None, 2)])
def test_matroska_raw(fmt, ch, tmp_path):
    pushes = {}
    if fmt:
        pushes["v"] = vpushes(fmt, ticks=3)
    if ch:
        pushes["a"] = apushes(1024, ch=ch, ticks=3)
    own = write_both(mkv_desc(fmt, ch), pushes, tmp_path, "mkv", batch=2)
    jfile = tmp_path / "jax.mkv"
    for f in (jfile, own):
        if fmt:
            pair(f"matroskademux location={f} ! appsink name=out", batch=2)
        if ch:
            pair(f"matroskademux location={f} stream=audio ! "
                 f"appsink name=out")
    if fmt and ch:
        pair(f"matroskademux name=d location={jfile} d.video_0 ! "
             f"appsink name=v d.audio_0 ! appsink name=a", sinks=("v", "a"),
             batch=3)
        pair(f"matroskademux location={jfile} stream=2 ! appsink name=out")


def test_matroskamux_raw_a420_is_a_reference_fault(tmp_path):
    """A420 is in matroskamux's video template, but the raw track's
    colour-space fourcc table has no A420: writing one raises KeyError in
    both packages (``elements/container_elements.py`` `_tracks`; ROADMAP.md
    section 3)."""
    from gstreamer_tpu.core.parse import parse_launch as jparse
    desc = mkv_desc("A420").format(loc=tmp_path / "a.mkv")
    for parse, kw in ((jparse, {}),
                      (gstreamer_tpu_torch.parse_launch, {"device": "cpu"})):
        p = parse(desc, batch=2, **kw)
        p.get_by_name("v").push_buffer(
            (JBuffer if parse is jparse else Buffer)(**vpushes("A420")[0]))
        p.get_by_name("v").end_of_stream()
        with pytest.raises(KeyError, match="A420"):
            p.run()


def test_webmmux(tmp_path):
    write_both(mkv_desc("I420", 2, mux="webmmux"),
               {"v": vpushes("I420"), "a": apushes(960)}, tmp_path, "webm",
               batch=2)
    assert b"webm" in (tmp_path / "port.webm").read_bytes()[:64]


def text_pushes():
    cues = ("hello", "wörld", "third cue")
    return [dict(data=[t], batch=1, pts=k * 500_000_000,
                 duration=400_000_000) for k, t in enumerate(cues)]


def test_matroska_subtitle_track(tmp_path):
    """An S_TEXT/UTF8 track: cues written as BlockGroups and read back as
    host text; the text pad makes the demuxer a host element."""
    desc = (mkv_desc("I420") + " appsrc name=s caps=text/x-raw,format=utf8 "
            "! m.subtitle_0")
    own = write_both(desc, {"v": vpushes("I420"), "s": text_pushes()},
                     tmp_path, "mkv", batch=2)
    for f in (tmp_path / "jax.mkv", own):
        _, _, tpipe, _ = pair(f"matroskademux location={f} stream=subtitle "
                              f"! appsink name=out")
        assert not tpipe._fused


@pytest.mark.parametrize("codec", ["h264", "h265", "av1", "mjpeg"])
def test_matroska_coded_video_passthrough(codec, tmp_path):
    if codec == "mjpeg":
        desc = mkv_desc() + f" {vsrc('I420')} ! jpegenc ! m.video_0"
        pushes = {"v": vpushes("I420")}
    else:
        caps = {"h264": "video/x-h264,stream-format=byte-stream,alignment=au",
                "h265": "video/x-h265,stream-format=byte-stream,alignment=au",
                "av1": "video/x-av1"}[codec]
        units = {"h264": lambda: nals(2, 5, H264),
                 "h265": lambda: nals(3, 5, H265),
                 "av1": lambda: av1_units(4, 5)}[codec]()
        desc = mkv_desc() + f" {coded_src(caps)} ! m.video_0"
        pushes = {"v": blob_pushes(units)}
    write_both(desc, pushes, tmp_path, "mkv", batch=2)
    pair(f"matroskademux location={tmp_path / 'jax.mkv'} ! appsink name=out",
         batch=2)


def test_matroska_aac_passthrough(tmp_path):
    """AAC access units (audio/mpeg, raw) with the port's own copy of the
    sample-rate table for the CodecPrivate."""
    from gstreamer_tpu.codecs import aac as jaac
    assert tiso.SAMPLE_RATES == jaac.SAMPLE_RATES
    units = [np.random.default_rng(k).integers(0, 256, 40 + k, np.uint8)
             for k in range(4)]
    desc = (mkv_desc() + " appsrc name=a caps=audio/mpeg,mpegversion=4,"
            "stream-format=raw,rate=44100,channels=2 ! m.audio_0")
    write_both(desc, {"a": blob_pushes(units)}, tmp_path, "mkv")


@pytest.mark.parametrize("extra,src", [
    ("audio-codec=vorbis ", asrc() + " ! m.audio_0"),
    ("video-codec=theora ", vsrc("I420") + " ! m.video_0"),
    ("video-codec=vp8 ", vsrc("I420") + " ! m.video_0"),
    ("video-codec=vp9 ", vsrc("I420") + " ! m.video_0"),
    ("", "appsrc name=a caps=audio/x-opus,rate=48000,channels=2 ! "
         "m.audio_0")])
def test_matroskamux_codec_modes_raise(extra, src, tmp_path):
    """The Vorbis and Theora modes are ported since the codec slice, Opus
    passthrough (the OpusHead) since the Opus slice and the VPx
    encode-at-EOS modes since the VPx slice (before which they raised):
    the same file as the JAX package's."""
    if "x-opus" not in src:
        pushes = ({"a": apushes(1920)} if "vorbis" in extra
                  else {"v": vpushes("I420")})
        write_both(f"matroskamux name=m location={{loc}} {extra}! fakesink "
                   f"{src}", pushes, tmp_path, "mkv", batch=2)
        return
    packets = [np.random.default_rng(k).integers(0, 256, 30 + k, np.uint8)
               for k in range(4)]
    write_both(f"matroskamux name=m location={{loc}} ! fakesink {src}",
               {"a": blob_pushes(packets)}, tmp_path, "mkv")


def _mkv_with_track(path, codec, kind):
    """A minimal Matroska file: one track of `codec`, one block."""
    e = tce
    entry = (e.ebml_uint(e.TRACK_NUMBER, 1) + e.ebml_uint(e.TRACK_UID, 1)
             + e.ebml_uint(e.TRACK_TYPE, 1 if kind == "video" else 2)
             + e.ebml_str(e.CODEC_ID, codec))
    if kind == "video":
        entry += e.ebml_elem(e.VIDEO, e.ebml_uint(e.PIXEL_WIDTH, 16)
                             + e.ebml_uint(e.PIXEL_HEIGHT, 16))
    else:
        entry += e.ebml_elem(e.AUDIO, e.ebml_float(e.SAMPLING_FREQ, 48000.0)
                             + e.ebml_uint(e.CHANNELS, 2))
    block = e.ebml_elem(e.SIMPLE_BLOCK, e.ebml_size(1) + b"\0\0\x80" + b"x")
    path.write_bytes(
        e.ebml_elem(e.EBML_HEADER, e.ebml_str(0x4282, "matroska"))
        + e.ebml_id(e.SEGMENT) + b"\xff"
        + e.ebml_elem(e.TRACKS, e.ebml_elem(e.TRACK_ENTRY, entry))
        + e.ebml_elem(e.CLUSTER, e.ebml_uint(e.CLUSTER_TS, 0) + block))


@pytest.mark.parametrize("codec,kind", [
    ("A_VORBIS", "audio"), ("A_OPUS", "audio"), ("A_AAC", "audio"),
    ("A_MPEG/L3", "audio"), ("V_THEORA", "video"), ("V_VP8", "video"),
    ("V_VP9", "video")])
def test_matroskademux_codec_tracks_raise(codec, kind, tmp_path):
    """A one-block track of each coded kind.  Vorbis, MPEG audio and Theora
    are ported since the codec slice, Opus and AAC since the Opus slice,
    VP8 and VP9 since the VPx slice (before which they raised): this track
    (no CodecPrivate, one byte) fails as in the JAX package."""
    path = tmp_path / "x.mkv"
    _mkv_with_track(path, codec, kind)
    tracks, blocks, _ = tce._parse_matroska(str(path))
    assert tracks[0]["codec"] == codec and len(blocks) == 1
    for desc in (f"matroskademux location={path} stream={kind} ! fakesink",
                 f"matroskademux name=d location={path} d.{kind}_0 ! "
                 f"fakesink"):
        with pytest.raises(ValueError) as ref:
            jparse_launch(desc).compile()
        with pytest.raises(ValueError, match=re.escape(str(ref.value))):
            gstreamer_tpu_torch.parse_launch(desc, device="cpu").compile()


# -- MXF ------------------------------------------------------------------------------

@pytest.fixture
def seeded_uuid(monkeypatch):
    """Both packages' `_uuid` from one seeded sequence, restarted for each
    writer, so the two files can be compared byte for byte."""
    def install():
        rng = np.random.default_rng(77)

        def ids():
            return rng.integers(0, 256, 16, np.uint8).tobytes()
        return ids
    monkeypatch.setattr(jmxf, "_uuid", install())
    monkeypatch.setattr(tmxf, "_uuid", install())


@pytest.mark.parametrize("video,audio", [(True, True), (True, False),
                                         (False, True)])
def test_mxf_raw(video, audio, seeded_uuid, tmp_path):
    desc = "mxfmux name=m location={loc} ! fakesink"
    pushes = {}
    if video:
        desc += f" {vsrc('UYVY')} ! m.video_0"
        pushes["v"] = vpushes("UYVY", ticks=3)
    if audio:
        desc += f" {asrc()} ! m.audio_0"
        pushes["a"] = apushes(1920, ticks=3)
    own = write_both(desc, pushes, tmp_path, "mxf", batch=2)
    jfile = tmp_path / "jax.mxf"
    for f in (jfile, own):
        if video:
            pair(f"mxfdemux location={f} ! appsink name=out", batch=2)
        if audio:
            pair(f"mxfdemux location={f} stream=audio ! appsink name=out")
    if video and audio:
        _, _, tpipe, _ = pair(f"mxfdemux name=d location={jfile} d.video_0 ! "
                              f"appsink name=v d.audio_0 ! appsink name=a",
                              sinks=("v", "a"), batch=2)
        assert tpipe.get_by_name("d").operational_pattern == "op1a"


def test_mxf_coded_video(seeded_uuid, tmp_path):
    caps = "video/x-h264,stream-format=byte-stream"
    write_both(f"mxfmux name=m location={{loc}} ! fakesink {coded_src(caps)} "
               f"! m.video_0", {"v": blob_pushes(nals(5, 4, H264))}, tmp_path,
               "mxf")
    pair(f"mxfdemux location={tmp_path / 'jax.mxf'} ! appsink name=out")


# -- QuickTime / MP4 -------------------------------------------------------------------

@pytest.mark.parametrize("fmt,afmt", [
    ("UYVY", "S16LE"), ("v308", "S16BE"), ("v210", "U8"), ("v216", None),
    ("r210", "S16LE"), ("RGB", None), (None, "S16LE")])
def test_qt_raw(fmt, afmt, tmp_path):
    w = 48 if fmt == "v210" else W           # v210 packs 6 pixels a group
    desc = "qtmux name=m location={loc} ! fakesink"
    pushes = {}
    if fmt:
        desc += f" {vsrc(fmt, w=w)} ! m.video_0"
        pushes["v"] = vpushes(fmt, w=w)
    if afmt:
        dtype = np.uint8 if afmt == "U8" else np.int16
        desc += f" {asrc(afmt)} ! m.audio_0"
        pushes["a"] = apushes(800, dtype=dtype)
    own = write_both(desc, pushes, tmp_path, "mov", batch=2)
    for f in (tmp_path / "jax.mov", own):
        if fmt:
            pair(f"qtdemux location={f} ! appsink name=out", batch=2)
        if afmt:
            pair(f"qtdemux location={f} stream=audio ! appsink name=out")
        if fmt and afmt:
            pair(f"qtdemux name=d location={f} d.video_0 ! appsink name=v "
                 f"d.audio_0 ! appsink name=a", sinks=("v", "a"), batch=2)


@pytest.mark.parametrize("law", ["mulaw", "alaw"])
def test_qt_law_audio(law, tmp_path):
    write_both(f"qtmux name=m location={{loc}} ! fakesink {asrc(ch=1)} ! "
               f"{law}enc ! m.audio_0", {"a": apushes(400, ch=1)}, tmp_path,
               "mov")
    pair(f"qtdemux location={tmp_path / 'jax.mov'} stream=audio ! "
         f"appsink name=out")


@pytest.mark.parametrize("codec", ["jpeg", "h264", "h265", "av1", "aac"])
def test_qt_coded_passthrough(codec, tmp_path):
    desc = "qtmux name=m location={loc} ! fakesink "
    if codec == "jpeg":
        desc += f"{vsrc('I420')} ! jpegenc ! m.video_0"
        pushes = {"v": vpushes("I420")}
    elif codec == "aac":
        desc += ("appsrc name=v caps=audio/mpeg,mpegversion=4,"
                 "stream-format=raw,rate=48000,channels=2 ! m.audio_0")
        pushes = {"v": blob_pushes([np.random.default_rng(k).integers(
            0, 256, 30 + k, np.uint8) for k in range(4)])}
    else:
        caps = {"h264": "video/x-h264,stream-format=byte-stream,alignment=au",
                "h265": "video/x-h265,stream-format=byte-stream,alignment=au",
                "av1": "video/x-av1"}[codec]
        units = {"h264": lambda: nals(6, 5, H264),
                 "h265": lambda: nals(7, 5, H265),
                 "av1": lambda: av1_units(8, 5)}[codec]()
        desc += f"{coded_src(caps)} ! m.video_0"
        pushes = {"v": blob_pushes(units)}
    write_both(desc, pushes, tmp_path, "mov", batch=2)
    if codec in ("jpeg", "av1"):
        _qt_bytes_blobs(tmp_path / "jax.mov")
    elif codec == "aac":
        # decoded since the Opus and AAC slice (before which it raised)
        same_outcome(f"qtdemux location={tmp_path / 'port.mov'} "
                     f"stream=audio ! appsink name=out")
    else:
        pair(f"qtdemux location={tmp_path / 'jax.mov'} ! appsink name=out",
             batch=2)


def _qt_bytes_blobs(path):
    """qtdemux gives 'jpeg' and 'av01' samples as `bytes` blobs.  The JAX
    package's fused graph cannot take them (jit of a `bytes` leaf raises
    TypeError, ROADMAP.md section 3); the port carries them to the sink, the
    same blobs as the JAX element's own `create`."""
    from gstreamer_tpu.core.parse import parse_launch as jparse
    desc = f"qtdemux location={path} ! appsink name=out"
    with pytest.raises(TypeError):
        jparse(desc, batch=2).run()
    j = jiso.QtDemux(location=str(path))
    j.start()
    ref = []
    while (b := j.create(2)) is not None:
        ref.append((b.batch, plain(b.data)))
    p = gstreamer_tpu_torch.parse_launch(desc, batch=2, device="cpu")
    p.run()
    sink = p.get_by_name("out")
    got = []
    while (sm := sink.pull_sample()) is not None:
        got.append((sm.buffer.batch, plain(sm.buffer.data)))
    assert got == ref and len(ref) >= 2


def test_qt_moov_recovery(tmp_path):
    """qtmux's recovery journal and incremental mdat equal the JAX
    package's; qtmoovrecover rebuilds the same file from a cut copy in
    both packages and posts the same message."""
    from gstreamer_tpu.core.parse import parse_launch as jparse
    desc = (f"qtmux name=m location={{loc}} moov-recovery-file={{loc}}.rec "
            f"! fakesink {vsrc('UYVY')} ! m.video_0 {asrc()} ! m.audio_0")
    pushes = {"v": vpushes("UYVY"), "a": apushes(800)}
    write_both(desc, pushes, tmp_path, "mov", batch=2)
    journal = tmp_path / "jax.mov.rec"
    assert (tmp_path / "port.mov.rec").read_bytes() == journal.read_bytes()
    broken = tmp_path / "broken.mov"
    raw = (tmp_path / "jax.mov").read_bytes()
    broken.write_bytes(raw[:raw.index(b"moov") - 4])
    rows = {}
    for key, parse, kw in (("j", jparse, {}),
                           ("t", gstreamer_tpu_torch.parse_launch,
                            {"device": "cpu"})):
        fixed = tmp_path / f"fixed_{key}.mov"
        p = parse(f"qtmoovrecover broken-input={broken} recovery-input="
                  f"{journal} fixed-output={fixed}", **kw)
        p.set_state("playing")
        rows[key] = ([(m.type, m.data["name"], m.data["samples"]) for m in
                      iter(p.bus.pop, None) if m.type == "element"],
                     fixed.read_bytes())
    assert rows["t"] == rows["j"]
    assert rows["t"][0][0][1] == "qtmoovrecover-done"
    pair(f"qtdemux location={tmp_path / 'fixed_t.mov'} ! appsink name=out",
         batch=2)


@pytest.mark.parametrize("mux", ["cmafmux", "fmp4mux"])
def test_cmaf(mux, tmp_path):
    caps = "video/x-h264,stream-format=byte-stream,alignment=au"
    desc = (f"{mux} name=m location={{loc}} ! fakesink {coded_src(caps)} ! "
            f"m.video_0 appsrc name=a caps=audio/mpeg,mpegversion=4,"
            f"stream-format=raw,rate=48000,channels=2 ! m.audio_0")
    aac = [np.random.default_rng(20 + k).integers(0, 256, 25, np.uint8)
           for k in range(6)]
    own = write_both(desc, {"v": blob_pushes(nals(9, 6, H264)),
                            "a": blob_pushes(aac)}, tmp_path, "mp4")
    for f in (tmp_path / "jax.mp4", own):
        pair(f"qtdemux location={f} ! appsink name=out", batch=3)
    # the AAC track: decoded since the Opus and AAC slice (before which it
    # raised)
    same_outcome(f"qtdemux location={own} stream=audio ! appsink name=out",
                 batch=3)


# -- RealMedia --------------------------------------------------------------------------

def _chunk(fcc, body, version=0):
    return fcc + struct.pack(">IH", 10 + len(body), version) + body


def _ra4(codec=b"lpcJ", rate=8000, ch=1, frame=20):
    """A RealAudio v4 header blob (the layout ``_parse_ra_header`` walks)."""
    head = (b".ra\xfd" + struct.pack(">H", 4) + b"\0\0" + b".ra4"
            + struct.pack(">IHIH", 0, 4, 0, 0) + struct.pack(">I", frame)
            + b"\0" * 12 + struct.pack(">HHHH", 1, frame, frame, 0)
            + struct.pack(">HHHH", rate, 0, 16, ch)
            + bytes([4]) + b"Int0" + bytes([4]) + codec + b"\0\0\0")
    return head


def rm_bytes(seed=0):
    """A hand-packed RealMedia file: .RMF, PROP, two MDPR (RV20 video,
    RealAudio 14.4), DATA with whole-frame video packets, one split frame
    and audio packets."""
    rng = np.random.default_rng(seed)

    def mdpr(snum, mime, ts):
        body = struct.pack(">H", snum) + b"\0" * 28
        body += bytes([4]) + b"name" + bytes([len(mime)]) + mime
        return _chunk(b"MDPR", body + struct.pack(">I", len(ts)) + ts)
    vido = (struct.pack(">I", 34) + b"VIDO" + b"RV20"
            + struct.pack(">HHHHHH", 32, 24, 12, 0, 0, 0) + b"\0" * 2
            + b"\x01\x02\x03\x04\x05\x06\x07\x08")
    pkts = []

    def pkt(snum, ts, payload, flags=2):
        pkts.append(struct.pack(">HHHIBB", 0, 12 + len(payload), snum, ts, 0,
                                flags) + payload)
    for k in range(4):
        frame = rng.integers(0, 256, 30 + k, np.uint8).tobytes()
        pkt(0, k * 80, bytes([0x40, k]) + frame)          # whole frame
        pkt(1, k * 80, rng.integers(0, 256, 20, np.uint8).tobytes(), 0)
    big = rng.integers(0, 256, 50, np.uint8).tobytes()     # split frame
    hdr = lambda typ, pos: (bytes([typ << 6, 9])
                            + struct.pack(">HH", 0x4000 + len(big),
                                          0x4000 + pos) + bytes([7]))
    pkt(0, 400, hdr(0, 0) + big[:30])
    pkt(0, 400, hdr(2, 20) + big[30:])
    data = _chunk(b"DATA", struct.pack(">II", len(pkts), 0) + b"".join(pkts))
    return (_chunk(b".RMF", struct.pack(">II", 0, 4))
            + _chunk(b"PROP", b"\0" * 40)
            + mdpr(0, b"video/x-pn-realvideo", vido)
            + mdpr(1, b"audio/x-pn-realaudio", _ra4())
            + data)


@pytest.fixture
def rm_file(tmp_path):
    p = tmp_path / "hand.rm"
    p.write_bytes(rm_bytes())
    return p


def test_rm_structure(rm_file):
    from gstreamer_tpu.elements import realmedia as jrm

    from gstreamer_tpu_torch.elements import realmedia as trm
    ref = jrm._parse_rm(str(rm_file))
    assert plain(trm._parse_rm(str(rm_file))) == plain(ref)
    streams, packets = ref
    assert sorted(s["mime"] for s in streams.values()) == \
        ["audio/x-pn-realaudio", "video/x-pn-realvideo"]
    assert len(packets) == 10
    for snum in (0, 1):
        pk = [(t, p) for s, t, _, p in packets if s == snum]
        assert plain(trm._assemble_video(pk)) == \
            plain(jrm._assemble_video(pk))


@pytest.mark.parametrize("stream", ["video", "audio", "1"])
def test_rmdemux_single(stream, rm_file):
    pair(f"rmdemux location={rm_file} stream={stream} ! appsink name=out",
         batch=4)


def test_rmdemux_multi(rm_file):
    pair(f"rmdemux name=d location={rm_file} d.video_0 ! appsink name=v "
         f"d.audio_0 ! appsink name=a", sinks=("v", "a"))


def test_rademux(tmp_path):
    p = tmp_path / "a.ra"
    p.write_bytes(_ra4(frame=20) + np.random.default_rng(3).integers(
        0, 256, 205, np.uint8).tobytes())
    pair(f"rademux location={p} ! appsink name=out")


def test_pnmsrc_redirects():
    _, _, tpipe, _ = pair("pnmsrc location=pnm://example.org/a.rm ! "
                          "appsink name=out")
    src = next(e for e in tpipe.iterate_elements() if e.FACTORY == "pnmsrc")
    assert src.redirect_location == "rtsp://example.org/a.rm"
