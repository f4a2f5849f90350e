"""The coded branches of the port's containers against the JAX package, bit
for bit: matroskamux's Vorbis and Theora encode-at-EOS modes, matroskademux's
A_VORBIS, V_THEORA and A_MPEG/L1-L3 tracks, avidemux's MP3 audio (tag
0x55), qtdemux's MP3 'mp4a' track (object type 0x6B), and uridecodebin,
decodebin and playbin on coded files (.ogg, .flac, .mp3 and a Theora +
Vorbis .mkv).

Files come from seeded numpy through both packages' writers (the same
bytes) or are built by hand around the system encoders' packets; every
reader runs in both packages on the same file: samples, caps, negotiation
and bus messages equal (``test_torch_captions.pair``), tolerance 0.  Video
stays at or under 320x240 and audio at or under 2 s.
"""

import os
import struct
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import audio_oracle as ao  # noqa: E402
import theora_oracle as to  # noqa: E402
from test_matroska_codecs import _mkv_audio  # noqa: E402
from test_mp3 import make_layer1_frames  # noqa: E402

from gstreamer_tpu.core.buffer import Buffer as JBuffer  # noqa: E402
from gstreamer_tpu.core.caps import Caps as JCaps  # noqa: E402
from gstreamer_tpu.core.element import element_factory_make as jmake  # noqa: E402
from gstreamer_tpu.core.parse import parse_launch as jparse  # noqa: E402
from gstreamer_tpu.elements import container_elements as jce  # noqa: E402
from gstreamer_tpu.elements import playback as jpb  # noqa: E402

import gstreamer_tpu_torch  # noqa: E402
from gstreamer_tpu_torch.codecs import vorbis_enc as tvenc  # noqa: E402
from gstreamer_tpu_torch.core.caps import Caps  # noqa: E402
from gstreamer_tpu_torch.core.element import element_factory_make as tmake  # noqa: E402
from gstreamer_tpu_torch.elements import container_elements as tce  # noqa: E402
from gstreamer_tpu_torch.elements import playback as tpb  # noqa: E402

from test_torch_captions import _run, drain, pair, sample_rows  # noqa: E402
from test_torch_file_formats import asrc, audio, write_both  # noqa: E402
from test_torch_mp3 import tone as tone16, twolame_encode  # noqa: E402
from test_torch_xiph import tone, vpushes, vsrc  # noqa: E402

needs_vorbis = pytest.mark.skipif(not ao.have_vorbis(),
                                  reason="system libvorbis missing")
needs_theora = pytest.mark.skipif(not to.have_theora(),
                                  reason="system libtheora missing")
needs_lame = pytest.mark.skipif(not ao.have_lame(),
                                reason="system libmp3lame missing")
tparse = gstreamer_tpu_torch.parse_launch
AV = "d.video_0 ! appsink name=v d.audio_0 ! appsink name=out"


def test_xiph_lacing():
    for pkts in ([b"a" * 3, b"b" * 255, b"c" * 700], [b"x"],
                 [b"", b"y" * 510, b"z"]):
        laced = tce._xiph_lace(pkts)
        assert laced == jce._xiph_lace(pkts)
        assert tce._parse_xiph_private(laced) == \
            jce._parse_xiph_private(laced) == pkts
    for mod in (tce, jce):
        with pytest.raises(ValueError, match="missing xiph CodecPrivate"):
            mod._parse_xiph_private(b"")


def av_pushes(w, h, n, batch, seed):
    """Seeded I420 frames and 48 kHz stereo S16 audio of the same length,
    a tick at a time."""
    v = vpushes(w, h, n, batch, seed)
    a = audio("S16LE", 2, 48000, 1920 * batch, len(v), seed)
    return {"in": v, "a": a}


def av_desc(modes, w, h):
    return (f"matroskamux name=m location={{loc}} {modes} ! fakesink "
            f"{vsrc(w, h)} ! m.video_0 {asrc('S16LE', 2, 48000, 'a')} ! "
            f"m.audio_0")


@needs_theora
@needs_vorbis
@pytest.mark.parametrize("modes", [
    "video-codec=theora audio-codec=vorbis",
    "video-codec=theora video-quality=20",
    "audio-codec=vorbis audio-quality=0.1"])
def test_matroskamux_coded_modes(modes, tmp_path):
    """The encode-at-EOS modes write the JAX package's file; matroskademux
    reads it back through both pads at once and one stream at a time."""
    path = write_both(av_desc(modes, 64, 48), av_pushes(64, 48, 6, 2, 1),
                      tmp_path, "mkv", batch=2)
    tracks, _, _ = tce._parse_matroska(str(path))
    assert [t["codec"] for t in tracks] == [
        t["codec"] for t in jce._parse_matroska(str(path))[0]]
    pair(f"matroskademux name=d location={path} {AV}", sinks=("v", "out"),
         batch=2)
    for kind in ("video", "audio"):
        pair(f"matroskademux location={path} stream={kind} ! "
             f"appsink name=out", batch=2)


@needs_theora
def test_matroskamux_mode_errors(tmp_path):
    """theora needs I420; Vorbis cannot join coded video: the same errors."""
    cases = [
        (f"matroskamux name=m location={{loc}} video-codec=theora ! fakesink "
         f"appsrc name=in caps=video/x-raw,format=YUY2,width=32,height=32,"
         f"framerate=25/1 ! m.video_0", "theora needs I420"),
        (f"matroskamux name=m location={{loc}} audio-codec=vorbis ! fakesink "
         f"appsrc name=in caps=video/x-h264,stream-format=byte-stream,"
         f"alignment=au,width=32,height=32,framerate=25/1 ! m.video_0 "
         f"{asrc('S16LE', 2, 48000, 'a')} ! m.audio_0", "cannot combine")]
    for desc, msg in cases:
        for parse, kw, loc in ((gstreamer_tpu_torch.parse_launch,
                                {"device": "cpu"}, tmp_path / "t.mkv"),
                               (jparse, {}, tmp_path / "j.mkv")):
            with pytest.raises(ValueError, match=msg):
                parse(desc.format(loc=loc), **kw).compile()


@needs_vorbis
def test_mkv_vorbis_track_from_packets(tmp_path):
    """A hand-built A_VORBIS track (the encoder's packets, its three headers
    xiph-laced in CodecPrivate): the same float32 PCM."""
    hdrs, pkts = tvenc.encode_packets(tone(44100, 2, 1.0, 2), 44100)
    path = tmp_path / "v.mkv"
    _mkv_audio(path, "A_VORBIS", jce._xiph_lace(hdrs), 44100, 2,
               [(0, p) for p, _ in pkts])
    pair(f"matroskademux location={path} stream=audio ! appsink name=out")


def mp3_blobs():
    """Layer III (libmp3lame), Layer II (libtwolame) and Layer I
    (hand-built) streams, by the Matroska codec id that carries them."""
    out = {"A_MPEG/L1": make_layer1_frames(6)}
    if ao.have_lame():
        out["A_MPEG/L3"] = ao.lame_encode(tone16(44100, 2, 1.0, 4), 44100)
    l2 = twolame_encode(tone16(48000, 2, 0.5, 5), 48000, 192)
    if l2 is not None:
        out["A_MPEG/L2"] = l2
    return out


@pytest.mark.parametrize("codec", ["A_MPEG/L3", "A_MPEG/L2", "A_MPEG/L1"])
def test_mkv_mpeg_audio_tracks(codec, tmp_path):
    blob = mp3_blobs().get(codec)
    if blob is None:
        pytest.skip("the system encoder for this layer is missing")
    path = tmp_path / "m.mkv"
    _mkv_audio(path, codec, b"", 44100, 2, [(0, blob[:len(blob) // 2]),
                                            (0, blob[len(blob) // 2:])])
    pair(f"matroskademux location={path} stream=audio ! appsink name=out")
    pair(f"matroskademux name=d location={path} d.audio_0 ! "
         f"appsink name=out")


def avi_mp3(path, blob, rate):
    """A one-stream AVI whose audio is WAVE_FORMAT_MPEGLAYER3 (0x55) in
    ##wb chunks (the JAX package's test layout)."""
    strh = (b"auds" + b"\x00" * 16 + struct.pack("<II", 1, rate)
            + b"\x00" * 4 + struct.pack("<I", len(blob)) + b"\x00" * 20)
    strf = struct.pack("<HHIIHH", 0x55, 2, rate, rate * 16000 // 8, 1, 16)
    strl = (b"strh" + struct.pack("<I", len(strh)) + strh
            + b"strf" + struct.pack("<I", len(strf)) + strf)
    hdrl = (b"hdrl" + b"LIST" + struct.pack("<I", 4 + len(strl)) + b"strl"
            + strl)
    if len(blob) & 1:
        blob += b"\x00"
    half = len(blob) // 2 & ~1
    movi = b"movi"
    for part in (blob[:half], blob[half:]):
        movi += b"00wb" + struct.pack("<I", len(part)) + part
    body = (b"AVI " + b"LIST" + struct.pack("<I", len(hdrl)) + hdrl
            + b"LIST" + struct.pack("<I", len(movi)) + movi)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


@needs_lame
def test_avidemux_mp3_audio(tmp_path):
    path = tmp_path / "m.avi"
    avi_mp3(path, ao.lame_encode(tone16(44100, 2, 1.0, 6), 44100), 44100)
    _, _, _, out = pair(f"avidemux location={path} stream=audio ! "
                        f"appsink name=out")
    assert out["out"] and out["out"][0].buffer.data.dtype == torch.float32


@needs_lame
def test_qtdemux_mp3_track(tmp_path):
    """An 'mp4a' track whose esds names MPEG-1 audio (object type 0x6B):
    qtmux writes the frames as AAC access units, the object type is
    patched, and qtdemux decodes the frames as MP3 in both packages."""
    blob = ao.lame_encode(tone16(48000, 2, 0.5, 8), 48000)
    from gstreamer_tpu_torch.codecs.mp3 import _find_frames
    frames = [np.frombuffer(f, np.uint8).copy() for f, _ in
              _find_frames(blob)]
    desc = ("qtmux name=m location={loc} ! fakesink appsrc name=a caps="
            "audio/mpeg,mpegversion=4,stream-format=raw,rate=48000,"
            "channels=2 ! m.audio_0")
    pushes = {"a": [dict(data=frames[k:k + 4], batch=len(frames[k:k + 4]),
                         pts=k * 24_000_000, duration=24_000_000)
                    for k in range(0, len(frames), 4)]}
    path = write_both(desc, pushes, tmp_path, "mov")
    raw = bytearray(path.read_bytes())
    at = raw.index(b"esds")
    dcd = raw.index(b"\x04", at + 12)
    assert raw[dcd + 2] == 0x40
    raw[dcd + 2] = 0x6B
    mp3mov = tmp_path / "mp3.mov"
    mp3mov.write_bytes(bytes(raw))
    _, _, _, out = pair(f"qtdemux location={mp3mov} stream=audio ! "
                        f"appsink name=out")
    assert str(out["out"][0].caps).startswith("audio/x-raw")


def test_decoder_for_caps_mpeg_audio():
    """decodebin's decoder table now holds mpg123audiodec in the port."""
    s = "audio/mpeg, mpegversion=1"
    assert tpb._decoder_for_caps(Caps.from_string(s)) == \
        jpb._decoder_for_caps(JCaps.from_string(s)) == "mpg123audiodec"


@pytest.fixture(scope="module")
def coded_files(tmp_path_factory):
    """One file of each coded kind, written by the JAX package."""
    tmp = tmp_path_factory.mktemp("coded")
    from gstreamer_tpu.codecs import flac as jflac
    from gstreamer_tpu.codecs import vorbis_enc as jvenc
    files = {}
    x16 = tone16(48000, 2, 1.0, 11)
    files["flac"] = tmp / "a.flac"
    files["flac"].write_bytes(jflac.encode(x16.astype(np.int64), 48000))
    if ao.have_vorbis():
        files["ogg"] = tmp / "v.ogg"
        files["ogg"].write_bytes(jvenc.encode_ogg(tone(48000, 2, 1.0, 12),
                                                  48000))
    if ao.have_lame():
        files["mp3"] = tmp / "a.mp3"
        files["mp3"].write_bytes(ao.lame_encode(x16, 48000))
    if ao.have_vorbis() and to.have_theora():
        files["mkv"] = tmp / "av.mkv"
        _run(jparse, JBuffer, av_desc(
            "video-codec=theora audio-codec=vorbis", 96, 64).format(
                loc=files["mkv"]), av_pushes(96, 64, 6, 2, 13), (), 2, None)
    return files


def _need(files, key):
    if key not in files:
        pytest.skip(f"the system encoder for .{key} is missing")
    return files[key]


@pytest.mark.parametrize("key", ["flac", "ogg", "mp3", "mkv"])
@pytest.mark.parametrize("factory", ["uridecodebin", "decodebin"])
def test_uridecodebin_coded_files(key, factory, coded_files):
    """typefind's route for each coded file: the same samples and caps."""
    path = _need(coded_files, key)
    pair(f"{factory} uri=file://{path} ! appsink name=out", batch=2)


def test_uridecodebin_theora_vorbis_mkv(coded_files):
    """Both tracks of the coded .mkv through uridecodebin's pads, video to
    RGB through the converter and audio as it decodes."""
    path = _need(coded_files, "mkv")
    pair(f"uridecodebin name=d uri=file://{path} d.video_0 ! "
         f"videoconvertscale add-borders=false ! video/x-raw,format=RGB,"
         f"width=48,height=32 ! appsink name=v d.audio_0 ! appsink name=out",
         sinks=("v", "out"), batch=2)


@pytest.mark.parametrize("key", ["flac", "ogg", "mp3", "mkv"])
def test_playbin_coded_files(key, coded_files):
    """playbin's single-stream build over each coded file."""
    path = _need(coded_files, key)
    rows = {}
    for k, make in (("j", jmake), ("t", tmake)):
        pb = make("playbin", uri=f"file://{path}")
        if k == "t":
            pb.device = torch.device("cpu")
        pipe, sink = pb.build_pipeline()
        pipe.run()
        rows[k] = sample_rows(drain(sink))
    assert rows["t"] == rows["j"] and rows["t"]
