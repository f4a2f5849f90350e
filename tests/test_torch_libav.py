"""The port's libav family against the JAX package: ``native/av.py`` and
``elements/libav.py`` (every avdec_* / avenc_* factory, x264enc, x265enc,
mpeg2enc, the audio wrappers and aptX), decodebin's coded routes after
tsdemux, and Ogg-Speex.

The cases are parametrised over the port's own copies of the tables,
filtered by the port's ``have_codec``: the count does not depend on the
JAX package's in-place build of its shim, which a test worker can lose to
another (``gstreamer_tpu/native/_build.py`` writes the library where it
loads it).  The ``jax_av`` fixture serialises that build with a lock file
and loads the JAX shim again where it failed, so a parity case fails, and
does not skip, when the reference cannot load.

Every decoder gets packets that the system encoder of its codec wrote from
seeded frames (seeded bytes where libavcodec has no encoder: wmv3, rv30,
rv40, dca, AMR, RealAudio 2.0, Cook, SIPR, ATRAC3); every encoder gets
seeded frames or PCM.  Both packages run the same launch string on the
same pushes (``test_torch_captions.pair``): samples, caps and bus messages
equal, tolerance 0.  The encoders are compared byte for byte: the JAX
package's encoders give the same bytes on two runs in one process
(``test_reference_encoders_are_deterministic``).  The JAX package's
``tests/test_libav.py`` runs again on the port (``on_port``), its
discoverer case too, with the aptX cases of ``tests/test_siren.py``.
"""

import fcntl
import importlib
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from gstreamer_tpu.core import element as jelement
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.parse import parse_launch as jparse
from gstreamer_tpu.elements import libav as jlibav
from gstreamer_tpu.elements import ogg as jogg
from gstreamer_tpu.elements import playback as jpb
from gstreamer_tpu.native import av as jav

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core import element as telement
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.elements import libav as tlibav
from gstreamer_tpu_torch.elements import playback as tpb
from gstreamer_tpu_torch.native import av as tav

import test_fec
import test_libav
import test_multistream_demux
import test_rtp_codecs
import test_siren
from test_torch_analytics import same_spec
from test_torch_captions import _run, pair, vsrc
from test_torch_flx import sha, vectors
from test_torch_mpegts import pair_deep
from test_torch_rtp import run_on_port
from test_torch_webrtc import _skip_marks, reference_cases

W, H, N = 64, 48, 4
DUR = 40_000_000
LOCK = os.path.join(tempfile.gettempdir(), "gstreamer_tpu_av_build.lock")


def load_jax_av():
    """The JAX package's av shim loaded and its libav factories
    registered: its first build runs under a lock file, and a load that
    failed (a half-written library of another worker) is tried again."""
    with open(LOCK, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for _ in range(5):
                if jav.get_lib() is not None:
                    break
                jav._tried = False
                time.sleep(1)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    assert jav.available(), "the JAX package's libavcodec shim did not load"
    jelement._ensure_elements_loaded()
    if not any(c.__module__ == jlibav.__name__
               for c, _rank in jelement._REGISTRY.values()):
        importlib.reload(jlibav)
    # the decoder aliases register over what libav registered at their
    # import: again where the libav factories came late
    from gstreamer_tpu.elements import aliases as jaliases
    for alias, base, register in (
            ("dvdec", "avdec_dvvideo", jaliases._register_dvdec),
            ("av1dec", "avdec_av1", jaliases._register_av1dec)):
        if base in jelement._REGISTRY and alias not in jelement._REGISTRY:
            register()
    telement._ensure_elements_loaded()


@pytest.fixture(scope="module")
def jax_av():
    load_jax_av()


def _have(entry, encoder):
    return tav.available() and tav.have_codec(entry[1], encoder=encoder)


VIDEO_DEC = [e[0] for e in tlibav._DECODERS if _have(e, False)]
AUDIO_DEC = [e[0] for e in tlibav._AUDIO_DECODERS if _have(e, False)]
VIDEO_ENC = [e[0] for e in tlibav._ENCODERS if _have(e, True)] + (
    ["mpeg2enc"] if tav.available() and tav.have_codec(
        "mpeg2video", encoder=True) else [])
AUDIO_ENC = [e[0] for e in tlibav._AUDIO_ENCODERS if _have(e, True)]
APTX = (["openaptxdec", "openaptxenc", "avdec_aptx", "avdec_aptx_hd"]
        if tav.available() and tav.have_codec("aptx") else [])
FACTORIES = VIDEO_DEC + AUDIO_DEC + VIDEO_ENC + AUDIO_ENC + APTX

# the system encoder (and its options) that writes each decoder's input
VIDEO_SOURCE = {
    "h264": ("libx264", "preset=veryfast:tune=zerolatency"),
    "hevc": ("libx265",
             "preset=veryfast:tune=zerolatency:x265-params=log-level=none"),
    "libdav1d": ("libaom-av1", "usage=realtime:cpu-used=8"),
    "vp8": ("libvpx", "deadline=1:lag-in-frames=0"),
    "vp9": ("libvpx-vp9", "deadline=1:lag-in-frames=0"),
    "webp": ("libwebp", ""), "ffv1": ("ffv1", ""),
    "mpeg2video": ("mpeg2video", ""), "mpeg4": ("mpeg4", ""),
    "wmv1": ("wmv1", ""), "wmv2": ("wmv2", ""), "rv10": ("rv10", ""),
    "rv20": ("rv20", ""), "dvvideo": ("dvvideo", "")}
# (encoder, rate, channels) of each audio decoder's input
AUDIO_SOURCE = {
    "ac3": ("ac3", 48000, 2), "eac3": ("eac3", 48000, 2),
    "wmav2": ("wmav2", 44100, 2), "libopus": ("libopus", 48000, 2),
    "sbc": ("sbc", 44100, 2), "libspeex": ("libspeex", 16000, 1),
    "wavpack": ("wavpack", 44100, 2), "libgsm": ("libgsm", 8000, 1),
    "real_144": ("real_144", 8000, 1)}
# the video codecs whose encoder's packets decode to frames as they are
# (the RealVideo decoders want RealMedia's slice layout, which rmdemux
# gives: raw packets raise alike in both packages)
DECODED = ("h264", "hevc", "libdav1d", "vp8", "vp9", "webp", "ffv1",
           "mpeg2video", "mpeg4", "wmv1", "wmv2", "dvvideo")
# the raw input each audio encoder takes
AUDIO_RAW = {"libspeex": (16000, 1), "libgsm": (8000, 1), "sbc": (44100, 2),
             "real_144": (8000, 1)}


def entry(table, factory):
    return next(e for e in table if e[0] == factory)


def launch_caps(caps, **fields):
    """The first structure of a template's caps, with `fields`, as a
    launch-string caps value."""
    s = caps.split(";")[0].replace(" ", "")
    return ",".join([s] + [f"{k}={v}" for k, v in fields.items()])


def frames(seed, w=W, h=H, n=N):
    """Seeded I420 frames: a random picture panning right, flat chroma
    that changes each frame."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (h, w), np.uint8)
    return [(np.roll(y, 2 * k, 1), np.full((h // 2, w // 2), 90 + 7 * k,
                                           np.uint8),
             np.full((h // 2, w // 2), 160 - 5 * k, np.uint8))
            for k in range(n)]


def tone(rate, ch, n, seed=0):
    """Seeded float PCM (n, ch): two tones and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(
        2 * np.pi * 1250 * t)
    return (x[:, None] + 0.02 * rng.standard_normal((n, ch))).astype(
        np.float32)


def seeded_blobs(seed, n=6, lo=20, hi=600):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8)
            for _ in range(n)]


def blob_pushes(blobs, meta, group=1):
    """One push of `group` blobs (a list when more than one) at a time."""
    out = []
    for k in range(0, len(blobs), group):
        part = blobs[k:k + group]
        out.append(dict(data=part if len(part) > 1 else part[0],
                        pts=k * DUR, duration=DUR, meta=dict(meta)))
    return out


def video_packets(codec, seed):
    """(packets, extradata, width, height) from the system encoder of
    `codec`, or seeded bytes where there is none."""
    enc_name, opts = VIDEO_SOURCE.get(codec, (None, ""))
    if enc_name is None or not tav.have_codec(enc_name, encoder=True):
        return [bytes(b) for b in seeded_blobs(seed)], b"", W, H
    w, h = (720, 576) if codec == "dvvideo" else (W, H)
    n = 2 if codec == "dvvideo" else N
    enc = tav.AvVideoEncoder(enc_name, w, h, (25, 1), 300000, opts,
                             global_header=codec == "ffv1")
    pkts = []
    for f in frames(seed, w, h, n):
        pkts += [p for p, _key in enc.encode(f)]
    pkts += [p for p, _key in enc.flush()]
    return pkts, enc.extradata(), w, h


def audio_packets(codec, seed):
    """(packets, extradata, rate, channels) from the system encoder of
    `codec`, or seeded bytes where there is none."""
    src = AUDIO_SOURCE.get(codec)
    if src is None or not tav.have_codec(src[0], encoder=True):
        return [bytes(b) for b in seeded_blobs(seed)], b"", 48000, 2
    name, rate, ch = src
    enc = tav.AvAudioEncoder(name, rate, ch, 0)
    return (enc.encode_all(tone(rate, ch, rate // 5, seed)), enc.extradata(),
            rate, ch)


def pair_or_error(desc, pushes):
    """``pair``, or where the JAX package raises (a decoder that will not
    open on seeded bytes without its extradata), the same error class and
    text from the port.  Returns the JAX samples, or None."""
    try:
        _run(jparse, JBuffer, desc, pushes, ("out",), 1, None)
    except Exception as e:                  # noqa: BLE001 (compared)
        with pytest.raises(type(e)) as got:
            _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, pushes,
                 ("out",), 1, None, device="cpu")
        assert str(got.value) == str(e)
        return None
    return pair(desc, pushes)[1]


def test_tables_are_the_references():
    for name in ("_DECODERS", "_AUDIO_DECODERS", "_ENCODERS",
                 "_AUDIO_ENCODERS", "_H264_CAPS", "_H265_CAPS"):
        assert getattr(tlibav, name) == getattr(jlibav, name), name


@pytest.mark.parametrize("encoder", [False, True])
def test_have_codec_matches(jax_av, encoder):
    names = sorted({e[1] for t in (tlibav._DECODERS, tlibav._AUDIO_DECODERS,
                                   tlibav._ENCODERS, tlibav._AUDIO_ENCODERS)
                    for e in t} | {"aptx", "aptx_hd", "nonexistent"})
    assert [tav.have_codec(n, encoder) for n in names] == \
        [jav.have_codec(n, encoder) for n in names]


def test_available_is_explicit():
    """The port's condition: g++, libavcodec's headers and the libraries to
    link; all present here, so the shim builds and loads (a failed build
    would raise)."""
    assert tav.missing() is None
    assert tav.available() and tav.get_lib() is not None


def test_registration_matches(jax_av):
    def av(reg):
        return sorted(f for f, (c, _r) in reg.items()
                      if c.__module__.endswith(".elements.libav"))
    assert av(telement._REGISTRY) == av(jelement._REGISTRY) == \
        sorted(FACTORIES)
    assert len(FACTORIES) == len(set(FACTORIES))


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_spec_matches(jax_av, factory):
    same_spec(factory)


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("factory", VIDEO_DEC)
def test_video_decoder_matches(jax_av, factory, group):
    """Decoded I420 frames, timestamps and caps, from the system
    encoder's packets, one blob a push or three (a list)."""
    _f, codec, caps, _d = entry(tlibav._DECODERS, factory)
    pkts, extra, w, h = video_packets(codec, 11)
    meta = {"codec_data": extra} if extra else {}
    desc = (f"appsrc name=in caps={launch_caps(caps, width=w, height=h)}"
            f",framerate=25/1 ! {factory} ! appsink name=out")
    blobs = [np.frombuffer(p, np.uint8) for p in pkts]
    ref = pair_or_error(desc, {"in": blob_pushes(blobs, meta, group)})
    if codec in DECODED:
        assert sum(s.buffer.batch for s in ref["out"]) >= 1


@pytest.mark.parametrize("factory", AUDIO_DEC)
def test_audio_decoder_matches(jax_av, factory):
    """Decoded F32 PCM, timestamps and caps from the system encoder's
    packets (seeded bytes where there is no encoder)."""
    _f, codec, caps, _d = entry(tlibav._AUDIO_DECODERS, factory)
    pkts, extra, rate, ch = audio_packets(codec, 12)
    meta = {"rate": rate, "channels": ch,
            "block_align": len(pkts[0]) if codec == "wmav2" else 0}
    if extra:
        meta["codec_data"] = extra
    desc = (f"appsrc name=in caps={launch_caps(caps, rate=rate, channels=ch)}"
            f" ! {factory} ! appsink name=out")
    blobs = [np.frombuffer(p, np.uint8) for p in pkts]
    ref = pair_or_error(desc, {"in": blob_pushes(blobs, meta, 2)})
    if codec in AUDIO_SOURCE:
        assert sum(s.buffer.data.shape[0] for s in ref["out"]) > 0


@pytest.mark.parametrize("factory", VIDEO_ENC)
def test_video_encoder_bytes_match(jax_av, factory):
    """The coded bytes, keyframe-free metas (codec_data) and timestamps
    byte for byte, two ticks of two seeded frames each."""
    planes = frames(21)
    pushes = [dict(data=tuple(np.stack([f[c] for f in planes[k:k + 2]])
                              for c in range(3)),
                   pts=k * DUR, duration=DUR, batch=2)
              for k in range(0, N, 2)]
    _, ref, _, _ = pair(f"{vsrc(W, H)} ! {factory} bitrate=300 ! "
                        "appsink name=out", {"in": pushes}, batch=2)
    assert ref["out"]


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
@pytest.mark.parametrize("factory", AUDIO_ENC)
def test_audio_encoder_bytes_match(jax_av, factory, fmt):
    """Packets byte for byte from seeded PCM in 1 000-frame pushes (the
    tail zero-padded at end of stream)."""
    codec = entry(tlibav._AUDIO_ENCODERS, factory)[1]
    rate, ch = AUDIO_RAW.get(codec, (48000, 2))
    x = tone(rate, ch, rate // 4, 31)
    if fmt == "S16LE":
        x = np.round(x * 32767).astype(np.int16)
    pushes = [dict(data=x[k:k + 1000], pts=k * 1_000_000_000 // rate,
                   duration=len(x[k:k + 1000]) * 1_000_000_000 // rate)
              for k in range(0, len(x), 1000)]
    desc = (f"appsrc name=in caps=audio/x-raw,format={fmt},rate={rate},"
            f"channels={ch},layout=interleaved ! {factory} ! "
            "appsink name=out")
    _, ref, _, _ = pair(desc, {"in": pushes})
    assert ref["out"]


@pytest.mark.parametrize("hd", [False, True])
def test_aptx_pair_matches(jax_av, hd):
    """openaptxenc (hd=false / true) to openaptxdec and to the
    avdec_aptx name of its variant: bytes and PCM."""
    if not APTX:
        pytest.skip("the system libavcodec has no aptX")
    x = np.round(tone(48000, 2, 9000, 41) * 32767).astype(np.int16)
    pushes = {"in": [dict(data=x[k:k + 3000], pts=k * 20833,
                          duration=3000 * 20833)
                     for k in range(0, len(x), 3000)]}
    src = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
           "channels=2,layout=interleaved ! openaptxenc hd="
           f"{'true' if hd else 'false'}")
    pair(f"{src} ! appsink name=out", pushes)
    dec = "avdec_aptx_hd" if hd else "avdec_aptx"
    for d in ("openaptxdec", dec):
        _, ref, _, _ = pair(f"{src} ! {d} ! appsink name=out", pushes)
        assert sum(s.buffer.data.shape[0] for s in ref["out"]) > 0


def test_reference_encoders_are_deterministic(jax_av):
    """Two runs of each JAX encoder in one process give the same bytes
    (so the encoder cases compare bytes, not decoded frames)."""
    planes = frames(5)
    for f in VIDEO_ENC:
        if f == "mpeg2enc":
            continue
        _f, codec, _c, _d, opts = entry(jlibav._ENCODERS, f)[:5]
        gh = len(entry(jlibav._ENCODERS, f)) > 5
        runs = []
        for _ in range(2):
            enc = jav.AvVideoEncoder(codec, W, H, (25, 1), 300000, opts,
                                     global_header=gh)
            pk = [p for fr in planes for p, _k in enc.encode(fr)]
            runs.append(pk + [p for p, _k in enc.flush()])
        assert runs[0] == runs[1], f


def test_native_video_decoder_matches():
    """AvVideoDecoder of both packages on the same H.264 packets, and the
    decode error both raise on a broken packet."""
    pkts, _extra, _w, _h = video_packets("h264", 3)
    planes = []
    for mod in (tav, jav):
        dec = mod.AvVideoDecoder("h264")
        got = [f for p in pkts for f in dec.decode(p)] + dec.flush()
        planes.append([[a.tobytes() for a in f] for f in got])
    assert planes[0] == planes[1] and len(planes[0]) == N


def test_native_audio_decoder_resize_matches():
    """The capacity regrowth path (a 16-float buffer) gives the same PCM
    in both packages."""
    enc = tav.AvAudioEncoder("libmp3lame", 48000, 2, 128000)
    pkts = enc.encode_all(tone(48000, 2, 4800))
    got = []
    for mod in (tav, jav):
        dec = mod.AvAudioDecoder("mp3")
        dec._buf = np.empty(16, np.float32)
        out = [c for p in pkts for c in dec.decode(p)] + dec.flush()
        got.append(np.concatenate(out))
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("writer", ["asf", "mxf"])
def test_file_writers_and_probe_match(tmp_path, writer):
    """write_asf / write_mxf (test-input makers) and probe of what they
    wrote: the same streams in both packages."""
    t, j = tmp_path / f"t.{writer}", tmp_path / f"j.{writer}"
    assert getattr(tav, f"write_{writer}")(str(t), 160, 120, 10)
    assert getattr(jav, f"write_{writer}")(str(j), 160, 120, 10)
    assert tav.probe(str(t)) == jav.probe(str(j)) == tav.probe(str(j))
    assert tav.probe(str(tmp_path / "none")) is None


# -- decodebin's coded routes after tsdemux -------------------------------

TS_ROUTES = {
    "h264": ("x264enc", "avdec_h264"),
    "h265": ("x265enc", "avdec_h265"),
    "mpeg2": ("avenc_mpeg2video", "avdec_mpeg2video"),
}


def write_ts(path, enc):
    """Five seeded frames through `enc` into an MPEG-TS, by the JAX
    package."""
    pushes = [dict(data=tuple(f[c][None] for c in range(3)), pts=k * DUR,
                   duration=DUR) for k, f in enumerate(frames(7, n=5))]
    p = jparse(f"{vsrc(W, H, rate='25/1')} ! {enc} ! "
               f"mpegtsmux location={path}")
    src = p.get_by_name("in")
    for b in pushes:
        src.push_buffer(JBuffer(**b))
    src.end_of_stream()
    p.run()


@pytest.mark.parametrize("route", sorted(TS_ROUTES))
def test_decodebin_ts_route_matches(jax_av, tmp_path, route):
    """decodebin on an MPEG-TS splices the libav decoder in after tsdemux
    in both packages: the same frames, caps and timestamps."""
    enc, dec = TS_ROUTES[route]
    path = tmp_path / f"{route}.ts"
    write_ts(path, enc)
    caps = tpb.element_factory_make("tsdemux", location=str(path)).get_caps()
    assert tpb._decoder_for_caps(caps) == dec == jpb._decoder_for_caps(
        jelement.element_factory_make("tsdemux",
                                      location=str(path)).get_caps())
    _, ref, _, _ = pair(f"decodebin uri=file://{path} ! appsink name=out")
    assert sum(s.buffer.batch for s in ref["out"]) == 5


def test_decodebin_ac3_route_matches(jax_av, tmp_path):
    """An AC-3 elementary stream in MPEG-TS: decodebin appends a52dec in
    both packages; tsdemux ! ac3parse ! a52dec gives the same PCM."""
    path = tmp_path / "a.ts"
    p = jparse("audiotestsrc num-buffers=8 samplesperbuffer=4096 ! "
               f"avenc_ac3 ! mpegtsmux location={path}")
    p.run()
    caps = tpb.element_factory_make("tsdemux", location=str(path)).get_caps()
    assert tpb._decoder_for_caps(caps) == "a52dec"
    pair(f"decodebin uri=file://{path} ! appsink name=out")
    _, ref, _, _ = pair_deep(f"tsdemux location={path} ! ac3parse ! a52dec "
                             "! appsink name=out")
    assert sum(s.buffer.data.shape[0] for s in ref["out"]) > 20000


# -- Ogg-Speex ------------------------------------------------------------

def write_ogg_speex(path, seconds=1.0, seed=0):
    """A libspeex stream in Ogg (the Speex header from the encoder's
    extradata, a comment packet, then one frame a page)."""
    rate = 16000
    enc = tav.AvAudioEncoder("libspeex", rate, 1)
    pkts = enc.encode_all(tone(rate, 1, int(rate * seconds), seed))
    pages = [jogg.ogg_page([enc.extradata()], 7, 0, 0, bos=True),
             jogg.ogg_page([b"\x00" * 8], 7, 1, 0)]
    g = 0
    for i, pk in enumerate(pkts):
        g += 320
        pages.append(jogg.ogg_page([pk], 7, 2 + i, g,
                                   eos=i == len(pkts) - 1))
    path.write_bytes(b"".join(pages))


@pytest.mark.parametrize("seconds", [0.25, 1.0])
def test_ogg_speex_matches(jax_av, tmp_path, seconds):
    path = tmp_path / "s.spx"
    write_ogg_speex(path, seconds, 3)
    _, ref, _, _ = pair(f"oggdemux location={path} ! appsink name=out")
    assert sum(s.buffer.data.shape[0] for s in ref["out"]) > \
        16000 * seconds * 0.7


# -- where the system libavcodec lacks a codec, or is absent ---------------

def test_missing_codec_registers_nothing(jax_av, monkeypatch, tmp_path):
    """With have_codec False, neither package's libav module registers a
    factory; decodebin on an H.264 TS then passes the coded stream on in
    the JAX package and raises naming the codec in the port."""
    for el, mod, av in ((jelement, jlibav, jav), (telement, tlibav, tav)):
        made = []
        monkeypatch.setattr(el, "register_element", made.append)
        monkeypatch.setattr(av, "have_codec", lambda *a, **k: False)
        importlib.reload(mod)
        assert made == []
        monkeypatch.undo()
    path = tmp_path / "v.ts"
    write_ts(path, "x264enc")
    monkeypatch.delitem(jelement._REGISTRY, "avdec_h264")
    monkeypatch.delitem(telement._REGISTRY, "avdec_h264")
    monkeypatch.setattr(tav, "have_codec", lambda *a, **k: False)
    p = jparse(f"decodebin uri=file://{path} ! appsink name=out")
    p.run()
    s = p.get_by_name("out").pull_sample()
    assert s.caps[0].name == "video/x-h264"
    with pytest.raises(RuntimeError,
                       match="system libavcodec has no 'h264' decoder"):
        gstreamer_tpu_torch.parse_launch(
            f"decodebin uri=file://{path} ! appsink name=out",
            device="cpu").run()
    with pytest.raises(RuntimeError, match="'h264' decoder"):
        tpb._decoder_for_caps(Caps.from_string("video/x-h264"))
    assert jpb._decoder_for_caps(JCaps.from_string("video/x-h264")) is None


def test_absent_libavcodec_raises_as_the_reference(monkeypatch, tmp_path):
    """A machine without libavcodec's development files (the card's): the
    port's available() is False, no factory can register, Ogg-Speex raises
    the JAX package's error and the decoder's error names what is
    missing."""
    path = tmp_path / "s.spx"
    write_ogg_speex(path)
    why = "no libavcodec headers (libavcodec/avcodec.h)"
    monkeypatch.setattr(tav, "missing", lambda: why)
    monkeypatch.setattr(tav, "_lib", None)
    monkeypatch.setattr(jav, "get_lib", lambda: None)
    assert not tav.available() and not tav.have_codec("h264")
    errors = []
    for parse, kw in ((jparse, {}), (gstreamer_tpu_torch.parse_launch,
                                     {"device": "cpu"})):
        with pytest.raises(RuntimeError) as e:
            parse(f"oggdemux location={path} ! appsink name=out",
                  **kw).run()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "av: libavcodec shim unavailable"
    assert tlibav.why_missing("avdec_h264") == (
        f"the system libavcodec is missing ({why}), so no libav factory "
        "registers")


# -- the JAX package's own tests, on the port --------------------------------



def gated(module, exclude=()):
    """The cases of a JAX test module under a ``skipif`` mark (its libav
    ones), which the port's file for that module leaves out."""
    return [c for c in reference_cases(module, exclude=exclude)
            if _skip_marks(module, c[3], getattr(module, c[2]) if c[2]
                           else None)]


REFERENCE = reference_cases(test_libav) + \
    reference_cases(test_siren, only=("TestAptx",)) + gated(test_fec) + \
    gated(test_rtp_codecs) + gated(test_multistream_demux, exclude=(
        "test_qtdemux_one_parse_av",))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(jax_av, case, tmp_path, monkeypatch):
    """Each case on the port's modules; their ``needs_av`` marks read the
    JAX shim, so the port's availability decides here."""
    if not tav.available():
        pytest.skip(f"the system libavcodec is missing ({tav.missing()})")
    _id, _module, _cls, fn, names, values = case
    run_on_port(fn, names, values, tmp_path, monkeypatch=monkeypatch)



def test_committed_vectors_match_digests():
    """h264_1080p.ts through the port's tsdemux ! h264parse ! avdec_h264
    and speex_16k.spx through its oggdemux on the CPU give the JAX
    package's committed digests, which the card is held to where it has
    libavcodec."""
    d, dig, cs = vectors()
    cpu = torch.device("cpu")
    frames = cs.ct_planes(cs.codec_run(
        f"tsdemux location={d / 'h264_1080p.ts'} ! h264parse ! avdec_h264 ! "
        "appsink name=a", cpu, 4, "a"))
    assert [sha([np.ascontiguousarray(p).tobytes() for p in f])
            for f in frames] == dig["h264_ts"]
    pcm = np.concatenate([s.buffer.data.numpy() for s in cs.codec_run(
        f"oggdemux location={d / 'speex_16k.spx'} ! appsink name=a", cpu, 1,
        "a")])
    want = dig["speex_ogg"]
    assert pcm.shape == (want["frames"], want["channels"])
    assert pcm[want["positions"]].astype("<f4").tobytes().hex() == \
        want["values"]


def test_qtdemux_one_parse_av_on_the_port(tmp_path, monkeypatch):
    """tests/test_multistream_demux.py's one-parse case, its spy set on the
    port's isomp4 (``on_port`` hands a test a wrapper of the module, which
    a monkeypatch does not reach): one moov parse drives the H.264 and AAC
    branches."""
    from gstreamer_tpu_torch.elements import isomp4
    path = tmp_path / "av.mp4"
    gstreamer_tpu_torch.parse_launch(
        f"cmafmux name=m location={path} ! fakesink "
        "videotestsrc num-buffers=6 ! "
        "video/x-raw,format=I420,width=64,height=48,framerate=30/1 ! "
        "x264enc ! m.video_0 audiotestsrc num-buffers=6 "
        "samplesperbuffer=4096 ! avenc_aac ! m.audio_0", device="cpu").run()
    parses = []
    orig = isomp4._parse_qt
    monkeypatch.setattr(isomp4, "_parse_qt",
                        lambda *a, **k: parses.append(1) or orig(*a, **k))
    d = gstreamer_tpu_torch.parse_launch(
        f"qtdemux name=d location={path} d.video_0 ! avdec_h264 ! appsink "
        "name=v d.audio_0 ! appsink name=a", device="cpu")
    d.run()
    v = list(iter(d.get_by_name("v").pull_sample, None))
    assert sum(s.buffer.batch for s in v) == 6
    assert list(iter(d.get_by_name("a").pull_sample, None))
    assert len(parses) == 1
