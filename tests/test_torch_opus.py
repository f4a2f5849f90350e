"""The port's Opus decoder against the JAX package, bit for bit: the range
decoder and the PVQ codewords (``codecs/celt.py``), the CELT, SILK and
hybrid paths of ``HybridOpusDecoder`` with in-band FEC and concealment
(``codecs/opus.py``, ``codecs/silk.py``), the native shims
(``native/celt.py``, ``native/silk.py``) and the pure-Python paths behind
their switches, Ogg-Opus (``encode_ogg``, ``decode_ogg``, the OpusHead), and
the elements opusdec, opusenc and oggdemux's Opus mapping.

Packets come from seeded numpy through the system libopus (the JAX
package's own oracle); a test skips only where libopus is absent, as the
JAX package's do.  Clips are 0.2-1 s; decoded PCM, packets, files, samples
and negotiated caps equal the JAX package's, tolerance 0.  The committed
10 s voice vector (SILK then hybrid) is held to ``digests.json``.
"""

import ctypes
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from gstreamer_tpu.codecs import _celt_tables as jct  # noqa: E402
from gstreamer_tpu.codecs import _silk_tables as jst  # noqa: E402
from gstreamer_tpu.codecs import celt as jcelt  # noqa: E402
from gstreamer_tpu.codecs import opus as jopus  # noqa: E402
from gstreamer_tpu.codecs import silk as jsilk  # noqa: E402
from gstreamer_tpu.native import celt as jncelt  # noqa: E402
from gstreamer_tpu.native import silk as jnsilk  # noqa: E402

from gstreamer_tpu_torch.codecs import _celt_tables as tct  # noqa: E402
from gstreamer_tpu_torch.codecs import _silk_tables as tst  # noqa: E402
from gstreamer_tpu_torch.codecs import celt as tcelt  # noqa: E402
from gstreamer_tpu_torch.codecs import opus as topus  # noqa: E402
from gstreamer_tpu_torch.codecs import silk as tsilk  # noqa: E402
from gstreamer_tpu_torch.native import celt as tncelt  # noqa: E402
from gstreamer_tpu_torch.native import silk as tnsilk  # noqa: E402

import gstreamer_tpu_torch  # noqa: E402
from gstreamer_tpu_torch.core.buffer import Buffer  # noqa: E402

from test_torch_analytics import same_spec  # noqa: E402
from test_torch_captions import _run, pair  # noqa: E402
from test_torch_file_formats import ASR, asrc, write_both  # noqa: E402

tparse = gstreamer_tpu_torch.parse_launch
needs_opus = pytest.mark.skipif(not jopus.available(),
                                reason="system libopus unavailable")
VECTORS = os.path.join(os.path.dirname(__file__), "data", "torch_codecs")
FACTORIES = ("opusdec", "opusenc")
# opus_encoder_ctl requests
SET_BITRATE, SET_BANDWIDTH, SET_FORCE_MODE = 4002, 4008, 11002
SET_INBAND_FEC, SET_PACKET_LOSS_PERC = 4012, 4014
BW = {"nb": 1101, "mb": 1102, "wb": 1103, "swb": 1104, "fb": 1105}
MODE = {"silk": 1000, "hybrid": 1001, "celt": 1002}


def signal(n, channels, seed, voice=False):
    """n seeded samples at 48 kHz in [-1, 1]: tones and noise, or a
    voiced buzz gated on and off (`voice`)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    if voice:
        x = (0.3 * np.sin(2 * np.pi * 155 * t)
             * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
             + 0.1 * rng.standard_normal(n)
             * (np.sin(2 * np.pi * 1.5 * t) > 0))
    else:
        x = (0.4 * np.sin(2 * np.pi * 440 * t)
             + 0.2 * np.sin(2 * np.pi * 880 * t * 1.003)
             + 0.08 * rng.standard_normal(n))
    x = np.stack([x, np.roll(x, 100) * 0.8], 1) if channels == 2 else x[:, None]
    return np.clip(x, -1, 1)


def encode(x, frame=960, bitrate=64000, mode=None, bw=None, fec=False,
           app=2049):
    """Packets of `x` ((n, ch) float) from the system libopus, `frame`
    samples each; `mode` / `bw` force the coding mode and bandwidth; `mode`
    may be a function of the packet index."""
    lib = ctypes.CDLL("libopus.so.0")
    lib.opus_encoder_create.restype = ctypes.c_void_p
    err = ctypes.c_int()
    enc = ctypes.c_void_p(lib.opus_encoder_create(
        48000, x.shape[1], app, ctypes.byref(err)))
    assert err.value == 0
    lib.opus_encoder_ctl(enc, SET_BITRATE, ctypes.c_int(bitrate))
    if bw is not None:
        lib.opus_encoder_ctl(enc, SET_BANDWIDTH, ctypes.c_int(BW[bw]))
    if fec:
        lib.opus_encoder_ctl(enc, SET_INBAND_FEC, ctypes.c_int(1))
        lib.opus_encoder_ctl(enc, SET_PACKET_LOSS_PERC, ctypes.c_int(30))
    buf, out = ctypes.create_string_buffer(4000), []
    for k in range(len(x) // frame):
        m = mode(k) if callable(mode) else mode
        if m is not None:
            lib.opus_encoder_ctl(enc, SET_FORCE_MODE, ctypes.c_int(MODE[m]))
        f = np.ascontiguousarray(x[k * frame:(k + 1) * frame], np.float32)
        got = lib.opus_encode_float(enc, f.ctypes.data_as(ctypes.c_void_p),
                                    frame, buf, 4000)
        assert got > 0
        out.append(bytes(buf.raw[:got]))
    lib.opus_encoder_destroy(enc)
    return out


def routes_zero():
    for k in topus.ROUTES:
        topus.ROUTES[k] = 0


def decode_both(packets, channels):
    """The packets through each package's HybridOpusDecoder: the same
    PCM, or the same error; returns the port's frames and its routes."""
    routes_zero()
    dj, dt = jopus.HybridOpusDecoder(channels), \
        topus.HybridOpusDecoder(channels)
    out = []
    for p in packets:
        try:
            want = dj.decode(p)
        except Exception as e:         # the same error from the port
            with pytest.raises(Exception) as got:
                dt.decode(p)
            assert (type(got.value).__name__, str(got.value)) == \
                (type(e).__name__, str(e))
            continue
        got = dt.decode(p)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        out.append(got)
    return out, {k: v for k, v in topus.ROUTES.items() if v}


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


@pytest.mark.parametrize("tables", [(jct, tct), (jst, tst)],
                         ids=["celt", "silk"])
def test_tables_are_copies(tables):
    j, t = tables
    names = [n for n in vars(j) if not n.startswith("_")]
    assert names == [n for n in vars(t) if not n.startswith("_")]
    for n in names:
        assert repr(getattr(t, n)) == repr(getattr(j, n)), n


# -- the range decoder and the codewords ---------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_range_decoder(seed):
    """The same symbols, bits and positions from seeded bytes."""
    rng = np.random.default_rng(seed)
    buf = bytes(rng.integers(0, 256, 64, np.uint8))
    icdf = [200, 120, 40, 0]

    def walk(mod):
        d, out = mod.RangeDecoder(buf), []
        for k in range(40):
            op = k % 5
            if op == 0:
                out.append(d.dec_uint(int(rng_k[k]) + 2))
            elif op == 1:
                out.append(d.dec_bit_logp(1 + k % 6))
            elif op == 2:
                out.append(d.dec_icdf(icdf, 8))
            elif op == 3:
                out.append(d.dec_bits(1 + k % 9))
            else:
                out.append(mod.laplace_decode(d, 16384, 90))
            out.append((d.tell(), d.tell_frac()))
        return out
    rng_k = rng.integers(0, 1000, 40)
    assert walk(tcelt) == walk(jcelt)


def test_pvq_codewords():
    """pvq_v and cwrsi of both packages, and the native shim's."""
    for n in range(2, 12):
        for k in range(1, 9):
            v = tcelt.pvq_v(n, k)
            assert v == jcelt.pvq_v(n, k)
            for i in sorted({0, v // 3, v - 1}):
                assert tcelt.cwrsi(n, k, i) == jcelt.cwrsi(n, k, i)
    lib = tncelt.get_lib()
    if lib is not None:
        assert int(lib.gtpu_celt_pvq_v(8, 5)) == jcelt.pvq_v(8, 5)


def test_native_loaders_build_into_the_port(monkeypatch):
    """The shims build from native/*.cpp into the port's _build directory
    (None only without g++), and the switches turn them off as in the JAX
    package."""
    from gstreamer_tpu_torch.native import _build
    for mod, name in ((tncelt, "gtpu_celt"), (tnsilk, "gtpu_silk")):
        lib = mod.get_lib()
        if lib is None:
            assert _build.build(name) is None
            continue
        assert _build.library_path(name).exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR
    monkeypatch.setenv("GTPU_CELT_NATIVE", "0")
    monkeypatch.setenv("GTPU_SILK_NATIVE", "0")
    assert tncelt.get_lib() is None and tnsilk.get_lib() is None


def test_configs():
    assert tcelt.CELT_CONFIGS == jcelt.CELT_CONFIGS
    assert tsilk.SILK_CONFIGS == jsilk.SILK_CONFIGS


@pytest.mark.parametrize("fs_in,fs_out", [(8000, 48000), (12000, 48000),
                                          (16000, 48000), (16000, 16000)])
def test_silk_resampler(fs_in, fs_out):
    """The decoder's resampler on seeded int16 blocks, its state carried
    from block to block."""
    rng = np.random.default_rng(fs_in)
    rj, rt = jsilk.SilkResampler(fs_in, fs_out), \
        tsilk.SilkResampler(fs_in, fs_out)
    for n in (fs_in // 100, fs_in // 50, fs_in // 25):
        x = rng.integers(-20000, 20000, n).astype(np.int16)
        a, b = rj.process(x), rt.process(x)
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)


# -- CELT ----------------------------------------------------------------------

@needs_opus
@pytest.mark.parametrize("frame", [120, 240, 480, 960])
@pytest.mark.parametrize("channels", [1, 2])
def test_celt_frame_sizes(frame, channels):
    x = signal(9600, channels, frame)
    out, routes = decode_both(encode(x, frame, mode="celt"), channels)
    assert routes == {"celt": len(out)} and len(out) == 9600 // frame


@needs_opus
@pytest.mark.parametrize("bw,bitrate", [("nb", 12000), ("wb", 24000),
                                        ("swb", 48000), ("fb", 128000),
                                        ("fb", 510000)])
def test_celt_bandwidths_and_rates(bw, bitrate):
    """Mono: libopus codes a low-rate stereo input as mono packets, which a
    stereo decoder hands to libopus (in both packages)."""
    x = signal(9600, 1, bitrate)
    _, routes = decode_both(encode(x, 960, bitrate, "celt", bw), 1)
    assert set(routes) == {"celt"}


@needs_opus
def test_celt_transients():
    """Clicks and silence: transient frames, the post-filter's gain
    changes and the anti-collapse path."""
    x = np.zeros((14400, 1))
    x[::1200] = 0.9
    x[7200:] += signal(7200, 1, 3)
    _, routes = decode_both(encode(x, 960, 32000, "celt"), 1)
    assert set(routes) == {"celt"}


@needs_opus
@pytest.mark.parametrize("native", ["1", "0"])
def test_celt_pure_python_path(native, monkeypatch):
    """GTPU_CELT_NATIVE=0 takes both packages' pure-Python CELT paths."""
    monkeypatch.setenv("GTPU_CELT_NATIVE", native)
    monkeypatch.setattr(jncelt, "_lib", None)
    monkeypatch.setattr(jncelt, "_tried", False)
    decode_both(encode(signal(4800, 2, 5), 960, 64000, "celt"), 2)


# -- SILK, hybrid, FEC, concealment ----------------------------------------------

@needs_opus
@pytest.mark.parametrize("bw,frame", [("nb", 960), ("mb", 960), ("wb", 480),
                                      ("wb", 960), ("wb", 1920),
                                      ("wb", 2880)])
@pytest.mark.parametrize("channels", [1, 2])
def test_silk(bw, frame, channels):
    x = signal(11520, channels, 7, voice=True)
    out, routes = decode_both(encode(x, frame, 32000, "silk", bw, app=2048),
                              channels)
    assert routes == {"silk": len(out)}


@needs_opus
@pytest.mark.parametrize("bw,frame", [("swb", 960), ("fb", 960),
                                      ("fb", 480)])
@pytest.mark.parametrize("channels", [1, 2])
def test_hybrid(bw, frame, channels):
    x = signal(9600, channels, 8, voice=True)
    out, routes = decode_both(encode(x, frame, 32000, "hybrid", bw,
                                     app=2048), channels)
    assert routes == {"hybrid": len(out)}


@needs_opus
def test_silk_python_synthesis(monkeypatch):
    """GTPU_SILK_NATIVE=0 in both: the pure-Python fixed-point chain."""
    monkeypatch.setenv("GTPU_SILK_NATIVE", "0")
    monkeypatch.setattr(jnsilk, "_lib", None)
    monkeypatch.setattr(jnsilk, "_tried", False)
    x = signal(4800, 1, 9, voice=True)
    decode_both(encode(x, 960, 24000, "silk", "wb", app=2048), 1)


@needs_opus
def test_silk_then_hybrid_stays_native():
    """SILK wideband, then hybrid fullband (the committed voice vector's
    layout): no mode-transition packet, every packet on a native route."""
    x = signal(19200, 2, 10, voice=True)
    pk = encode(x, 960, 20000, lambda k: "silk" if k < 10 else "hybrid",
                app=2048)
    pk = pk[:10] + encode(x[9600:], 960, 20000, "hybrid", "fb", app=2048)
    _, routes = decode_both(pk, 2)
    assert "libopus" not in routes


@needs_opus
def test_mode_transition_goes_to_libopus():
    """A CELT stream switching to SILK carries a redundant frame: both
    packages hand the stream to libopus there, for good."""
    x = signal(19200, 1, 11, voice=True)
    pk = encode(x, 960, 32000, lambda k: "celt" if k < 8 else "silk",
                app=2048)
    out, routes = decode_both(pk, 1)
    assert routes["celt"] >= 1 and routes["libopus"] >= 1
    assert len(out) == len(pk)


@needs_opus
@pytest.mark.parametrize("channels", [1, 2])
def test_fec_and_concealment(channels):
    """decode_fec of a SILK packet with LBRR data recovers the packet
    before it; decode_plc conceals a loss without it; both packages
    alike, packet by packet."""
    x = signal(14400, channels, 12, voice=True)
    pk = encode(x, 960, 32000, "silk", "wb", fec=True, app=2048)
    dj, dt = jopus.HybridOpusDecoder(channels), \
        topus.HybridOpusDecoder(channels)
    recovered = 0
    for k, p in enumerate(pk):
        if k % 4 == 2:                  # lost: conceal, then recover
            a, b = dj.decode_plc(960), dt.decode_plc(960)
            assert np.array_equal(a, b)
            a, b = dj.decode_fec(p), dt.decode_fec(p)
            assert (a is None) == (b is None)
            if a is not None:
                recovered += 1
                assert np.array_equal(a, b)
        assert np.array_equal(dj.decode(p), dt.decode(p))
    assert recovered


@needs_opus
@pytest.mark.parametrize("seed", range(3))
def test_random_packets(seed):
    """Random bytes behind real TOC bytes: the same PCM or the same
    error."""
    rng = np.random.default_rng(seed)
    tocs = [c << 3 | s << 2 | code for c in (1, 9, 13, 15, 17, 23, 31)
            for s in (0, 1) for code in (0, 1)]
    pk = [bytes([tocs[k % len(tocs)]])
          + bytes(rng.integers(0, 256, int(rng.integers(2, 120)), np.uint8))
          for k in range(40)]
    for channels in (1, 2):
        decode_both([p for p in pk if ((p[0] >> 2) & 1) == channels - 1],
                    channels)


# -- Ogg-Opus and the elements ---------------------------------------------------

def test_opus_head():
    for args in ((1, 312, 48000), (2, 0, 44100, -256), (2, 3840, 16000, 512)):
        head = topus.opus_head(*args)
        assert head == jopus.opus_head(*args)
        assert topus.parse_opus_head(head) == jopus.parse_opus_head(head)
    for bad in (b"OpusHead", b"OpusHeaX" + bytes(11),
                b"OpusHead\x10\x02" + bytes(9),
                b"OpusHead\x01\x02" + bytes(8) + b"\x01"):
        errs = []
        for mod in (topus, jopus):
            with pytest.raises(ValueError) as e:
                mod.parse_opus_head(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@needs_opus
@pytest.mark.parametrize("bitrate,seconds", [(64000, 0.5), (16000, 0.5),
                                             (96000, 0.2)])
def test_ogg_opus_roundtrip(bitrate, seconds):
    """encode_ogg writes the same file in both packages (libopus); the
    decode, with pre-skip and end trimming, is the same PCM."""
    n = int(48000 * seconds)
    x = (signal(n, 2, bitrate) * 32767).astype(np.int16)
    blob = topus.encode_ogg(x, 48000, bitrate)
    assert blob == jopus.encode_ogg(x, 48000, bitrate)
    routes_zero()
    got, want = topus.decode_ogg(blob), jopus.decode_ogg(blob)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert got[0].shape == (n, 2) and sum(topus.ROUTES.values()) > 0


@needs_opus
def test_ogg_opus_errors():
    from gstreamer_tpu_torch.elements.ogg import ogg_page
    blob = ogg_page([b"\x01vorbis" + bytes(20)], 1, 0, 0, bos=True)
    errs = []
    for mod in (topus, jopus):
        with pytest.raises(ValueError) as e:
            mod.decode_ogg(blob)
        errs.append(str(e.value))
    assert errs[0] == errs[1] == "opus: no OpusHead BOS packet"


@pytest.fixture(scope="module")
def opus_file(tmp_path_factory):
    if not jopus.available():
        pytest.skip("system libopus unavailable")
    path = tmp_path_factory.mktemp("opus") / "a.opus"
    x = (signal(24000, 2, 13) * 32767).astype(np.int16)
    path.write_bytes(jopus.encode_ogg(x, 48000, 64000))
    return path


@pytest.mark.parametrize("desc", [
    "opusdec location={p} blocksize=4096 ! appsink name=out",
    "opusdec location={p} blocksize=1000 ! appsink name=out",
    "oggdemux location={p} ! appsink name=out"])
def test_opusdec_and_oggdemux(desc, opus_file):
    """opusdec and oggdemux's Opus mapping: samples, timestamps and caps
    as the JAX package's."""
    pair(desc.format(p=opus_file))


def test_opus_into_the_asr_front_end(opus_file):
    """opusdec, oggdemux and uridecodebin into the ASR chain give what
    appsrc carrying the JAX package's decode in the same blocks gives (F32
    resampling is held to the JAX package by the audio tests' 1-ULP
    contract, not here)."""
    _, ref, _, _ = pair(f"opusdec location={opus_file} ! appsink name=out")
    pushes = [dict(data=np.asarray(s.buffer.data), pts=s.buffer.pts,
                   duration=s.buffer.duration) for s in ref["out"]]
    _, fed = _run(tparse, Buffer, f"{asrc('F32LE', 2, 48000)} ! {ASR}",
                  {"in": pushes}, ("out",), 1, None, device="cpu")
    want = torch.cat([s.buffer.data for s in fed["out"]])
    for desc in (f"opusdec location={opus_file}",
                 f"oggdemux location={opus_file}",
                 f"uridecodebin uri=file://{opus_file}"):
        _, out = _run(tparse, Buffer, f"{desc} ! {ASR}", {}, ("out",), 1,
                      None, device="cpu")
        got = torch.cat([s.buffer.data for s in out["out"]])
        assert got.dtype == torch.float32 and torch.equal(got, want), desc


@needs_opus
@pytest.mark.parametrize("fmt", ["S16LE", "F32LE"])
@pytest.mark.parametrize("frame_ms", [20, 10])
def test_opusenc_packets(fmt, frame_ms):
    """opusenc's packet stream (the last frame padded at EOS)."""
    x = signal(4000 * 3, 2, 14)
    pushes = [dict(data=(x[k * 4000:(k + 1) * 4000] * 32767).astype(np.int16)
                   if fmt == "S16LE"
                   else x[k * 4000:(k + 1) * 4000].astype(np.float32),
                   pts=k * 4000 * 10**9 // 48000,
                   duration=4000 * 10**9 // 48000) for k in range(3)]
    pair(f"appsrc name=in caps=audio/x-raw,format={fmt},rate=48000,"
         f"channels=2,layout=interleaved ! opusenc bitrate=48000 "
         f"frame-size={frame_ms} ! appsink name=out", {"in": pushes},
         host_bytes=True)


@needs_opus
def test_opusenc_location_writes_the_same_file(tmp_path):
    """opusenc location= dumps Ogg-Opus at EOS as in the JAX package; the
    port's opusdec reads it back as the JAX package's does."""
    x = (signal(9600, 1, 15) * 32767).astype(np.int16)
    pushes = {"in": [dict(data=x[:4800], pts=0, duration=10**8),
                     dict(data=x[4800:], pts=10**8, duration=10**8)]}
    path = write_both("appsrc name=in caps=audio/x-raw,format=S16LE,"
                      "rate=48000,channels=1,layout=interleaved ! "
                      "opusenc location={loc} ! fakesink", pushes, tmp_path,
                      "opus")
    pair(f"opusdec location={path} ! appsink name=out")


def test_opusenc_without_libopus(monkeypatch):
    """Without the system libopus opusenc raises RuntimeError in both
    packages."""
    from gstreamer_tpu.core.buffer import Buffer as JBuffer
    from gstreamer_tpu.core.parse import parse_launch as jparse
    monkeypatch.setattr(jopus, "_get", lambda: None)
    monkeypatch.setattr(topus, "_get", lambda: None)
    desc = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
            "channels=1,layout=interleaved ! opusenc ! fakesink")
    errs = []
    for parse, buf, kw in ((jparse, JBuffer, {}),
                           (tparse, Buffer, {"device": "cpu"})):
        p = parse(desc, **kw)
        p.get_by_name("in").push_buffer(buf(data=np.zeros((960, 1),
                                                          np.int16)))
        p.get_by_name("in").end_of_stream()
        with pytest.raises(RuntimeError) as e:
            p.run()
        errs.append(str(e.value))
    assert errs[0] == errs[1] == "opus: system libopus not available"


def test_routes_count_packets():
    """ROUTES counts a packet once, by the route it took; libopus is not
    needed for a CELT-only stream."""
    from gstreamer_tpu_torch.elements.ogg import parse_ogg_pages
    with open(os.path.join(VECTORS, "opus_10s.opus"), "rb") as f:
        pk = [p for _, _, ps in parse_ogg_pages(f.read()) for p in ps][2:12]
    routes_zero()
    d = topus.HybridOpusDecoder(2)
    for p in pk:
        d.decode(p)
    assert topus.ROUTES == {"celt": 10, "silk": 0, "hybrid": 0,
                            "libopus": 0}


def test_voice_vector_against_the_digest():
    """The committed SILK-then-hybrid vector through the port's opusdec:
    the JAX package's PCM (digests.json) and packet routes, exactly."""
    sys.path.insert(0, VECTORS)
    from make_vectors import pcm_digest
    with open(os.path.join(VECTORS, "digests.json")) as f:
        dig = json.load(f)["opus_voice"]
    routes_zero()
    p = tparse(f"opusdec location="
                     f"{os.path.join(VECTORS, 'opus_voice_10s.opus')} ! "
                     f"appsink name=out", device="cpu")
    p.run()
    sink, blocks = p.get_by_name("out"), []
    while (s := sink.pull_sample()) is not None:
        blocks.append(s.buffer.data)
    pcm = torch.cat(blocks).numpy()
    assert pcm_digest(pcm, 48000) == {k: v for k, v in dig.items()
                                      if k != "routes"}
    assert {k: v for k, v in topus.ROUTES.items() if v} == dig["routes"]
