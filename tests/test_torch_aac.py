"""The port's AAC decoder against the JAX package, bit for bit: AAC-LC
(``codecs/aac.py``: ADTS and raw access units, the AudioSpecificConfig,
window grouping, M/S and intensity stereo, TNS, PNS, multichannel), SBR
(``codecs/sbr.py``: HE-AAC v1, mono and channel pairs, the 2x upsampler),
and the elements aacparse and faad (caps from the first frame, the rate
doubled under SBR, a tick's frames decoded on the host).

Streams come from seeded numpy through the system libavcodec AAC encoder
(``tests/aac_oracle.py``), with SBR written into them by
``tests/sbr_writer.py``; a test skips only where libavcodec is absent, as
the JAX package's do.  Clips are 0.5-1 s; PCM, caps and timestamps equal
the JAX package's, tolerance 0.  One difference is deliberate: a reserved
section codebook raises ``ValueError`` in the port and ``KeyError`` in the
JAX package (ROADMAP.md section 3).  The committed 10 s LC and HE-AAC
vectors are held to ``digests.json``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import aac_oracle as ao  # noqa: E402
from sbr_writer import splice_sbr_adts  # noqa: E402

from gstreamer_tpu.codecs import _aac_tables as jat  # noqa: E402
from gstreamer_tpu.codecs import _sbr_tables as jsbt  # noqa: E402
from gstreamer_tpu.codecs import aac as jaac  # noqa: E402
from gstreamer_tpu.codecs import sbr as jsbr  # noqa: E402
from gstreamer_tpu.elements import aacdec as jfaad  # noqa: E402

import gstreamer_tpu_torch  # noqa: E402
from gstreamer_tpu_torch.codecs import _aac_tables as tat  # noqa: E402
from gstreamer_tpu_torch.codecs import _sbr_tables as tsbt  # noqa: E402
from gstreamer_tpu_torch.codecs import aac as taac  # noqa: E402
from gstreamer_tpu_torch.codecs import sbr as tsbr  # noqa: E402
from gstreamer_tpu_torch.core.buffer import Buffer  # noqa: E402
from gstreamer_tpu_torch.elements import aacdec as tfaad  # noqa: E402

from test_torch_analytics import same_spec  # noqa: E402
from test_torch_captions import _run, pair  # noqa: E402
from test_torch_file_formats import ASR, asrc  # noqa: E402

needs_aac = pytest.mark.skipif(not ao.have_aac(),
                               reason="system libavcodec missing")
VECTORS = os.path.join(os.path.dirname(__file__), "data", "torch_codecs")
FACTORIES = ("faad", "aacparse")
NO_PNS = "aac_pns=0"
tparse = gstreamer_tpu_torch.parse_launch


def tones(rate, seconds, channels, seed=0, noise=0.02):
    """Seeded int16 (n, channels): a tone a channel under noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds))[:, None] / rate
    x = 0.35 * np.sin(2 * np.pi * (330 + 110 * np.arange(channels)) * t) \
        + rng.normal(0, noise, (len(t), channels))
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)


def adts(sig, rate, bitrate=128000, opts=NO_PNS, layout=""):
    blob = ao.aac_encode_adts(sig, rate, bitrate, opts, layout)
    assert blob is not None
    return blob


def same(fn_t, fn_j, *args):
    """fn of both packages on the same arguments: the same result (arrays
    bit for bit) or the same error."""
    try:
        want = fn_j(*args)
    except Exception as e:             # each package has its own classes
        with pytest.raises(Exception) as got:
            fn_t(*args)
        assert (type(got.value).__name__, str(got.value)) == \
            (type(e).__name__, str(e))
        return None
    got = fn_t(*args)
    assert type(got) is type(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and np.array_equal(g, w)
            else:
                assert g == w
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want
    return got


def frames_both(blob):
    """An ADTS stream frame by frame through each package's AACDecoder:
    the same frames, sbr_present and ps_present."""
    pos, dj, dt, out = 0, None, None, []
    while pos + 7 <= len(blob):
        hdr = jaac.parse_adts_header(blob, pos)
        assert hdr == taac.parse_adts_header(blob, pos)
        flen, sfi, cc, _p, hlen = hdr
        if dj is None:
            dj, dt = jaac.AACDecoder(sfi, cc), taac.AACDecoder(sfi, cc)
        body = blob[pos + hlen:pos + flen]
        a = dj.decode_frame(jaac.Bits(body))
        b = dt.decode_frame(taac.Bits(body))
        assert b.dtype == a.dtype and np.array_equal(a, b)
        out.append(b)
        pos += flen
    assert (dt.sbr_present, dt.ps_present, dt.output_rate) == \
        (dj.sbr_present, dj.ps_present, dj.output_rate)
    return out, dt


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


@pytest.mark.parametrize("tables", [(jat, tat), (jsbt, tsbt)],
                         ids=["aac", "sbr"])
def test_tables_are_copies(tables):
    j, t = tables
    names = [n for n in vars(j) if not n.startswith("_")]
    assert names == [n for n in vars(t) if not n.startswith("_")]
    for n in names:
        assert repr(getattr(t, n)) == repr(getattr(j, n)), n


# -- AAC-LC --------------------------------------------------------------------

@needs_aac
@pytest.mark.parametrize("rate,channels,bitrate", [
    (48000, 2, 128000), (44100, 1, 64000), (32000, 2, 96000),
    (22050, 2, 48000), (8000, 1, 16000), (96000, 2, 192000),
    (44100, 2, 16000)])
def test_lc(rate, channels, bitrate):
    """Tones under noise at each rate: long and short windows, M/S and,
    at 16 kbit/s, intensity stereo."""
    blob = adts(tones(rate, 0.5, channels, rate), rate, bitrate)
    same(taac.decode_adts, jaac.decode_adts, blob)
    frames_both(blob)


@needs_aac
def test_lc_transients_and_pns():
    """Clicks (short windows, TNS) and PNS (the decoder's noise
    generator)."""
    rate = 44100
    x = tones(rate, 0.5, 2, 5, noise=0.1)
    x[::4000] = 30000
    same(taac.decode_adts, jaac.decode_adts, adts(x, rate, 96000,
                                                  "aac_pns=1"))


@needs_aac
@pytest.mark.parametrize("channels,layout", [(3, "3.0"), (6, "5.1"),
                                             (8, "7.1")])
def test_lc_multichannel(channels, layout):
    blob = adts(tones(48000, 0.25, channels, channels), 48000,
                64000 * channels, NO_PNS, layout)
    same(taac.decode_adts, jaac.decode_adts, blob)


@needs_aac
def test_raw_access_units_and_asc():
    """decode_raw over the access units of an ADTS stream with its
    AudioSpecificConfig, and the ASC parser on valid and broken configs."""
    from gstreamer_tpu_torch.elements.isomp4 import _make_asc
    blob = adts(tones(48000, 0.5, 2, 6), 48000)
    units, pos = [], 0
    while pos + 7 <= len(blob):
        flen, _s, _c, _p, hlen = taac.parse_adts_header(blob, pos)
        units.append(blob[pos + hlen:pos + flen])
        pos += flen
    asc = _make_asc(48000, 2)
    same(taac.decode_raw, jaac.decode_raw, asc, units)
    rng = np.random.default_rng(7)
    for cfg in [asc, bytes([0x13, 0x10]), bytes([0x2B, 0x92, 0x08, 0x00]),
                bytes([0xF8, 0x00, 0x00]), bytes([0x17, 0x80, 0, 0, 0]),
                b"", b"\x00"] + [bytes(rng.integers(0, 256, 5, np.uint8))
                                 for _ in range(30)]:
        same(taac.parse_audio_specific_config,
             jaac.parse_audio_specific_config, cfg)


@needs_aac
def test_garbage_and_truncation():
    """Garbage before the first header, a cut last frame and random
    blobs: the same PCM or the same error."""
    blob = adts(tones(44100, 0.5, 1, 8), 44100, 64000)
    rng = np.random.default_rng(8)
    for data in (bytes(rng.integers(0, 256, 300, np.uint8)) + blob,
                 blob[:-200], blob[:40], b"\xff\xf1" + bytes(64)):
        same(taac.decode_adts, jaac.decode_adts, data)


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_random_raw_frames(seed):
    """Random access units through one decoder of each package (its state
    carried from unit to unit): the same PCM or the same error."""
    rng = np.random.default_rng(seed)
    dj, dt = jaac.AACDecoder(4, 2), taac.AACDecoder(4, 2)
    for _ in range(12):
        blob = bytes(rng.integers(0, 256, 512, np.uint8))
        same(lambda b: dt.decode_frame(taac.Bits(b)),
             lambda b: dj.decode_frame(jaac.Bits(b)), blob)


def test_reserved_codebook_is_a_reference_fault():
    """ISO/IEC 14496-3 reserves section codebook 12.  A stream that selects
    it is malformed: the port raises ValueError, the error every malformed
    stream gives; the JAX package's lookup raises KeyError, which its
    callers (decode_adts, decode_raw, faad) do not catch (ROADMAP.md
    section 3).  The same random units (tests/test_fuzz_codecs.py's
    raw-frame case, seed 51) reach it in both at the fifth."""
    rng = np.random.default_rng(51)
    units = [bytes(rng.integers(0, 256, 512, np.uint8)) for _ in range(5)]
    dj, dt = jaac.AACDecoder(4, 2), taac.AACDecoder(4, 2)
    for u in units[:4]:
        same(lambda b: dt.decode_frame(taac.Bits(b)),
             lambda b: dj.decode_frame(jaac.Bits(b)), u)
    with pytest.raises(KeyError):
        dj.decode_frame(jaac.Bits(units[4]))
    with pytest.raises(ValueError, match="reserved codebook 12"):
        dt.decode_frame(taac.Bits(units[4]))


# -- SBR (HE-AAC v1) -------------------------------------------------------------

def he_stream(stereo=False, seed=7, header=None, **kw):
    core = tones(24000, 0.5, 2 if stereo else 1, seed, noise=0.2)
    return splice_sbr_adts(adts(core, 24000, 160000 if stereo else 96000),
                           header or jsbr.SbrHeader(amp_res=1, start_freq=5,
                                                    stop_freq=3), **kw)


@needs_aac
@pytest.mark.parametrize("label,kw", [
    ("1env", dict(num_env=1, env_q=[80], noise_q=[30], invf_mode=0)),
    ("2env", dict(num_env=2, env_q=[[60], [70]], noise_q=[20, 26],
                  invf_mode=0)),
    ("4env", dict(num_env=4, env_q=[55, 60, 65, 70], noise_q=[22],
                  invf_mode=1)),
    ("lowres", dict(num_env=1, env_q=[66], noise_q=[24], freq_res=0,
                    invf_mode=0)),
    ("chirp", dict(num_env=1, env_q=[70], noise_q=[14], invf_mode=3)),
    ("sine", dict(num_env=1, env_q=[65], noise_q=[20], invf_mode=0,
                  add_harmonic=[0, 1, 0, 0, 1])),
    ("ps", dict(num_env=1, env_q=[70], noise_q=[25], ps=True))])
def test_sbr_mono(label, kw):
    blob = he_stream(**kw)
    _, dec = frames_both(blob)
    assert dec.sbr_present and dec.output_rate == 48000
    assert dec.ps_present == (label == "ps")
    same(taac.decode_adts, jaac.decode_adts, blob)


@needs_aac
@pytest.mark.parametrize("cpe", [
    dict(coupling=False, env_q1=[64], noise_q1=[22]),
    dict(coupling=True, env_bal=[14], noise_bal=[11])],
    ids=["independent", "coupled"])
def test_sbr_channel_pair(cpe):
    blob = he_stream(True, 11, env_q=[68], noise_q=[24], cpe=cpe)
    _, dec = frames_both(blob)
    assert dec.sbr_present
    same(taac.decode_adts, jaac.decode_adts, blob)


@needs_aac
def test_sbr_second_header():
    """Multi-patch tables, interpol_freq=0, slot smoothing, -3 dB limiter
    gain."""
    hdr = jsbr.SbrHeader(amp_res=0, start_freq=8, stop_freq=7,
                         interpol_freq=0, smoothing_mode=0,
                         limiter_gains=1, freq_scale=1)
    same(taac.decode_adts, jaac.decode_adts,
         he_stream(header=hdr, env_q=[40], noise_q=[20]))


def test_freq_tables_and_upsampler():
    for cfg in (dict(start_freq=5, stop_freq=3), dict(start_freq=8,
                                                      stop_freq=7),
                dict(start_freq=0, stop_freq=0, freq_scale=0),
                dict(start_freq=13, stop_freq=14, alter_scale=0)):
        for rate in (32000, 44100, 48000):
            try:
                want = jsbr.make_freq_tables(jsbr.SbrHeader(**cfg), rate)
            except Exception as e:
                with pytest.raises(type(e)):
                    tsbr.make_freq_tables(tsbr.SbrHeader(**cfg), rate)
                continue
            got = tsbr.make_freq_tables(tsbr.SbrHeader(**cfg), rate)
            assert repr(got) == repr(want)
    rng = np.random.default_rng(9)
    uj, ut = jsbr.Upsampler2x(), tsbr.Upsampler2x()
    for _ in range(3):
        x = rng.normal(0, 1000, 1024)
        assert np.array_equal(uj.process(x), ut.process(x))


# -- the elements ----------------------------------------------------------------

@pytest.fixture(scope="module")
def aac_files(tmp_path_factory):
    if not ao.have_aac():
        pytest.skip("system libavcodec missing")
    d = tmp_path_factory.mktemp("aac")
    (d / "lc.aac").write_bytes(adts(tones(44100, 1.0, 2, 12), 44100))
    (d / "he.aac").write_bytes(he_stream(True, 13, env_q=[68], noise_q=[24],
                                         cpe={}))
    (d / "mono.aac").write_bytes(adts(tones(16000, 0.5, 1, 14), 16000,
                                      32000))
    return d


@pytest.mark.parametrize("name", ["lc", "he", "mono"])
@pytest.mark.parametrize("blocksize", [4096, 777])
def test_aacparse_faad(name, blocksize, aac_files):
    """filesrc ! aacparse ! faad: samples, timestamps and caps (HE-AAC at
    twice the core rate) as the JAX package's."""
    _, _, tpipe, out = pair(f"filesrc location={aac_files / name}.aac "
                            f"blocksize={blocksize} ! aacparse ! faad ! "
                            f"appsink name=out")
    rate = out["out"][0].caps[0]["rate"]
    assert rate == {"lc": 44100, "he": 48000, "mono": 16000}[name]


def test_aacparse_frames(aac_files):
    """aacparse alone: the same ADTS frames and caps."""
    pair(f"filesrc location={aac_files / 'lc.aac'} blocksize=1000 ! "
         f"aacparse ! appsink name=out", host_bytes=True)


def test_faad_raw_units_with_codec_data(aac_files):
    """Raw access units with an AudioSpecificConfig in codec_data (a
    demuxer's output): the same PCM in both packages."""
    from gstreamer_tpu_torch.elements.isomp4 import _make_asc
    blob = (aac_files / "lc.aac").read_bytes()
    units, pos = [], 0
    while pos + 7 <= len(blob):
        flen, _s, _c, _p, hlen = taac.parse_adts_header(blob, pos)
        units.append(np.frombuffer(blob[pos + hlen:pos + flen],
                                   np.uint8).copy())
        pos += flen
    asc = _make_asc(44100, 2)
    pushes = [dict(data=units[k:k + 5], batch=len(units[k:k + 5]),
                   pts=k * 1024 * 10**9 // 44100,
                   meta={"codec_data": asc})
              for k in range(0, len(units), 5)]
    pair("appsrc name=in caps=audio/mpeg,mpegversion=4,stream-format=raw,"
         "rate=44100,channels=2 ! faad ! audio/x-raw,rate=44100,"
         "channels=2 ! appsink name=out", {"in": pushes})


def test_faad_host_process_direct(aac_files):
    """faad's tick alone: the port uploads the decoded PCM to its device
    once (here the CPU), the JAX package returns host samples."""
    from gstreamer_tpu.core.buffer import Buffer as JBuffer
    blob = (aac_files / "he.aac").read_bytes()
    frames, pos = [], 0
    while pos + 7 <= len(blob):
        flen = taac.parse_adts_header(blob, pos)[0]
        frames.append(np.frombuffer(blob[pos:pos + flen], np.uint8).copy())
        pos += flen
    jd, td = jfaad.Faad(), tfaad.Faad()
    td.device = torch.device("cpu")
    jd.start()
    td.start()
    for k in range(0, len(frames), 4):
        part = frames[k:k + 4]
        a = jd.host_process(JBuffer(data=list(part), batch=len(part)))
        b = td.host_process(Buffer(data=list(part), batch=len(part)))
        assert isinstance(b.data, torch.Tensor) and b.data.device.type == "cpu"
        assert np.array_equal(b.data.numpy(), np.asarray(a.data))
        assert (b.pts, b.duration) == (a.pts, a.duration)
    assert td.host_process(None) is None


def test_aac_into_the_asr_front_end(aac_files):
    """aacparse ! faad into the ASR chain gives what appsrc carrying the
    JAX package's decode in the same blocks gives (F32 resampling is held
    to the JAX package by the audio tests' 1-ULP contract)."""
    path = aac_files / "he.aac"
    _, ref, _, _ = pair(f"filesrc location={path} ! aacparse ! faad ! "
                        f"appsink name=out")
    pushes = [dict(data=np.asarray(s.buffer.data), pts=s.buffer.pts,
                   duration=s.buffer.duration) for s in ref["out"]]
    _, fed = _run(tparse, Buffer, f"{asrc('F32LE', 2, 48000)} ! {ASR}",
                  {"in": pushes}, ("out",), 1, None, device="cpu")
    _, out = _run(tparse, Buffer, f"filesrc location={path} ! aacparse ! "
                  f"faad ! {ASR}", {}, ("out",), 1, None, device="cpu")
    got = torch.cat([s.buffer.data for s in out["out"]])
    want = torch.cat([s.buffer.data for s in fed["out"]])
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("name,key", [("aac_10s.aac", "aac_adts"),
                                      ("heaac_10s.aac", "heaac_adts")])
def test_vectors_against_the_digests(name, key):
    """The committed 10 s LC and HE-AAC vectors through the port's
    aacparse ! faad: the JAX package's PCM (digests.json), exactly."""
    sys.path.insert(0, VECTORS)
    from make_vectors import pcm_digest
    with open(os.path.join(VECTORS, "digests.json")) as f:
        dig = json.load(f)[key]
    p = tparse(f"filesrc location={os.path.join(VECTORS, name)} ! aacparse "
               f"! faad ! appsink name=out", device="cpu")
    p.run()
    sink, blocks = p.get_by_name("out"), []
    while (s := sink.pull_sample()) is not None:
        blocks.append(s.buffer.data)
    assert pcm_digest(torch.cat(blocks).numpy(), 48000) == dig
