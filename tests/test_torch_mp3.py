"""The port's MPEG audio against the JAX package, bit for bit:
``codecs/mp3.py`` with ``_mp3_tables.py`` (Layers I, II and III, MPEG-1, 2
and 2.5, mono and stereo, the LAME gapless tag, free-format and garbage
rejected alike), mpg123audiodec, and the audio parsers of
``elements/audioparsers.py`` (mpegaudioparse, ac3parse, sbcparse,
wavpackparse) on the JAX package's own test inputs.

Layer III vectors come from the system libmp3lame and Layer II from
libtwolame (each test skips where its library is absent, as the JAX
package's do); Layer I frames are hand-built.  PCM, samples, caps,
negotiation and bus messages equal the JAX package's, tolerance 0.
"""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import audio_oracle as ao  # noqa: E402
from test_audioparsers import make_mp3_frame  # noqa: E402
from test_mp3 import make_layer1_frames  # noqa: E402
from test_sbc_wavpack_parse import mk_sbc_frame, mk_wvpk_block  # noqa: E402

from gstreamer_tpu.codecs import _mp3_tables as jtables  # noqa: E402
from gstreamer_tpu.codecs import mp3 as jmp3  # noqa: E402
from gstreamer_tpu.elements import audioparsers as jap  # noqa: E402

import gstreamer_tpu_torch  # noqa: E402
from gstreamer_tpu_torch.codecs import _mp3_tables as ttables  # noqa: E402
from gstreamer_tpu_torch.codecs import mp3 as tmp3  # noqa: E402
from gstreamer_tpu_torch.core.buffer import Buffer  # noqa: E402
from gstreamer_tpu_torch.elements import audioparsers as tap  # noqa: E402

from test_torch_analytics import same_spec  # noqa: E402
from test_torch_captions import _run, pair  # noqa: E402
from test_torch_file_formats import ASR, asrc  # noqa: E402

needs_lame = pytest.mark.skipif(not ao.have_lame(),
                                reason="system libmp3lame missing")
FACTORIES = ("mpegaudioparse", "ac3parse", "sbcparse", "wavpackparse",
             "mpg123audiodec")
tparse = gstreamer_tpu_torch.parse_launch


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


def test_tables_equal():
    names = [n for n in dir(jtables) if n.isupper()]
    assert names == [n for n in dir(ttables) if n.isupper()] and names
    for n in names:
        assert repr(getattr(ttables, n)) == repr(getattr(jtables, n)), n


def tone(rate, ch, seconds, seed=0, clicks=False):
    t = np.arange(int(rate * seconds))[:, None] / rate
    x = 0.5 * np.sin(2 * np.pi * (440 + 220 * np.arange(ch)) * t)
    rng = np.random.default_rng(seed)
    x = x + rng.normal(0, 0.02, x.shape)
    if clicks:
        for k in range(0, len(x), 3000):
            x[k:k + 60] += rng.normal(0, 0.6, x[k:k + 60].shape)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


_twolame = None


def twolame_encode(pcm16, rate, kbps):
    """int16 (n, ch) -> MPEG-1 Layer II bytes via the system libtwolame, or
    None where it is absent."""
    global _twolame
    if _twolame is None:
        try:
            _twolame = ctypes.CDLL("libtwolame.so.0")
        except OSError:
            _twolame = False
    if not _twolame:
        return None
    lib = _twolame
    lib.twolame_init.restype = ctypes.c_void_p
    opts = ctypes.c_void_p(lib.twolame_init())
    n, ch = pcm16.shape
    lib.twolame_set_in_samplerate(opts, rate)
    lib.twolame_set_out_samplerate(opts, rate)
    lib.twolame_set_num_channels(opts, ch)
    lib.twolame_set_mode(opts, 3 if ch == 1 else 0)
    lib.twolame_set_bitrate(opts, kbps)
    assert lib.twolame_init_params(opts) == 0
    cap = n * 4 + 16384
    out = ctypes.create_string_buffer(cap)
    pcm = np.ascontiguousarray(pcm16)
    wrote = lib.twolame_encode_buffer_interleaved(
        opts, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n, out,
        cap)
    tail = ctypes.create_string_buffer(16384)
    more = lib.twolame_encode_flush(opts, tail, 16384)
    lib.twolame_close(ctypes.byref(opts))
    assert wrote >= 0 and more >= 0
    return out.raw[:wrote] + tail.raw[:more]


def decode_both(blob, gapless=True):
    """Both packages' whole-stream decoders on `blob`: the same PCM, rate
    and channels, or the same error."""
    got = []
    for mod in (tmp3, jmp3):
        try:
            pcm, rate, ch = mod.decode(blob, gapless)
            got.append((pcm.dtype.str, pcm.shape, pcm.tobytes(), rate, ch))
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[0] == got[1]
    return got[0]


@needs_lame
@pytest.mark.parametrize("rate,kbps,ch", [
    (48000, 128, 2), (44100, 320, 2), (32000, 64, 2), (44100, 128, 1),
    (22050, 64, 2), (24000, 96, 1), (16000, 32, 2), (11025, 24, 1),
    (8000, 16, 1)])
def test_layer3_pcm_bit_equal(rate, kbps, ch):
    """MPEG-1, MPEG-2 (LSF) and MPEG-2.5 Layer III, stereo and mono, with
    LAME's gapless tag trimmed, and without the trim (LAME may pick a
    lower output rate for a low bitrate)."""
    blob = ao.lame_encode(tone(rate, ch, 1.0, rate), rate, kbps)
    got = decode_both(blob)
    assert got[4] == ch and got[3] <= rate
    decode_both(blob, gapless=False)


@needs_lame
def test_layer3_short_blocks_and_reservoir():
    rng = np.random.default_rng(5)
    for pcm, rate, kbps in (
            (tone(44100, 2, 1.0, 7, clicks=True), 44100, 128),
            ((rng.standard_normal((22050, 2)) * 1600).astype(np.int16),
             22050, 96)):
        decode_both(ao.lame_encode(pcm, rate, kbps))


@pytest.mark.parametrize("rate,kbps,ch", [(48000, 192, 2), (44100, 128, 1),
                                          (32000, 256, 2)])
def test_layer2_pcm_bit_equal(rate, kbps, ch):
    blob = twolame_encode(tone(rate, ch, 0.5, ch), rate, kbps)
    if blob is None:
        pytest.skip("system libtwolame missing")
    assert jmp3.FrameHeader(blob[:4]).layer == 2
    assert decode_both(blob)[3:] == (rate, ch)


@pytest.mark.parametrize("seed", [1, 2])
def test_layer1_pcm_bit_equal(seed):
    assert decode_both(make_layer1_frames(8, seed))[3:] == (44100, 1)


def test_garbage_free_format_and_headers():
    """Garbage between frames resyncs alike; free-format (bitrate index 0)
    and empty streams are refused with the same error; headers alike."""
    data = make_layer1_frames(4)
    decode_both(b"\x00garbage" + data[:300] + b"\xff\xfb" + data)
    free = bytes([0xFF, 0xFB, 0x00, 0x00]) + bytes(400)
    assert decode_both(free * 4)[0] == "ValueError"
    for blob in (b"", b"\x00" * 1000):
        assert decode_both(blob)[0] == "ValueError"
    for hdr in (b"\x00\x00\x00\x00", b"\xff\xea\x00\x00",
                bytes([0xFF, 0xFB, 0x90, 0x00]), bytes([0xFF, 0xF3, 0x84, 0xC4]),
                bytes([0xFF, 0xE3, 0x18, 0xC4])):
        got = []
        for mod in (tmp3, jmp3):
            try:
                h = mod.FrameHeader(hdr)
                got.append({k: getattr(h, k) for k in h.__slots__})
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1]


def test_frame_info_helpers():
    for b in (make_mp3_frame()[0][:4], make_mp3_frame(14, 1)[0][:4],
              b"\x00\x00\x00\x00", b"\xff\xe0\x00\x00",
              bytes([0xFF, 0xF3, 0x84, 0xC4])):
        assert tap.mp3_frame_info(b) == jap.mp3_frame_info(b)
    for fscod in range(3):
        for code in range(0, 40, 3):
            hdr = bytes([0x0B, 0x77, 0, 0, (fscod << 6) | code])
            assert tap.ac3_frame_info(hdr) == jap.ac3_frame_info(hdr)
    f = mk_sbc_frame(rate_i=3, blocks_i=3, mode=2, bitpool=40)
    assert tap.sbc_parse_header(f) == jap.sbc_parse_header(f)
    for args in ((4, 0, 4, 2), (8, 0, 16, 32), (8, 2, 16, 32),
                 (8, 3, 16, 32)):
        assert tap.sbc_calc_framelen(*args) == jap.sbc_calc_framelen(*args)
    assert tap.wvpk_header(mk_wvpk_block()) == jap.wvpk_header(
        mk_wvpk_block())


def chunks(blob, size, caps="application/octet-stream"):
    pushes = [dict(data=np.frombuffer(blob[i:i + size], np.uint8).copy(),
                   pts=0 if i == 0 else None)
              for i in range(0, len(blob), size)]
    return f"appsrc name=in ! {caps}", {"in": pushes}


def ac3_stream():
    size, _ = jap.ac3_frame_info(bytes([0x0B, 0x77, 0, 0, 16]))
    frame = bytes([0x0B, 0x77, 0, 0, 16]) + b"\x55" * (size - 5)
    return b"\x00\x01" + frame * 4


@pytest.mark.parametrize("name,blob,size,caps", [
    ("mpegaudioparse", b"garbage!" + b"".join(make_mp3_frame()[0]
                                              for _ in range(6)), 333,
     "application/octet-stream"),
    ("mpegaudioparse", make_layer1_frames(5), 500,
     "application/octet-stream"),
    ("ac3parse", ac3_stream(), 700, "application/octet-stream"),
    ("sbcparse", b"garbage" + b"".join(mk_sbc_frame(fill=k)
                                       for k in range(6)), 10**6,
     "audio/x-sbc"),
    ("wavpackparse", b"xx" + b"".join(mk_wvpk_block(idx=k)
                                      for k in range(4)), 10**6,
     "audio/x-wavpack"),
    ("wavpackparse", mk_wvpk_block(flags_extra=0x0800)
     + mk_wvpk_block(flags_extra=0x1000), 10**6, "audio/x-wavpack")],
    ids=["mp3", "layer1", "ac3", "sbc", "wavpack", "wavpack-multiblock"])
def test_parsers_on_the_reference_inputs(name, blob, size, caps):
    """Each parser on the JAX tests' input, fed in chunks: the same frames,
    timestamps and caps."""
    src, pushes = chunks(blob, size, caps)
    _, ref, _, out = pair(f"{src} ! {name} ! appsink name=out", pushes,
                          host_bytes=True)
    assert len(out["out"]) == len(ref["out"]) > 0


@pytest.mark.parametrize("name,caps", [
    ("mpegaudioparse", "application/octet-stream"),
    ("ac3parse", "application/octet-stream"),
    ("sbcparse", "audio/x-sbc"), ("wavpackparse", "audio/x-wavpack")])
def test_parsers_on_random_bytes(name, caps):
    """The JAX package's fuzz inputs: sync-heavy garbage and noise give the
    same frames, or the same error."""
    rng = np.random.default_rng(1234)
    base = bytes([0x47, 0xFF, 0x9C, 0x24, 0x00, 0x01]) * 300
    noise = rng.integers(0, 256, len(base), np.uint8).tobytes()
    mixed = bytes(a if i % 3 else b for i, (a, b) in
                  enumerate(zip(base, noise)))
    for blob in (base, mixed, noise):
        src, pushes = chunks(blob, 512, caps)
        try:
            pair(f"{src} ! {name} ! appsink name=out", pushes,
                 host_bytes=True)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                _run(tparse, Buffer, f"{src} ! {name} ! appsink name=out",
                     pushes, ("out",), 1, None, device="cpu")


@needs_lame
@pytest.mark.parametrize("rate,ch,kbps", [(48000, 2, 128), (44100, 1, 64),
                                          (22050, 2, 48)])
def test_mpg123audiodec(rate, ch, kbps, tmp_path):
    """filesrc ! mpegaudioparse ! mpg123audiodec: the caps peeked from the
    file, the same F32 samples a frame run; the file's bytes go to the
    parser unstaged."""
    path = tmp_path / "a.mp3"
    path.write_bytes(ao.lame_encode(tone(rate, ch, 1.0, 3), rate, kbps))
    _, _, tpipe, out = pair(f"filesrc location={path} ! mpegaudioparse ! "
                            f"mpg123audiodec ! appsink name=out")
    assert all(s.buffer.data.dtype == torch.float32 for s in out["out"])
    assert [e.FACTORY for e in tpipe._host_fed] == ["filesrc"]


@needs_lame
def test_mp3_into_the_asr_front_end(tmp_path):
    """mpg123audiodec's samples equal the JAX package's; through the ASR
    chain the file gives what appsrc carrying the JAX package's decode
    gives, by the parser chain and by uridecodebin (typefind's route)."""
    path = tmp_path / "a.mp3"
    path.write_bytes(ao.lame_encode(tone(48000, 2, 1.0, 9), 48000, 128))
    chain = f"filesrc location={path} ! mpegaudioparse ! mpg123audiodec"
    _, ref, _, _ = pair(f"{chain} ! appsink name=out")
    pair(f"uridecodebin uri=file://{path} ! appsink name=out")
    pushes = [dict(data=np.asarray(s.buffer.data), pts=s.buffer.pts,
                   duration=s.buffer.duration) for s in ref["out"]]
    _, fed = _run(tparse, Buffer, f"{asrc('F32LE', 2, 48000)} ! {ASR}",
                  {"in": pushes}, ("out",), 1, None, device="cpu")
    want = torch.cat([s.buffer.data for s in fed["out"]])
    for desc in (chain, f"uridecodebin uri=file://{path}"):
        _, out = _run(tparse, Buffer, f"{desc} ! {ASR}", {}, ("out",), 1,
                      None, device="cpu")
        got = torch.cat([s.buffer.data for s in out["out"]])
        assert got.dtype == torch.float32 and torch.equal(got, want), desc
