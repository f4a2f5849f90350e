"""The port's FLAC against the JAX package, bit for bit: ``codecs/flac.py``
and its native fast path ``native/flac.py`` (over ``native/gtpu_flac.cpp``),
flacenc / flacdec, flacparse, and FLAC in Ogg (oggmux / oggdemux).

The same seeded samples go through both packages: encoded streams are the
same bytes (the port's Python and native paths and the JAX package's),
decodes the same samples, the elements' files, samples, caps, negotiation
and bus messages equal (``test_torch_captions.pair``), tolerance 0.
"""

import hashlib
import struct

import numpy as np
import pytest

from gstreamer_tpu.codecs import flac as jflac
from gstreamer_tpu.native import flac as jnflac

from gstreamer_tpu_torch.codecs import flac as tflac
from gstreamer_tpu_torch.native import flac as tnflac

from test_torch_analytics import same_spec
from test_torch_captions import pair
from test_torch_file_formats import ASR, asrc, audio, write_both

FACTORIES = ("flacenc", "flacdec", "flacparse", "oggmux", "oggdemux")


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


def signal(n, ch, bps, seed=0):
    """A seeded sine under noise at `bps` bits, one column a channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    amp = (1 << (bps - 2)) - 1
    x = amp * np.sin(2 * np.pi * 440 * t / 44100 * (1 + np.arange(ch))) \
        + rng.standard_normal((n, ch)) * amp / 80
    return x.astype(np.int64)


def test_crc_header_and_numbers():
    for mod in (tflac, jflac):
        assert mod.crc8(b"123456789") == 0xF4
        assert mod.crc16(b"123456789") == 0xFEE8
    for v in (0, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10FFFF, (1 << 31) - 1,
              (1 << 36) - 1):
        bw = tflac._BitWriter()
        tflac._write_utf8(bw, v)
        jw = jflac._BitWriter()
        jflac._write_utf8(jw, v)
        assert bw.get_bytes() == jw.get_bytes()
        assert tflac._read_utf8(tflac._BitReader(bw.get_bytes())) == v
    blob = jflac.encode(signal(5000, 1, 16), 22050, bps=16)
    (ts, toff), (js, joff) = (tflac.parse_stream_header(blob),
                              jflac.parse_stream_header(blob))
    assert toff == joff and vars(ts) == vars(js)


@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("ch", [1, 2, 5, 8])
def test_streams_equal(bps, ch):
    """The port's Python and native encoders write the JAX package's
    stream; every decoder gives the samples back."""
    x = signal(4500 if ch < 5 else 2300, ch, bps, seed=ch)
    gold = jflac.encode(x, 44100, bps=bps, blocksize=1024)
    assert tflac.encode(x, 44100, bps=bps, blocksize=1024) == gold
    assert tnflac.get_lib() is not None
    assert tnflac.encode(x, 44100, bps=bps, blocksize=1024) == gold
    got, si = tflac.decode(gold)
    ref, jsi = jflac.decode(gold)
    assert vars(si) == vars(jsi)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, x)
    nat = tnflac.decode(gold)
    assert nat[1:] == (44100, ch, bps)
    np.testing.assert_array_equal(nat[0], x)
    assert si.md5 == hashlib.md5(tflac._md5_raw_bytes(
        x, (bps + 7) // 8)).digest()


@pytest.mark.parametrize("kind", ["constant", "verbatim"])
def test_constant_and_verbatim_subframes(kind):
    x = (np.full((6000, 2), 123, np.int64) if kind == "constant"
         else np.random.default_rng(3).integers(-32768, 32768, (5000, 1)))
    gold = jflac.encode(x, 8000, bps=16)
    assert tflac.encode(x, 8000, bps=16) == gold
    assert tnflac.encode(x, 8000, bps=16) == gold
    np.testing.assert_array_equal(tflac.decode(gold)[0], x)


def test_corrupt_frame_rejected_alike():
    blob = bytearray(jflac.encode(signal(5000, 1, 16), 44100))
    blob[100] ^= 0xFF
    errs = []
    for mod in (tflac, jflac):
        with pytest.raises(ValueError) as e:
            mod.decode(bytes(blob))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    got, ref = tnflac.decode(bytes(blob)), jnflac.decode(bytes(blob))
    assert (got is None) == (ref is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]


def lpc_stream(x):
    """A hand-built stream with an order-1 LPC subframe (coef 1, shift 0),
    a subframe type the encoder never writes."""
    n = len(x)
    head = tflac._BitWriter()
    head.write(0x664C6143, 32)
    for v, bits in ((1, 1), (0, 7), (34, 24), (n, 16), (n, 16), (0, 24),
                    (0, 24), (8000, 20), (0, 3), (15, 5), (n, 36)):
        head.write(v, bits)
    blob = bytearray(head.get_bytes()) + b"\0" * 16
    bw = tflac._BitWriter()
    for v, bits in ((0x3FFE, 14), (0, 2), (1, 4), (4, 4), (0, 4), (4, 3),
                    (0, 1)):
        bw.write(v, bits)
    tflac._write_utf8(bw, 0)
    hdr = bw.get_bytes()
    bw2 = tflac._BitWriter()
    bw2._out = bytearray(hdr)
    bw2.write(tflac.crc8(hdr), 8)
    for v, bits in ((0, 1), (32, 6), (0, 1), (int(x[0]), 16), (1, 4),
                    (0, 5), (1, 2), (0, 2), (0, 4)):
        bw2.write(v, bits)
    res = np.diff(x)
    k, _ = tflac._best_rice_param(res)
    bw2.write(k, 4)
    tflac._write_rice(bw2, res, k)
    body = bw2.get_bytes()
    return bytes(blob + body + struct.pack(">H", tflac.crc16(body)))


def test_lpc_subframes_decode_alike():
    x = (np.sin(np.arange(192) / 5) * 1000).astype(np.int64)
    blob = lpc_stream(x)
    for dec in (tflac.decode, jflac.decode):
        np.testing.assert_array_equal(dec(blob)[0][:, 0], x)
    np.testing.assert_array_equal(tnflac.decode(blob)[0][:, 0], x)


@pytest.mark.parametrize("fmt,ch", [("S16LE", 1), ("S16LE", 2),
                                    ("S8", 2), ("S24LE", 2), ("S32LE", 1),
                                    ("S16LE", 8)])
def test_flacenc_flacdec(fmt, ch, tmp_path):
    """flacenc writes the JAX package's file; flacdec reads it in blocks of
    `blocksize` (the last one short), S32 as 32-bit samples."""
    path = write_both(f"{asrc(fmt, ch, 44100)} ! flacenc blocksize=1152 "
                      f"location={{loc}}", {"in": audio(fmt, ch, 44100, 1500,
                                                        3, ch)},
                      tmp_path, "flac")
    _, _, _, out = pair(f"flacdec location={path} blocksize=1000 ! "
                        f"appsink name=out")
    assert [s.buffer.data.shape[0] for s in out["out"]] == [1000] * 4 + [500]


@pytest.mark.parametrize("native", [True, False])
def test_flacenc_python_path(native, tmp_path, monkeypatch):
    """Without the native library both elements take the Python codec:
    the same file and samples."""
    if not native:
        monkeypatch.setattr(tnflac, "get_lib", lambda: None)
        monkeypatch.setattr(jnflac, "get_lib", lambda: None)
    path = write_both(f"{asrc('S16LE', 2, 22050)} ! flacenc "
                      f"location={{loc}}",
                      {"in": audio("S16LE", 2, 22050, 2000, 2, 7)}, tmp_path,
                      "flac")
    pair(f"flacdec location={path} ! appsink name=out")


def test_flacdec_asr_chain(tmp_path):
    path = write_both(f"{asrc('S16LE', 2, 48000)} ! flacenc location={{loc}}",
                      {"in": audio("S16LE", 2, 48000, 4800, 3, 2)}, tmp_path,
                      "flac")
    pair(f"flacdec location={path} ! {ASR}")


def test_flacparse_frames(tmp_path):
    """flacparse on the JAX tests' stream (4 frames and a header), fed in
    1000-byte chunks: the same frames, pts and caps."""
    x = (np.random.default_rng(1).standard_normal((4096 * 3 + 100, 1))
         * 3000).astype(np.int64)
    blob = jflac.encode(x, 44100, bps=16)
    pushes = [dict(data=np.frombuffer(blob[i:i + 1000], np.uint8).copy(),
                   pts=0) for i in range(0, len(blob), 1000)]
    _, ref, _, out = pair("appsrc name=in ! application/octet-stream ! "
                          "flacparse ! appsink name=out", {"in": pushes},
                          host_bytes=True)
    assert len(out["out"]) == len(ref["out"]) > 0


@pytest.mark.parametrize("rate,ch,blocksize", [(22050, 2, 4096),
                                               (8000, 1, 1024)])
def test_oggmux_oggdemux_flac(rate, ch, blocksize, tmp_path):
    """FLAC in Ogg: the same pages (granulepos, CRC), read back as the
    samples written."""
    pushes = audio("S16LE", ch, rate, 1500, 4, rate)
    path = write_both(f"{asrc('S16LE', ch, rate)} ! oggmux blocksize="
                      f"{blocksize} location={{loc}}", {"in": pushes},
                      tmp_path, "ogg")
    _, _, _, out = pair(f"oggdemux location={path} ! appsink name=out")
    got = np.concatenate([s.buffer.data.numpy() for s in out["out"]])
    np.testing.assert_array_equal(got, np.concatenate(
        [p["data"] for p in pushes]))


@pytest.mark.parametrize("ext", ["flac", "ogg"])
def test_uridecodebin_flac(ext, tmp_path):
    mux = "flacenc" if ext == "flac" else "oggmux"
    path = write_both(f"{asrc('S16LE', 2, 48000)} ! {mux} location={{loc}}",
                      {"in": audio("S16LE", 2, 48000, 2400, 2, 5)}, tmp_path,
                      ext)
    pair(f"uridecodebin uri=file://{path} ! {ASR}")
