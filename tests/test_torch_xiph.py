"""The port's Xiph codecs against the JAX package, bit for bit: the Ogg page
layer (``elements/ogg.py``), ``codecs/vorbis.py`` with ``vorbis_enc.py``,
``codecs/theora.py`` with ``theora_enc.py``, the elements vorbisdec,
vorbisenc, theoradec, theoraenc, theoraparse and opusparse, and oggdemux's
Vorbis and Theora mappings.

Inputs come from seeded numpy through the system libvorbisenc and
libtheoraenc (the JAX package's own oracles in ``tests/``); a test skips
only where such a library is absent, as the JAX package's do.  Decoded
PCM and planes, written files, samples, caps, negotiation and bus messages
equal the JAX package's, tolerance 0.  Video stays at or under 320x240 and
audio at or under 2 s.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import audio_oracle as ao  # noqa: E402
import theora_oracle as to  # noqa: E402

from gstreamer_tpu.codecs import theora as jtheora  # noqa: E402
from gstreamer_tpu.codecs import theora_enc as jtenc  # noqa: E402
from gstreamer_tpu.codecs import vorbis as jvorbis  # noqa: E402
from gstreamer_tpu.codecs import vorbis_enc as jvenc  # noqa: E402
from gstreamer_tpu.core.buffer import Buffer as JBuffer  # noqa: E402
from gstreamer_tpu.core.parse import parse_launch as jparse  # noqa: E402
from gstreamer_tpu.elements import ogg as jogg  # noqa: E402
from gstreamer_tpu.elements import xiph as jxiph  # noqa: E402

import gstreamer_tpu_torch  # noqa: E402
from gstreamer_tpu_torch.codecs import theora as ttheora  # noqa: E402
from gstreamer_tpu_torch.codecs import theora_enc as ttenc  # noqa: E402
from gstreamer_tpu_torch.codecs import vorbis as tvorbis  # noqa: E402
from gstreamer_tpu_torch.codecs import vorbis_enc as tvenc  # noqa: E402
from gstreamer_tpu_torch.core.buffer import Buffer  # noqa: E402
from gstreamer_tpu_torch.elements import ogg as togg  # noqa: E402
from gstreamer_tpu_torch.elements import xiph as txiph  # noqa: E402

from test_torch_analytics import same_spec  # noqa: E402
from test_torch_captions import _run, pair, plain  # noqa: E402
from test_torch_file_formats import ASR, asrc, audio, write_both  # noqa: E402

needs_vorbis = pytest.mark.skipif(not ao.have_vorbis(),
                                  reason="system libvorbis missing")
needs_theora = pytest.mark.skipif(not to.have_theora(),
                                  reason="system libtheora missing")
FACTORIES = ("vorbisdec", "vorbisenc", "theoradec", "theoraenc",
             "theoraparse", "opusparse")
tparse = gstreamer_tpu_torch.parse_launch


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


# -- the Ogg page layer --------------------------------------------------------

@pytest.mark.parametrize("pkts", [
    [b"hello", b"x" * 300, b"", b"tail"], [b"a" * 255], [b"b" * 510, b"c"],
    [bytes(range(256)) * 250]])
def test_ogg_pages_equal(pkts):
    for bos, eos in ((True, False), (False, True)):
        page = togg.ogg_page(pkts, 42, 7, 1234, bos=bos, eos=eos)
        assert page == jogg.ogg_page(pkts, 42, 7, 1234, bos=bos, eos=eos)
        assert togg.parse_ogg_pages(page) == jogg.parse_ogg_pages(page) \
            == [(42, 1234, pkts)]
    assert togg.ogg_crc(page) == jogg.ogg_crc(page)


def test_ogg_spanning_packets_and_corruption():
    """A packet split across two pages is reassembled alike; a corrupt
    page raises the same error."""
    big = bytes(np.random.default_rng(4).integers(0, 256, 600, np.uint8))
    first = jogg.ogg_page([big[:510]], 9, 0, -1)
    # the first page's last lacing value is 255: the packet continues
    first = first[:26] + bytes([2, 255, 255]) + first[30:]
    crc = jogg.ogg_crc(first[:22] + b"\0\0\0\0" + first[26:])
    first = first[:22] + crc.to_bytes(4, "little") + first[26:]
    data = first + jogg.ogg_page([big[510:]], 9, 1, 5)
    assert togg.parse_ogg_pages(data) == jogg.parse_ogg_pages(data)
    assert togg.parse_ogg_pages(data)[-1][2] == [big]
    bad = bytearray(jogg.ogg_page([b"data"], 1, 0, 0))
    bad[-1] ^= 0xFF
    errs = []
    for mod in (togg, jogg):
        with pytest.raises(ValueError) as e:
            mod.parse_ogg_pages(bytes(bad))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@needs_theora
def test_theoraenc_1080p_keyframe_is_a_reference_fault(tmp_path):
    """ogg_page writes whole packets only and refuses one needing more than
    255 lacing values (more than 65 024 bytes).  A 1080p keyframe at
    theoraenc's default quality 48 is larger, so theoraenc at 1080p raises
    in both packages (ROADMAP.md section 3); the packet is fine in Matroska."""
    pkt = bytes(65025)
    for mod in (togg, jogg):
        mod.ogg_page([bytes(65024)], 1, 0, 0)
        with pytest.raises(ValueError, match="too many segments"):
            mod.ogg_page([pkt], 1, 0, 0)
    rng = np.random.default_rng(20)
    y = rng.integers(0, 256, (1, 1080, 1920), np.uint8)
    c = rng.integers(0, 256, (1, 540, 960), np.uint8)
    hdrs, pkts = jtenc.encode_packets([(y[0], c[0], c[0])], 1920, 1080,
                                      (25, 1))
    assert len(pkts[0]) > 65024
    desc = ("appsrc name=in caps=video/x-raw,format=I420,width=1920,"
            f"height=1080,framerate=25/1 ! theoraenc location={{loc}}")
    push = {"in": [dict(data=(y, c, c.copy()), pts=0, duration=40_000_000)]}
    for parse, buf, kw, loc in ((jparse, JBuffer, {}, tmp_path / "j.ogv"),
                                (tparse, Buffer, {"device": "cpu"},
                                 tmp_path / "t.ogv")):
        with pytest.raises(ValueError, match="too many segments"):
            _run(parse, buf, desc.format(loc=loc), push, (), 1, None, **kw)


# -- Vorbis --------------------------------------------------------------------

def tone(rate, ch, seconds, seed=0, clicks=False):
    t = np.arange(int(rate * seconds))[:, None] / rate
    x = 0.4 * np.sin(2 * np.pi * (440 + 220 * np.arange(ch)) * t)
    rng = np.random.default_rng(seed)
    x = x + rng.normal(0, 0.02, x.shape)
    if clicks:
        for k in range(0, len(x), 3000):
            x[k:k + 60] += rng.normal(0, 0.6, x[k:k + 60].shape)
    return np.clip(x, -1, 1).astype(np.float32)


@needs_vorbis
@pytest.mark.parametrize("rate,ch,q,clicks", [
    (44100, 2, 0.4, False), (48000, 1, -0.1, False), (8000, 1, 0.9, False),
    (22050, 2, 0.1, True), (44100, 6, 0.4, False), (96000, 2, 0.5, False)])
def test_vorbis_pcm_bit_equal(rate, ch, q, clicks):
    """vorbis_enc writes the JAX package's stream; the port's decoder gives
    its PCM bit for bit (float32, the IMDCT as numpy products)."""
    x = tone(rate, ch, 0.5 if ch > 2 else 1.0, rate, clicks)
    blob = tvenc.encode_ogg(x, rate, q)
    assert blob == jvenc.encode_ogg(x, rate, q)
    pcm, r, c = tvorbis.decode_ogg(blob)
    ref, jr, jc = jvorbis.decode_ogg(blob)
    assert (r, c) == (jr, jc) == (rate, ch)
    assert pcm.dtype == ref.dtype == np.float32
    assert pcm.tobytes() == ref.tobytes()
    gold, _, _ = ao.vorbis_decode_bytes(blob)
    assert len(pcm) == len(gold)


@needs_vorbis
def test_vorbis_headers_and_robustness():
    x = tone(8000, 1, 0.3)
    hdrs, pkts = tvenc.encode_packets(x, 8000)
    assert (hdrs, pkts) == jvenc.encode_packets(x, 8000)
    t = tvorbis.VorbisDecoder(hdrs[0], hdrs[2], hdrs[1])
    j = jvorbis.VorbisDecoder(hdrs[0], hdrs[2], hdrs[1])
    assert (t.rate, t.channels, t.vendor) == (j.rate, j.channels, j.vendor)
    np.testing.assert_array_equal(tvorbis.INVERSE_DB_TABLE,
                                  jvorbis.INVERSE_DB_TABLE)
    rng = np.random.default_rng(11)
    for _ in range(20):
        pkt = rng.integers(0, 256, rng.integers(1, 64), np.uint8).tobytes()
        got = []
        for dec, mod in ((t, tvorbis), (j, jvorbis)):
            try:
                got.append(plain(dec.decode_packets([pkt])))
            except (ValueError, mod.EndOfPacket) as e:
                got.append((type(e).__name__, str(e)))
        assert got[0] == got[1]
    blob = tvenc.encode_ogg(x, 8000)
    for cut in (blob[:137], blob[:40] + bytes([blob[40] ^ 0xFF]) + blob[41:]):
        errs = []
        for mod in (tvorbis, jvorbis):
            with pytest.raises(ValueError) as e:
                mod.decode_ogg(cut)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@needs_vorbis
@pytest.mark.parametrize("fmt,ch,quality", [("F32LE", 2, 0.4),
                                            ("S16LE", 1, 0.2),
                                            ("F32LE", 6, 0.6)])
def test_vorbisenc_vorbisdec(fmt, ch, quality, tmp_path):
    """vorbisenc writes the JAX package's file; vorbisdec and oggdemux give
    its PCM in blocks of `blocksize`."""
    path = write_both(f"{asrc(fmt, ch, 44100)} ! vorbisenc quality={quality}"
                      f" location={{loc}}",
                      {"in": audio(fmt, ch, 44100, 8820, 2, ch)}, tmp_path,
                      "ogg")
    pair(f"vorbisdec location={path} blocksize=2048 ! appsink name=out")
    pair(f"oggdemux location={path} ! appsink name=out")


@needs_vorbis
def test_vorbis_into_the_asr_front_end(tmp_path):
    """vorbisdec's PCM equals the JAX package's; through the ASR chain it
    gives what appsrc carrying the JAX package's decode in the same blocks
    gives (F32 resampling is held to the JAX package by the audio tests'
    1-ULP contract, not here)."""
    path = tmp_path / "v.ogg"
    path.write_bytes(tvenc.encode_ogg(tone(48000, 2, 1.0), 48000))
    _, ref, _, _ = pair(f"vorbisdec location={path} ! appsink name=out")
    pushes = [dict(data=np.asarray(s.buffer.data), pts=s.buffer.pts,
                   duration=s.buffer.duration) for s in ref["out"]]
    _, fed = _run(tparse, Buffer, f"{asrc('F32LE', 2, 48000)} ! {ASR}",
                  {"in": pushes}, ("out",), 1, None, device="cpu")
    for desc in (f"vorbisdec location={path}",
                 f"oggdemux location={path}",
                 f"uridecodebin uri=file://{path}"):
        _, out = _run(tparse, Buffer, f"{desc} ! {ASR}", {}, ("out",), 1,
                      None, device="cpu")
        got = torch.cat([s.buffer.data for s in out["out"]])
        want = torch.cat([s.buffer.data for s in fed["out"]])
        assert got.dtype == torch.float32 and torch.equal(got, want), desc


# -- Theora --------------------------------------------------------------------

def noise(rng, shape, s=30):
    return np.clip(rng.normal(128, s, shape), 0, 255).astype(np.uint8)


def chroma_shape(fmt, fh, fw):
    return {0: (fh // 2, fw // 2), 2: (fh, fw // 2), 3: (fh, fw)}[fmt]


def panning(w, h, fmt, n, seed):
    """n frames panning over a seeded noise field (inter frames with
    motion), padded to the coded size."""
    rng = np.random.default_rng(seed)
    fw, fh = (w + 15) & ~15, (h + 15) & ~15
    ch, cw = chroma_shape(fmt, fh, fw)
    big = noise(rng, (fh + 32, fw + 32), 35)
    bigc = noise(rng, (ch + 32, cw + 32), 20)
    sy, sx = ch // fh, cw // fw
    out = []
    for k in range(n):
        dx, dy = 2 * k, k
        out.append((np.ascontiguousarray(big[dy:dy + fh, dx:dx + fw]),
                    np.ascontiguousarray(bigc[:ch, dx:dx + cw]),
                    np.ascontiguousarray(bigc[dy:dy + ch, :cw])))
    return out


def decode_both(hdrs, pkts):
    """Every packet through both packages' decoders: the same planes (and
    both crops), and equal to libtheoradec's."""
    t = ttheora.TheoraDecoder(hdrs[0], hdrs[1], hdrs[2])
    j = jtheora.TheoraDecoder(hdrs[0], hdrs[1], hdrs[2])
    assert (t.pixel_fmt, t.pic_width, t.pic_height, t.fps_n, t.fps_d) == \
        (j.pixel_fmt, j.pic_width, j.pic_height, j.fps_n, j.fps_d)
    gold = to.decode_packets(hdrs, pkts)
    for k, pkt in enumerate(pkts):
        a, b = t.decode_packet(pkt), j.decode_packet(pkt)
        assert (a is None) == (b is None)
        if a is None:
            continue
        for p, q, g in zip(a, b, gold[0][k]):
            np.testing.assert_array_equal(p, q)
            np.testing.assert_array_equal(p, g)
        for p, q in zip(t.crop(a), j.crop(b)):
            np.testing.assert_array_equal(p, q)


@needs_theora
@pytest.mark.parametrize("w,h,fmt,q", [
    (64, 48, 0, 63), (64, 48, 0, 5), (48, 48, 2, 40), (32, 32, 3, 40),
    (176, 144, 0, 30), (50, 38, 0, 40), (320, 240, 0, 48)])
def test_theora_intra_planes_equal(w, h, fmt, q):
    frames = panning(w, h, fmt, 1, w + h + fmt)
    hdrs, pkts = to.encode_packets(frames, w, h, pixel_fmt=fmt, quality=q)
    decode_both(hdrs, pkts)


@needs_theora
@pytest.mark.parametrize("w,h,fmt,q", [(96, 80, 0, 48), (96, 80, 2, 40),
                                       (64, 48, 3, 40), (160, 120, 0, 20)])
def test_theora_inter_planes_equal(w, h, fmt, q):
    """Panning frames: motion vectors, inter blocks and the loop filter."""
    hdrs, pkts = to.encode_packets(panning(w, h, fmt, 8, 5 + fmt), w, h,
                                   pixel_fmt=fmt, quality=q)
    decode_both(hdrs, pkts)


@needs_theora
def test_theora_static_and_scene_cut():
    rng = np.random.default_rng(7)
    a = panning(96, 80, 0, 1, 1)[0]
    frames = [a] * 3 + panning(96, 80, 0, 2, 2) + [
        (noise(rng, (80, 96)), noise(rng, (40, 48)), noise(rng, (40, 48)))]
    hdrs, pkts = to.encode_packets(frames, 96, 80, quality=40)
    decode_both(hdrs, pkts)


def vector_scene():
    """``tests/data/torch_codecs/make_vectors.py`` as a module (its seeded
    panning scene)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("make_vectors", os.path.join(
        os.path.dirname(__file__), "data", "torch_codecs", "make_vectors.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@needs_theora
def test_theora_block_run_of_30_is_a_reference_fault():
    """The coded-block flags' short runs toggle their value after every run,
    one of the maximum length 30 included (libtheoradec).  The JAX
    package's decoder reads a new value after a run of 30 and loses sync
    (ROADMAP.md section 3).  On the vectors' panning scene at 320x240,
    quality 40, the 9th frame holds such a run: the JAX package raises
    there; the port equals libtheoradec on all 12 frames, and the JAX
    package on the 8 before."""
    frames = vector_scene().frames(320, 240, 12)
    hdrs, pkts = to.encode_packets(frames, 320, 240, quality=40)
    gold = to.decode_packets(hdrs, pkts)[0]
    t = ttheora.TheoraDecoder(hdrs[0], hdrs[1], hdrs[2])
    j = jtheora.TheoraDecoder(hdrs[0], hdrs[1], hdrs[2])
    for k, pkt in enumerate(pkts):
        got = t.decode_packet(pkt)
        for p, g in zip(got, gold[k]):
            np.testing.assert_array_equal(p, g)
        if k < 8:
            for p, q in zip(got, j.decode_packet(pkt)):
                np.testing.assert_array_equal(p, q)
        elif k == 8:
            with pytest.raises(jtheora.EndOfPacket):
                j.decode_packet(pkt)


@needs_theora
def test_theora_robustness():
    frames = panning(64, 48, 0, 1, 1)
    hdrs, pkts = ttenc.encode_packets(frames, 64, 48)
    assert (hdrs, pkts) == jtenc.encode_packets(frames, 64, 48)
    errs = []
    for mod in (ttheora, jtheora):
        with pytest.raises(ValueError) as e:
            mod.TheoraDecoder(b"\x80cheora" + b"\0" * 40, None, b"")
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    t = ttheora.TheoraDecoder(hdrs[0], hdrs[1], hdrs[2])
    j = jtheora.TheoraDecoder(hdrs[0], hdrs[1], hdrs[2])
    t.decode_packet(pkts[0])
    j.decode_packet(pkts[0])
    rng = np.random.default_rng(1)
    for _ in range(10):
        blob = rng.integers(0, 256, rng.integers(4, 64), np.uint8).tobytes()
        blob = bytes([blob[0] & 0x3F]) + blob[1:]
        got = []
        for dec, mod in ((t, ttheora), (j, jtheora)):
            try:
                got.append(plain(dec.decode_packet(blob)))
            except (ValueError, IndexError, mod.EndOfPacket) as e:
                got.append(type(e).__name__)
        assert got[0] == got[1]


def vpushes(w, h, n, batch, seed):
    frames = panning(w, h, 0, n, seed)
    y = np.stack([f[0][:h, :w] for f in frames])
    u = np.stack([f[1][:h // 2, :w // 2] for f in frames])
    v = np.stack([f[2][:h // 2, :w // 2] for f in frames])
    return [dict(data=(y[k:k + batch], u[k:k + batch], v[k:k + batch]),
                 batch=batch, pts=k * 40_000_000, duration=40_000_000)
            for k in range(0, n, batch)]


def vsrc(w, h):
    return (f"appsrc name=in caps=video/x-raw,format=I420,width={w},"
            f"height={h},framerate=25/1")


@needs_theora
@pytest.mark.parametrize("w,h,quality,batch", [(64, 48, 48, 2),
                                               (160, 120, 20, 3),
                                               (50, 38, 40, 1)])
def test_theoraenc_theoradec(w, h, quality, batch, tmp_path):
    """theoraenc writes the JAX package's file; theoradec and oggdemux
    stream=video give its planes, batch by batch, and through the
    converter the same RGB."""
    path = write_both(f"{vsrc(w, h)} ! theoraenc quality={quality} "
                      f"location={{loc}}",
                      {"in": vpushes(w, h, 6, batch, w)}, tmp_path, "ogv",
                      batch=batch)
    pair(f"theoradec location={path} ! appsink name=out", batch=batch)
    pair(f"oggdemux location={path} stream=video ! appsink name=out",
         batch=batch)
    pair(f"theoradec location={path} ! videoconvertscale add-borders=false"
         f" ! video/x-raw,format=RGB,width=32,height=24 ! appsink name=out",
         batch=batch)


@needs_theora
@pytest.mark.parametrize("fmt", [2, 3])
def test_theoradec_422_444_files(fmt, tmp_path):
    """4:2:2 and 4:4:4 Ogg/Theora files (libtheoraenc through the oracle):
    theoradec's Y42B / Y444 planes and caps equal the JAX package's."""
    hdrs, pkts = to.encode_packets(panning(48, 32, fmt, 4, fmt), 48, 32,
                                   pixel_fmt=fmt, quality=40)
    pages = [jogg.ogg_page([hdrs[0]], 5, 0, 0, bos=True),
             jogg.ogg_page(hdrs[1:], 5, 1, 0)]
    pages += [jogg.ogg_page([p], 5, 2 + k, k, eos=k == len(pkts) - 1)
              for k, p in enumerate(pkts)]
    path = tmp_path / "t.ogv"
    path.write_bytes(b"".join(pages))
    pair(f"theoradec location={path} ! appsink name=out", batch=2)
    pair(f"oggdemux location={path} ! appsink name=out", batch=2)


@needs_theora
@needs_vorbis
def test_oggdemux_picks_the_stream(tmp_path):
    """A two-stream Ogg file (Theora and Vorbis pages): stream=video and
    stream=audio pick their mapping in both packages; an unknown mapping
    raises the same error."""
    th = ttenc.encode_ogg([f[:3] for f in panning(32, 32, 0, 2, 3)], 32, 32)
    vb = tvenc.encode_ogg(tone(8000, 1, 0.2), 8000)
    path = tmp_path / "av.ogg"
    path.write_bytes(th + vb)
    pair(f"oggdemux location={path} stream=video ! appsink name=out",
         batch=2)
    pair(f"oggdemux location={path} stream=audio ! appsink name=out")
    odd = tmp_path / "odd.ogg"
    odd.write_bytes(jogg.ogg_page([b"\x01unknown"], 3, 0, 0, bos=True))
    for mod in (togg, jogg):
        e = mod.OggDemux(location=str(odd))
        with pytest.raises(ValueError, match="unsupported ogg mapping"):
            e._load()


@pytest.mark.parametrize("head", [b"OpusHead\x01\x02" + bytes(9),
                                  b"Speex   " + bytes(72)])
def test_oggdemux_opus_speex_raise(head, tmp_path):
    """Ogg-Opus decodes since the Opus slice, Ogg-Speex since the libav
    slice (before which each raised naming ROADMAP.md).  The Opus stream
    (an OpusHead, then one packet, granule 0) gives the JAX package's
    samples and caps; the Speex one (a zeroed header, no frame) fails in
    both packages with the same error."""
    path = tmp_path / "x.ogg"
    path.write_bytes(jogg.ogg_page([head], 3, 0, 0, bos=True)
                     + jogg.ogg_page([b"tags"], 3, 1, 0))
    if head.startswith(b"OpusHead"):
        pair(f"oggdemux location={path} ! appsink name=out")
        return
    errors = []
    for parse, kw in ((jparse, {}), (tparse, {"device": "cpu"})):
        with pytest.raises(Exception) as e:
            parse(f"oggdemux name=d location={path} ! fakesink", **kw).run()
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]


@needs_theora
def test_theoraparse_and_opusparse(tmp_path):
    """theoraparse attaches the ident header's caps, opusparse the TOC
    byte's duration; the same buffers in both packages."""
    hdrs, pkts = ttenc.encode_packets(panning(64, 48, 0, 2, 1), 64, 48,
                                      (30, 1))
    blobs = [np.frombuffer(p, np.uint8).copy() for p in hdrs + pkts]
    pair("appsrc name=in caps=video/x-theora ! theoraparse ! "
         "appsink name=out", {"in": [dict(data=[b], batch=1, pts=k)
                                     for k, b in enumerate(blobs)]})
    t = txiph.TheoraParse().host_process(Buffer(data=[blobs[0]], batch=1))
    j = jxiph.TheoraParse().host_process(JBuffer(data=[blobs[0]], batch=1))
    assert str(t.meta["caps"]) == str(j.meta["caps"])
    tocs = [bytes([c << 3 | code, 3]) for c in (0, 3, 13, 17, 31)
            for code in range(4)] + [b""]
    for pkt in tocs:
        assert txiph.OpusParse.packet_duration_ns(pkt) == \
            jxiph.OpusParse.packet_duration_ns(pkt)
    pair("appsrc name=in caps=audio/x-opus ! opusparse ! appsink name=out",
         {"in": [dict(data=[np.frombuffer(p, np.uint8).copy()], batch=1,
                      pts=k, duration=1) for k, p in enumerate(tocs[:-1])]})
