"""The port's file, link and small host modules against the JAX package,
bit for bit: wav_elements (wavparse, wavenc), simple_formats (pnm, Sun AU,
AIFF), ``audio/adpcm.py`` with adpcmenc / adpcmdec, gdp (gdppay,
gdpdepay), ipcpipeline, inter_netsim (the inter bridges, netsim, the
segment clips) and good_extras.

Writers run in both packages on the same seeded pushes and must write the
same bytes; readers run in both on the same file; samples, caps,
negotiation and bus messages equal (``test_torch_captions.pair``),
tolerance 0.  The WAV file feeding the ASR front-end gives the samples
that ``appsrc`` carrying the same samples gives.
"""

import os

import numpy as np
import pytest
import torch

from gstreamer_tpu.audio import adpcm as jadpcm
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.events import Event as JEvent
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import gdp as jgdp
from gstreamer_tpu.elements import inter_netsim as jinter
from gstreamer_tpu.elements import simple_formats as jsf

import gstreamer_tpu_torch
from gstreamer_tpu_torch.audio import adpcm as tadpcm
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.core.events import Event as TEvent
from gstreamer_tpu_torch.elements import gdp as tgdp
from gstreamer_tpu_torch.elements import inter_netsim as tinter
from gstreamer_tpu_torch.elements import simple_formats as tsf
from gstreamer_tpu_torch.interop import negotiated_caps

from test_torch_analytics import same_spec
from test_torch_captions import (_run, pair, plain, sample_rows,
                                 video_pushes, vsrc)

FACTORIES = ("wavparse", "wavenc", "pnmenc", "pnmdec", "auparse", "auenc",
             "aiffmux", "aiffparse", "adpcmenc", "adpcmdec", "gdppay",
             "gdpdepay", "ipcpipelinesink", "ipcpipelinesrc",
             "ipcslavepipeline", "intervideosink", "intervideosrc",
             "interaudiosink", "interaudiosrc", "intersubsink",
             "intersubsrc", "netsim", "videosegmentclip", "audiosegmentclip",
             "aspectratiocrop", "imagesequencesrc", "pushfilesrc",
             "splitfilesrc", "rndbuffersize", "capsdebug", "testsink",
             "navseek", "navigationtest")
tparse = gstreamer_tpu_torch.parse_launch


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


def audio(fmt, ch, rate, frames, pushes, seed):
    """Seeded pushes of `fmt` samples (a sine under noise)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(pushes):
        n = np.arange(t * frames, (t + 1) * frames)[:, None]
        x = 0.6 * np.sin(2 * np.pi * 440 * n / rate * (1 + np.arange(ch))) \
            + rng.normal(0, 0.05, (frames, ch))
        x = np.clip(x, -1, 1)
        if fmt.startswith("F"):
            a = x.astype(np.float32 if "32" in fmt else np.float64)
        elif fmt == "U8":
            a = np.round(x * 127 + 128).astype(np.uint8)
        elif fmt == "S8":
            a = np.round(x * 127).astype(np.int8)
        else:
            bits = {"S16": 16, "S24": 24, "S32": 32}[fmt[:3]]
            a = np.round(x * (2 ** (bits - 1) - 1)).astype(
                np.int16 if bits == 16 else np.int32)
        out.append(dict(data=a, pts=t * frames * 10 ** 9 // rate,
                        duration=frames * 10 ** 9 // rate))
    return out


def asrc(fmt, ch, rate, name="in"):
    return (f"appsrc name={name} caps=audio/x-raw,format={fmt},rate={rate},"
            f"channels={ch},layout=interleaved")


def write_both(desc, pushes, tmp_path, ext, batch=1):
    """`desc` with {loc} through both packages, each writing a file of its
    own: the files must be the same bytes; returns the port's path."""
    jl, tl = tmp_path / f"jax.{ext}", tmp_path / f"port.{ext}"
    jpipe, _ = _run(jparse_launch, JBuffer, desc.format(loc=jl), pushes, (),
                    batch, None)
    tpipe, _ = _run(tparse, Buffer, desc.format(loc=tl), pushes, (), batch,
                    None, device="cpu")
    assert tl.read_bytes() == jl.read_bytes()
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)
    return tl


# -- WAV ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["S16LE", "U8", "S24LE", "S32LE", "F32LE",
                                 "F64LE"])
@pytest.mark.parametrize("ch", [1, 2])
def test_wav_pcm_roundtrip(fmt, ch, tmp_path):
    """wavenc writes the same file; wavparse reads it in blocks of
    `blocksize` (the last one short)."""
    path = write_both(f"{asrc(fmt, ch, 8000)} ! wavenc location={{loc}}",
                      {"in": audio(fmt, ch, 8000, 700, 3, ch)}, tmp_path,
                      "wav")
    _, _, tpipe, out = pair(f"wavparse location={path} blocksize=500 ! "
                            f"appsink name=out")
    assert sum(s.buffer.data.shape[0] for s in out["out"]) == 2100


@pytest.mark.parametrize("law", ["mulaw", "alaw"])
def test_wav_law(law, tmp_path):
    path = write_both(f"{asrc('S16LE', 2, 8000)} ! {law}enc ! wavenc "
                      f"location={{loc}}",
                      {"in": audio("S16LE", 2, 8000, 500, 2, 1)}, tmp_path,
                      "wav")
    pair(f"wavparse location={path} ! {law}dec ! appsink name=out")


@pytest.mark.parametrize("ch", [1, 2])
def test_wav_adpcm(ch, tmp_path):
    """adpcmenc's IMA blocks in a WAV (fmt 18 + fact), read back as blocks
    of host bytes straight into adpcmdec."""
    path = write_both(f"{asrc('S16LE', ch, 22050)} ! adpcmenc blockalign="
                      f"512 ! wavenc location={{loc}}",
                      {"in": audio("S16LE", ch, 22050, 1017, 4, ch)},
                      tmp_path, "wav")
    _, _, tpipe, _ = pair(f"wavparse location={path} ! appsink name=out")
    _, _, tpipe, _ = pair(f"wavparse location={path} ! adpcmdec ! "
                          f"appsink name=out")
    assert tpipe.get_by_name("wavparse_0") in tpipe._host_fed


def test_wav_seek(tmp_path):
    path = write_both(f"{asrc('S16LE', 2, 8000)} ! wavenc location={{loc}}",
                      {"in": audio("S16LE", 2, 8000, 800, 2, 5)}, tmp_path,
                      "wav")
    pair(f"wavparse location={path} blocksize=300 ! appsink name=out",
         setup=lambda p: p.seek(25_000_000))


ASR = ("audioconvert ! audio/x-raw,channels=1 ! audioresample ! "
       "audio/x-raw,rate=16000 ! audioconvert ! audio/x-raw,format=F32LE ! "
       "appsink name=out")


def test_wav_into_the_asr_front_end(tmp_path):
    """BASELINE config 2 from a file: wavparse's samples through the ASR
    chain equal the JAX package's, and the port's own run with appsrc
    carrying the same samples in the same blocks."""
    pushes = audio("S16LE", 2, 48000, 4800, 4, 2)
    path = write_both(f"{asrc('S16LE', 2, 48000)} ! wavenc location={{loc}}",
                      {"in": pushes}, tmp_path, "wav")
    _, _, _, out = pair(f"wavparse location={path} blocksize=4800 ! {ASR}")
    _, fed = _run(tparse, Buffer, f"{asrc('S16LE', 2, 48000)} ! {ASR}",
                  {"in": pushes}, ("out",), 1, None, device="cpu")
    got = torch.cat([s.buffer.data for s in out["out"]])
    want = torch.cat([s.buffer.data for s in fed["out"]])
    assert got.dtype == torch.float32 and torch.equal(got, want)


# -- PNM, Sun AU, AIFF --------------------------------------------------------

PNMS = [b"P2\n# comment\n3 2\n255\n0 128 255\n10 20 30\n",
        b"P1\n4 2\n0 1 1 0\n1 1 1 1\n", b"P4\n8 1\n" + bytes([0b10110001]),
        b"P3\n2 1\n15\n15 0 7 1 2 3\n",
        b"P5\n3 1\n100\n" + bytes([0, 50, 100]),
        b"X1\n"]


@pytest.mark.parametrize("k", range(len(PNMS)))
def test_pnm_decode(k):
    try:
        want = jsf.pnm_decode(PNMS[k])
    except ValueError:
        with pytest.raises(ValueError):
            tsf.pnm_decode(PNMS[k])
        return
    assert plain(tsf.pnm_decode(PNMS[k])) == plain(want)


@pytest.mark.parametrize("fmt", ["RGB", "GRAY8"])
@pytest.mark.parametrize("batch", [1, 3])
def test_pnm_pipeline(fmt, batch, tmp_path):
    """pnmenc's host bytes (a list, one image a frame) and pnmenc ! pnmdec
    back to the same planes; pnmdec peeks a file's header through filesrc
    and takes its bytes unstaged."""
    rng = np.random.default_rng(batch)
    shape = (batch, 20, 30)
    planes = tuple(rng.integers(0, 256, shape, dtype=np.uint8)
                   for _ in range(3 if fmt == "RGB" else 1))
    push = [dict(data=planes, pts=0, duration=10 ** 8, batch=batch)]
    src = vsrc(30, 20, fmt=fmt, rate="10/1")
    _, _, _, enc = pair(f"{src} ! pnmenc ! appsink name=out", {"in": push},
                        batch=batch)
    _, _, _, out = pair(f"{src} ! pnmenc ! pnmdec ! appsink name=out",
                        {"in": push}, batch=batch)
    for a, b in zip(out["out"][0].buffer.data, planes):
        assert np.array_equal(a.numpy(), b)
    f = tmp_path / "img.pnm"
    f.write_bytes(enc["out"][0].buffer.data[0])
    _, _, tpipe, _ = pair(f"filesrc location={f} ! pnmdec ! appsink "
                          f"name=out")
    assert tpipe.get_by_name("filesrc_0") in tpipe._host_fed


@pytest.mark.parametrize("kind", ["S8", "S16BE", "mulaw", "alaw"])
def test_au_roundtrip(kind, tmp_path):
    chain = (f"{asrc(kind, 2, 8000)} ! auenc location={{loc}}"
             if kind.startswith("S") else
             f"{asrc('S16LE', 2, 8000)} ! {kind}enc ! auenc location={{loc}}")
    fmt = kind if kind.startswith("S") else "S16LE"
    path = write_both(chain, {"in": audio(fmt, 2, 8000, 400, 3, 3)},
                      tmp_path, "au")
    pair(f"auparse location={path} ! appsink name=out")


@pytest.mark.parametrize("fmt", ["S8", "S16BE", "S24BE", "S32BE"])
def test_aiff_roundtrip(fmt, tmp_path):
    path = write_both(f"{asrc(fmt, 2, 44100)} ! aiffmux location={{loc}}",
                      {"in": audio(fmt, 2, 44100, 900, 3, 4)}, tmp_path,
                      "aiff")
    pair(f"aiffparse location={path} blocksize=1000 ! appsink name=out")


def test_float80():
    for v in (0.0, 1.0, 8000.0, 44100.0, 48000.0, 96000.0, -3.5, 1e-300,
              123456.789):
        b = tsf._float80_encode(v)
        assert b == jsf._float80_encode(v)
        assert tsf._float80_decode(b) == jsf._float80_decode(b)


# -- ADPCM --------------------------------------------------------------------

@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("size", [40, 256, 1024])
def test_adpcm_codecs(ch, size):
    """The IMA and MS block decoders on seeded blocks and the IMA encoder
    over consecutive blocks (the step index carried across them)."""
    rng = np.random.default_rng(size + ch)
    block = bytearray(rng.integers(0, 256, size, dtype=np.uint8))
    for c in range(ch):
        block[c * 4 + 2] %= 89
        block[c * 4 + 3] = 0
    assert plain(tadpcm.decode_ima_block(bytes(block), ch)) == \
        plain(jadpcm.decode_ima_block(bytes(block), ch))
    ms = bytearray(rng.integers(0, 256, size, dtype=np.uint8))
    for c in range(ch):
        ms[c] %= 7
    assert plain(tadpcm.decode_ms_block(bytes(ms), ch)) == \
        plain(jadpcm.decode_ms_block(bytes(ms), ch))
    te, je = tadpcm.ImaEncoder(ch, size), jadpcm.ImaEncoder(ch, size)
    spb = je.samples_per_block
    x = rng.integers(-30000, 30000, (3 * spb, ch)).astype(np.int16)
    for k in range(3):
        assert te.encode_block(x[k * spb:(k + 1) * spb]) == \
            je.encode_block(x[k * spb:(k + 1) * spb])


@pytest.mark.parametrize("blockalign", [256, 1024])
@pytest.mark.parametrize("ch", [1, 2])
def test_adpcm_elements(blockalign, ch):
    """adpcmenc's coded caps and blocks (samples carried across pushes) and
    adpcmdec's samples on the pipeline's device."""
    desc = (f"{asrc('S16LE', ch, 22050)} ! adpcmenc blockalign={blockalign} "
            f"! tee name=t t. ! queue ! appsink name=coded t. ! queue ! "
            f"adpcmdec ! appsink name=out")
    _, _, _, out = pair(desc, {"in": audio("S16LE", ch, 22050, 1017, 5, 9)},
                        sinks=("coded", "out"))
    assert out["coded"][0].caps[0]["block_align"] == blockalign
    assert all(isinstance(s.buffer.data, torch.Tensor) for s in out["out"])


# -- GDP and ipcpipeline ------------------------------------------------------

def test_gdp_wire_format():
    assert tgdp._CRC_TABLE == jgdp._CRC_TABLE
    for blob in (b"", b"123456789", bytes(range(256)) * 3):
        assert tgdp.dp_crc(blob) == jgdp.dp_crc(blob)
    for kw in (dict(pts=123, duration=456), dict(crc_payload=True),
               dict(crc_header=False), dict(pts=None, duration=7)):
        pkt = tgdp.dp_packet(tgdp.PAYLOAD_BUFFER, b"hello", **kw)
        assert pkt == jgdp.dp_packet(jgdp.PAYLOAD_BUFFER, b"hello", **kw)
        assert tgdp.dp_parse(pkt, 0) == jgdp.dp_parse(pkt, 0)
        assert tgdp.dp_parse(pkt[:-1], 0) is None
    bad = bytearray(jgdp.dp_packet(1, b"payload", crc_payload=True))
    bad[jgdp.HEADER_LEN + 2] ^= 0xFF
    with pytest.raises(ValueError, match="payload CRC"):
        tgdp.dp_parse(bytes(bad), 0)


GDP_STREAMS = {
    "I420": (vsrc(48, 32, rate="30/1"), lambda: video_pushes(48, 32, 2, 2)),
    "RGB": (vsrc(20, 10, fmt="RGB", rate="30/1"),
            lambda: [dict(data=tuple(np.random.default_rng(k).integers(
                0, 256, (2, 10, 20), dtype=np.uint8) for k in range(3)),
                pts=0, duration=33333333, batch=2)]),
    "S16LE": (asrc("S16LE", 2, 8000), lambda: audio("S16LE", 2, 8000, 300,
                                                   3, 1)),
    "octet": ("appsrc name=in caps=application/octet-stream",
              lambda: [dict(data=np.arange(k, 40 + k, dtype=np.uint8),
                            pts=k * 10) for k in range(3)])}


@pytest.mark.parametrize("kind", list(GDP_STREAMS))
@pytest.mark.parametrize("props", ["", "crc-payload=true crc-header=false"])
def test_gdp_roundtrip(kind, props, tmp_path):
    """gdppay's stream (caps packet first, a buffer packet a frame) to the
    same file; gdpdepay replays it into the same samples."""
    src, pushes = GDP_STREAMS[kind]
    batch = 2 if kind in ("I420", "RGB") else 1
    _, _, _, pay = pair(f"{src} ! gdppay {props} ! appsink name=out",
                        {"in": pushes()}, batch=batch)
    path = write_both(f"{src} ! gdppay {props} ! filesink location={{loc}}",
                      {"in": pushes()}, tmp_path, "gdp", batch=batch)
    pair(f"gdpdepay location={path} ! appsink name=out", batch=batch)


def _master(parse, bcls, desc, pushes, batch, **kw):
    r, w = os.pipe()
    _run(parse, bcls, f"{desc} ! ipcpipelinesink fdout={w}", pushes, (),
         batch, None, **kw)
    os.close(w)
    with os.fdopen(r, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["I420", "S16LE"])
@pytest.mark.parametrize("slave", ["ipcpipelinesrc", "ipcslavepipeline"])
def test_ipcpipeline(kind, slave):
    """The master's wire bytes (caps, buffers, EOS) equal between the
    packages, and a slave of either package continues a master of the
    other into the same samples."""
    src, pushes = GDP_STREAMS[kind]
    batch = 2 if kind == "I420" else 1
    jwire = _master(jparse_launch, JBuffer, src, {"in": pushes()}, batch)
    twire = _master(tparse, Buffer, src, {"in": pushes()}, batch,
                    device="cpu")
    assert twire == jwire

    def slave_run(parse, bcls, wire, **kw):
        r, w = os.pipe()
        os.write(w, wire)
        os.close(w)
        pipe, out = _run(parse, bcls, f"{slave} fdin={r} ! appsink name=o",
                         {}, ("o",), batch, None, **kw)
        os.close(r)
        return pipe, out["o"]
    _, ref = slave_run(jparse_launch, JBuffer, jwire)
    tpipe, got = slave_run(tparse, Buffer, jwire, device="cpu")
    assert sample_rows(got) == sample_rows(ref) and got


def test_ipcpipelinesink_without_caps():
    """ANY caps upstream: the sink fails the flow in both."""
    e = tmake("ipcpipelinesink", fdout=1)
    assert e.render(Buffer(data=np.zeros(3, np.uint8))) == "error"
    j = jmake("ipcpipelinesink", fdout=1)
    assert j.render(JBuffer(data=np.zeros(3, np.uint8))) == "error"


# -- inter, netsim, segment clips ---------------------------------------------

@pytest.mark.parametrize("kind", ["video", "audio"])
def test_inter_bridge(kind):
    """A sink pipeline deposits its buffers on a named surface; a second
    pipeline replays them into the same samples and caps."""
    src, pushes = {"video": (vsrc(32, 24, rate="30/1"),
                             lambda: video_pushes(32, 24, 2, 3)),
                   "audio": (asrc("S16LE", 1, 8000),
                             lambda: audio("S16LE", 1, 8000, 500, 2, 0))
                   }[kind]
    outs = []
    for mod, parse, bcls, kw in ((jinter, jparse_launch, JBuffer, {}),
                                 (tinter, tparse, Buffer,
                                  {"device": "cpu"})):
        mod._SURFACES.clear()
        _run(parse, bcls, f"{src} ! inter{kind}sink channel=ch1",
             {"in": pushes()}, (), 2, None, **kw)
        pipe, out = _run(parse, bcls, f"inter{kind}src channel=ch1 ! "
                         f"appsink name=out", {}, ("out",), 2, None, **kw)
        outs.append((pipe, out["out"]))
        mod._SURFACES.clear()
    assert sample_rows(outs[1][1]) == sample_rows(outs[0][1]) and outs[1][1]
    assert negotiated_caps(outs[1][0]) == negotiated_caps(outs[0][0])


def test_intervideosrc_hands_on_the_sinks_tensors():
    """The src pipeline gets the very tensors the sink pipeline left (no
    staging copy of data already on its device); an empty surface is
    EOS at once, as in the reference."""
    tinter._SURFACES.clear()
    _, left = _run(tparse, Buffer, f"{vsrc(32, 24, rate='30/1')} ! tee "
                   f"name=t t. ! intervideosink channel=c t. ! appsink "
                   f"name=out", {"in": video_pushes(32, 24, 2, 2)}, ("out",),
                   2, None, device="cpu")
    stored = [b for _, b in tinter._SURFACES["c"]]
    pipe, out = _run(tparse, Buffer, "intervideosrc channel=c ! appsink "
                     "name=out", {}, ("out",), 2, None, device="cpu")
    assert [s.buffer.data for s in out["out"]] == [b.data for b in stored]
    assert all(a is b for s, st in zip(out["out"], stored)
               for a, b in zip(s.buffer.data, st.data))
    tinter._SURFACES.clear()


def test_intersub_bridge():
    """Text through intersubsink / intersubsrc (the JAX package's fused
    graph cannot carry a text leaf, so the port is held to the pushed
    strings); an empty surface fails negotiation in both packages."""
    tinter._SURFACES.clear()
    lines = [dict(data=f"line {k}", pts=k * 10 ** 9) for k in range(3)]
    _run(tparse, Buffer, "appsrc name=in caps=text/x-raw ! intersubsink "
         "channel=s", {"in": lines}, (), 1, None, device="cpu")
    _, out = _run(tparse, Buffer, "intersubsrc channel=s ! appsink name=out",
                  {}, ("out",), 1, None, device="cpu")
    assert [(s.buffer.data, s.buffer.pts) for s in out["out"]] == \
        [(b["data"], b["pts"]) for b in lines]
    tinter._SURFACES.clear()
    jinter._SURFACES.clear()
    for parse, kw in ((jparse_launch, {}), (tparse, {"device": "cpu"})):
        with pytest.raises(ValueError, match="ANY"):
            parse("intervideosrc channel=empty ! appsink name=out",
                  **kw).run()


@pytest.mark.parametrize("props", ["", "drop-packets=4",
                                   "drop-probability=0.5 seed=3",
                                   "duplicate-probability=0.5 seed=9"])
def test_netsim_audio(props):
    _, _, _, out = pair(f"{asrc('S16LE', 1, 8000)} ! netsim {props} ! "
                        f"appsink name=out",
                        {"in": audio("S16LE", 1, 8000, 100, 12, 2)})
    assert out["out"]


def test_netsim_duplicates_video_planes():
    """A reference fault (ROADMAP.md section 3): netsim duplicates a buffer
    with ``np.asarray`` of its data, which fails on a tuple of I420 planes
    of different shapes.  The port duplicates plane by plane."""
    desc = (f"{vsrc(16, 16, rate='30/1')} ! netsim duplicate-probability=1 "
            f"! appsink name=out")
    pushes = video_pushes(16, 16, 2, 1)
    with pytest.raises(ValueError):
        _run(jparse_launch, JBuffer, desc, {"in": pushes}, ("out",), 2, None)
    _, out = _run(tparse, Buffer, desc, {"in": pushes}, ("out",), 2, None,
                  device="cpu")
    b = out["out"][0].buffer
    assert b.batch == 4
    for got, want in zip(b.data, pushes[0]["data"]):
        assert np.array_equal(got.numpy(), np.concatenate([want, want]))


@pytest.mark.parametrize("props", ["start=250000000 stop=750000000",
                                   "start=0 stop=-1", "start=2000000000",
                                   "start=100000000 stop=1300000000"])
def test_audiosegmentclip(props):
    x = [dict(data=np.arange(k * 1000, (k + 1) * 1000, dtype=np.int16)[:,
                                                                      None],
              pts=k * 10 ** 9, duration=10 ** 9) for k in range(2)]
    pair(f"{asrc('S16LE', 1, 1000)} ! audiosegmentclip {props} ! appsink "
         f"name=out", {"in": x})


def test_videosegmentclip():
    pair("videotestsrc num-buffers=10 ! video/x-raw,format=I420,width=16,"
         "height=16,framerate=10/1 ! videosegmentclip start=300000000 "
         "stop=700000000 ! appsink name=out")


# -- good_extras --------------------------------------------------------------

@pytest.mark.parametrize("ratio", ["16/9", "1/1", "4/3", "2/1"])
def test_aspectratiocrop(ratio):
    pair(f"{vsrc(64, 48, rate='30/1')} ! aspectratiocrop aspect-ratio="
         f"{ratio} ! appsink name=out", {"in": video_pushes(64, 48, 2, 2)},
         batch=2)


def test_imagesequencesrc(tmp_path):
    """Numbered JPEGs at the stream's framerate (one a tick), decoded."""
    enc = tparse(f"videotestsrc num-buffers=3 ! video/x-raw,format=I420,"
                 f"width=32,height=24 ! jpegenc ! multifilesink "
                 f"location={tmp_path}/img_%d.jpg", device="cpu")
    enc.run()
    enc.set_state("null")
    pair(f"imagesequencesrc location={tmp_path}/img_%d.jpg framerate=5/1 "
         f"start-index=1 ! jpegdec ! appsink name=out")


def test_splitfilesrc(tmp_path):
    for k, chunk in enumerate((b"AAAA", b"BB", b"CCCCCC" * 700)):
        (tmp_path / f"part{k}.bin").write_bytes(chunk)
    _, _, _, out = pair(f"splitfilesrc location={tmp_path}/part*.bin "
                        f"blocksize=1000 ! application/octet-stream ! "
                        f"appsink name=out")
    got = b"".join(np.asarray(s.buffer.data).tobytes() for s in out["out"])
    assert got == b"AAAABB" + b"CCCCCC" * 700


@pytest.mark.parametrize("props", ["initial-timestamp=12345", ""])
def test_pushfilesrc(props, tmp_path):
    (tmp_path / "d.bin").write_bytes(b"\x01\x02\x03\x04" * 100)
    pair(f"pushfilesrc location={tmp_path}/d.bin {props} ! "
         f"application/octet-stream ! appsink name=out")


@pytest.mark.parametrize("props", ["seed=7 min=17 max=333",
                                   "seed=1 min=50 max=200",
                                   "seed=5 min=10 max=99"])
def test_rndbuffersize(props):
    """Host byte chunks of seeded sizes, the tail flushed at EOS; the
    content and its hash equal the stream's (testsink)."""
    desc = (f"{asrc('S16LE', 1, 8000)} ! tee name=t t. ! testsink name=a "
            f"t. ! rndbuffersize {props} ! tee name=u u. ! testsink name=b "
            f"u. ! appsink name=out")
    jpipe, _, tpipe, _ = pair(desc, {"in": audio("S16LE", 1, 8000, 997, 3,
                                                 0)}, host_bytes=True)
    for p in (jpipe, tpipe):
        a, b = p.get_by_name("a"), p.get_by_name("b")
        assert a.md5 == b.md5 and a.byte_count == b.byte_count == 5982
    assert (tpipe.get_by_name("b").md5, tpipe.get_by_name("b").buffer_count) \
        == (jpipe.get_by_name("b").md5, jpipe.get_by_name("b").buffer_count)


def test_rndbuffersize_takes_host_bytes(tmp_path):
    (tmp_path / "d.bin").write_bytes(bytes(range(256)) * 20)
    _, _, tpipe, _ = pair(f"filesrc location={tmp_path}/d.bin ! "
                          f"rndbuffersize seed=2 min=100 max=700 ! "
                          f"appsink name=out")
    assert tpipe.get_by_name("filesrc_0") in tpipe._host_fed


def test_capsdebug_and_testsink():
    jpipe, _, tpipe, _ = pair(
        f"{vsrc(16, 16, fmt='RGB', rate='30/1')} ! capsdebug name=cd ! "
        f"testsink name=ts", {"in": [dict(data=tuple(
            np.full((2, 16, 16), k, np.uint8) for k in range(3)), pts=0,
            duration=10, batch=2)]}, sinks=(), batch=2)
    for name, attrs in (("cd", ("seen_caps",)),
                        ("ts", ("md5", "byte_count", "buffer_count"))):
        for a in attrs:
            assert getattr(tpipe.get_by_name(name), a) == \
                getattr(jpipe.get_by_name(name), a)


@pytest.mark.parametrize("factory", ["navseek", "navigationtest"])
def test_navigation(factory):
    events = [("navigation", {"key": "Right"}),
              ("navigation", {"key": "Left", "x": 3}),
              ("navigation", {"event": "mouse-move", "x": 1.5, "y": 2}),
              ("navigation", {"key": "Up"})]
    j, t = jmake(factory, **({"seek-offset": 2.5} if factory == "navseek"
                              else {})), \
        tmake(factory, **({"seek-offset": 2.5} if factory == "navseek"
                          else {}))
    for typ, data in events:
        assert j.src_event(None, JEvent(typ, dict(data))) == \
            t.src_event(None, TEvent(typ, dict(data)))
    attr = "requested_seeks" if factory == "navseek" else "events"
    assert getattr(t, attr) == getattr(j, attr)
    pair(f"{vsrc(16, 16, rate='30/1')} ! {factory} ! appsink name=out",
         {"in": video_pushes(16, 16, 1, 2)})
