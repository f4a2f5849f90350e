"""The port's last parsers, multipart, the aliases and transcode against the
JAX package, bit for bit: ``elements/multipart.py`` (multipartmux,
multipartdemux, id3demux, apedemux), ``elements/moreparsers.py`` (h263parse,
h266parse, vc1parse, diracparse, jpeg2000parse, oggparse, matroskaparse,
vorbisparse, vorbistag, flactag, id3metaparse, ssaparse, goom),
``elements/aliases.py`` and ``elements/transcode.py`` (uritranscodebin,
transcodebin).

The JAX package's own tests of these modules (``tests/test_multipart.py``,
``test_moreparsers.py``, the uritranscodebin cases of
``test_transcode_hls.py``, the alias case of ``test_aes_dash_tone.py`` and
the apedemux case of ``test_xing_ape.py``; its xingmux cases wait for that
module) run again on the port (``on_port``).  And the same seeded inputs go
through both packages (``test_torch_captions.pair``,
``test_torch_file_formats.write_both``): every parser on seeded bitstreams
cut into seeded pushes, the muxers' bytes, the demuxers' payloads and tag
messages, the transcoders' files; tolerance 0.  Where the port differs on
purpose (a coded input whose libav decoder is not registered) a test states
both behaviours.
"""

import os
import struct

import numpy as np
import pytest
import torch

from gstreamer_tpu.core import element as jelement
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import ParseError as JParseError
from gstreamer_tpu.core.parse import parse_launch as jparse
from gstreamer_tpu.elements import multipart as jmp

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core import element as telement
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.parse import ParseError
from gstreamer_tpu_torch.elements import multipart as tmp_
from gstreamer_tpu_torch.elements.ogg import ogg_page, parse_ogg_pages

import test_aes_dash_tone
import test_moreparsers
import test_multipart
import test_transcode_hls
import test_xing_ape
from test_torch_analytics import same_spec
from test_torch_captions import _run, pair, plain
from test_torch_file_formats import write_both
from test_torch_flow import PARSERS_MULTIPART_FACTORIES
from test_torch_subtitles_tags import id3_tag, outcome
from test_torch_webrtc import reference_cases, run_case

CPU = torch.device("cpu")
VECTORS = os.path.join(os.path.dirname(__file__), "data", "torch_codecs")

REFERENCE = (reference_cases(test_multipart)
             + reference_cases(test_moreparsers)
             + reference_cases(test_transcode_hls,
                               only=("test_uritranscodebin",))
             + reference_cases(test_aes_dash_tone,
                               only=("test_alias_elements_registered",))
             + reference_cases(test_xing_ape, only=("TestApeDemux",)))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    """The JAX package's tests of these modules, on the port's."""
    run_case(case, tmp_path)


@pytest.mark.parametrize("factory", PARSERS_MULTIPART_FACTORIES)
def test_factory_spec_matches_reference(factory):
    """Properties, pad templates, description and HOST_ELEMENT of the
    slice's factories (35 here) as the JAX package's."""
    same_spec(factory)


@pytest.mark.parametrize("factory", PARSERS_MULTIPART_FACTORIES)
def test_factory_builds_through_parse_launch(factory):
    j = next(iter(jparse(factory).iterate_elements()))
    t = next(iter(gstreamer_tpu_torch.parse_launch(
        factory, device="cpu").iterate_elements()))
    assert (type(t).__name__, t.FACTORY) == (type(j).__name__, j.FACTORY)
    assert plain(t.props) == plain(j.props)
    assert [type(b).__name__ for b in type(t).__mro__[1:3]] == \
        [type(b).__name__ for b in type(j).__mro__[1:3]]


# -- seeded bitstreams --------------------------------------------------------
def filler(rng, n):
    """Bytes with no 00 and no FF: no start code, no marker inside."""
    return rng.integers(1, 255, n, dtype=np.uint8).tobytes()


def h263_stream(rng):
    return b"".join(b"\x00\x00" + bytes([0x80 | int(rng.integers(0, 4))])
                    + filler(rng, int(rng.integers(5, 300)))
                    for _ in range(8))


def nal(rng, ntype, n):
    return (b"\x00\x00\x00\x01" if rng.integers(0, 2) else b"\x00\x00\x01") \
        + bytes([0, ntype << 3]) + filler(rng, n)


def h266_stream(rng):
    out = b""
    for k in range(6):
        if k % 3 == 0:
            out += nal(rng, 15, 20) + nal(rng, 16, 8)
        elif k % 3 == 1:
            out += nal(rng, 20, 2)
        out += b"".join(nal(rng, int(rng.integers(0, 13)),
                            int(rng.integers(10, 200)))
                        for _ in range(int(rng.integers(1, 4))))
    return out


def vc1_stream(rng):
    out = b""
    for k in range(7):
        if k % 3 == 0:
            out += b"\x00\x00\x01\x0f" + filler(rng, 24)
            out += b"\x00\x00\x01\x0e" + filler(rng, 6)
        out += b"\x00\x00\x01\x0d" + filler(rng, int(rng.integers(20, 250)))
        if k % 2:
            out += b"\x00\x00\x01\x0c" + filler(rng, 10)      # a field
    return out


def dirac_stream(rng):
    out = b""
    for code in (0x00, 0x08, 0x0C, 0x08, 0x00, 0x08):
        body = filler(rng, int(rng.integers(0, 200)))
        out += (b"BBCD" + bytes([code]) + struct.pack(">I", 13 + len(body))
                + struct.pack(">I", 0) + body)
    return out + b"BBCD\x10" + bytes(8)


def j2k_stream(rng):
    return b"".join(b"\xff\x4f\xff\x51" + filler(rng, int(rng.integers(
        20, 400))) + b"\xff\xd9" for _ in range(5))


def ogg_stream(rng):
    pages = []
    for k in range(6):
        pkts = [filler(rng, int(rng.integers(1, 600)))
                for _ in range(int(rng.integers(1, 4)))]
        pages.append(ogg_page(pkts, 0x1234, k, 1000 * k, bos=k == 0,
                              eos=k == 5))
    return b"".join(pages)


STREAMS = {"h263parse": h263_stream, "h266parse": h266_stream,
           "vc1parse": vc1_stream, "diracparse": dirac_stream,
           "jpeg2000parse": j2k_stream, "oggparse": ogg_stream}


def chunked(blob, rng, lead=b""):
    """`lead` + `blob` cut at seeded places, each piece a push."""
    blob = lead + blob
    cuts = sorted(set(int(c) for c in rng.integers(1, len(blob), 5)))
    edges = [0] + cuts + [len(blob)]
    return [dict(data=np.frombuffer(blob[a:b], np.uint8), pts=k)
            for k, (a, b) in enumerate(zip(edges, edges[1:]))]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("parser", sorted(STREAMS))
def test_parser_frames_match_reference(parser, seed):
    """A seeded stream (with leading garbage for odd seeds) in seeded
    pushes: the same frames, caps and timestamps."""
    rng = np.random.default_rng(seed * 31 + len(parser))
    lead = filler(rng, 7) if seed % 2 else b""
    pair(f"appsrc name=in ! application/octet-stream ! {parser} ! appsink "
         "name=out", {"in": chunked(STREAMS[parser](rng), rng, lead)},
         host_bytes=True)


def test_parsers_take_host_bytes():
    for parser in sorted(STREAMS) + ["matroskaparse", "vorbisparse",
                                     "flactag", "id3metaparse", "ssaparse"]:
        pipe = gstreamer_tpu_torch.parse_launch(
            f"appsrc name=in caps=application/octet-stream ! {parser} ! "
            "fakesink", device="cpu")
        assert getattr(pipe.get_by_name("in").src_pads()[0].peer.element,
                       "HOST_INPUT", False), parser


@pytest.mark.parametrize("head", [b"\x1aE\xdf\xa3", b"RIFF"])
def test_matroskaparse_matches_reference(head):
    rng = np.random.default_rng(3)
    pushes = {"in": chunked(head + filler(rng, 300), rng)}
    desc = "appsrc name=in ! matroskaparse ! appsink name=out"
    t = outcome(lambda: pair(desc, pushes, host_bytes=True) and None)
    j = outcome(lambda: _run(jparse, JBuffer, desc, pushes, ("out",), 1,
                             None) and None)
    assert t == j or t[0] == j[0] == "ok"


def vorbis_packets():
    with open(os.path.join(VECTORS, "vorbis_10s.ogg"), "rb") as f:
        return [p for _s, _g, pkts in parse_ogg_pages(f.read())
                for p in pkts]


@pytest.mark.parametrize("element", [
    "vorbisparse", "vorbistag", "vorbistag tags=TITLE=New;ARTIST=Me",
    "vorbistag tags=;;"])
def test_vorbis_parse_tag_match_reference(element):
    """The committed Vorbis file's packets (headers and the first 40 audio
    packets, 3 a push): the same packets out; vorbistag rewrites the
    comment header alone."""
    pkts = vorbis_packets()[:43]
    pushes = {"in": [dict(data=[np.frombuffer(p, np.uint8)
                                for p in pkts[k:k + 3]], pts=k, batch=3)
                     for k in range(0, len(pkts), 3)]}
    _, _, tpipe, out = pair(f"appsrc name=in ! audio/x-vorbis ! {element} "
                            "name=v ! appsink name=out", pushes,
                            host_bytes=True)
    jpipe = _run(jparse, JBuffer, f"appsrc name=in ! audio/x-vorbis ! "
                 f"{element} name=v ! appsink name=out", pushes, ("out",), 1,
                 None)[0]
    tv, jv = tpipe.get_by_name("v"), jpipe.get_by_name("v")
    assert (tv.rate, tv.channels) == (jv.rate, jv.channels) != (0, 0)


FLAC_SRC = ("audiotestsrc num-buffers=3 samplesperbuffer=4096 wave=ticks ! "
            "audio/x-raw,format=S16LE,rate=44100,channels=2 ! flacenc "
            "location={loc}")


@pytest.mark.parametrize("tags", ["TITLE=New", "TITLE=A;ARTIST=B;DATE=2024",
                                  ""])
@pytest.mark.parametrize("blocksize", [16, 4096])
def test_flactag_matches_reference(tags, blocksize, tmp_path):
    """flacenc's file read in blocks through flactag: the rewritten
    metadata and the untouched frames, the same bytes; flacdec decodes the
    port's output to the same PCM as the untagged file."""
    flac = write_both(FLAC_SRC, {}, tmp_path, "flac")
    prop = f" tags={tags}" if tags else ""
    _, _, _, out = pair(f"filesrc location={flac} blocksize={blocksize} ! "
                        f"audio/x-flac ! flactag{prop} ! appsink name=out",
                        host_bytes=True)
    blob = b"".join(plain(s.buffer.data)[3] for s in out["out"])
    tagged = tmp_path / "tagged.flac"
    tagged.write_bytes(blob)
    pcm = [plain(s.buffer.data) for f in (flac, tagged)
           for s in _run(gstreamer_tpu_torch.parse_launch, None,
                         f"flacdec location={f} ! appsink name=out", {},
                         ("out",), 1, None, device="cpu")[1]["out"]]
    assert pcm[:len(pcm) // 2] == pcm[len(pcm) // 2:]


@pytest.mark.parametrize("blob", [
    id3_tag([(b"TIT2", b"\x00Hello"), (b"TRCK", b"\x035")], 3)
    + b"\xff\xfbAUDIOFRAME" * 20,
    id3_tag([(b"TPE1", b"\x03Me")], 4, pad=40) + b"\xff\xfbREST",
    b"\xff\xfbno tag here" * 4, b"ID3\x04\x00\x00\x00\x00\x7f\x7fcut"])
def test_id3metaparse_matches_reference(blob):
    """The tag stripped from the first push only, the rest passed on; the
    tags surface as the element's `tags` and the buffer's `id3` meta."""
    rng = np.random.default_rng(len(blob))
    pushes = {"in": chunked(blob, rng) if len(blob) > 40 else
              [dict(data=np.frombuffer(blob, np.uint8), pts=0)]}
    desc = ("appsrc name=in ! application/octet-stream ! id3metaparse name=m "
            "! appsink name=out")
    jpipe, ref = _run(jparse, JBuffer, desc, pushes, ("out",), 1, None)
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, pushes,
                      ("out",), 1, None, device="cpu")

    def rows(samples):
        return [(s.buffer.pts, plain(s.buffer.data), sorted(
            k for k in (s.buffer.meta or {})), dict(getattr(
                (s.buffer.meta or {}).get("id3"), "_tags", {})))
            for s in samples]
    assert rows(out["out"]) == rows(ref["out"])
    assert dict(getattr(tpipe.get_by_name("m").tags, "_tags", {})) == \
        dict(getattr(jpipe.get_by_name("m").tags, "_tags", {}))


SSA = ("[Script Info]\nTitle: x\n\n[Events]\nFormat: Layer, Start, End, "
       "Style, Name, MarginL, MarginR, MarginV, Effect, Text\n"
       "Dialogue: 0,0:00:01.00,0:00:03.50,Default,,0,0,0,,{\\i1}Hello{\\i0} "
       "world\\Nbye\nComment: 0,0:00:02.00,0:00:03.00,Default,,0,0,0,,no\n"
       "Dialogue: 0,0:00:04.25,0:00:05.00,Default,,0,0,0,,a, b, c {{x}}\n"
       "Dialogue: 0,bad,0:00:05.00,Default,,0,0,0,,skipped\n"
       "Dialogue: short,line\n")


@pytest.mark.parametrize("doc", [SSA, SSA.split("Dialogue")[0],
                                 "Dialogue: 0,1:02:03.04,1:02:04.05,D,,0,0,0"
                                 ",,ünïcode"])
def test_ssaparse_matches_reference(doc):
    pair("appsrc name=in ! application/x-ssa ! ssaparse ! appsink name=out",
         {"in": [dict(data=np.frombuffer(doc.encode(), np.uint8), pts=0)]})


def test_goom_matches_reference():
    """goom over the port's goom2k1: the same frames."""
    pair("audiotestsrc num-buffers=4 samplesperbuffer=1764 wave=ticks ! "
         "audio/x-raw,format=S16LE,rate=44100,channels=2 ! goom seed=3 ! "
         "video/x-raw,width=64,height=48 ! appsink name=out")


# -- multipart ----------------------------------------------------------------
JPEGS = ("videotestsrc num-buffers={n} pattern={pat} ! video/x-raw,"
         "format=I420,width=48,height=32,framerate=25/1 ! jpegenc")


@pytest.mark.parametrize("mux", ["multipartmux", "multipartmux boundary=XYZ"])
@pytest.mark.parametrize("n", [1, 5])
def test_multipartmux_writes_reference_bytes(mux, n, tmp_path):
    write_both(JPEGS.format(n=n, pat="ball") + f" ! {mux} ! filesink "
               "location={loc}", {}, tmp_path, "mjpeg")


def test_multipartmux_two_streams_match_reference(tmp_path):
    """Two request pads (JPEG and seeded bytes): parts in pad order."""
    rng = np.random.default_rng(5)
    pushes = {"t": [dict(data=rng.integers(0, 256, 60, np.uint8), pts=k)
                    for k in range(3)]}
    write_both("multipartmux name=m ! filesink location={loc} "
               + JPEGS.format(n=3, pat="snow") + " ! m.sink_0 appsrc name=t "
               "caps=application/x-data ! m.sink_1", pushes, tmp_path, "mp")


def multipart_cases():
    parts = [b"\xff\xd8" + bytes(range(40)) + b"\xff\xd9", b"text\r\nbody"]
    with_len = b"".join(
        b"--B1\r\nContent-Type: image/jpeg\r\nContent-Length: "
        + str(len(p)).encode() + b"\r\n\r\n" + p + b"\r\n" for p in parts)
    without = b"".join(b"--B2\r\ncontent-type: text/plain\r\n\r\n" + p
                       + b"\r\n" for p in parts) + b"--B2--\r\n"
    return [with_len, without, b"--B3\r\nX-Other: 1\r\n\r\nraw",
            b"no boundary", b"--B4\r\nContent-Type: a/b\r\n", b"",
            b"--B5\r\nContent-Length: x\r\n\r\nbody"]


@pytest.mark.parametrize("k", range(len(multipart_cases())))
@pytest.mark.parametrize("boundary", [None, "B1"])
def test_parse_multipart_matches_reference(k, boundary):
    blob = multipart_cases()[k]
    assert outcome(tmp_.parse_multipart, blob, boundary) == \
        outcome(jmp.parse_multipart, blob, boundary)


@pytest.fixture
def mjpeg(tmp_path):
    return write_both(JPEGS.format(n=6, pat="ball") + " ! multipartmux "
                      "boundary=cam ! filesink location={loc}", {}, tmp_path,
                      "mjpeg")


@pytest.mark.parametrize("batch", [1, 4])
def test_multipartdemux_matches_reference(mjpeg, batch):
    """The parts, a tick's `batch` of them, decoded by jpegdec (its source
    left unstaged in the port)."""
    _, _, tpipe, _ = pair(f"multipartdemux name=d location={mjpeg} boundary="
                          "cam ! jpegdec ! appsink name=out", batch=batch)
    assert tpipe.get_by_name("d") in tpipe._host_fed


def test_multipartdemux_errors_match_reference(tmp_path):
    bad = tmp_path / "bad.mp"
    bad.write_bytes(b"not multipart at all")
    for desc in (f"multipartdemux location={bad} ! appsink name=out",
                 f"multipartdemux location={tmp_path / 'none'} ! appsink "
                 "name=out"):
        t = outcome(lambda: gstreamer_tpu_torch.parse_launch(
            desc, device="cpu").run())
        j = outcome(lambda: jparse(desc).run())
        assert t == j


def ape_tag(items, header, footer_header_flag=True):
    body = b"".join(struct.pack("<II", len(v), flags) + k + b"\0" + v
                    for k, v, flags in items)
    size = len(body) + 32
    hdr = (b"APETAGEX" + struct.pack("<IIII", 2000, size, len(items),
                                     0xA0000000) + bytes(8))
    ftr = (b"APETAGEX" + struct.pack("<IIII", 2000, size, len(items),
                                     0x80000000 if footer_header_flag
                                     else 0) + bytes(8))
    return (hdr if header else b"") + body + ftr


APE_ITEMS = [(b"Title", b"Hi", 0), (b"Artist", "Mé".encode(), 0),
             (b"Cover", b"\x00\x01binary", 2), (b"Year", b"2024", 0)]


@pytest.mark.parametrize("layout", ["head", "tail", "tail_with_header",
                                    "none", "v1_trailer"])
def test_tag_demuxers_match_reference(layout, tmp_path):
    """apedemux and id3demux on tagged files: the payload and the posted
    tag message equal."""
    payload = np.random.default_rng(9).integers(0, 256, 700, np.uint8) \
        .tobytes()
    f = tmp_path / "t.bin"
    if layout == "head":
        f.write_bytes(ape_tag(APE_ITEMS, True) + payload)
    elif layout == "tail":
        f.write_bytes(payload + ape_tag(APE_ITEMS, False, False))
    elif layout == "tail_with_header":
        f.write_bytes(payload + ape_tag(APE_ITEMS, True))
    elif layout == "none":
        f.write_bytes(payload)
    else:
        f.write_bytes(id3_tag([(b"TIT2", b"\x03Song"), (b"TRCK", b"\x032/9")],
                              4) + payload + b"TAG" + bytes(125))
    for demux in ("apedemux", "id3demux"):
        pair(f"{demux} location={f} ! appsink name=out", host_bytes=True)


MP3 = os.path.join(VECTORS, "mp3_10s.mp3")


def test_id3demux_of_id3v2mux_decodes(tmp_path):
    """id3v2mux then id3demux on the committed MP3: the payload equals the
    file, the tags come back, mpg123audiodec gives the same PCM as from
    the untagged file."""
    tagged = write_both(f"filesrc location={MP3} ! mpegaudioparse ! "
                        "taginject tags=\"title=T,artist=A\" ! id3v2mux ! "
                        "filesink location={loc}", {}, tmp_path, "mp3")
    _, _, _, out = pair(f"id3demux location={tagged} ! appsink name=out",
                        host_bytes=True)
    with open(MP3, "rb") as f:
        assert plain(out["out"][0].buffer.data)[3] == f.read()


# -- aliases ------------------------------------------------------------------
def test_alias_classes_match_reference():
    """Each alias subclasses the port's class of the element it names, as
    the JAX package's does."""
    for f in PARSERS_MULTIPART_FACTORIES:
        t, j = telement.get_factory_class(f), jelement.get_factory_class(f)
        assert [c.__name__ for c in t.__mro__] == \
            [c.__name__ for c in j.__mro__], f


@pytest.mark.parametrize("factory, mode", [
    ("srtclientsrc", "caller"), ("srtserversrc", "listener"),
    ("srtclientsink", "caller"), ("srtserversink", "listener")])
def test_srt_aliases_fix_the_mode(factory, mode):
    t = gstreamer_tpu_torch.parse_launch(factory, device="cpu")
    el = next(iter(t.iterate_elements()))
    assert el.props["mode"] == mode
    assert plain(el.props) == plain(next(iter(
        jparse(factory).iterate_elements())).props)


def test_liveadder_matches_reference():
    rng = np.random.default_rng(11)
    pushes = {n: [dict(data=rng.integers(-3000, 3000, (480, 2), np.int16),
                       pts=t * 10_000_000, duration=10_000_000)
                  for t in range(3)] for n in ("a", "b")}
    pair("liveadder name=m ! appsink name=out "
         "appsrc name=a caps=audio/x-raw,format=S16LE,rate=48000,channels=2,"
         "layout=interleaved ! m. appsrc name=b caps=audio/x-raw,"
         "format=S16LE,rate=48000,channels=2,layout=interleaved ! m.", pushes)


@pytest.mark.parametrize("factory", ["uridecodebin3", "urisourcebin"])
def test_uri_aliases_match_reference(factory, tmp_path):
    y4m = write_both("videotestsrc num-buffers=3 pattern=ball ! video/x-raw,"
                     "format=I420,width=48,height=32,framerate=25/1 ! y4menc "
                     "location={loc}", {}, tmp_path, "y4m")
    pair(f"{factory} uri=file://{y4m} ! appsink name=out")


def test_encodebin2_writes_reference_bytes(tmp_path):
    write_both("audiotestsrc num-buffers=2 samplesperbuffer=480 ! audio/x-raw,"
               "format=S16LE,rate=48000,channels=1 ! encodebin2 "
               "profile=audio/x-wav location={loc}", {}, tmp_path, "wav")


# -- transcode ----------------------------------------------------------------
RAW_MKV = ("videotestsrc num-buffers=5 pattern=ball ! video/x-raw,format=I420,"
           "width=48,height=32,framerate=25/1 ! matroskamux name=m "
           "location={loc} ! fakesink audiotestsrc num-buffers=5 "
           "samplesperbuffer=1920 wave=ticks ! audio/x-raw,format=S16LE,"
           "rate=48000,channels=2 ! m.audio_0")


def transcode_both(src, tmp_path, profile, factory="uritranscodebin"):
    """Both packages' transcoders on `src`: their files' bytes."""
    out = []
    for name, make in (("jax", jelement.element_factory_make),
                       ("port", telement.element_factory_make)):
        dst = tmp_path / f"{name}.out"
        tb = make(factory, **{"source-uri": f"file://{src}",
                              "dest-uri": str(dst), "profile": profile})
        if name == "port":
            tb.device = CPU
        assert tb.transcode() == str(dst)
        out.append(dst.read_bytes())
    return out


@pytest.mark.parametrize("factory", ["uritranscodebin", "transcodebin"])
@pytest.mark.parametrize("profile", [
    "video/x-matroska:video/x-raw:audio/x-raw", "video/x-matroska:video/x-raw",
    "video/x-msvideo:video/x-raw:audio/x-raw",
    "video/x-matroska::audio/x-raw"])
def test_raw_transcode_matches_reference(factory, profile, tmp_path):
    """A raw Matroska transcoded to raw profiles: the same file; read back,
    the frames equal the source's."""
    src = write_both(RAW_MKV, {}, tmp_path, "mkv")
    t, j = transcode_both(src, tmp_path, profile, factory)
    assert t == j
    if profile.endswith("video/x-raw:audio/x-raw") and "matroska" in profile:
        out = tmp_path / "readback.mkv"
        out.write_bytes(t)
        a = _run(gstreamer_tpu_torch.parse_launch, None,
                 f"matroskademux location={src} stream=video ! appsink "
                 "name=out", {}, ("out",), 1, None, device="cpu")[1]["out"]
        b = _run(gstreamer_tpu_torch.parse_launch, None,
                 f"matroskademux location={out} stream=video ! appsink "
                 "name=out", {}, ("out",), 1, None, device="cpu")[1]["out"]
        assert [plain(s.buffer.data) for s in a] == \
            [plain(s.buffer.data) for s in b]


@pytest.mark.parametrize("profile", [
    "video/x-matroska:video/x-vp8:audio/x-vorbis",
    "video/x-matroska:video/x-h264:audio/mpeg"])
def test_coded_transcode_matches_reference(profile, tmp_path):
    """Muxer-coded and libav-coded profiles: the same file in both, or the
    same error where the system library is missing."""
    src = write_both(RAW_MKV, {}, tmp_path, "mkv")
    t = outcome(transcode_both, src, tmp_path, profile)
    if t[0] == "raised":
        assert "x264enc" in t[2] or "vorbisenc" in t[2] or "vp8" in t[2]
    else:
        assert t[1][1][0] == t[1][1][1]


def test_transcode_without_the_encoder_same_error(tmp_path, monkeypatch):
    """Where libavcodec lacks libx264 (the card's machine) neither package
    registers x264enc: both transcoders fail to parse their pipeline,
    naming it."""
    src = write_both(RAW_MKV, {}, tmp_path, "mkv")
    for reg in (jelement._REGISTRY, telement._REGISTRY):
        monkeypatch.delitem(reg, "x264enc", raising=False)
    with pytest.raises(JParseError, match="x264enc"):
        jelement.element_factory_make("uritranscodebin", **{
            "source-uri": str(src), "dest-uri": str(tmp_path / "j.mkv"),
            "profile": "video/x-matroska:video/x-h264"}).transcode()
    tb = telement.element_factory_make("uritranscodebin", **{
        "source-uri": str(src), "dest-uri": str(tmp_path / "t.mkv"),
        "profile": "video/x-matroska:video/x-h264"})
    tb.device = CPU
    with pytest.raises(ParseError, match="x264enc"):
        tb.transcode()


def test_transcode_of_undecodable_input_differs_on_purpose(tmp_path,
                                                           monkeypatch):
    """A coded H.264 track whose libav decoder is not registered: the
    port's uritranscodebin raises naming the decoder
    (``playback._decoder_for_caps``); the JAX package's builds a chain with
    no decoder and passes the coded stream on (ROADMAP.md section 3)."""
    if not telement.factory_exists("x264enc"):
        pytest.skip("libavcodec without libx264: no H.264 input to make")
    src = write_both(RAW_MKV, {}, tmp_path, "mkv")
    coded = tmp_path / "coded.mkv"
    tb = telement.element_factory_make("uritranscodebin", **{
        "source-uri": str(src), "dest-uri": str(coded),
        "profile": "video/x-matroska:video/x-h264"})
    tb.device = CPU
    tb.transcode()
    for reg in (jelement._REGISTRY, telement._REGISTRY):
        monkeypatch.delitem(reg, "avdec_h264")
    props = {"source-uri": str(coded), "dest-uri": str(tmp_path / "o.mkv"),
             "profile": "video/x-matroska:video/x-raw"}
    jpipe = jelement.element_factory_make("uritranscodebin", **props) \
        .build_pipeline()
    assert not any("avdec" in e.FACTORY for e in jpipe.iterate_elements())
    t = telement.element_factory_make("uritranscodebin", **props)
    t.device = CPU
    with pytest.raises(RuntimeError, match="avdec_h264 for video/x-h264"):
        t.build_pipeline()


def test_transcode_keeps_the_longer_track_is_a_reference_fault(tmp_path):
    """A file written two frames a tick (its audio in blocks of two frames'
    samples, its video a block a frame): each branch of the JAX
    package's uritranscodebin has a demuxer of its own, and the run ends
    with the audio's last tick, half-way through the video
    (``gstreamer_tpu/elements/transcode.py:107``); gsttranscodebin.c
    transcodes both tracks to their ends.  The port's branches share one
    multi-stream matroskademux: every frame and sample comes through."""
    src = write_both(RAW_MKV.replace("num-buffers=5", "num-buffers=4"), {},
                     tmp_path, "mkv", batch=2)
    jdst, tdst = tmp_path / "j.mkv", tmp_path / "t.mkv"
    profile = "video/x-matroska:video/x-raw:audio/x-raw"
    jelement.element_factory_make("uritranscodebin", **{
        "source-uri": str(src), "dest-uri": str(jdst),
        "profile": profile}).transcode()
    tb = telement.element_factory_make("uritranscodebin", **{
        "source-uri": str(src), "dest-uri": str(tdst), "profile": profile})
    tb.device = CPU
    tb.transcode()

    def frames(path, kind):
        out = _run(gstreamer_tpu_torch.parse_launch, None,
                   f"matroskademux location={path} stream={kind} ! appsink "
                   "name=out", {}, ("out",), 1, None, device="cpu")[1]["out"]
        return [plain(s.buffer.data) for s in out]
    assert frames(tdst, "video") == frames(src, "video")
    assert frames(tdst, "audio") == frames(src, "audio")
    assert len(frames(src, "audio")) == 2
    assert len(frames(jdst, "video")) == 2 < len(frames(src, "video")) == 4
