"""The port's subtitle and tag modules against the JAX package, bit for bit:
``utils/tagreaders.py``, ``utils/tagwriters.py``, ``utils/pbutils.py``,
``utils/discoverer.py``, ``elements/subparse.py`` (subparse, encodebin),
``elements/subtitles_extra.py`` (subtitleoverlay, ttmlparse, ttmlrender,
avisubtitle, apev2mux, bpmdetect, rtpdec) and ``elements/tagmux.py``
(id3v2mux, id3mux).

Two kinds of case.  The JAX package's own tests of these modules
(``tests/test_subtitles_extra.py``, ``test_subparse_wavenc.py``,
``test_tagwriters.py``, ``test_pbutils_tags.py``,
``test_discoverer_formats.py`` and the id3mux case of
``test_aes_dash_tone.py``) run again on the port (``on_port``; a case under
a library's ``skipif`` skips where its condition holds).  And the same
seeded inputs go through both packages: tags, bytes, caps, samples and bus
messages equal, tolerance 0 (``test_torch_captions.pair``,
``test_torch_file_formats.write_both``): the overlays at 160x120 with
several texts at batch 4, every subparse dialect, the tag writers' bytes,
the discoverer's report of every committed vector.  Where the JAX package
is at fault (a subparse cue, a Python string, into subtitleoverlay) a test
states both behaviours (ROADMAP.md section 3).
"""

import os
import struct

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse
from gstreamer_tpu.core.tags import TagList as JTagList
from gstreamer_tpu.elements import subparse as jsp
from gstreamer_tpu.elements import subtitles_extra as jse
from gstreamer_tpu.utils import discoverer as jdisc
from gstreamer_tpu.utils import pbutils as jpb
from gstreamer_tpu.utils import tagreaders as jtr
from gstreamer_tpu.utils import tagwriters as jtw

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.core.tags import TagList
from gstreamer_tpu_torch.elements import subparse as tsp
from gstreamer_tpu_torch.net.rtpmanager import RtpBin
from gstreamer_tpu_torch.utils import discoverer as tdisc
from gstreamer_tpu_torch.utils import pbutils as tpb
from gstreamer_tpu_torch.utils import tagreaders as ttr
from gstreamer_tpu_torch.utils import tagwriters as ttw

import test_aes_dash_tone
import test_discoverer_formats
import test_pbutils_tags
import test_subparse_wavenc
import test_subtitles_extra
import test_tagwriters
from test_torch_analytics import same_spec
from test_torch_captions import _run, pair, plain
from test_torch_file_formats import write_both
from test_torch_flow import SUBTITLES_TAGS_FACTORIES
from test_torch_webrtc import reference_cases, run_case

CPU = torch.device("cpu")
VECTORS = os.path.join(os.path.dirname(__file__), "data", "torch_codecs")
W, H, BATCH = 160, 120, 4
DUR = 40_000_000

REFERENCE = (reference_cases(test_subtitles_extra)
             + reference_cases(test_subparse_wavenc)
             + reference_cases(test_tagwriters)
             + reference_cases(test_pbutils_tags)
             + reference_cases(test_discoverer_formats)
             + reference_cases(test_aes_dash_tone,
                               only=("test_id3mux_alias",)))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    """The JAX package's tests of these modules, on the port's."""
    run_case(case, tmp_path)


@pytest.mark.parametrize("factory", SUBTITLES_TAGS_FACTORIES)
def test_factory_spec_matches_reference(factory):
    """Properties, pad templates, description and HOST_ELEMENT of the 11
    factories as the JAX package's."""
    same_spec(factory)


@pytest.mark.parametrize("factory", SUBTITLES_TAGS_FACTORIES)
def test_factory_builds_through_parse_launch(factory):
    j = next(iter(jparse(factory).iterate_elements()))
    t = next(iter(gstreamer_tpu_torch.parse_launch(
        factory, device="cpu").iterate_elements()))
    assert (type(t).__name__, t.FACTORY) == (type(j).__name__, j.FACTORY)
    assert plain(t.props) == plain(j.props)


def outcome(fn, *a, **kw):
    """A call's result as plain data, or its exception's class name and
    message (each package has classes of its own)."""
    try:
        return ("ok", plain(fn(*a, **kw)))
    except Exception as e:            # noqa: BLE001 - compared as data
        return ("raised", type(e).__name__, str(e))


def tags_of(tl):
    return None if tl is None else plain(dict(tl._tags))


# -- tagreaders ---------------------------------------------------------------
def syncsafe(n):
    return bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F,
                  n & 0x7F])


def id3_frame(fid, body, version):
    size = syncsafe(len(body)) if version >= 4 else struct.pack(
        ">I", len(body))
    return fid + size + b"\x00\x00" + body


def id3_tag(frames, version, pad=0):
    body = b"".join(id3_frame(f, b, version) for f, b in frames) + bytes(pad)
    return b"ID3" + bytes([version, 0, 0]) + syncsafe(len(body)) + body


ID3_FRAMES = [
    (b"TIT2", b"\x03Title \xc3\xa9"), (b"TPE1", b"\x00Art\xe9"),
    (b"TALB", b"\x01" + "Albüm".encode("utf-16")),
    (b"TCON", b"\x02" + "Rock".encode("utf-16-be")),
    (b"TRCK", b"\x033/12"), (b"TPOS", b"\x032"), (b"TBPM", b"\x03128"),
    (b"COMM", b"\x03eng\x00a comment"), (b"TYER", b"\x032001"),
    (b"TXXX", b"\x03user\x00value"), (b"TCOM", b"\x03"),
    (b"TRCK", b"\x03x/9"), (b"TSSE", b"\x03enc\x00\x00"),
    (b"TCOP", b"\x01\xff"), (b"TENC", b""), (b"TPE2", b"\x03 both ")]


def id3_cases():
    out = [id3_tag(ID3_FRAMES, v, pad) for v in (3, 4) for pad in (0, 12)]
    out += [id3_tag(ID3_FRAMES[:4], 4)[:30], b"ID3\x04", b"XYZ" + bytes(20),
            id3_tag([], 3)]
    rng = np.random.default_rng(7)
    for k in range(6):
        tag = bytearray(id3_tag(ID3_FRAMES, 3 + k % 2))
        for pos in rng.integers(10, len(tag), 4):
            tag[pos] = int(rng.integers(0, 256))
        out.append(bytes(tag))
    return out


@pytest.mark.parametrize("k", range(len(id3_cases())))
def test_parse_id3v2_matches_reference(k):
    """Frames of v2.3 and v2.4 in every text encoding, track and disc
    numbers, COMM, empty and unknown frames, padding, a cut tag and seeded
    corruptions: the same TagList or the same error."""
    blob = id3_cases()[k]
    j = outcome(lambda: tags_of(jtr.parse_id3v2(blob)))
    t = outcome(lambda: tags_of(ttr.parse_id3v2(blob)))
    assert t == j


def vorbis_comment(vendor, fields, count=None):
    out = struct.pack("<I", len(vendor)) + vendor
    out += struct.pack("<I", len(fields) if count is None else count)
    for f in fields:
        out += struct.pack("<I", len(f)) + f
    return out


VC_FIELDS = [b"TITLE=Water", b"artist=Me", b"TRACKNUMBER=7",
             b"TRACKNUMBER=seven", b"NOEQUALS", b"DESCRIPTION=d",
             b"COMMENT=c", b"LOCATION=Somewhere", b"ISRC=X", b"GENRE=",
             b"UNKNOWN=u", "ALBUM=Ä".encode()]


@pytest.mark.parametrize("blob", [
    vorbis_comment(b"vendor", VC_FIELDS), vorbis_comment(b"", []),
    vorbis_comment(b"v", VC_FIELDS, count=40),
    vorbis_comment(b"v", [b"TITLE=\xff\xfe"]),
    vorbis_comment(b"v", VC_FIELDS)[:37], b"\x01\x00"])
def test_parse_vorbis_comment_matches_reference(blob):
    j = outcome(lambda: tags_of(jtr.parse_vorbis_comment(blob)))
    t = outcome(lambda: tags_of(ttr.parse_vorbis_comment(blob)))
    assert t == j


# -- tagwriters ---------------------------------------------------------------
TAG_SETS = [
    [("title", "Tagged Song"), ("artist", "Me"), ("artist", "You"),
     ("album", "Albüm"), ("date", "2024"), ("track-number", 3),
     ("comment", "a comment"), ("genre", "Rock"), ("encoder", "x")],
    [("description", "A picture"), ("device-manufacturer", "Cam"),
     ("device-model", "M1"), ("copyright", "(c) me"),
     ("application-name", "app"), ("datetime", "2024:01:02 03:04:05"),
     ("image-orientation", "rotate-90"), ("artist", "Ph<o>to & co")],
    [("image-orientation", "sideways"), ("title", "x" * 300),
     ("keywords", "a"), ("keywords", "b & c"), ("date", "2001-02-03")],
    [("unknown-tag", "v")],
]


def taglists(pairs):
    out = []
    for cls in (JTagList, TagList):
        tl = cls()
        for k, v in pairs:
            tl.add("append", k, v)
        out.append(tl)
    return out


@pytest.mark.parametrize("writer, kw", [
    ("write_id3v2", {"version": 3}), ("write_id3v2", {"version": 4}),
    ("write_vorbis_comment", {}), ("write_vorbis_comment",
                                   {"vendor": "someone"}),
    ("write_exif", {}), ("write_exif", {"byte_order": ">"}),
    ("write_xmp", {})])
@pytest.mark.parametrize("k", range(len(TAG_SETS)))
def test_tag_writers_bytes_match_reference(writer, kw, k):
    """Every writer's bytes equal the JAX package's, and the matching
    reader gives back the same TagList in both."""
    jt, tt = taglists(TAG_SETS[k])
    jb, tb = getattr(jtw, writer)(jt, **kw), getattr(ttw, writer)(tt, **kw)
    assert tb == jb
    reader = {"write_id3v2": (jtr.parse_id3v2, ttr.parse_id3v2),
              "write_vorbis_comment": (jtr.parse_vorbis_comment,
                                       ttr.parse_vorbis_comment),
              "write_exif": (jtw.parse_exif, ttw.parse_exif),
              "write_xmp": (jtw.parse_xmp, ttw.parse_xmp)}[writer]
    assert tags_of(reader[1](tb)) == tags_of(reader[0](jb))


def exif_cases():
    jt, _ = taglists(TAG_SETS[1])
    good = jtw.write_exif(jt)
    rng = np.random.default_rng(3)
    out = [good, jtw.write_exif(jt, ">"), good[:20], b"II\x2b\x00" + good[4:],
           b"MM", b"XX" + good[2:]]
    for _ in range(4):
        bad = bytearray(good)
        for pos in rng.integers(8, len(bad), 3):
            bad[pos] = int(rng.integers(0, 256))
        out.append(bytes(bad))
    return out


@pytest.mark.parametrize("k", range(len(exif_cases())))
def test_parse_exif_matches_reference(k):
    blob = exif_cases()[k]
    assert outcome(lambda: tags_of(ttw.parse_exif(blob))) == \
        outcome(lambda: tags_of(jtw.parse_exif(blob)))


@pytest.mark.parametrize("blob", [
    b"no packet here",
    b"<x:xmpmeta><dc:title><rdf:Alt><rdf:li>T &amp; &lt;</rdf:li></rdf:Alt>"
    b"</dc:title><xmp:CreatorTool>tool</xmp:CreatorTool></x:xmpmeta>",
    b"<x:xmpmeta><dc:creator><rdf:Seq><rdf:li>a</rdf:li><rdf:li> </rdf:li>"
    b"</rdf:Seq></dc:creator>\xff</x:xmpmeta>"])
def test_parse_xmp_matches_reference(blob):
    assert tags_of(ttw.parse_xmp(blob)) == tags_of(jtw.parse_xmp(blob))


# -- pbutils ------------------------------------------------------------------
CAPS = ["video/x-raw, format=I420", "audio/mpeg, mpegversion=1, layer=3",
        "audio/mpeg, mpegversion=1, layer=2", "audio/mpeg, mpegversion=4",
        "video/mpeg, mpegversion=4", "video/mpeg, mpegversion=2",
        "video/mpeg, mpegversion=1", "video/mpeg", "video/x-h265",
        "application/x-subtitle-vtt", "application/x-unknown", "ANY",
        "EMPTY", "video/x-vp9; video/x-vp8"]


@pytest.mark.parametrize("caps", CAPS)
@pytest.mark.parametrize("fn", ["get_codec_description",
                                "get_decoder_description",
                                "get_encoder_description"])
def test_descriptions_match_reference(fn, caps):
    """From a caps string and from caps of each package's own class."""
    assert getattr(tpb, fn)(caps) == getattr(jpb, fn)(caps)
    assert getattr(tpb, fn)(Caps.from_string(caps)) == \
        getattr(jpb, fn)(JCaps.from_string(caps))


def profile_rows(p):
    return (type(p).__name__, str(p.format), p.name, p.presence,
            None if p.restriction is None else str(p.restriction),
            [profile_rows(s) for s in getattr(p, "profiles", ())])


@pytest.mark.parametrize("spec", [
    "video/x-matroska:video/x-h264:audio/mpeg", "video/webm::audio/x-vorbis",
    "video/quicktime:video/x-h265", "audio/x-wav", "video/x-raw",
    "application/ogg:audio/x-vorbis:audio/x-opus", "audio/x-flac:"])
def test_profile_from_string_matches_reference(spec):
    assert profile_rows(tpb.profile_from_string(spec)) == \
        profile_rows(jpb.profile_from_string(spec))


# -- discoverer ---------------------------------------------------------------
def info_rows(info):
    return (info.uri, info.duration_ns, [
        (s.kind, None if s.caps is None else str(s.caps), s.width, s.height,
         None if s.fps is None else str(s.fps), s.rate, s.channels,
         s.format) for s in info.streams],
        [s.kind for s in info.video_streams],
        [s.kind for s in info.audio_streams])


def discover_both(path):
    return (outcome(lambda: info_rows(tdisc.Discoverer().discover(path))),
            outcome(lambda: info_rows(jdisc.Discoverer().discover(path))))


ADTS = ("aac_10s.aac", "heaac_10s.aac")


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(VECTORS)
    if not n.endswith((".py", ".json")) and n not in ADTS))
def test_discoverer_on_committed_vectors(name):
    """Every committed vector but the ADTS files (Ogg Theora, Vorbis, Opus
    and Speex, MP3, MP4, Matroska, WebM, IVF, TS, FLIC, FLAC): the same
    report, or the same error."""
    t, j = discover_both(os.path.join(VECTORS, name))
    assert t == j
    t, j = discover_both("file://" + os.path.join(VECTORS, name))
    assert t == j


@pytest.mark.parametrize("name, rate", [("aac_10s.aac", 48000),
                                        ("heaac_10s.aac", 24000)])
def test_discoverer_adts_is_a_reference_fault(name, rate):
    """An ADTS AAC file: the JAX package takes its sync word for MPEG audio
    and reports an MP3 stream of a wrong duration
    (``gstreamer_tpu/utils/discoverer.py:75``); the port reports AAC (the
    header's rate, the SBR core's for HE-AAC), its duration from the frame
    count, as gstdiscoverer.c over aacparse does."""
    info = tdisc.Discoverer().discover(os.path.join(VECTORS, name))
    ref = jdisc.Discoverer().discover(os.path.join(VECTORS, name))
    assert [s.format for s in ref.streams] == ["MP3"]
    assert [(s.kind, s.format, s.rate, s.channels) for s in info.streams] \
        == [("audio", "AAC", rate, 2)]
    assert abs(info.duration_ns - 10_000_000_000) < 2 * 1024 * 10**9 // rate
    assert str(info.streams[0].caps) == (
        f"audio/mpeg, mpegversion=4, stream-format=adts, rate={rate}, "
        "channels=2")


ASRC = ("audiotestsrc num-buffers=3 samplesperbuffer=800 wave=ticks ! "
        "audio/x-raw,format={fmt},rate={rate},channels={ch}")
VSRC = ("videotestsrc num-buffers=5 pattern=ball ! video/x-raw,format={fmt},"
        "width=48,height=32,framerate={fps}")


@pytest.mark.parametrize("ext, desc", [
    ("y4m", VSRC.format(fmt="I420", fps="30/1") + " ! y4menc location={loc}"),
    ("y4m", VSRC.format(fmt="Y444", fps="24000/1001")
     + " ! y4menc location={loc}"),
    ("y4m", VSRC.format(fmt="Y42B", fps="25/1") + " ! y4menc location={loc}"),
    ("wav", ASRC.format(fmt="S16LE", rate=8000, ch=2)
     + " ! wavenc location={loc}"),
    ("wav", ASRC.format(fmt="F32LE", rate=44100, ch=1)
     + " ! wavenc location={loc}"),
    ("wav", ASRC.format(fmt="U8", rate=16000, ch=1)
     + " ! wavenc location={loc}"),
    ("flac", ASRC.format(fmt="S16LE", rate=48000, ch=2)
     + " ! flacenc location={loc}"),
    ("ogg", ASRC.format(fmt="S16LE", rate=48000, ch=1)
     + " ! oggmux location={loc}"),
    ("avi", VSRC.format(fmt="I420", fps="25/1") + " ! avimux name=m "
     "location={loc} ! fakesink " + ASRC.format(fmt="S16LE", rate=8000, ch=1)
     + " ! m.audio_0"),
    ("mkv", VSRC.format(fmt="I420", fps="25/1") + " ! matroskamux name=m "
     "location={loc} ! fakesink " + ASRC.format(fmt="S16LE", rate=8000, ch=2)
     + " ! m.audio_0"),
    ("mov", VSRC.format(fmt="UYVY", fps="10/1") + " ! qtmux "
     "location={loc}")])
def test_discoverer_on_written_files(ext, desc, tmp_path):
    """Files the port writes (the same bytes as the JAX package's): y4m of
    three chroma layouts, WAV of three formats, FLAC, Ogg-FLAC, AVI,
    Matroska and QuickTime with two tracks."""
    path = write_both(desc, {}, tmp_path, ext)
    t, j = discover_both(str(path))
    assert t == j and t[0] == "ok"


def test_discoverer_unknown_and_missing(tmp_path):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(bytes(range(256)))
    tagged = tmp_path / "tagged.mp3"
    with open(os.path.join(VECTORS, "mp3_10s.mp3"), "rb") as f:
        tagged.write_bytes(id3_tag(ID3_FRAMES[:3], 4) + f.read())
    for p in (junk, tagged, tmp_path / "missing.wav"):
        t, j = discover_both(str(p))
        assert t == j
    assert discover_both(str(tmp_path / "missing.wav"))[0][1] == \
        "FileNotFoundError"


# -- subparse -----------------------------------------------------------------
SUBS = dict(test_subparse_wavenc.TestAllSubtitleFormats.SAMPLES)
SUBS.update({
    "srt_crlf": "1\r\n00:00:01,000 --> 00:00:02,500\r\nCRLF line\r\n\r\n"
                "2\r\n00:00:03,000 --> 00:00:04,000\r\nnext\r\n",
    "srt_noindex": "00:00:01.5 --> 00:00:02.25\nno index\n\n"
                   "01:02:03,004 --> 01:02:04,005\nhour\n",
    "srt_last_open": "1\n00:00:01,000 --> 00:00:02,000\none\n\n2\n"
                     "00:00:02,000 --> 00:00:03,000\ntwo",
    "vtt_cues": "WEBVTT - title\n\nNOTE x\n\nid1\n00:00:01.000 --> "
                "00:00:02.000 align:start\n<b>bold</b>\n\n00:00:03.000 --> "
                "00:00:04.000\nplain\n",
    "microdvd_style": "{0}{25}{y:i}Italic|next\n{30}{60}x",
    "microdvd_badfps": "{1}{1}abc\n{25}{50}X",
    "sami_tags": "<SAMI><BODY><SYNC Start=\"500\"><P Class=EN>A <b>b</b>"
                 "</P><SYNC Start=\"900\"><P>c</P></BODY></SAMI>",
    "lrc_multi": "[00:01.00][00:05.5]twice\n[00:03.123]once\n[ar:x]\n",
    "mpsub_neg": "FORMAT=TIME\n# comment\n0 1.5\na\nb\n\n-0.5 1\nc\n",
    "tmplayer_eq": "0:00:01=First\n0:00:02:\n0:00:05:Last|two\n",
    "qttext_multi": "{QTtext}\n[00:00:01.5]\nA {b}\n[00:00:02.25]\n\n"
                    "[00:00:03.00]\nC\n",
    "dks_br": "[0:00:01]one[br]two\n[0:00:03]\n[0:00:04]end\n",
    "empty": "", "garbage": "\x00\x01 not subtitles at all",
})


@pytest.mark.parametrize("name", sorted(SUBS))
def test_subtitle_parsers_match_reference(name):
    """Every dialect's detection and every parser on every sample: the
    same cues (times and text) or the same error."""
    text = SUBS[name]
    assert tsp.detect_sub_format(text) == jsp.detect_sub_format(text)
    for fmt in sorted(jsp._SUB_PARSERS):
        assert outcome(tsp._SUB_PARSERS[fmt], text) == \
            outcome(jsp._SUB_PARSERS[fmt], text), fmt


@pytest.mark.parametrize("blocksize", [7, 64, 4096])
@pytest.mark.parametrize("name", ["srt", "srt_last_open", "vtt_cues",
                                  "microdvd", "sami", "mpsub", "lrc_multi",
                                  "dks", "tmplayer", "qttext", "mpl2",
                                  "subviewer"])
def test_subparse_element_matches_reference(name, blocksize, tmp_path):
    """filesrc ! subparse in blocks of `blocksize` bytes: the cues each
    tick gives (a held-back last cue flushed at end of stream), their
    times and `cues` meta, equal."""
    path = tmp_path / "subs.txt"
    path.write_bytes(SUBS[name].encode())
    pair(f"filesrc location={path} blocksize={blocksize} ! subparse ! "
         "appsink name=out")


def test_subparse_takes_host_bytes(tmp_path):
    """The port's subparse takes its source's bytes unstaged: the file is
    not copied to the pipeline's device."""
    path = tmp_path / "s.srt"
    path.write_bytes(SUBS["srt"].encode())
    pipe = gstreamer_tpu_torch.parse_launch(
        f"filesrc name=f location={path} ! subparse ! appsink name=out",
        device="cpu")
    pipe.set_state("playing")
    assert pipe.get_by_name("f") in pipe._host_fed


@pytest.mark.parametrize("ext, desc", [
    ("wav", "audiotestsrc num-buffers=3 samplesperbuffer=480 ! "
     "audio/x-raw,format=S16LE,rate=48000,channels=2 ! encodebin "
     "profile=audio/x-wav location={loc}"),
    ("wav", "audiotestsrc num-buffers=2 samplesperbuffer=333 wave=ticks ! "
     "audio/x-raw,format=F32LE,rate=16000,channels=1 ! encodebin "
     "profile=audio/x-wav location={loc}"),
    ("y4m", "videotestsrc num-buffers=3 pattern=ball ! video/x-raw,"
     "format=I420,width=48,height=32,framerate=25/1 ! encodebin "
     "profile=application/x-yuv4mpeg location={loc}"),
    ("y4m", "videotestsrc num-buffers=2 ! video/x-raw,format=Y444,width=32,"
     "height=16,framerate=30/1 ! encodebin profile=video/x-yuv4mpeg "
     "location={loc}")])
def test_encodebin_writes_reference_bytes(ext, desc, tmp_path):
    write_both(desc, {}, tmp_path, ext)


@pytest.mark.parametrize("profile", ["video/x-matroska:video/x-h264:",
                                     "audio/x-flac"])
def test_encodebin_unsupported_profile_same_error(profile, tmp_path):
    desc = ("audiotestsrc num-buffers=1 ! audio/x-raw,format=S16LE,"
            f"rate=8000,channels=1 ! encodebin profile={profile} "
            f"location={tmp_path / 'x.bin'}")
    t = outcome(lambda: gstreamer_tpu_torch.parse_launch(
        desc, device="cpu").run())
    j = outcome(lambda: jparse(desc).run())
    assert t == j and t[0] == "raised"


# -- subtitles_extra: the overlays --------------------------------------------
def frames(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(16, 236, (n,) + s, dtype=np.uint8)
                 for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))


def video_pushes(ticks, seed=0):
    return [dict(data=frames(BATCH, seed + t), pts=t * BATCH * DUR,
                 duration=DUR, batch=BATCH) for t in range(ticks)]


def text_pushes(texts):
    return [dict(data=np.frombuffer(t.encode(), np.uint8), pts=k * BATCH * DUR)
            for k, t in enumerate(texts)]


OVERLAY = (f"appsrc name=in caps=video/x-raw,format=I420,width={W},height={H},"
           f"framerate=25/1 ! {{el}} name=o {{props}} ! appsink name=out "
           f"appsrc name=txt ! {{caps}} ! o.")
TEXTS = [["HELLO", "two\nlines", "Ünïcödé été"],
         ["", "  ", "a"], ["x" * 40, "long line that is wider than the frame "
                           "is wide, surely", "."]]


@pytest.mark.parametrize("props", ["", "font-size=10 ypad=4",
                                   "font-size=40 ypad=200"])
@pytest.mark.parametrize("k", range(len(TEXTS)))
def test_subtitleoverlay_matches_reference(k, props):
    """Text buffers over three ticks of 4 seeded 160x120 frames: the planes
    equal the JAX package's (Y blended on the host in float64; a tick
    without text passes as it is)."""
    n = len(TEXTS[k])
    pair(OVERLAY.format(el="subtitleoverlay", props=props,
                        caps="text/x-raw,format=utf8"),
         {"in": video_pushes(n, k), "txt": text_pushes(TEXTS[k])},
         batch=BATCH)


def test_subtitleoverlay_ass_route_matches_reference():
    """ASS caps route through the port's assrender, as the JAX package's
    through its own."""
    hdr = ("[Script Info]\nScriptType: v4.00+\n\n[V4+ Styles]\nFormat: Name, "
           "Fontsize, PrimaryColour, Alignment\nStyle: Default,20,"
           "&H0000FFFF,2\n")
    ev = ("Dialogue: 0,0:00:00.00,0:00:05.00,Default,,0,0,0,,"
          "{\\b1}Bold{\\b0} ass\\Nline")
    pair(OVERLAY.format(el="subtitleoverlay", props="",
                        caps="application/x-ass"),
         {"in": video_pushes(2, 5), "txt": text_pushes([hdr + ev, ev])},
         batch=BATCH)


TTML = test_subtitles_extra.TTML


@pytest.mark.parametrize("docs", [
    [TTML.decode(), TTML.decode()],
    ['<tt xmlns="http://www.w3.org/ns/ttml"><body><div><p begin="1.5s">'
     'no end</p><p begin="00:01.0" end="2s">mm:ss<br/>broken</p></div>'
     '</body></tt>', "<not xml"],
    ['<tt><body><p begin="x">bad time</p><p end="1s">no begin</p></body>'
     '</tt>']])
def test_ttmlrender_matches_reference(docs):
    pair(OVERLAY.format(el="ttmlrender", props="font-size=14",
                        caps="application/ttml+xml"),
         {"in": video_pushes(len(docs), 9), "txt": text_pushes(docs)},
         batch=BATCH)


def test_overlay_text_pad_takes_host_bytes():
    """The text pad's source is not staged; the video's is."""
    pipe = gstreamer_tpu_torch.parse_launch(
        OVERLAY.format(el="subtitleoverlay", props="",
                       caps="text/x-raw,format=utf8"), device="cpu")
    pipe.set_state("playing")
    host = {e.name for e in pipe._host_fed}
    assert "txt" in host and "in" not in host


def fixed_flat(data):
    """The JAX package's ``_flat`` with a text leaf encoded as UTF-8."""
    blobs = data if isinstance(data, (list, tuple)) else [data]
    return b"".join(b.encode() if isinstance(b, str) else jse._flat(b)
                    for b in blobs)


def test_subparse_into_subtitleoverlay_is_a_reference_fault(tmp_path,
                                                            monkeypatch):
    """subparse gives each cue as a Python string; the JAX package's
    subtitleoverlay casts it to uint8 and raises ValueError
    (``gstreamer_tpu/elements/subtitles_extra.py:44``), where
    gstsubtitleoverlay.c renders subparse's text.  The port renders it:
    its frames equal the JAX package's with the string encoded as UTF-8."""
    path = tmp_path / "s.srt"
    path.write_bytes("".join(
        f"{k + 1}\n00:00:0{k},000 --> 00:00:0{k},900\ncue {k}\n\n"
        for k in range(6)).encode())
    desc = (f"appsrc name=in caps=video/x-raw,format=I420,width={W},"
            f"height={H},framerate=25/1 ! subtitleoverlay name=o ! appsink "
            f"name=out filesrc location={path} blocksize=8 ! subparse ! o.")
    pushes = {"in": video_pushes(3, 2)}
    with pytest.raises(ValueError, match="invalid literal"):
        _run(jparse, JBuffer, desc, pushes, ("out",), BATCH, None)
    monkeypatch.setattr(jse, "_flat", fixed_flat)
    _, ref, _, out = pair(desc, pushes, batch=BATCH)
    assert len(out["out"]) == 3
    assert any(not torch.equal(o.buffer.data[0], torch.from_numpy(
        p["data"][0])) for o, p in zip(out["out"], pushes["in"]))


# -- subtitles_extra: the byte elements ---------------------------------------
def ttml_pushes(doc):
    return {"in": [dict(data=np.frombuffer(doc.encode(), np.uint8), pts=0)]}


@pytest.mark.parametrize("doc", [
    TTML.decode(),
    '<tt><body><p begin="0.5s" end="1s">one</p></body></tt>',
    '<tt><body><p begin="bad">x</p></body></tt>', "<broken"])
def test_ttmlparse_matches_reference(doc):
    pair("appsrc name=in ! application/ttml+xml ! ttmlparse ! appsink "
         "name=out", ttml_pushes(doc))


def gab2(chunks, magic=b"GAB2\x00"):
    return magic + b"".join(struct.pack("<HI", cid, len(body)) + body
                            for cid, body in chunks)


@pytest.mark.parametrize("blob", [
    gab2([(2, "s.srt".encode("utf-16-le")), (4, SUBS["srt"].encode())]),
    gab2([(4, b"first"), (4, b"second"), (7, b"other")]),
    gab2([(2, b"n")]), gab2([(4, b"x")], magic=b"GAB3\x00"), b"GAB2"])
def test_avisubtitle_matches_reference(blob):
    desc = ("appsrc name=in ! application/x-subtitle-avi ! avisubtitle ! "
            "appsink name=out")
    pushes = {"in": [dict(data=np.frombuffer(blob, np.uint8), pts=0)]}
    t = outcome(lambda: pair(desc, pushes) and None)
    j = outcome(lambda: _run(jparse, JBuffer, desc, pushes, ("out",), 1,
                             None) and None)
    assert t[0] == j[0] == "ok" or t == j


@pytest.mark.parametrize("tags", ["title=Test", "title=A,artist=\"B C\"",
                                  "", "album=x,,=y,genre=Rock"])
def test_apev2mux_matches_reference(tags):
    """The APEv2 header, items and footer before the stream, over two
    pushes: the bytes equal."""
    audio = np.random.default_rng(4).integers(0, 256, 900, np.uint8)
    pushes = {"in": [dict(data=audio[:500], pts=0),
                     dict(data=audio[500:], pts=1)]}
    pair(f"appsrc name=in ! audio/mpeg ! apev2mux tags={tags!r} ! "
         "appsink name=out" if tags else
         "appsrc name=in ! audio/mpeg ! apev2mux ! appsink name=out", pushes)


def click_track(rate, bpm, seconds, seed):
    """Seeded noise bursts every beat (the JAX package's test's track)."""
    n = rate * seconds
    x = np.zeros(n, np.float32)
    rng = np.random.default_rng(seed)
    for i in range(0, n, int(rate * 60 / bpm)):
        x[i:i + 200] = rng.standard_normal(min(200, n - i)).astype(np.float32)
    return x


@pytest.mark.parametrize("rate, bpm, seconds", [
    (8000, 120, 8), (16000, 90, 10), (44100, 140, 6), (16000, 60, 3),
    (8000, 200, 1)])
def test_bpmdetect_matches_reference(rate, bpm, seconds):
    """bpm bit for bit, through a launch string in 4 pushes (the envelope
    grows across buffers) and through host_process on a card-less tensor."""
    x = click_track(rate, bpm, seconds, rate + bpm)
    per = len(x) // 4
    pushes = {"in": [dict(data=x[k * per:(k + 1) * per, None], pts=k)
                     for k in range(4)]}
    _, _, tpipe, _ = pair(
        f"appsrc name=in caps=audio/x-raw,format=F32LE,rate={rate},"
        "channels=1,layout=interleaved ! bpmdetect name=b ! appsink name=out",
        pushes)
    jpipe = _run(jparse, JBuffer, f"appsrc name=in caps=audio/x-raw,"
                 f"format=F32LE,rate={rate},channels=1,layout=interleaved ! "
                 "bpmdetect name=b ! appsink name=out", pushes, ("out",), 1,
                 None)[0]
    assert tpipe.get_by_name("b").bpm == jpipe.get_by_name("b").bpm
    t, j = tmake("bpmdetect"), jmake("bpmdetect")
    t.device = CPU
    for e, buf in ((t, Buffer(data=torch.from_numpy(x))),
                   (j, JBuffer(data=x))):
        e._rate = rate
        e.start()
        e.host_process(buf)
    assert t.bpm == j.bpm


def test_rtpdec_is_the_port_session():
    t = tmake("rtpdec")
    assert isinstance(t, RtpBin)
    assert plain(t.props) == plain(jmake("rtpdec").props)


# -- tagmux -------------------------------------------------------------------
MP3 = os.path.join(VECTORS, "mp3_10s.mp3")


@pytest.mark.parametrize("mux", ["id3v2mux", "id3v2mux version=3", "id3mux",
                                 "id3v2mux tags=\"album=A,comment=c\""])
def test_id3v2mux_writes_reference_bytes(mux, tmp_path):
    """The committed MP3 through mpegaudioparse and taginject's tag event
    into the muxer: the same file."""
    write_both(f"filesrc location={MP3} ! mpegaudioparse ! taginject "
               f"tags=\"title=Tagged Song,artist=Me,track-number=4\" ! {mux}"
               " ! filesink location={loc}", {}, tmp_path, "mp3")


def test_id3v2mux_takes_host_bytes():
    pipe = gstreamer_tpu_torch.parse_launch(
        f"filesrc name=f location={MP3} ! id3v2mux ! fakesink", device="cpu")
    pipe.set_state("playing")
    assert pipe.get_by_name("f") in pipe._host_fed


def test_bpmdetect_octave_is_a_reference_fault():
    """A 120 beats-a-minute click track at 16 kHz: the envelope's
    autocorrelation peaks at two beats, and both packages read half the
    tempo (``gstreamer_tpu/elements/subtitles_extra.py:407``), where
    gstbpmdetect.cc (SoundTouch) reads the beat.  The port keeps the JAX
    package's estimate bit for bit (ROADMAP.md section 3)."""
    x = click_track(16000, 120, 10, 2027)
    t, j = tmake("bpmdetect"), jmake("bpmdetect")
    t.device = CPU
    for e, buf in ((t, Buffer(data=torch.from_numpy(x))),
                   (j, JBuffer(data=x))):
        e._rate = 16000
        e.start()
        e.host_process(buf)
    assert t.bpm == j.bpm
    assert abs(t.bpm - 60) < 2
