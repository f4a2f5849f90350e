"""The port's fittings and flow elements against the JAX package.

tee, valve, queue2, multiqueue, streamiddemux, fakesrc, concat, funnel,
input-selector, output-selector, clocksync (under a TestClock),
autovideoconvert, autoconvert and switchbin: the same launch string and
the same seeded numpy buffers go through both packages
(``test_torch_compositor.run_both``), samples and negotiated caps equal,
tolerance 0.  Where the port differs on purpose (``valve drop=true``,
``videomedian filtersize=9``, input-selector on one audio tensor) a test
states the port's behaviour and the reference's (ROADMAP.md section 3).
The 31 factories this slice adds carry the reference's properties and pad
templates.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.check.testclock import TestClock as JTestClock
from gstreamer_tpu.core import element as jelement
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch

import gstreamer_tpu_torch
from gstreamer_tpu_torch.check import testclock
from gstreamer_tpu_torch.core import element as telement
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements import chromaprint as tchromaprint

from test_torch_compositor import _run, run_both, video_pushes

NEW_FACTORIES = (
    "gamma", "videoflip", "videocrop", "videobox", "videomedian", "alpha",
    "progressreport", "taginject", "capssetter", "breakmydata", "cpureport",
    "fakevideosink", "fakeaudiosink", "queue2", "downloadbuffer", "tee",
    "valve", "fakesrc", "autovideosink", "autoaudiosink", "watchdog",
    "concat", "funnel", "input-selector", "output-selector", "streamiddemux",
    "clocksync", "multiqueue", "switchbin", "autoconvert", "autovideoconvert")
# the analytics path and the last device modules, with the video-analysis
# host elements (analytics_elements to webrtcdsp in elements/__init__.py)
LATER_FACTORIES = (
    "jaxinference", "yolov8tensordec", "ssdobjectdetector",
    "classifiertensordecoder", "ioutracker", "tensordecodebin",
    "objectdetectionoverlay", "yolo26tensordec", "yolosegv8tensordec",
    "yoloobbv8tensordec", "ultralightfacedetectortensordec",
    "segmentationoverlay", "insertbin", "testsrcbin", "rtponviftimestamp",
    "rtponvifparse", "facedetectortensordecoder", "smooth", "speed",
    "autovideosrc", "autoaudiosrc", "videoanalyse", "audiomixmatrix",
    "audiobuffersplit", "videoframe_audiolevel", "spanplc", "srtenc",
    "webvttenc", "audiochannelmix", "checksumsink", "videocodectestsink",
    "chopmydata", "errorignore", "debugspy", "fpsdisplaysink", "clockselect",
    "roundrobin", "videoparse", "audioparse", "autovideoflip",
    "videoframe-audiolevel", "simplevideomark", "simplevideomarkdetect",
    "iqa", "fieldanalysis", "interlace", "zebrastripe", "scenechange",
    "videodiff", "accurip", "imagefreeze", "webrtcechoprobe", "webrtcdsp")
BROADCAST_FACTORIES = (
    "ccconverter", "cccombiner", "ccextractor", "cea608mux", "line21encoder",
    "line21decoder", "h264ccinserter", "h264ccextractor", "h265ccinserter",
    "h265ccextractor", "alpha_combine", "alphacombine", "h264seiinserter",
    "h265seiinserter", "timecodestamper", "avwait", "h264timestamper",
    "h265timestamper", "combdetect", "ivtc", "compare", "audiolatency",
    "assrender", "dvbsubenc", "dvbsuboverlay", "dvdlpcmdec", "dvdsubdec",
    "dvdspu", "dvdsubparse", "wavescope", "spectrascope", "spacescope",
    "synaescope", "monoscope", "goom2k1", "intervideosink", "intervideosrc",
    "interaudiosink", "interaudiosrc", "intersubsink", "intersubsrc", "netsim",
    "videosegmentclip", "audiosegmentclip", "wavparse", "wavenc", "pnmenc",
    "pnmdec", "auparse", "auenc", "aiffmux", "aiffparse", "adpcmenc",
    "adpcmdec", "gdppay", "gdpdepay", "ipcpipelinesink", "ipcpipelinesrc",
    "ipcslavepipeline", "aspectratiocrop", "imagesequencesrc", "pushfilesrc",
    "splitfilesrc", "rndbuffersize", "capsdebug", "testsink", "navseek",
    "navigationtest")
# multi-stream sources, the containers and playback autoplugging
CONTAINER_FACTORIES = (
    "avimux", "avidemux", "matroskamux", "webmmux", "matroskademux",
    "mxfmux", "mxfdemux", "qtmux", "qtdemux", "cmafmux", "fmp4mux",
    "qtmoovrecover", "rmdemux", "rademux", "pnmsrc", "typefind",
    "uridecodebin", "decodebin", "playbin")
CODEC_FACTORIES = (
    "flacenc", "flacdec", "mpegaudioparse", "ac3parse", "flacparse",
    "sbcparse", "wavpackparse", "oggmux", "oggdemux", "vorbisdec",
    "vorbisenc", "theoradec", "theoraenc", "theoraparse", "opusparse",
    "mpg123audiodec")
# the Opus and AAC slice (aacparse frames an ADTS file for faad)
OPUS_AAC_FACTORIES = ("opusdec", "opusenc", "faad", "aacparse")
# VPx, the video parsers, the transport containers and playback_extra
VPX_TRANSPORT_FACTORIES = (
    "h264parse", "mpegvideoparse", "ivfparse", "h265parse", "mpeg4videoparse",
    "av1parse", "vp9parse", "pngparse", "vp8dec", "vp9dec", "vp8enc",
    "vp9enc", "codecalphademux", "vp8alphadecodebin", "vp9alphadecodebin",
    "mpegtsmux", "tsdemux", "atscmux", "mpegpsmux", "mpegpsdemux", "mplex",
    "hlssink2", "hlssink", "dashsink", "flvmux", "flvdemux", "jpegparse",
    "jifmux", "asfmux", "asfparse", "asfdemux", "decodebin3", "parsebin",
    "playbin3", "playsink", "y4mdec", "alphacolor", "dtmfdetect")
# RTP with its payloaders, RTCP's elements, the sockets, SDP, RTSP, DTMF
# and pcapparse
NET_FACTORIES = (
    "tcpserversink", "tcpclientsink", "tcpclientsrc", "tcpserversrc",
    "udpsink", "udpsrc", "rtpvrawpay", "rtpvrawdepay", "rtpL16pay",
    "rtpL16depay", "rtpjitterbuffer", "rtppcmupay", "rtppcmudepay",
    "rtppcmapay", "rtppcmadepay", "rtph264pay", "rtph264depay", "rtpptdemux",
    "rtpssrcdemux", "rtpdtmfsrc", "rtpdtmfdepay", "rtpjpegpay",
    "rtpjpegdepay", "rtpmux", "rtpdtmfmux", "rtpfunnel", "rtprtxsend",
    "rtprtxreceive", "rtprtxqueue", "rtpvp8pay", "rtpvp8depay", "rtpvp9pay",
    "rtpvp9depay", "rtpopuspay", "rtpopusdepay", "rtpL8pay", "rtpL8depay",
    "rtpL24pay", "rtpL24depay", "asteriskh263", "rtphdrextclientaudiolevel",
    "rtphdrextmid", "rtphdrextstreamid", "rtphdrextrepairedstreamid",
    "rtphdrextntp64", "rtphdrexttwcc", "rtphdrextcolorspace", "sdpdemux",
    "sdpsrc", "rtpsink", "rtpsrc", "rtspsrc", "rtspclientsink", "rtpsession",
    "rtpbin", "dtmfsrc", "icydemux", "amrparse", "dcaparse", "pcapparse")
# the rest of RTP: the second payloader batch with RED, ULPFEC and
# rtpstorage, SMPTE 2022-1 FEC, rtp_tail and Siren
RTP2_FACTORIES = (
    "rtpg722pay", "rtpg722depay", "rtpg723pay", "rtpg723depay", "rtpg726pay",
    "rtpg726depay", "rtpg729pay", "rtpg729depay", "rtpgsmpay", "rtpgsmdepay",
    "rtpilbcpay", "rtpilbcdepay", "rtpspeexpay", "rtpspeexdepay", "rtpbvpay",
    "rtpbvdepay", "rtpqcelppay", "rtpqcelpdepay", "rtpklvpay", "rtpklvdepay",
    "rtpdvpay", "rtpdvdepay", "rtpmp4vpay", "rtpmp4vdepay", "rtpmp4apay",
    "rtpmp4adepay", "rtph265pay", "rtph265depay", "rtph263ppay",
    "rtph263pdepay", "rtph263pay", "rtph263depay", "rtph261pay",
    "rtph261depay", "rtpmpapay", "rtpmpadepay", "rtpmpvpay", "rtpmpvdepay",
    "rtpmp2tpay", "rtpmp2tdepay", "rtpmp1sdepay", "rtpmp4gpay",
    "rtpmp4gdepay", "rtpac3pay", "rtpac3depay", "rtpamrpay", "rtpamrdepay",
    "rtpsbcpay", "rtpsbcdepay", "rtpj2kpay", "rtpj2kdepay", "rtpvorbispay",
    "rtpvorbisdepay", "rtptheorapay", "rtptheoradepay", "rtpstreampay",
    "rtpstreamdepay", "rtpgstpay", "rtpgstdepay", "rtppassthroughpay",
    "rtpredenc", "rtpreddec", "rtpulpfecenc", "rtpulpfecdec", "rtpstorage",
    "rtpst2022_1_fecenc", "rtpst2022_1_fecdec", "rtpmparobustdepay",
    "rtpxqtdepay", "rtpsv3vdepay", "rtpasfpay", "rtpasfdepay", "sirenenc",
    "sirendec", "rtpsirenpay", "rtpsirendepay")
# the rest of net/: WebRTC (SRTP, DTLS, SCTP, webrtcbin), RIST, SRT, RTMP,
# HLS/DASH/MSS, the socket fan-out, RFB, AVTP, the web sinks and ipc_misc
NET_TAIL_FACTORIES = (
    "srtpenc", "srtpdec", "dtlsenc", "dtlsdec", "dtlssrtpenc", "dtlssrtpdec",
    "dtlssrtpdemux", "sctpenc", "sctpdec", "webrtcbin", "ristsink",
    "ristsrc", "ristrtpext", "ristrtpdeext", "ristrtxsend", "ristrtxreceive",
    "srtsink", "srtsrc", "rtmp2sink", "rtmp2src", "hlsdemux", "dashdemux",
    "mssdemux", "multiudpsink", "dynudpsink", "multisocketsink",
    "multifdsink", "socketsrc", "rfbsrc", "avtpaafpay", "avtpaafdepay",
    "avtpcvfpay", "avtpcvfdepay", "avtprvfpay", "avtprvfdepay", "avtpsink",
    "avtpsrc", "avtpcrfsync", "avtpcrfcheck", "proxysink", "proxysrc",
    "shmsink", "shmsrc", "souphttpsrc", "streamsynchronizer", "tsparse",
    "unalignedvideoparse", "unalignedaudioparse", "neonhttpsrc",
    "souphttpclientsink", "curlhttpsink", "curlfilesink", "curlftpsink",
    "curlsmtpsink", "curlhttpsrc")


def av_factories():
    """The libav factories the port registers where the tests run: its copies
    of the JAX package's tables, filtered by its own ``have_codec`` (so
    the list does not hang on the JAX package's in-place build)."""
    from gstreamer_tpu_torch.elements import libav
    from gstreamer_tpu_torch.native import av
    if not av.available():
        return ()
    out = [e[0] for table, enc in ((libav._DECODERS, False),
                                   (libav._AUDIO_DECODERS, False),
                                   (libav._ENCODERS, True),
                                   (libav._AUDIO_ENCODERS, True))
           for e in table if av.have_codec(e[1], encoder=enc)]
    if av.have_codec("mpeg2video", encoder=True):
        out.append("mpeg2enc")
    if av.have_codec("aptx"):
        out += ["openaptxdec", "openaptxenc", "avdec_aptx", "avdec_aptx_hd"]
    return tuple(out)


# the libav family (where the system libavcodec has each codec) and the
# numpy codecs LC3, Smoke and FLIC
CODEC_TAIL_FACTORIES = ("lc3enc", "lc3dec", "smokeenc", "smokedec",
                        "flxdec") + av_factories()
# subtitles, tags and the last parsers: subparse, subtitles_extra, tagmux
# (modules 5-7) and multipart, moreparsers, aliases, transcode (8-11); the
# decoder aliases where the port's libav registered what they name
SUBTITLES_TAGS_FACTORIES = (
    "subparse", "encodebin", "subtitleoverlay", "ttmlparse", "ttmlrender",
    "avisubtitle", "apev2mux", "bpmdetect", "rtpdec", "id3v2mux", "id3mux")
PARSERS_MULTIPART_FACTORIES = (
    "multipartmux", "multipartdemux", "id3demux", "apedemux", "h263parse",
    "h266parse", "vc1parse", "diracparse", "jpeg2000parse", "oggparse",
    "matroskaparse", "vorbisparse", "vorbistag", "flactag", "id3metaparse",
    "ssaparse", "goom", "srtclientsrc", "srtserversrc", "srtclientsink",
    "srtserversink", "liveadder", "uridecodebin3", "urisourcebin",
    "encodebin2", "rtmpsink", "rtmpsrc", "hlsdemux2", "dashdemux2",
    "mssdemux2", "uritranscodebin", "transcodebin") + (
        ("dvdec",) if "avdec_dvvideo" in CODEC_TAIL_FACTORIES else ()) + (
        ("av1dec", "dav1ddec") if "avdec_av1" in CODEC_TAIL_FACTORIES
        else ())
TAGS_SUBS_FACTORIES = SUBTITLES_TAGS_FACTORIES + PARSERS_MULTIPART_FACTORIES
TAGS_SUBS_MODULES = ("subparse", "subtitles_extra", "tagmux", "multipart",
                     "moreparsers", "aliases", "transcode")
# the leaves: the last 14 modules of elements/ and mse.py (chromaprint only
# where libchromaprint loads, in both packages)
LEAVES_MODULES = ("shout2", "camerabin", "dsd_elements", "midi_irtsp",
                  "splitmux", "aes_misc", "chromaprint", "xingmux",
                  "bz2_elements", "ext_music", "de265", "mse", "gio_dv",
                  "ogm")
LEAVES_FACTORIES = (
    "shout2send", "camerabin", "dsdconvert", "fakevideodec", "midiparse",
    "irtspparse", "unixfdsink", "unixfdsrc", "splitmuxsink", "splitmuxsrc",
    "aesenc", "aesdec", "tonegeneratesrc", "xingmux", "bz2enc", "bz2dec",
    "gmedec", "openmptdec", "libde265dec", "msesrc", "giostreamsrc",
    "giostreamsink", "dvdemux", "ogmvideoparse", "ogmaudioparse",
    "ogmtextparse", "oggaviparse") + (
        ("chromaprint",) if tchromaprint._LIB is not None else ())
VSRC = ("appsrc name={n} caps=video/x-raw,format=I420,width=32,height=24,"
        "framerate=30/1")
ASRC = ("appsrc name={n} caps=audio/x-raw,format=S16LE,rate=48000,"
        "channels=2,layout=interleaved")
DUR = 10_000_000           # 480 frames at 48 kHz


def video(names=("in",), batch=2, ticks=2):
    return video_pushes({n: ("I420", 32, 24) for n in names}, batch, ticks)


def audio(names=("in",), ticks=2, seed=0):
    rng = np.random.default_rng(seed)
    return {n: [dict(data=rng.integers(-3000, 3000, (480, 2), np.int16),
                     pts=t * DUR, duration=DUR) for t in range(ticks)]
            for n in names}


def _spec(cls):
    props = {k: (v[0].__name__, str(v[1])) for k, v in cls.PROPERTIES.items()}
    pads = [(t.name, t.direction, t.presence, str(t.caps))
            for t in cls.PAD_TEMPLATES]
    return props, pads


@pytest.mark.parametrize("factory", NEW_FACTORIES + CODEC_TAIL_FACTORIES)
def test_factory_matches_reference(factory):
    """Property names, types, defaults and pad templates as the
    reference's class of the same factory."""
    if factory in CODEC_TAIL_FACTORIES:
        from test_torch_libav import load_jax_av
        load_jax_av()
    jelement._ensure_elements_loaded()
    telement._ensure_elements_loaded()
    assert _spec(telement._REGISTRY[factory][0]) == \
        _spec(jelement._REGISTRY[factory][0])


PORT_ELEMENT_MODULES = ("gstreamer_tpu_torch.elements.",
                        "gstreamer_tpu_torch.net.")


def port_element_factories():
    """The factories the port's element packages register (elements/,
    net/, mse.py), loaded first: what a module outside them registers when
    a test imports it (``editing/timeline.py``'s two, a test's own
    element) is left out, so the count holds in any order of tests."""
    telement._ensure_elements_loaded()
    return sorted(f for f, (c, _r) in telement._REGISTRY.items()
                  if c.__module__.startswith(PORT_ELEMENT_MODULES)
                  or c.__module__ == "gstreamer_tpu_torch.mse")


def test_registry_count():
    """571 before the libav slice, the five numpy codec factories, as many
    libav factories as the JAX package registers where the tests run, as
    many of the subtitle, tag and parser modules' (46 here: the decoder
    aliases follow libav) and the leaves' (28 here: chromaprint follows
    libchromaprint)."""
    from test_torch_libav import load_jax_av
    load_jax_av()
    jav = [f for f, (c, _r) in jelement._REGISTRY.items()
           if c.__module__ == "gstreamer_tpu.elements.libav"]
    jslice = [f for f, (c, _r) in jelement._REGISTRY.items()
              if c.__module__.rsplit(".", 1)[-1] in TAGS_SUBS_MODULES
              and c.__module__.startswith("gstreamer_tpu.elements.")]
    jleaves = [f for f, (c, _r) in jelement._REGISTRY.items()
               if c.__module__.rsplit(".", 1)[-1] in LEAVES_MODULES]
    assert len(port_element_factories()) == 571 + 5 + len(jav) \
        + len(jslice) + len(jleaves)
    assert sorted(LEAVES_FACTORIES) == sorted(jleaves)
    assert len(LEAVES_FACTORIES) == 27 + (
        "gstreamer_tpu_torch.elements.chromaprint" in {
            c.__module__ for c, _r in telement._REGISTRY.values()})
    assert len(CODEC_TAIL_FACTORIES) == 5 + len(jav)
    assert sorted(TAGS_SUBS_FACTORIES) == sorted(jslice)
    assert len(TAGS_SUBS_FACTORIES) == 43 + ("avdec_dvvideo" in jav) \
        + 2 * ("avdec_av1" in jav)
    assert len(set(LATER_FACTORIES)) == 53
    assert len(set(BROADCAST_FACTORIES)) == 68
    assert len(set(CONTAINER_FACTORIES)) == 19
    assert len(set(CODEC_FACTORIES)) == 16
    assert len(set(OPUS_AAC_FACTORIES)) == 4
    assert len(set(VPX_TRANSPORT_FACTORIES)) == 38
    assert len(set(NET_FACTORIES)) == 60
    assert len(set(RTP2_FACTORIES)) == 76
    assert len(set(NET_TAIL_FACTORIES)) == 55
    assert set(NEW_FACTORIES) | set(LATER_FACTORIES) \
        | set(BROADCAST_FACTORIES) | set(CONTAINER_FACTORIES) \
        | set(CODEC_FACTORIES) | set(OPUS_AAC_FACTORIES) \
        | set(VPX_TRANSPORT_FACTORIES) | set(NET_FACTORIES) \
        | set(RTP2_FACTORIES) | set(NET_TAIL_FACTORIES) \
        | set(CODEC_TAIL_FACTORIES) | set(TAGS_SUBS_FACTORIES) \
        | set(LEAVES_FACTORIES) <= set(telement._REGISTRY)


def test_codec_slice_leaves_opus_aac_libav_out():
    """The libav family waited for its slice, which registers it in the
    port as the JAX package does: every avdec_* factory of the JAX
    registry is the port's too.  The Opus and AAC decoders, which waited
    with it until the Opus slice, are registered in both."""
    from test_torch_libav import load_jax_av
    load_jax_av()
    later = sorted(f for f in jelement._REGISTRY if f.startswith("avdec_"))
    assert len(later) > 3 and all(f in telement._REGISTRY for f in later)
    assert all(f in jelement._REGISTRY and f in telement._REGISTRY
               for f in OPUS_AAC_FACTORIES)


def _mkv_track(path, codec, kind, private=b""):
    """A minimal Matroska file: one track of `codec`, one block."""
    from gstreamer_tpu_torch.elements import container_elements as e
    entry = (e.ebml_uint(e.TRACK_NUMBER, 1) + e.ebml_uint(e.TRACK_UID, 1)
             + e.ebml_uint(e.TRACK_TYPE, 1 if kind == "video" else 2)
             + e.ebml_str(e.CODEC_ID, codec))
    if private:
        entry += e.ebml_elem(e.CODEC_PRIVATE, private)
    if kind == "video":
        entry += e.ebml_elem(e.VIDEO, e.ebml_uint(e.PIXEL_WIDTH, 16)
                             + e.ebml_uint(e.PIXEL_HEIGHT, 16))
    else:
        entry += e.ebml_elem(e.AUDIO, e.ebml_float(e.SAMPLING_FREQ, 48000.0)
                             + e.ebml_uint(e.CHANNELS, 2))
    block = e.ebml_elem(e.SIMPLE_BLOCK, e.ebml_size(1) + b"\0\0\x80" + b"x")
    path.write_bytes(
        e.ebml_elem(e.EBML_HEADER, e.ebml_str(0x4282, "matroska"))
        + e.ebml_id(e.SEGMENT) + b"\xff"
        + e.ebml_elem(e.TRACKS, e.ebml_elem(e.TRACK_ENTRY, entry))
        + e.ebml_elem(e.CLUSTER, e.ebml_uint(e.CLUSTER_TS, 0) + block))


@pytest.mark.parametrize("desc", [
    "queue2", "multiqueue", "streamiddemux", "queue2 ! multiqueue",
    "valve drop=false", "tee"])
def test_structural_pass_through(desc):
    tpipe, _ = run_both(VSRC.format(n="in") + f" ! {desc} ! appsink name=out",
                        video(), batch=2)
    assert tpipe._fused


def test_tee_into_two_sinks():
    run_both(VSRC.format(n="in") + " ! videobalance contrast=1.2 ! tee name=t"
             " t. ! queue ! appsink name=a t. ! gamma gamma=2.0 ! "
             "appsink name=b", video(), sinks=("a", "b"), batch=2)


def test_valve_drop_emits_nothing():
    """The port's closed valve passes no buffer; the JAX package's passes
    every one (it declares `drop` and never reads it)."""
    desc = VSRC.format(n="in") + " ! valve drop=true ! appsink name=out"
    pushes = video(ticks=3)
    jpipe, ref = _run(jparse_launch, JBuffer, desc, pushes, ("out",), 2)
    tpipe, got = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, pushes,
                      ("out",), 2, device="cpu")
    assert got["out"] == [] and len(ref["out"]) == 3
    valve = next(e for e in tpipe.iterate_elements() if e.FACTORY == "valve")
    assert valve in tpipe._host_elems and not tpipe._fused


def test_fakesrc_bytes():
    run_both("fakesrc num-buffers=5 sizemax=64 ! application/octet-stream ! "
             "appsink name=out", batch=2)


@pytest.mark.parametrize("factory", ["concat", "funnel",
                                     "input-selector active-pad=sink_1",
                                     "input-selector"])
def test_n_to_1_video(factory):
    desc = (f"{factory} name=s ! appsink name=out "
            + " ".join(VSRC.format(n=f"in{k}") + f" ! s.sink_{k}"
                       for k in range(2)))
    pushes = video(("in0", "in1"))
    _, out = run_both(desc, pushes, batch=2)
    pick = "in1" if "sink_1" in factory else "in0"
    got = out["out"][0].buffer.data
    assert all(np.array_equal(g.numpy(), w)
               for g, w in zip(got, pushes[pick][0]["data"]))


@pytest.mark.parametrize("factory", ["concat", "funnel"])
def test_n_to_1_audio(factory):
    desc = (f"{factory} name=s ! appsink name=out "
            + " ".join(ASRC.format(n=f"in{k}") + f" ! s.sink_{k}"
                       for k in range(2)))
    run_both(desc, audio(("in0", "in1")))


def test_input_selector_audio():
    """On an audio stream (one tensor a buffer) the port forwards the
    active pad's tensor; the JAX package's choice tests the array's truth
    value and raises (ROADMAP.md section 3)."""
    desc = ("input-selector name=s active-pad=sink_1 ! appsink name=out "
            + " ".join(ASRC.format(n=f"in{k}") + f" ! s.sink_{k}"
                       for k in range(2)))
    pushes = audio(("in0", "in1"))
    _, got = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, pushes,
                  ("out",), 1, device="cpu")
    assert [s.buffer.pts for s in got["out"]] == [0, DUR]
    for s, want in zip(got["out"], pushes["in1"]):
        assert torch.equal(s.buffer.data, torch.from_numpy(want["data"]))
    with pytest.raises(ValueError, match="truth value"):
        _run(jparse_launch, JBuffer, desc, pushes, ("out",), 1)


def test_output_selector_active_branch():
    """The active branch gets every buffer, as in the JAX package (both
    also feed the other branch: ROADMAP.md section 3)."""
    run_both(VSRC.format(n="in") + " ! output-selector name=o "
             "active-pad=src_1 o. ! appsink name=a o. ! appsink name=b",
             video(), sinks=("b",), batch=2)


@pytest.mark.parametrize("desc", [
    "autovideoconvert ! video/x-raw,format=RGB",
    "autoconvert factories=videoflip,videoconvert",
    'switchbin paths="audio/x-raw->volume,volume=0.5|'
    'video/x-raw->videoflip,method=clockwise|ANY->"',
    'switchbin paths="video/x-raw->gamma,gamma=2.2|ANY->"'])
def test_caps_chosen_inner_video(desc):
    tpipe, _ = run_both(VSRC.format(n="in") + f" ! {desc} ! appsink name=out",
                        video(), batch=2)
    proxy = next(e for e in tpipe.iterate_elements()
                 if e.FACTORY in ("autovideoconvert", "autoconvert",
                                  "switchbin"))
    assert proxy._inner is not None and proxy._inner.device.type == "cpu"


def test_caps_chosen_inner_audio():
    tpipe, _ = run_both(
        ASRC.format(n="in") + ' ! switchbin paths="video/x-raw->videoflip|'
        'audio/x-raw->volume,volume=0.5|ANY->" ! appsink name=out', audio())
    sb = next(e for e in tpipe.iterate_elements()
              if e.FACTORY == "switchbin")
    assert sb.props["current-path"] == 1 and sb._inner.FACTORY == "volume"


def _clocksync(parse, buffer_cls, clock_cls, **kw):
    """tests/test_harness_extras.py's clocksync case on a pipeline: a
    buffer one second ahead of the clock is held; after a crank it comes
    out on the next tick, which holds the newer buffer."""
    pipe = parse(ASRC.format(n="in") + " ! clocksync sync=true ! "
                 "appsink name=out", **kw)
    clock = clock_cls()
    pipe.use_clock(clock)
    assert pipe.get_clock() is clock
    src, sink = pipe.get_by_name("in"), pipe.get_by_name("out")
    src.push_buffer(buffer_cls(data=np.ones((16, 2), np.int16),
                               pts=1_000_000_000))
    assert pipe.tick()
    assert sink.pull_sample() is None and clock._waits
    assert clock.process_next_clock_id() is not None
    assert clock.get_time() >= 1_000_000_000
    src.push_buffer(buffer_cls(data=np.full((16, 2), 2, np.int16),
                               pts=2_000_000_000))
    assert pipe.tick()
    out = sink.pull_sample()
    host = sorted(e.FACTORY for e in pipe._host_elems)
    return pipe, out, host


def test_clocksync_under_a_test_clock():
    jpipe, jout, jhost = _clocksync(jparse_launch, JBuffer, JTestClock)
    tpipe, tout, thost = _clocksync(gstreamer_tpu_torch.parse_launch,
                                    Buffer, testclock.TestClock,
                                    device="cpu")
    assert thost == jhost == ["clocksync"]
    assert tout.buffer.pts == jout.buffer.pts == 1_000_000_000
    assert np.array_equal(tout.buffer.data.numpy(),
                          np.asarray(jout.buffer.data))
    assert (tout.buffer.data == 1).all()


def test_clocksync_without_a_clock_is_structural():
    tpipe, _ = run_both(ASRC.format(n="in") + " ! clocksync ts-offset=5 ! "
                        "appsink name=out", audio())
    assert tpipe._fused


def test_videomedian_filtersize_9_raises():
    """The port raises at 9; the JAX package reads the property and runs
    the 5-point median all the same (ROADMAP.md section 3)."""
    desc = VSRC.format(n="in") + " ! videomedian filtersize={} ! " \
        "appsink name=out"
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _run(gstreamer_tpu_torch.parse_launch, Buffer, desc.format(9),
             video(), ("out",), 2, device="cpu")
    _, nine = _run(jparse_launch, JBuffer, desc.format(9), video(), ("out",),
                   2)
    _, five = _run(jparse_launch, JBuffer, desc.format(5), video(), ("out",),
                   2)
    for a, b in zip(nine["out"], five["out"]):
        for x, y in zip(a.buffer.data, b.buffer.data):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_clocksync_held_buffers_carry_across():
    """A buffer the JAX package's clocksync holds comes out of the port's
    after element_states / load_element_states, as it comes out of the JAX
    package's: on the tick after the clock reaches it."""
    from gstreamer_tpu_torch.interop import (element_states,
                                             load_element_states)
    desc = ASRC.format(n="in") + " ! clocksync name=cs ! appsink name=out"
    jpipe = jparse_launch(desc)
    jclock = JTestClock()
    jpipe.use_clock(jclock)
    jpipe.get_by_name("in").push_buffer(JBuffer(
        data=np.arange(32, dtype=np.int16).reshape(16, 2), pts=10**9))
    assert jpipe.tick() and jpipe.get_by_name("out").pull_sample() is None
    states = element_states(jpipe)
    assert [b["pts"] for b in states["cs"]["held"]] == [10**9]

    tpipe = gstreamer_tpu_torch.parse_launch(desc, device="cpu")
    tclock = testclock.TestClock()
    tpipe.use_clock(tclock)
    tpipe.set_state("playing")
    load_element_states(tpipe, states)
    outs = []
    for pipe, clock, cls in ((jpipe, jclock, JBuffer),
                             (tpipe, tclock, Buffer)):
        clock.set_time(10**9)
        pipe.get_by_name("in").push_buffer(cls(
            data=np.zeros((16, 2), np.int16), pts=2 * 10**9))
        assert pipe.tick()
        outs.append(pipe.get_by_name("out").pull_sample().buffer)
    t, j = outs[1], outs[0]
    assert t.pts == j.pts == 10**9
    assert np.array_equal(t.data.numpy(), np.asarray(j.data))
