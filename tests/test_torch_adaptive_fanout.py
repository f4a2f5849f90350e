"""The port's pull and fan-out modules against the JAX package:
``net/adaptive.py`` (hlsdemux, dashdemux, mssdemux), ``net/fanout.py``
(multiudpsink, dynudpsink, multisocketsink, multifdsink, socketsrc),
``net/rfb.py`` (rfbsrc), ``net/websinks.py`` (the HTTP, file, FTP and SMTP
upload sinks, curlhttpsrc) and ``elements/ipc_misc.py`` (proxysink /
proxysrc, shmsink / shmsrc, souphttpsrc, streamsynchronizer, tsparse, the
unaligned raw parsers, neonhttpsrc).

The JAX package's own tests (``tests/test_adaptive.py``,
``test_fanout.py``, ``test_rfb.py``, ``test_websinks.py``,
``test_ipc_misc.py``) run again on the port, against local servers on port
0 and ``file://`` URIs, never the network.  ``test_adaptive.TestHlsDecode``
builds its segments with x264enc and avenc_aac, which the port has not
(libav waits in ROADMAP.md): its decode path is held here on TS segments
of the committed AAC vector instead, as the playlist parses (M3U8, MPD,
the MSS manifest) are, byte for byte, tolerance 0.
``test_fanout.TestAliases`` asks for the aliases of
``elements/aliases.py`` (srtclientsrc, liveadder, hlsdemux2, ...), a module
not ported yet (ROADMAP.md), and is left out.
"""

import http.server
import socket
import socketserver
import threading

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.net import adaptive as jadaptive

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.parse import parse_launch as tparse_launch
from gstreamer_tpu_torch.net import adaptive as tadaptive

import test_adaptive
import test_fanout
import test_ipc_misc
import test_rfb
import test_websinks
from test_torch_analytics import same_spec
from test_torch_captions import pair
from test_torch_flow import NET_TAIL_FACTORIES
from test_torch_rtp import _cpu_make, packets
from test_torch_webrtc import reference_cases, run_case

DATA = __import__("pathlib").Path(__file__).parent / "data" / "torch_codecs"

REFERENCE = (reference_cases(test_adaptive, exclude=("TestHlsDecode",))
             + reference_cases(test_fanout, exclude=("TestAliases",))
             + reference_cases(test_rfb)
             + reference_cases(test_websinks)
             + reference_cases(test_ipc_misc))


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    run_case(case, tmp_path)


PULL_FACTORIES = [f for f in NET_TAIL_FACTORIES if not f.startswith(
    ("srtp", "dtls", "sctp", "webrtc", "rist", "srt", "rtmp", "avtp"))]


@pytest.mark.parametrize("factory", PULL_FACTORIES)
def test_factory_spec_matches_reference(factory):
    same_spec(factory)


# -- playlists and manifests ------------------------------------------------
M3U8 = [
    "#EXTM3U\n#EXT-X-VERSION:3\n#EXT-X-TARGETDURATION:4\n"
    "#EXT-X-MEDIA-SEQUENCE:17\n#EXTINF:3.966,\nseg17.ts\n"
    "#EXTINF:4.0,title\nsub/seg18.ts?x=1\n#EXTINF:1.5,\n"
    "http://cdn.example/seg19.ts\n#EXT-X-ENDLIST\n",
    "#EXTM3U\n#EXT-X-STREAM-INF:BANDWIDTH=1280000,RESOLUTION=640x360\n"
    "low/index.m3u8\n#EXT-X-STREAM-INF:BANDWIDTH=2560000\nhi/index.m3u8\n"
    "#EXT-X-STREAM-INF:PROGRAM-ID=1\nnobw.m3u8\n",
    "#EXTM3U\n\n#EXTINF:2,\n  a.ts  \n#EXT-X-DISCONTINUITY\n#EXTINF:2,\nb.ts\n",
]


@pytest.mark.parametrize("text", M3U8)
@pytest.mark.parametrize("base", ["/media/live/index.m3u8",
                                  "http://host:8080/live/index.m3u8"])
def test_m3u8_parses_match(text, base):
    assert tadaptive.parse_m3u8(text, base) == \
        jadaptive.parse_m3u8(text, base)


@pytest.mark.parametrize("text", ["", "#EXTM3U8\nx.ts\n", "seg.ts\n"])
def test_m3u8_refusals_match(text):
    for mod in (tadaptive, jadaptive):
        with pytest.raises(ValueError):
            mod.parse_m3u8(text, "/x.m3u8")


@pytest.mark.parametrize("s", ["PT1H2M3.5S", "PT30S", "PT0.25S", "P1D", "",
                               None, "PT2M"])
def test_mpd_durations_match(s):
    assert tadaptive._mpd_duration(s) == jadaptive._mpd_duration(s)


MPDS = {
    "list": """<?xml version="1.0"?>
<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" mediaPresentationDuration="PT6S">
 <BaseURL>media/</BaseURL>
 <Period><AdaptationSet mimeType="audio/mp4">
  <Representation id="a1" bandwidth="64000">
   <SegmentList duration="96000" timescale="48000">
    <Initialization sourceURL="init-a1.mp4"/>
    <SegmentURL media="a1-1.m4s"/><SegmentURL media="a1-2.m4s"/>
   </SegmentList></Representation>
  <Representation id="a2" bandwidth="128000"><BaseURL>hi/</BaseURL>
   <SegmentList duration="2" timescale="1">
    <SegmentURL media="a2-1.m4s"/><SegmentURL media="a2-2.m4s"/>
    <SegmentURL media="a2-3.m4s"/></SegmentList></Representation>
 </AdaptationSet></Period></MPD>""",
    "template": """<?xml version="1.0"?>
<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" mediaPresentationDuration="PT7.5S">
 <Period><AdaptationSet>
  <SegmentTemplate media="$RepresentationID$/seg-$Number$.ts"
    initialization="$RepresentationID$/init.mp4" duration="2"
    timescale="1" startNumber="5"/>
  <Representation id="v720" bandwidth="3000000"/>
  <Representation id="v360" bandwidth="800000"/>
 </AdaptationSet></Period></MPD>""",
}


@pytest.mark.parametrize("kind", sorted(MPDS))
def test_mpd_segment_lists_match(kind, tmp_path):
    (tmp_path / "m.mpd").write_text(MPDS[kind])
    segs = []
    for mod in (tadaptive, jadaptive):
        e = mod.DashDemux(uri=str(tmp_path / "m.mpd"))
        e._load()
        segs.append(e._segments)
    assert segs[0] == segs[1] and segs[0]


MSS = """<?xml version="1.0" encoding="utf-8"?>
<SmoothStreamingMedia MajorVersion="2" MinorVersion="0" Duration="40000000">
 <StreamIndex Type="video" Url="QualityLevels({bitrate})/Fragments(video={start time})"
  MaxWidth="1280" MaxHeight="720">
  <QualityLevel Bitrate="1500000" FourCC="H264" CodecPrivateData="000000016742"/>
  <QualityLevel Bitrate="350000" FourCC="H264" CodecPrivateData="00"/>
  <c t="0" d="20000000"/><c d="20000000"/>
 </StreamIndex>
 <StreamIndex Type="audio" Url="QualityLevels({bitrate})/Fragments(audio={start time})">
  <QualityLevel Bitrate="128000" FourCC="AACL" SamplingRate="48000"
   Channels="2" CodecPrivateData="1190"/>
  <c t="0" d="20053333"/><c d="19946667"/>
 </StreamIndex></SmoothStreamingMedia>"""


@pytest.mark.parametrize("stream_type", ["video", "audio"])
def test_mss_manifest_parses_match(stream_type, tmp_path):
    (tmp_path / "Manifest").write_text(MSS)
    out = []
    for mod in (tadaptive, jadaptive):
        e = mod.MssDemux(uri=str(tmp_path / "Manifest"),
                         **{"stream-type": stream_type})
        e._load()
        out.append((e._segments, e.manifest_info))
    assert out[0] == out[1]


# -- HLS / DASH over TS segments of the committed AAC -----------------------
def _aac_head(path, frames):
    """The first `frames` ADTS frames of the committed AAC vector."""
    data = (DATA / "aac_10s.aac").read_bytes()
    pos = 0
    for _ in range(frames):
        pos += ((data[pos + 3] & 3) << 11) | (data[pos + 4] << 3) \
            | (data[pos + 5] >> 5)
    path.write_bytes(data[:pos])
    return path


@pytest.fixture(scope="module")
def aac_segments(tmp_path_factory):
    """hlssink2's segments and playlist and dashsink's MPD of 2 s of the
    committed AAC (the port's writers, which write the JAX package's files
    byte for byte: test_torch_mpegts.py)."""
    d = tmp_path_factory.mktemp("hls")
    aac = _aac_head(d / "a.aac", 90)
    for sink in (f"hlssink2 location={d}/seg%05d.ts "
                 f"playlist-location={d}/p.m3u8 target-duration=1",
                 f"dashsink location={d}/d%05d.ts mpd-filename={d}/m.mpd "
                 "target-duration=1"):
        tparse_launch(f"filesrc location={aac} ! aacparse ! {sink}",
                      device="cpu").run()
    return d


@pytest.mark.parametrize("demux,manifest,stream", [
    ("hlsdemux", "p.m3u8", ""), ("hlsdemux", "p.m3u8", "audio"),
    ("dashdemux", "m.mpd", ""), ("dashdemux", "m.mpd", "0")])
def test_adaptive_pulls_match(demux, manifest, stream, aac_segments):
    """Segment bytes (no stream=) and the decoded AAC (stream=audio or 0,
    through the inner tsdemux ! aacparse ! faad chain) as the JAX
    package's, over a file:// URI and a bare path."""
    uri = (f"file://{aac_segments}/{manifest}" if stream
           else f"{aac_segments}/{manifest}")
    sel = f" stream={stream}" if stream else ""
    _, ref, _, _ = pair(f"{demux} uri={uri}{sel} ! appsink name=out", {})
    assert len(ref["out"]) >= 2


def test_adaptive_names_roadmap_for_an_unported_decoder(monkeypatch):
    """A segment stream of H.264 gets avdec_h264 in both packages since the
    libav slice; where the system libavcodec has no H.264 decoder (the
    factory unregistered), the port raises naming that codec, no longer
    ROADMAP.md."""
    from gstreamer_tpu.core.caps import Caps as JCaps
    from gstreamer_tpu.elements import playback as jplayback
    from gstreamer_tpu_torch.core import element as telement
    from gstreamer_tpu_torch.core.caps import Caps
    from gstreamer_tpu_torch.elements import playback
    from gstreamer_tpu_torch.native import av
    caps = "video/x-h264, stream-format=byte-stream"
    telement._ensure_elements_loaded()
    assert playback._decoder_for_caps(Caps.from_string(caps)) == \
        jplayback._decoder_for_caps(JCaps.from_string(caps)) == "avdec_h264"
    monkeypatch.delitem(telement._REGISTRY, "avdec_h264")
    monkeypatch.setattr(av, "have_codec", lambda *a, **k: False)
    with pytest.raises(RuntimeError,
                       match="system libavcodec has no 'h264' decoder"):
        playback._decoder_for_caps(Caps.from_string(caps))


# -- shm, proxy, tsparse, souphttpsrc through both packages ------------------
def test_shm_jpegs_match(tmp_path):
    rng = np.random.default_rng(4)
    jpegs = [b"\xff\xd8" + rng.integers(0, 256, 300 + 50 * k,
                                        np.uint8).tobytes() + b"\xff\xd9"
             for k in range(5)]
    for mod, parse, buffer in (("t", tparse_launch, Buffer),
                               ("j", jparse_launch, JBuffer)):
        kw = {"device": "cpu"} if mod == "t" else {}
        p = parse(f"appsrc name=in ! application/octet-stream ! shmsink "
                  f"socket-path={tmp_path}/{mod}", **kw)
        for j in jpegs:
            p.get_by_name("in").push_buffer(buffer(
                data=np.frombuffer(j, np.uint8), batch=1))
        p.get_by_name("in").end_of_stream()
        p.run()
        p.set_state("null")
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    pair(f"shmsrc socket-path={tmp_path}/t ! appsink name=out", {})


def test_tsparse_matches(tmp_path):
    rng = np.random.default_rng(6)
    pkts = [bytes([0x47]) + rng.integers(0, 256, 187, np.uint8).tobytes()
            for _ in range(9)]
    blob = rng.integers(1, 0x40, 37, np.uint8).tobytes() + b"".join(pkts)
    pushes = {"in": [dict(data=np.frombuffer(blob[k:k + 500], np.uint8),
                          pts=k) for k in range(0, len(blob), 500)]}
    pair("appsrc name=in caps=video/mpegts ! tsparse ! appsink name=out",
         pushes)


def _http_dir(root):
    class H(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(root), **kw)

        def log_message(self, *a):
            pass
    httpd = socketserver.TCPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.mark.parametrize("factory", ["souphttpsrc", "neonhttpsrc",
                                     "curlhttpsrc"])
def test_http_sources_match(factory, tmp_path):
    blob = np.random.default_rng(1).integers(0, 256, 20000,
                                             np.uint8).tobytes()
    (tmp_path / "b.bin").write_bytes(blob)
    httpd = _http_dir(tmp_path)
    try:
        port = httpd.server_address[1]
        pair(f"{factory} location=http://127.0.0.1:{port}/b.bin "
             "blocksize=3000 ! appsink name=out", {})
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_upload_sinks_write_the_same_file(tmp_path):
    blob = np.random.default_rng(2).integers(0, 256, 5000,
                                             np.uint8).tobytes()
    for mod, parse, buffer in (("t", tparse_launch, Buffer),
                               ("j", jparse_launch, JBuffer)):
        kw = {"device": "cpu"} if mod == "t" else {}
        p = parse("appsrc name=in ! application/octet-stream ! "
                  f"curlfilesink location=file://{tmp_path}/{mod}.bin", **kw)
        for k in range(0, len(blob), 1200):
            p.get_by_name("in").push_buffer(buffer(
                data=np.frombuffer(blob[k:k + 1200], np.uint8), batch=1))
        p.get_by_name("in").end_of_stream()
        p.run()
        p.set_state("null")
    assert (tmp_path / "t.bin").read_bytes() == blob == \
        (tmp_path / "j.bin").read_bytes()


# -- fan-out ----------------------------------------------------------------
def test_multiudpsink_fans_out_the_same_datagrams():
    rxs = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
           for _ in range(3)]
    for r in rxs:
        r.bind(("127.0.0.1", 0))
        r.settimeout(5.0)
    clients = ",".join(f"127.0.0.1:{r.getsockname()[1]}" for r in rxs)
    blob = np.random.default_rng(3).integers(0, 256, 3500,
                                             np.uint8).tobytes()
    got = {}
    try:
        for mod, make, buffer in (("t", _cpu_make, Buffer),
                                  ("j", test_fanout.make_element,
                                   JBuffer)):
            s = make("multiudpsink", clients=clients, mtu=1000)
            s.start()
            s.render(buffer(data=np.frombuffer(blob, np.uint8), batch=1))
            s.render(buffer(data=[b"pkt-a", b"pkt-b"], batch=1))
            got[mod] = ([[r.recvfrom(2000)[0] for _ in range(6)]
                         for r in rxs], dict(s.bytes_sent))
            s.stop()
    finally:
        for r in rxs:
            r.close()
    assert got["t"] == got["j"]
    assert b"".join(got["t"][0][0][:4]) == blob


def test_socketsrc_reads_as_the_reference():
    blob = np.random.default_rng(5).integers(0, 256, 9000,
                                             np.uint8).tobytes()
    outs = []
    for parse, kw in ((tparse_launch, {"device": "cpu"}),
                      (jparse_launch, {})):
        a, b = socket.socketpair()
        a.sendall(blob)
        a.close()
        p = parse("socketsrc name=s blocksize=4096 timeout=1.0 ! "
                  "appsink name=out", **kw)
        p.get_by_name("s").props["socket"] = b
        p.run()
        chunks = []
        while (s := p.get_by_name("out").pull_sample()) is not None:
            chunks.append(b"".join(packets(s.buffer.data)))
        b.close()
        outs.append(chunks)
    assert outs[0] == outs[1] and b"".join(outs[0]) == blob


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_rfbsrc_frames_on_the_port_device():
    """rfbsrc's RGBx planes go to the pipeline's device, bytes as the JAX
    package's, from one seeded VNC server each."""
    outs = []
    for parse, kw in ((tparse_launch, {"device": "cpu"}),
                      (jparse_launch, {})):
        srv = test_rfb.MiniVnc()
        srv.start()
        p = parse(f"rfbsrc port={srv.port} num-buffers=2 ! "
                  "appsink name=out", **kw)
        p.run()
        frames = []
        while (s := p.get_by_name("out").pull_sample()) is not None:
            frames.append([_host(x) for x in s.buffer.data])
        outs.append(frames)
        srv.join(5.0)
    assert len(outs[0]) == 2
    for a, b in zip(outs[0], outs[1]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
