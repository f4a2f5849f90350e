"""FLV, ASF and the JPEG format elements in the port against the JAX
package, bit for bit: flvmux / flvdemux (PCM, G.711, AAC and H.264),
asfmux / asfparse / asfdemux (PCM audio and MJPEG video, one stream per
instance), and jpegparse / jifmux with the EXIF and XMP writers.

The same launch string and the same seeded or committed bytes go through
both packages (the port on the CPU): files are the same bytes, and every
sample, caps and the negotiated caps equal (``test_torch_captions.pair``),
tolerance 0.  asfmux takes its file ID from ``uuid.uuid4()``: the file is
held byte for byte with ``uuid.uuid4`` fixed alike for both packages, and
everything else about it whatever the ID.  Each demuxer also reads a file
the JAX package wrote, and one written by libavformat where the JAX
package's shim can write it.  Decoded PCM from a demuxed stream equals the
same decoder's PCM on the plain file.
"""

import os
import uuid

import numpy as np
import pytest

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import asf as jasf
from gstreamer_tpu.elements import jpegformat as jjf
from gstreamer_tpu.native import av as native_av

from gstreamer_tpu_torch import parse_launch as tparse_launch
from gstreamer_tpu_torch.codecs import aac as taac
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements import asf as tasf
from gstreamer_tpu_torch.elements import jpegformat as tjf

from test_torch_captions import _run, pair
from test_torch_file_formats import write_both
from test_torch_mpegts import blob_push, file_head, h264_aus, pcm_rows

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_codecs")
AAC = os.path.join(DATA, "aac_10s.aac")


def asrc(fmt, rate, ch, name="a"):
    return (f"appsrc name={name} caps=audio/x-raw,format={fmt},rate={rate},"
            f"channels={ch},layout=interleaved")


def apushes(fmt, rate, ch, n, ticks, seed=0):
    rng = np.random.default_rng(seed)
    dt = {"S16LE": np.int16, "U8": np.uint8}[fmt]
    lo, hi = (-20000, 20000) if fmt == "S16LE" else (0, 256)
    dur = n * 1_000_000_000 // rate
    return [dict(data=rng.integers(lo, hi, (n, ch)).astype(dt), pts=t * dur,
                 duration=dur) for t in range(ticks)]


def jpegs(n, w=48, h=32, seed=0):
    """Seeded frames through the port's JPEG encoder (the JAX package's
    bytes, PR 10)."""
    from gstreamer_tpu_torch.codecs.jpeg import jpeg_encode
    rng = np.random.default_rng(seed)
    return [bytes(jpeg_encode(
        (rng.integers(0, 256, (h, w), np.uint8),
         rng.integers(0, 256, (h // 2, w // 2), np.uint8),
         rng.integers(0, 256, (h // 2, w // 2), np.uint8)), w, h,
        device="cpu")) for _ in range(n)]


def jpeg_pushes(blobs, fps=10):
    dur = 1_000_000_000 // fps
    return [dict(data=np.frombuffer(b, np.uint8).copy(), pts=k * dur,
                 duration=dur) for k, b in enumerate(blobs)]


def aac_units(frames):
    data = file_head(AAC, frames, "adts")
    units, pos = [], 0
    while pos < len(data):
        flen, _s, _c, _p, hlen = taac.parse_adts_header(data, pos)
        units.append(data[pos + hlen:pos + flen])
        pos += flen
    return data, units


@pytest.fixture
def fixed_uuid(monkeypatch):
    """uuid.uuid4 fixed alike for both packages (asfmux's file ID)."""
    rng = np.random.default_rng(22)
    fixed = uuid.UUID(bytes=rng.integers(0, 256, 16, np.uint8).tobytes())
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    return fixed


# -- FLV -------------------------------------------------------------------

@pytest.mark.parametrize("fmt,rate,ch", [("S16LE", 22050, 2),
                                         ("U8", 11025, 1),
                                         ("S16LE", 44100, 1)])
def test_flv_pcm(fmt, rate, ch, tmp_path):
    path = write_both(f"{asrc(fmt, rate, ch)} ! flvmux location={{loc}}",
                      {"a": apushes(fmt, rate, ch, 1024, 3)}, tmp_path, "flv")
    assert path.read_bytes()[:5] == b"FLV\x01\x04"
    pair(f"flvdemux location={path} ! appsink name=out")
    pair(f"flvdemux location={path} stream=audio ! audioconvert ! "
         f"audio/x-raw,format=F32LE ! appsink name=out")


@pytest.mark.parametrize("law", ["mulaw", "alaw"])
def test_flv_g711(law, tmp_path):
    path = write_both(f"{asrc('S16LE', 8000, 1)} ! {law}enc ! flvmux "
                      f"location={{loc}}",
                      {"a": apushes("S16LE", 8000, 1, 800, 3)}, tmp_path,
                      "flv")
    pair(f"flvdemux location={path} ! appsink name=out")
    pair(f"flvdemux location={path} ! {law}dec ! appsink name=out")


def test_flv_aac(tmp_path):
    """AAC access units through flvmux (its AudioSpecificConfig tag);
    flvdemux decodes them to the PCM that faad gives on the ADTS file."""
    data, units = aac_units(60)
    push = [dict(data=[np.frombuffer(u, np.uint8).copy()
                       for u in units[k:k + 8]],
                 batch=len(units[k:k + 8]), pts=k * 21_333_333,
                 duration=21_333_333) for k in range(0, len(units), 8)]
    path = write_both("appsrc name=a caps=audio/mpeg,mpegversion=4,"
                      "stream-format=raw,rate=48000,channels=2 ! flvmux "
                      "location={loc}", {"a": push}, tmp_path, "flv")
    pair(f"flvdemux location={path} ! appsink name=out")
    (tmp_path / "plain.aac").write_bytes(data)
    np.testing.assert_array_equal(
        pcm_rows(f"flvdemux location={path}"),
        pcm_rows(f"filesrc location={tmp_path / 'plain.aac'} ! aacparse ! "
                 f"faad"))


def test_flv_h264(tmp_path):
    """H.264 access units: the avcC and onMetaData tags and the
    length-prefixed samples; flvdemux gives the Annex-B units and caps."""
    push = [dict(data=np.frombuffer(a, np.uint8).copy(), pts=k * 33_333_333,
                 duration=33_333_333) for k, a in enumerate(h264_aus(5))]
    path = write_both("appsrc name=v caps=video/x-h264,stream-format="
                      "byte-stream,alignment=au,width=640,height=480,"
                      "framerate=30/1 ! flvmux location={loc}", {"v": push},
                      tmp_path, "flv")
    assert b"onMetaData" in path.read_bytes()
    pair(f"flvdemux location={path} stream=video ! appsink name=out")
    pair(f"flvdemux location={path} stream=video ! h264parse ! "
         f"appsink name=out")


@pytest.mark.skipif(not native_av.available(),
                    reason="libavcodec shim unavailable")
def test_flvdemux_on_a_libx264_file(tmp_path):
    """A real x264 stream (the JAX package's libavcodec shim) in FLV."""
    from test_videoparsers2 import _enc_stream
    blob = _enc_stream("libx264", n=6, opts="preset=ultrafast")
    path = write_both("appsrc name=v ! application/octet-stream ! h264parse "
                      "! flvmux location={loc}", {"v": blob_push(blob)},
                      tmp_path, "flv")
    pair(f"flvdemux location={path} stream=video ! appsink name=out")


def test_uridecodebin_flv(tmp_path):
    path = write_both(f"{asrc('S16LE', 22050, 2)} ! flvmux location={{loc}}",
                      {"a": apushes("S16LE", 22050, 2, 1024, 2)}, tmp_path,
                      "flv")
    pair(f"uridecodebin uri=file://{path} ! appsink name=out")


# -- ASF -------------------------------------------------------------------

@pytest.mark.parametrize("rate,ch", [(16000, 2), (8000, 1)])
def test_asf_audio(rate, ch, tmp_path, fixed_uuid):
    path = write_both(f"{asrc('S16LE', rate, ch)} ! asfmux location={{loc}}",
                      {"a": apushes("S16LE", rate, ch, 500, 3)}, tmp_path,
                      "asf")
    blob = path.read_bytes()
    assert blob[:16] == tasf.GUID_HEADER and tasf.GUID_DATA in blob
    assert fixed_uuid.bytes in blob
    for f in ("asfparse", "asfdemux"):
        _, _, _, out = pair(f"{f} location={path} stream=audio ! "
                            f"appsink name=out")
    got = np.concatenate([s.buffer.data.numpy() for s in out["out"]])
    np.testing.assert_array_equal(
        got, np.concatenate([p["data"] for p in
                             apushes("S16LE", rate, ch, 500, 3)]))


def _asf_av(tmp_path, blobs):
    return write_both(f"asfmux name=m location={{loc}} "
                      f"appsrc name=v caps=image/jpeg,width=48,height=32,"
                      f"framerate=10/1 ! m.video_0 "
                      f"{asrc('S16LE', 8000, 1)} ! m.audio_0",
                      {"v": jpeg_pushes(blobs),
                       "a": apushes("S16LE", 8000, 1, 800, len(blobs))},
                      tmp_path, "asf")


def test_asf_av(tmp_path, fixed_uuid):
    """MJPEG video and PCM audio: the same file; each stream read by its
    own demuxer instance, decoded and scaled alike; the video's RGB equals
    multifilesrc's of the same JPEGs."""
    blobs = jpegs(5)
    path = _asf_av(tmp_path, blobs)
    for f in ("asfparse", "asfdemux"):
        pair(f"{f} location={path} stream=video ! appsink name=out")
        pair(f"{f} location={path} stream=audio ! appsink name=out")
        _, _, _, out = pair(f"{f} location={path} stream=video ! jpegdec ! "
                            f"videoconvertscale ! video/x-raw,format=RGB,"
                            f"width=24,height=16 ! appsink name=out", batch=2)
    for k, b in enumerate(blobs):
        (tmp_path / f"f_{k}.jpg").write_bytes(b)
    _, _, _, ref = pair(f"multifilesrc location={tmp_path}/f_%d.jpg "
                        f"caps=image/jpeg,framerate=10/1 ! jpegdec ! "
                        f"videoconvertscale ! video/x-raw,format=RGB,"
                        f"width=24,height=16 ! appsink name=out")
    assert [f.tobytes() for s in out["out"] for f in s.buffer.data[0].numpy()] \
        == [f.tobytes() for s in ref["out"] for f in s.buffer.data[0].numpy()]


def test_asf_file_id_is_random(tmp_path):
    """Without a fixed uuid4 the files differ only in the 16-byte file ID
    (twice: the File Properties and Data objects), and demux alike."""
    blobs = jpegs(3)
    paths = []
    for parse, buf, kw, tag in ((jparse_launch, JBuffer, {}, "j"),
                                (tparse_launch, Buffer, {"device": "cpu"},
                                 "t")):
        p = tmp_path / f"{tag}.asf"
        _run(parse, buf, f"asfmux name=m location={p} appsrc name=v "
             f"caps=image/jpeg,width=48,height=32,framerate=10/1 ! m.video_0",
             {"v": jpeg_pushes(blobs)}, (), 1, None, **kw)
        paths.append(p)
    a, b = (p.read_bytes() for p in paths)
    assert len(a) == len(b)
    diff = [i for i in range(len(a)) if a[i] != b[i]]
    assert 0 < len(diff) <= 32
    ids = {a[i] for i in diff}
    assert ids and tasf._parse_asf(str(paths[1]))[0] == \
        jasf._parse_asf(str(paths[1]))[0]
    pair(f"asfdemux location={paths[0]} stream=video ! appsink name=out")


def test_asf_caps_from_sof_and_garbage(tmp_path, fixed_uuid):
    blobs = jpegs(1, 96, 64)
    path = write_both("appsrc name=v caps=image/jpeg,framerate=5/1 ! "
                      "asfmux location={loc}", {"v": jpeg_pushes(blobs, 5)},
                      tmp_path, "asf")
    _, _, _, out = pair(f"asfparse location={path} ! appsink name=out")
    assert out["out"][0].caps[0]["width"] == 96
    bad = tmp_path / "bad.asf"
    bad.write_bytes(b"\x00" * 128)
    for parse, kw in ((jparse_launch, {}), (tparse_launch,
                                            {"device": "cpu"})):
        with pytest.raises(Exception) as ei:
            parse(f"asfparse location={bad} stream=audio ! fakesink",
                  **kw).run()
        assert ei.type.__name__ in ("NegotiationError", "ValueError")


@pytest.mark.skipif(not native_av.available(),
                    reason="libavformat unavailable")
def test_asfdemux_on_a_libavformat_file(tmp_path):
    """A WMA / WMV file written by libavformat (the JAX package's shim):
    the same coded packets, caps and codec data in both."""
    path = str(tmp_path / "real.asf")
    if not native_av.write_asf(path, 160, 120, 25, True):
        pytest.skip("cannot write reference ASF")
    assert tasf._parse_asf(path)[0] == jasf._parse_asf(path)[0]
    for stream in ("video", "audio"):
        pair(f"asfdemux location={path} stream={stream} ! appsink name=out")


# -- jpegparse / jifmux ----------------------------------------------------

def test_walk_markers_and_sof():
    for blob in jpegs(2, 64, 48, 3):
        t, j = tjf.walk_markers(blob), jjf.walk_markers(blob)
        assert t == j and t[2]
        sof = [p for m, _, p in t[0] if m == 0xC0][0]
        assert tjf.parse_sof(sof) == jjf.parse_sof(sof)


@pytest.mark.parametrize("copies,chunks", [(1, 1), (3, 1), (3, 4)])
def test_jpegparse(copies, chunks):
    blob = b"".join(jpegs(copies, 48, 32, 4))
    cuts = np.linspace(0, len(blob), chunks + 1).astype(int)
    push = [dict(data=np.frombuffer(blob[a:b], np.uint8).copy(),
                 pts=0 if k == 0 else None)
            for k, (a, b) in enumerate(zip(cuts, cuts[1:]))]
    _, _, _, out = pair("appsrc name=in ! image/jpeg ! jpegparse ! "
                        "appsink name=out", {"in": push})
    assert out["out"][0].caps[0]["parsed"] is True


@pytest.mark.parametrize("tags", ["", "comment=hello-goom,artist=me",
                                  "description=d,copyright=c,artist=a"])
def test_jifmux(tags, tmp_path):
    """jifmux with and without tags (EXIF APP1, COM, XMP): the same JPEG,
    and it still decodes alike."""
    blob = jpegs(1, 64, 48, 5)[0]
    inject = f"taginject tags={tags} ! " if tags else ""
    _, _, _, out = pair(f"appsrc name=in ! image/jpeg ! {inject}jifmux ! "
                        f"appsink name=out", {"in": blob_push(blob)})
    raw = np.asarray(out["out"][0].buffer.data).tobytes()
    assert raw[:2] == b"\xff\xd8" and raw[-2:] == b"\xff\xd9"
    (tmp_path / "m_0.jpg").write_bytes(raw)
    pair(f"multifilesrc location={tmp_path}/m_%d.jpg ! jpegdec ! "
         f"appsink name=out")
    pair(f"appsrc name=in ! image/jpeg ! jpegparse ! {inject}jifmux ! "
         f"appsink name=out", {"in": blob_push(blob)})


@pytest.mark.parametrize("tags", [{}, {"artist": "someone", "description":
                                       "d"}, {"comment": "x" * 300}])
def test_exif_xmp_writers(tags):
    assert tjf.build_exif_app1(tags) == jjf.build_exif_app1(tags)
    assert tjf.build_xmp_app1(tags) == jjf.build_xmp_app1(tags)
