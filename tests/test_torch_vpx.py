"""VP8 / VP9 in the port against the JAX package, bit for bit: the codec
module (``codecs/vpx.py``: encode, decode, IVF), ivfparse and vp9parse,
the four elements vp8dec / vp9dec / vp8enc / vp9enc, codecalpha's
elements and alpha WebM, and matroska's V_VP8 / V_VP9 tracks both ways.

Both packages call the same system libvpx, so the same seeded numpy
frames give the same packets, files and planes; every sample's data,
timestamps, caps and the negotiated caps equal (``test_torch_captions.
pair``), tolerance 0.  Frames stay at 64x48.  A test that needs libvpx
skips only where the port's ``vpx.available()`` is False.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.codecs import vpx as jvpx
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.elements import container_elements as jce

from gstreamer_tpu_torch.codecs import vpx as tvpx
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements import container_elements as tce
from gstreamer_tpu_torch.elements.videoparsers import Vp9Parse

from test_torch_captions import host_element, pair, plain
from test_torch_file_formats import write_both

needs_vpx = pytest.mark.skipif(not tvpx.available(),
                               reason="system libvpx missing")
CODECS = ("vp8", "vp9")
W, H = 64, 48


def frames(n=5, w=W, h=H, seed=1):
    """Seeded I420 frames: a noise luma that brightens, flat chroma."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w), np.uint8)
    return [(np.clip(base.astype(int) + i * 3, 0, 255).astype(np.uint8),
             np.full((h // 2, w // 2), 120 + i, np.uint8),
             np.full((h // 2, w // 2), 60, np.uint8)) for i in range(n)]


def pushes(n=6, batch=2, fmt_alpha=False, seed=1):
    fs = frames(n, seed=seed)
    y, u, v = (np.stack([f[c] for f in fs]) for c in range(3))
    planes = (y, u, v)
    if fmt_alpha:
        a = np.zeros_like(y)
        a[:, :, :W // 2] = 255
        planes += (a,)
    return [dict(data=tuple(p[k:k + batch] for p in planes), batch=batch,
                 pts=k * 33_333_333, duration=33_333_333)
            for k in range(0, n, batch)]


def vsrc(fmt="I420"):
    return (f"appsrc name=in caps=video/x-raw,format={fmt},width={W},"
            f"height={H},framerate=30/1")


def same_frames(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert len(fa) == len(fb)
        for pa, pb in zip(fa, fb):
            np.testing.assert_array_equal(pa, pb)


# -- the codec module ------------------------------------------------------

def test_available_and_loader_match():
    """The port's loader finds what the JAX package's finds (the same
    sonames in the same order)."""
    assert tvpx.available() == jvpx.available()


@needs_vpx
@pytest.mark.parametrize("codec", CODECS)
def test_encode_decode_packets(codec):
    fs = frames()
    jp = jvpx.encode_frames(codec, fs, W, H)
    tp = tvpx.encode_frames(codec, fs, W, H)
    assert tp == jp
    assert tp[0][1] and not any(k for _, k in tp[1:])
    pk = [p for p, _ in tp]
    same_frames(tvpx.decode_packets(codec, pk),
                jvpx.decode_packets(codec, pk))


@needs_vpx
@pytest.mark.parametrize("codec", CODECS)
def test_encoder_decoder_objects(codec):
    """VpxEncoder / VpxDecoder frame by frame, with a bitrate and flush."""
    fs = frames(4, seed=2)
    outs = []
    for m in (jvpx, tvpx):
        enc = m.VpxEncoder(codec, W, H, (25, 1), 300)
        pk = [p for f in fs for p in enc.encode(f)] + enc.flush()
        dec = m.VpxDecoder(codec)
        outs.append((pk, [d for p, _ in pk for d in dec.decode(p)]))
    assert outs[0][0] == outs[1][0]
    same_frames(outs[1][1], outs[0][1])


@needs_vpx
@pytest.mark.parametrize("codec", CODECS)
def test_ivf_helpers(codec, tmp_path):
    pk = [p for p, _ in tvpx.encode_frames(codec, frames(3), W, H)]
    assert tvpx.ivf_header(codec, W, H, (30, 1), 3) == \
        jvpx.ivf_header(codec, W, H, (30, 1), 3)
    tvpx.write_ivf(str(tmp_path / "t.ivf"), codec, W, H, (30, 1), pk)
    jvpx.write_ivf(str(tmp_path / "j.ivf"), codec, W, H, (30, 1), pk)
    blob = (tmp_path / "t.ivf").read_bytes()
    assert blob == (tmp_path / "j.ivf").read_bytes()
    assert tvpx.parse_ivf(blob) == jvpx.parse_ivf(blob)


def test_ivf_parse_errors():
    for m in (jvpx, tvpx):
        with pytest.raises(ValueError):
            m.parse_ivf(b"XXXX" + b"\0" * 40)
    hdr = tvpx.ivf_header("vp8", W, H, (30, 1), 0)
    assert tvpx.parse_ivf(hdr) == ("vp8", W, H, (30, 1), [])


def test_without_libvpx_raises(monkeypatch):
    """No library: available() is False and both classes raise the JAX
    package's RuntimeError."""
    monkeypatch.setattr(tvpx, "_lib", None)
    monkeypatch.setattr(tvpx, "_tried", True)
    assert not tvpx.available()
    with pytest.raises(RuntimeError, match="system libvpx not available"):
        tvpx.VpxEncoder("vp8", W, H)
    with pytest.raises(RuntimeError, match="system libvpx not available"):
        tvpx.VpxDecoder("vp8")


# -- the elements and parsers ----------------------------------------------

@needs_vpx
@pytest.mark.parametrize("codec", CODECS)
def test_vpxenc_vpxdec(codec, tmp_path):
    """vp8enc / vp9enc location= write the JAX package's IVF file (their
    packet stream equal too); vp8dec / vp9dec, ivfparse and the
    converter after the decoder give its samples."""
    path = write_both(f"{vsrc()} ! {codec}enc location={{loc}} "
                      f"target-bitrate=300000 ! appsink name=out",
                      {"in": pushes()}, tmp_path, "ivf", batch=2)
    pair(f"{vsrc()} ! {codec}enc ! appsink name=out", {"in": pushes()},
         batch=2)
    pair(f"{codec}dec location={path} ! appsink name=out", batch=2)
    pair(f"{codec}dec location={path} ! videoconvertscale ! "
         f"video/x-raw,format=RGB,width=32,height=24 ! appsink name=out",
         batch=4)
    pair(f"filesrc location={path} ! ivfparse ! appsink name=out")


@needs_vpx
def test_vpxdec_codec_mismatch(tmp_path):
    """vp9dec on a VP8 IVF file: caps ANY in both (the missing-codec
    branch of get_caps), so negotiation fails alike."""
    path = write_both(f"{vsrc()} ! vp8enc location={{loc}} ! fakesink",
                      {"in": pushes(2)}, tmp_path, "ivf", batch=2)
    j = jmake("vp9dec", location=str(path))
    t = host_element("vp9dec", location=str(path))
    assert j.get_caps().is_any and t.get_caps().is_any


@needs_vpx
def test_vp9parse_superframes(tmp_path):
    """vp9parse splits superframes by their index as the JAX package
    does, on a hand-built superframe and on a libvpx stream."""
    f1, f2 = b"\x11" * 10, b"\x22" * 20
    marker = bytes([0xC9])
    idx = marker + (10).to_bytes(2, "little") + (20).to_bytes(2, "little") \
        + marker
    assert Vp9Parse.split_superframe(f1 + f2 + idx) == [f1, f2]
    assert Vp9Parse.split_superframe(f1) == [f1]
    pk = [p for p, _ in tvpx.encode_frames("vp9", frames(6), W, H)]
    blobs = [f1 + f2 + idx] + pk
    push = [dict(data=[np.frombuffer(b, np.uint8).copy() for b in blobs],
                 batch=len(blobs), pts=0, duration=33_333_333)]
    pair("appsrc name=in caps=video/x-vp9 ! vp9parse ! appsink name=out",
         {"in": push})


# -- codecalpha ------------------------------------------------------------

@needs_vpx
@pytest.mark.parametrize("codec", CODECS)
def test_alpha_decode_bin(codec):
    """vpXalphadecodebin: a colour packet with its alpha packet in the
    buffer's meta gives the JAX package's A420 planes (on the element's
    device); without one the alpha is opaque.  codecalphademux moves the
    meta key alike."""
    enc = tvpx.VpxEncoder(codec, W, H, bitrate_kbps=200)
    y, u, v = frames(1)[0]
    pk = [p for p, _ in enc.encode((y, u, v)) + enc.flush()]
    aenc = tvpx.VpxEncoder(codec, W, H, bitrate_kbps=200)
    apk = [p for p, _ in aenc.encode((np.full_like(y, 200), u, v))
           + aenc.flush()]
    for meta in ({"alpha_data": apk[0]}, {"alpha": apk[0]}, {}):
        outs = []
        for make, buf in ((jmake, JBuffer), (host_element, Buffer)):
            e = make(f"{codec}alphadecodebin")
            e.start()
            outs.append(e.host_process(buf(
                data=np.frombuffer(pk[0], np.uint8), meta=dict(meta),
                batch=1)))
        assert all(isinstance(p, torch.Tensor) for p in outs[1].data)
        assert plain(outs[1].data) == plain(tuple(outs[0].data))
        assert outs[1].batch == outs[0].batch == 1
    for make, buf in ((jmake, JBuffer), (host_element, Buffer)):
        d = make("codecalphademux")
        out = d.host_process(buf(data=np.zeros(4, np.uint8),
                                 meta={"alpha_data": b"ab", "x": 1}))
        assert out.meta == {"alpha": b"ab", "x": 1}


@needs_vpx
@pytest.mark.parametrize("codec", CODECS)
def test_alpha_webm(codec, tmp_path):
    """matroskamux video-codec=vpX of A420 writes the JAX package's file
    (the alpha stream in BlockAdditions, MaxBlockAdditionID 1);
    matroskademux gives its A420 planes."""
    path = write_both(f"webmmux name=m location={{loc}} video-codec={codec} "
                      f"! fakesink {vsrc('A420')} ! m.video_0",
                      {"in": pushes(4, 4, fmt_alpha=True)}, tmp_path,
                      "webm", batch=4)
    _, ref, _, out = pair(f"matroskademux location={path} stream=video ! "
                          f"appsink name=out", batch=4)
    s = out["out"][0]
    assert s.caps[0]["format"] == "A420"
    alpha = s.buffer.data[3].numpy()
    assert alpha[..., :W // 2].mean() > 250 and alpha[..., W // 2:].mean() < 5


# -- matroska's V_VP8 / V_VP9 ---------------------------------------------

@needs_vpx
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("batch", [1, 3])
def test_matroska_vpx_track(codec, batch, tmp_path):
    """matroskamux video-codec=vpX encodes at EOS into the JAX package's
    file (V_VP8 / V_VP9, SimpleBlocks); matroskademux and the pad form
    decode it alike, and through the converter."""
    path = write_both(f"matroskamux name=m location={{loc}} "
                      f"video-codec={codec} ! fakesink {vsrc()} ! m.video_0",
                      {"in": pushes(6, 2)}, tmp_path, "mkv", batch=2)
    tracks, _, _ = tce._parse_matroska(str(path))
    assert tracks == jce._parse_matroska(str(path))[0]
    assert tracks[0]["codec"] == {"vp8": "V_VP8", "vp9": "V_VP9"}[codec]
    pair(f"matroskademux location={path} stream=video ! appsink name=out",
         batch=batch)
    pair(f"matroskademux name=d location={path} d.video_0 ! "
         f"appsink name=out", batch=batch)
    pair(f"matroskademux location={path} stream=video ! videoconvertscale "
         f"! video/x-raw,format=RGB,width=32,height=24 ! appsink name=out",
         batch=batch)


@needs_vpx
@pytest.mark.parametrize("codec", CODECS)
def test_matroskamux_vpx_needs_i420(codec, tmp_path):
    """Another input format fails with the JAX package's ValueError."""
    desc = (f"matroskamux name=m location={tmp_path / 'x.mkv'} "
            f"video-codec={codec} ! fakesink {vsrc('YUY2')} ! m.video_0")
    from gstreamer_tpu.core.parse import parse_launch as jparse
    import gstreamer_tpu_torch
    msgs = []
    for parse, kw in ((jparse, {}), (gstreamer_tpu_torch.parse_launch,
                                     {"device": "cpu"})):
        with pytest.raises(ValueError) as ei:
            parse(desc, **kw).compile()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "I420/A420" in msgs[1]


@needs_vpx
def test_uridecodebin_webm(tmp_path):
    """decodebin's matroskademux route on a VP8 WebM file."""
    path = write_both(f"webmmux name=m location={{loc}} video-codec=vp8 ! "
                      f"fakesink {vsrc()} ! m.video_0",
                      {"in": pushes(4, 2)}, tmp_path, "webm", batch=2)
    pair(f"uridecodebin uri=file://{path} ! appsink name=out", batch=2)
