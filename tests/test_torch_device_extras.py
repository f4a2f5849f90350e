"""The last element functions that run on the device, with their modules'
host elements, against the JAX package, bit for bit.

smooth (int64 masked shifted adds), audiomixmatrix (a float64 product in
input-channel order, then rint and a clip) and audiochannelmix (float32
``a*x + b*y`` with XLA's fused product, ``bad_extras._mix``) run on the
pipeline's device; every other factory of ``smooth_speed.py``,
``misc_elements.py``, ``bad_extras.py`` and ``bad_bins.py`` is the JAX
package's host code.  The same launch string and the same seeded buffers
go through both packages (``test_torch_audiofx.both``,
``test_torch_compositor.run_both``); samples, negotiated caps and bus
messages equal, tolerance 0, except where a test states a difference:
audiomixmatrix on F64LE (XLA's dot order on the CPU, ROADMAP.md section 3)
and spanplc in a launch string (the JAX package's NameError there).
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu import analytics as janalytics
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import bad_bins as jbins

import gstreamer_tpu_torch
from gstreamer_tpu_torch import analytics as tanalytics
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps as TCaps
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.elements import bad_bins as tbins
from gstreamer_tpu_torch.elements import bad_extras as textras

from test_torch_analytics import all_metas, same_spec
from test_torch_audiofx import both, desc_of, pushes, samples
from test_torch_compositor import _run, run_both, video_pushes

FACTORIES = (
    "smooth", "speed",
    "autovideosrc", "autoaudiosrc", "videoanalyse", "audiomixmatrix",
    "audiobuffersplit", "videoframe_audiolevel", "spanplc",
    "srtenc", "webvttenc", "audiochannelmix", "checksumsink",
    "videocodectestsink", "chopmydata", "errorignore", "debugspy",
    "fpsdisplaysink", "clockselect", "roundrobin", "videoparse",
    "audioparse", "autovideoflip", "videoframe-audiolevel",
    "insertbin", "testsrcbin", "rtponviftimestamp", "rtponvifparse",
    "facedetectortensordecoder")
DUR = 33333333


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    if factory in ("autovideosrc", "autoaudiosrc"):   # resolve to sources
        from gstreamer_tpu.core.element import get_factory_class as jget
        from gstreamer_tpu_torch.core.element import get_factory_class as tg
        assert tg(factory).DESCRIPTION == jget(factory).DESCRIPTION
        return
    same_spec(factory)


# -- smooth --------------------------------------------------------------------

def smooth_pushes(fmt, w, h, batch, ticks, seed):
    """Frames smooth has work on: a seeded low-frequency luma with noise of
    a few levels (neighbours inside the tolerance) and edges."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        yy, xx = np.mgrid[0:h, 0:w]
        base = 128 + 60 * np.sin(xx / 7.0 + t) * np.cos(yy / 5.0)
        y = np.clip(base[None] + rng.normal(0, 4, (batch, h, w)), 0, 255)
        y[:, :, w // 2:] = np.clip(y[:, :, w // 2:] + 40, 0, 255)
        cw, ch = (w + 1) // 2, (h + 1) // 2
        u = rng.integers(0, 256, (batch, ch, cw), dtype=np.uint8)
        v = rng.integers(0, 256, (batch, ch, cw), dtype=np.uint8)
        out.append(dict(data=(y.astype(np.uint8), u, v), pts=t * batch * DUR,
                        duration=DUR, batch=batch))
    return {"in": out}


@pytest.mark.parametrize("tol,fs", [(8, 3), (3, 1), (20, 2), (8, 0),
                                    (255, 3)])
@pytest.mark.parametrize("fmt,w,h", [("I420", 48, 32), ("YV12", 37, 23)])
def test_smooth(tol, fs, fmt, w, h):
    desc = (f"appsrc name=in caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=30/1 ! smooth tolerance={tol} "
            f"filter-size={fs} ! appsink name=out")
    _, out = run_both(desc, smooth_pushes(fmt, w, h, 2, 2, tol + fs), batch=2)
    assert len(out["out"]) == 2


def test_smooth_inactive_passes_through():
    desc = ("appsrc name=in caps=video/x-raw,format=I420,width=16,"
            "height=8,framerate=30/1 ! smooth active=false ! appsink name=out")
    run_both(desc, smooth_pushes("I420", 16, 8, 1, 1, 0))


def test_smooth_tiny_frames():
    """Frames shorter than the window's reach (rows skipped entirely)."""
    desc = ("appsrc name=in caps=video/x-raw,format=I420,width=6,"
            "height=2,framerate=30/1 ! smooth filter-size=3 ! "
            "appsink name=out")
    run_both(desc, smooth_pushes("I420", 6, 2, 2, 1, 3), batch=2)


# -- speed ---------------------------------------------------------------------

@pytest.mark.parametrize("speed", [0.5, 1.0, 1.5, 2.75])
@pytest.mark.parametrize("fmt,ch", [("S16LE", 1), ("F32LE", 2)])
def test_speed(speed, fmt, ch):
    both(desc_of(fmt, ch, f"speed speed={speed}"), pushes(fmt, ch))


# -- audiomixmatrix --------------------------------------------------------------

def mix_setup(m):
    def fn(pipe):
        pipe.get_by_name("mm").set_property("matrix", m)
    return fn


@pytest.mark.parametrize("fmt", ["S16LE", "S32LE", "F32LE"])
@pytest.mark.parametrize("inc,outc", [(8, 2), (2, 6), (3, 3), (6, 1)])
def test_audiomixmatrix(fmt, inc, outc):
    """Seeded coefficients in [-1, 1]: integer formats after rint and the
    clip, F32LE after the cast, equal to the byte."""
    m = np.random.default_rng(inc * 10 + outc).uniform(-1, 1, (outc, inc))
    desc = desc_of(fmt, inc, f"audiomixmatrix name=mm in-channels={inc} "
                   f"out-channels={outc}")
    both(desc, pushes(fmt, inc, ticks=2, frames=4800), mix_setup(m.tolist()))


@pytest.mark.parametrize("fmt", ["S16LE", "F64LE"])
def test_audiomixmatrix_first_channels(fmt):
    desc = desc_of(fmt, 4, "audiomixmatrix mode=first-channels ! "
                   "audio/x-raw,channels=2")
    both(desc, pushes(fmt, 4, ticks=2))


def test_audiomixmatrix_f64_order():
    """F64LE keeps the float64 product: the port adds the products in
    input-channel order with one rounding each; XLA's CPU dot picks its
    own order and fuses some products by the shape (ROADMAP.md section 3).
    Both lie within the error bound of an 8-term float64 sum,
    8 * 2^-53 * sum(|x_c * m_c|), and they differ in some samples."""
    inc, outc = 8, 2
    m = np.random.default_rng(3).uniform(-1, 1, (outc, inc))
    desc = desc_of("F64LE", inc, f"audiomixmatrix name=mm in-channels={inc} "
                   f"out-channels={outc}")
    ref, out, _ = both(desc, pushes("F64LE", inc, ticks=1, frames=4800),
                       mix_setup(m.tolist()), exact=False)
    a = out[0].buffer.data.numpy()
    b = np.asarray(ref[0].buffer.data)
    x = pushes("F64LE", inc, ticks=1, frames=4800)[0]["data"]
    bound = inc * 2.0 ** -53 * (np.abs(x) @ np.abs(m).T)
    assert (np.abs(a - b) <= bound).all() and (a != b).any()


# -- audiochannelmix ---------------------------------------------------------------

@pytest.mark.parametrize("coefs", [
    (1.0, 0.0, 0.0, 1.0), (0.0, 1.0, 1.0, 0.0), (0.3, 0.7, 0.6, 0.2),
    (-0.37, 1.3, 0.91, -0.11), (0.37, -1.3, 0.91, 0.11),
    (-0.37, -1.3, -0.91, -0.11), (0.5, 0.5, -0.5, 0.5),
    (0.1, -0.2, -0.3, -0.4)])
def test_audiochannelmix(coefs):
    ll, lr, rl, rr = coefs
    both(desc_of("F32LE", 2, f"audiochannelmix left-to-left={ll} "
                 f"left-to-right={lr} right-to-left={rl} "
                 f"right-to-right={rr}"),
         pushes("F32LE", 2, ticks=2, frames=24000))


# -- misc_elements' host elements ----------------------------------------------------

@pytest.mark.parametrize("fmt", ["I420", "GRAY16_LE"])
def test_videoanalyse(fmt):
    both(f"appsrc name=in caps=video/x-raw,format={fmt},width=32,height=24,"
         f"framerate=30/1 ! videoanalyse ! appsink name=out",
         video_pushes({"in": (fmt, 32, 24)}, 3, 2)["in"])


@pytest.mark.parametrize("dur,strict", [(None, False), ("1/100", False),
                                        ("3/70", True)])
def test_audiobuffersplit(dur, strict):
    prop = f" output-buffer-duration={dur}" if dur else ""
    both(desc_of("S16LE", 2, f"audiobuffersplit{prop} "
                 f"strict-buffer-size={strict}"),
         pushes("S16LE", 2, ticks=3, frames=1234))


def test_autosources():
    run_both("autovideosrc num-buffers=3 ! video/x-raw,format=I420,width=32,"
             "height=24 ! appsink name=out", batch=2)
    run_both("autoaudiosrc num-buffers=2 samplesperbuffer=480 ! "
             "audio/x-raw,format=S16LE,rate=48000,channels=2 ! "
             "appsink name=out")


def _bus(pipe, *types):
    return [(m.type, m.src, m.data) for m in iter(pipe.bus.pop, None)
            if m.type in types]


def test_videoframe_audiolevel_aggregator():
    """videoframe_audiolevel: video through, one RMS message a tick."""
    desc = ("videoframe_audiolevel name=v ! appsink name=out "
            "appsrc name=vin caps=video/x-raw,format=I420,width=32,height=24,"
            "framerate=30/1 ! v.video "
            "appsrc name=ain caps=audio/x-raw,format=S16LE,rate=48000,"
            "channels=2,layout=interleaved ! v.audio")
    vid = video_pushes({"vin": ("I420", 32, 24)}, 1, 3)
    aud = {"ain": pushes("S16LE", 2, ticks=3, frames=1600)}
    run_both(desc, {**vid, **aud})
    jpipe, _ = _run(jparse_launch, JBuffer, desc, {**vid, **aud}, ("out",), 1)
    tpipe, _ = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                    {**vid, **aud}, ("out",), 1, device="cpu")
    jm, tm = _bus(jpipe, "element"), _bus(tpipe, "element")
    assert tm == jm and len(tm) == 3


def plc_run(make, B, seed):
    rng = np.random.default_rng(seed)
    plc = make("spanplc")
    plc.start()
    t = np.arange(2048) / 8000
    good = np.clip(np.round(np.sin(2 * np.pi * 400 * t) * 10000
                            + rng.normal(0, 50, 2048)), -32768,
                   32767).astype(np.int16)[:, None]
    wrap = (lambda a: a) if B is JBuffer else torch.from_numpy
    outs = [plc.host_process(B(data=wrap(good), batch=1))]
    for n in (800, 3000):
        outs.append(plc.host_process(B(data=wrap(np.zeros((n, 1), np.int16)),
                                       batch=1, meta={"gap": True})))
    return [np.asarray(o.data) for o in outs]


@pytest.mark.parametrize("seed", range(2))
def test_spanplc_conceals_like_reference(seed):
    for a, b in zip(plc_run(jmake, JBuffer, seed),
                    plc_run(tmake, Buffer, seed)):
        assert np.array_equal(a, b)


def test_spanplc_launch_string_is_a_reference_fault():
    """The JAX package's spanplc.transform_caps names Caps, which its
    module does not import: a launch string raises NameError there.  The
    port's negotiates and passes good audio through."""
    desc = desc_of("S16LE", 1, "spanplc")
    bufs = pushes("S16LE", 1, ticks=2)
    with pytest.raises(NameError, match="Caps"):
        jparse_launch(desc).run()
    tpipe = gstreamer_tpu_torch.parse_launch(desc, device="cpu")
    src = tpipe.get_by_name("in")
    for b in bufs:
        src.push_buffer(Buffer(**dict(b, data=b["data"].copy())))
    src.end_of_stream()
    tpipe.run()
    got = tpipe.get_by_name("out").pull_sample()
    assert np.array_equal(got.buffer.data.numpy(), bufs[0]["data"])


# -- bad_extras -------------------------------------------------------------------

@pytest.mark.parametrize("factory,ext", [("srtenc", "srt"),
                                         ("webvttenc", "vtt")])
def test_subtitle_encoders(factory, ext, tmp_path):
    texts = ["First", "Second line", "Dritte"]
    res = []
    for parse, B, tag in ((jparse_launch, JBuffer, "j"),
                          (gstreamer_tpu_torch.parse_launch, Buffer, "t")):
        path = tmp_path / f"{tag}.{ext}"
        kw = {} if tag == "j" else {"device": "cpu"}
        p = parse(f"appsrc name=in ! text/x-raw ! {factory} "
                  f"location={path} timestamp=5000000 duration=7", **kw)
        for k, t in enumerate(texts):
            p.get_by_name("in").push_buffer(B(
                data=t, pts=k * 61_250_000_000, duration=500_000_000 * k))
        p.get_by_name("in").end_of_stream()
        p.run()
        p.set_state("null")
        res.append(path.read_text())
    assert res[0] == res[1] and "Dritte" in res[1]


def _sink_run(desc, push_fmt=None):
    """(JAX pipeline, port pipeline) of a launch string ending in a named
    sink, fed seeded audio through appsrc 'in' when `push_fmt` is given."""
    pipes = []
    for parse, B, kw in ((jparse_launch, JBuffer, {}),
                         (gstreamer_tpu_torch.parse_launch, Buffer,
                          {"device": "cpu"})):
        p = parse(desc, batch=2, **kw)
        if push_fmt:
            for b in pushes(push_fmt, 2, ticks=3):
                p.get_by_name("in").push_buffer(B(**dict(
                    b, data=b["data"].copy())))
            p.get_by_name("in").end_of_stream()
        p.run()
        pipes.append(p)
    return pipes


@pytest.mark.parametrize("hash_", ["md5", "sha1", "sha256"])
def test_checksumsink(hash_):
    j, t = _sink_run(f"appsrc name=in caps=audio/x-raw,format=S16LE,"
                     f"rate=48000,channels=2,layout=interleaved ! "
                     f"checksumsink name=cs hash={hash_}", "S16LE")
    assert t.get_by_name("cs").checksums == j.get_by_name("cs").checksums
    assert len(t.get_by_name("cs").checksums) == 3


def test_videocodectestsink(tmp_path):
    res = []
    for tag in ("j", "t"):
        p = (jparse_launch if tag == "j" else
             lambda d, **k: gstreamer_tpu_torch.parse_launch(
                 d, device="cpu", **k))(
            f"videotestsrc num-buffers=3 pattern=snow ! video/x-raw,"
            f"format=I420,width=18,height=10 ! videocodectestsink name=v "
            f"location={tmp_path}/{tag}.yuv", batch=2)
        p.run()
        p.set_state("null")
        res.append((p.get_by_name("v").checksums,
                    (tmp_path / f"{tag}.yuv").read_bytes()))
    assert res[0] == res[1]


def test_fpsdisplaysink_and_debugspy():
    j, t = _sink_run("videotestsrc num-buffers=5 ! video/x-raw,format=RGB,"
                     "width=8,height=8 ! debugspy checksum-type=md5 ! "
                     "fpsdisplaysink name=f")
    assert t.get_by_name("f").frames_rendered == \
        j.get_by_name("f").frames_rendered == 5
    assert [d for _, _, d in _bus(t, "element")] == \
        [d for _, _, d in _bus(j, "element")]


@pytest.mark.parametrize("lo,hi,step", [(1, 4096, 1), (10, 100, 1),
                                        (16, 64, 16)])
def test_chopmydata(lo, hi, step):
    both(desc_of("S16LE", 1, f"chopmydata min-size={lo} max-size={hi} "
                 f"step-size={step}"), pushes("S16LE", 1, ticks=3,
                                              frames=999))


@pytest.mark.parametrize("factory", ["errorignore", "clockselect",
                                     "videoframe-audiolevel", "debugspy"])
def test_passthrough_elements(factory):
    both(desc_of("F32LE", 2, factory), pushes("F32LE", 2, ticks=2))


def test_roundrobin():
    desc = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=8000,"
            "channels=1,layout=interleaved ! roundrobin name=rr "
            "rr.src_0 ! appsink name=a rr.src_1 ! appsink name=b")
    _, out = run_both(desc, {"in": pushes("S16LE", 1, ticks=4, rate=8000)},
                      sinks=("a", "b"))
    assert len(out["a"]) == len(out["b"]) == 2


@pytest.mark.parametrize("desc,n", [
    ("videoparse width=8 height=8 format=GRAY8", 128),
    ("audioparse pcm-format=S16LE sample-rate=8000 num-channels=2", 400)])
def test_legacy_parsers(desc, n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    run_both(f"appsrc name=in ! application/octet-stream ! {desc} ! "
             f"appsink name=out", {"in": [dict(data=data, pts=0)]})


@pytest.mark.parametrize("orientation", [None, "rotate-90", "flip-rotate-0"])
def test_autovideoflip(orientation):
    tag = (f"taginject tags=\"image-orientation={orientation}\" ! "
           if orientation else "")
    run_both(f"appsrc name=in caps=video/x-raw,format=I420,width=32,"
             f"height=24,framerate=30/1 ! {tag}autovideoflip ! "
             f"appsink name=out", video_pushes({"in": ("I420", 32, 24)}, 2, 2),
             batch=2)


# -- bad_bins ------------------------------------------------------------------------

@pytest.mark.parametrize("chain", [[], ["volume"], ["volume", "volume"],
                                   ["audioinvert", "volume"]])
def test_insertbin(chain):
    """The chain's functions in order: the same samples from both."""
    caps = ("audio/x-raw, format=F32LE, rate=8000, channels=2, "
            "layout=interleaved")
    x = samples("F32LE", 2, 7, frames=300)
    res = []
    for make, C, B, wrap in ((jmake, JCaps, JBuffer, np.array),
                             (tmake, TCaps, Buffer, torch.from_numpy)):
        ib = make("insertbin")
        for k, f in enumerate(chain):
            ib.append(f)
            if f == "volume":
                ib._chain[-1].props["volume"] = 0.5 + 0.25 * k
        if make is tmake:
            ib.device = torch.device("cpu")
        c = C.from_string(caps)
        ib.set_info(c, c)
        out = ib.host_process(B(data=wrap(x.copy()), pts=0))
        res.append(np.asarray(out.data))
    assert res[0].dtype == res[1].dtype and np.array_equal(res[0], res[1])


def test_insertbin_remove():
    ib = tmake("insertbin")
    ib.append("volume")
    ib.remove(ib._chain[0])
    assert ib._chain == []


@pytest.mark.parametrize("desc", [
    "testsrcbin stream=video num-buffers=3 ! video/x-raw,format=RGB,"
    "width=16,height=16 ! appsink name=out",
    "testsrcbin stream=audio num-buffers=2 ! audio/x-raw,format=S16LE,"
    "rate=8000,channels=1 ! appsink name=out"])
def test_testsrcbin(desc):
    run_both(desc, batch=2)


def test_onvif_extension_helpers():
    for ntp, cseq, c, e, d in [(0x0102030405060708, 9, True, False, True),
                               (2 << 32, 255, False, True, False)]:
        ext = tbins.onvif_extension(ntp, cseq, c, e, d)
        assert ext == jbins.onvif_extension(ntp, cseq, c, e, d)
        assert tbins.parse_onvif_extension(ext) == \
            jbins.parse_onvif_extension(ext)


@pytest.mark.parametrize("offset", [0, 1_000_000_000])
def test_onvif_timestamp_and_parse(offset):
    """rtponviftimestamp ! rtponvifparse on seeded RTP packets: the
    stamped packets, the stripped packets and the recovered NTP time."""
    from gstreamer_tpu.net.rtp import rtp_header
    rng = np.random.default_rng(offset % 7)
    pkts = [rtp_header(0, k, 160 * k, 1) + rng.bytes(40) for k in range(3)]
    res = []
    for make, B in ((jmake, JBuffer), (tmake, Buffer)):
        ts = make("rtponviftimestamp", **{"ntp-offset": offset})
        pr = make("rtponvifparse")
        out = ts.host_process(B(data=list(pkts), pts=2_500_000_000))
        back = pr.host_process(out)
        res.append(([bytes(p) for p in out.data],
                    [bytes(p) for p in back.data], back.meta))
    assert res[0] == res[1] and res[1][1] == pkts


@pytest.mark.parametrize("thr", [0.5, 0.1])
def test_facedetectortensordecoder(thr):
    rng = np.random.default_rng(int(thr * 10))
    boxes = rng.uniform(0, 1, (12, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, 12).astype(np.float32)
    res = []
    for make, lib, B in ((jmake, janalytics, JBuffer),
                         (tmake, tanalytics, Buffer)):
        buf = B(data=np.zeros(4), pts=0, batch=1)
        rm = lib.get_relation_meta(buf, 0, create=True)
        rm.add_tensor_mtd(lib.Tensor(id="boxes", data=boxes))
        rm.add_tensor_mtd(lib.Tensor(id="scores", data=scores))
        out = make("facedetectortensordecoder",
                   **{"score-threshold": thr}).host_process(buf)
        res.append(all_metas(out, lib.relation_meta_of))
    assert res[0] == res[1]


def test_mix_rule_is_xla_s():
    """_mix against the jitted expression on a seeded grid of samples
    for each sign pair (the bits the launch strings above compare)."""
    import jax
    import jax.numpy as jnp
    s = np.random.default_rng(1).uniform(-1, 1, (20000, 2)).astype(
        np.float32)
    t = torch.from_numpy(s)
    for a, b in [(0.3, 0.6), (-0.37, 0.91), (0.37, -0.91), (-0.3, -0.6)]:
        r = np.asarray(jax.jit(lambda x: a * x[:, 0] + b * x[:, 1])(
            jnp.asarray(s)))
        got = textras._mix(a, t[:, 0], b, t[:, 1]).numpy()
        assert np.array_equal(got.view(np.int32), r.view(np.int32))
