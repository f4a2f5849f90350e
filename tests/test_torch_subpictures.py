"""The port's subtitle overlays and subpicture codecs against the JAX
package, bit for bit: assrender (the ASS parser, the rasteriser, the
placement and the blend), dvbsub (the 4-bit code strings, display sets,
dvbsubenc, dvbsuboverlay) and dvd (dvdlpcmdec, dvdsubdec, dvdspu,
dvdsubparse).

Launch strings and direct calls go through both packages on the same
seeded inputs (the port with ``device="cpu"``); samples, metas, negotiated
caps and bus messages equal, tolerance 0.  The subtitle and subpicture
bytes stay host arrays (their appsrc is not staged); the overlays leave the
video tensors they were given as they were.
"""

import struct

import numpy as np
import pytest
import torch

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.caps import Caps as JCaps
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import assrender as jass
from gstreamer_tpu.elements import dvbsub as jdvb
from gstreamer_tpu.elements import dvd as jdvd

from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.elements import assrender as tass
from gstreamer_tpu_torch.elements import dvbsub as tdvb
from gstreamer_tpu_torch.elements import dvd as tdvd

from test_torch_analytics import same_spec
from test_torch_captions import (CPU, DUR, host_element, i420, pair, plain,
                                 video_pushes, vsrc)

FACTORIES = ("assrender", "dvbsubenc", "dvbsuboverlay", "dvdlpcmdec",
             "dvdsubdec", "dvdspu", "dvdsubparse")


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


# -- assrender ---------------------------------------------------------------

HEADER = """[Script Info]
PlayResX: 640
PlayResY: 480

[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, Bold, Italic, Underline, Alignment, MarginL, MarginR, MarginV
Style: Default,DejaVu Sans,24,&H00FFFFFF,0,0,0,2,10,10,20
Style: Red,DejaVu Sans,30,&H000000FF,1,0,0,8,10,10,12
Style: Odd,DejaVu Sans,x,&Hzz,1,1,1,q,a,b,c
"""

LINES = [
    r"Dialogue: 0,0:00:01.00,0:00:03.00,Default,,0,0,0,,plain {\b1}bold"
    r"{\b0} {\i1}it{\i0} {\u1}under{\u0} {\c&H0000FF&}red{\c&HFFFFFF&} end",
    r"Dialogue: 0,0:00:00.00,0:00:01.00,Default,,0,0,0,,{\an7}{\pos(100,50)}"
    r"top",
    r"Dialogue: 0,0:00:00.00,0:00:01.00,Red,,5,6,7,,line one\Nline two\n3",
    r"Dialogue: 0,0:00:00.50,0:00:01.00,Odd,,0,0,0,,{\a6}{\1c&H00FF00&}"
    r"{\pos(bad)}legacy",
    r"Dialogue: 0,0:00:00.00,0:00:01.00,Missing,,0,0,0,,{\fs40\blur3}x",
    r"Dialogue: 0,bad,0:00:01.00,Default,,0,0,0,,never",
    r"Dialogue: 0,0:00:00.00,0:00:01.00,Default,,0,0,0",
]


def test_ass_styles():
    assert plain({k: vars(v) for k, v in tass.parse_ass_styles(
        HEADER).items()}) == plain({k: vars(v) for k, v in
                                    jass.parse_ass_styles(HEADER).items()})


def _event(mod, line):
    ev = mod.parse_dialogue(line, mod.parse_ass_styles(HEADER))
    if ev is None:
        return None
    d = dict(vars(ev))
    d["text_runs"] = [[vars(r) for r in runs] for runs in ev.text_runs]
    return plain(d)


@pytest.mark.parametrize("line", LINES)
def test_ass_dialogue(line):
    assert _event(tass, line) == _event(jass, line)


@pytest.mark.parametrize("line", LINES[:5])
def test_ass_render_event(line):
    """The rasterised ARGB bitmap of an event (bold face, synthetic
    oblique, underline, colours, line breaks) and its placement at every
    numpad alignment."""
    styles_t, styles_j = (m.parse_ass_styles(HEADER) for m in (tass, jass))
    ev_t = tass.parse_dialogue(line, styles_t)
    ev_j = jass.parse_dialogue(line, styles_j)
    bt, bj = tass.render_event(ev_t, styles_t), jass.render_event(ev_j,
                                                                  styles_j)
    assert bt.dtype == bj.dtype and np.array_equal(bt, bj)
    for an in range(1, 10):
        ev_t.alignment = ev_j.alignment = an
        for size in ((40, 20, 640, 480), (700, 500, 640, 480)):
            assert tass.place(ev_t, *size) == jass.place(ev_j, *size)


@pytest.mark.parametrize("x0,y0", [(0, 0), (7, 3), (50, 30), (60, 40)])
def test_ass_blend(x0, y0):
    """blend_argb_i420 on seeded planes and a seeded bitmap, clipped at
    the frame's edges."""
    rng = np.random.default_rng(x0 + y0)
    bmp = rng.integers(0, 256, (21, 33, 4), dtype=np.uint8)
    got = [np.array(p) for p in i420(64, 48, 2, 1)]
    want = [np.array(p) for p in got]
    tass.blend_argb_i420(got, 1, bmp, x0, y0)
    jass.blend_argb_i420(want, 1, bmp, x0, y0)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


DOC = HEADER + """
[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:02.00,Default,,0,0,0,,Hello styled world
Dialogue: 0,0:00:00.00,0:00:02.00,Red,,0,0,0,,{\\pos(40,30)}TOP RED
"""


def overlay_desc(element, w, h, caps="application/x-ass"):
    return (f"{element} name=ov ! appsink name=out {vsrc(w, h, 'v')} ! "
            f"ov.video appsrc name=t caps={caps} ! ov.text")


@pytest.mark.parametrize("element", ["assrender", "assrender enable=false"])
@pytest.mark.parametrize("batch", [1, 3])
def test_assrender(element, batch):
    """A document with styles and two events over each tick (the second
    tick's text carries only events; the third tick has none)."""
    docs = [DOC, "Dialogue: 0,0:00:00.00,0:00:01.00,Default,,0,0,0,,"
            "{\\an5}{\\i1}mid{\\i0}", "[Events]\n"]
    text = [dict(data=np.frombuffer(d.encode(), np.uint8), pts=k * DUR)
            for k, d in enumerate(docs)]
    _, _, tpipe, out = pair(overlay_desc(element, 160, 120),
                            {"v": video_pushes(160, 120, batch, 3),
                             "t": text}, batch=batch)
    assert tpipe.get_by_name("t") in tpipe._host_fed
    assert tpipe.get_by_name("v") not in tpipe._host_fed


def test_assrender_leaves_its_input():
    """The blend happens on a host copy: the caller's planes keep their
    bytes; a tick without events passes the very tensors."""
    host = i420(96, 64, 2, 3)
    planes = tuple(torch.from_numpy(p.copy()) for p in host)
    e = host_element("assrender")
    text = Buffer(data=np.frombuffer(DOC.encode(), np.uint8))
    out = e.host_aggregate({"video": Buffer(data=planes, batch=2),
                            "text": text})
    assert all(np.array_equal(p.numpy(), h) for p, h in zip(planes, host))
    assert not np.array_equal(out.data[0].numpy(), host[0])
    assert all(o.device == CPU for o in out.data)
    quiet = Buffer(data=np.frombuffer(b"[Events]\n", np.uint8))
    same = e.host_aggregate({"video": Buffer(data=planes, batch=2),
                             "text": quiet})
    assert same.data is planes


# -- dvbsub -------------------------------------------------------------------

ROWS = [np.zeros(64, np.uint8), np.full(64, 5, np.uint8),
        np.array([0, 0, 1, 1, 1, 1, 2] * 9 + [3], np.uint8),
        np.array([0] * 3 + [4] * 8 + [0] * 2 + [6] * 30 + [7] * 300
                 + [0], np.uint8),
        np.array([7], np.uint8)]


@pytest.mark.parametrize("k", range(len(ROWS) + 1))
def test_dvb_code_strings(k):
    row = ROWS[k] if k < len(ROWS) else np.random.default_rng(0).integers(
        0, 16, 301).astype(np.uint8)
    blob = tdvb._encode_4bit_row(row)
    assert blob == jdvb._encode_4bit_row(row)
    got, used = tdvb.decode_4bit_string(blob, len(row))
    want, wused = jdvb.decode_4bit_string(blob, len(row))
    assert used == wused and np.array_equal(got, want)


@pytest.mark.parametrize("h,w", [(20, 48), (7, 5), (1, 300)])
def test_dvb_display_sets(h, w):
    rng = np.random.default_rng(h * w)
    idx = rng.integers(0, 4, (h, w)).astype(np.uint8)
    palette = [(0, 16, 128, 128), (255, 235, 128, 128),
               (255, 16, 128, 128), (200, 145, 54, 34)]
    blob = tdvb.encode_display_set(idx, palette, x=100, y=50, page_id=3)
    assert blob == jdvb.encode_display_set(idx, palette, x=100, y=50,
                                           page_id=3)
    assert plain(tdvb.decode_display_set(blob)) == \
        plain(jdvb.decode_display_set(blob))
    assert tdvb.decode_display_set(blob[:12]) is None


def ayuv_sub(h, w, colours, seed):
    """A seeded AYUV subpicture as (4, h, w): transparent background, a few
    opaque rectangles of `colours` distinct colours."""
    rng = np.random.default_rng(seed)
    img = np.zeros((4, h, w), np.uint8)
    img[1], img[2:] = 16, 128
    for c in range(colours):
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 8)
        img[:, y0:y0 + 4, x0:x0 + 8] = np.array(
            [255, 30 + 7 * c, 60 + 5 * c, 200 - 3 * c], np.uint8)[:, None,
                                                                  None]
    return img


@pytest.mark.parametrize("colours", [1, 5, 20])
def test_dvbsubenc_direct(colours):
    """The reference's direct call: a (1, 4, h, w) AYUV array; more than
    15 colours take the nearest palette entry."""
    img = ayuv_sub(24, 64, colours, colours)
    j = jmake("dvbsubenc", x=8, y=4).host_process(JBuffer(data=img[None],
                                                          batch=1))
    t = host_element("dvbsubenc", x=8, y=4).host_process(Buffer(
        data=torch.from_numpy(img[None]), batch=1))
    assert plain(t.data) == plain(j.data)
    assert isinstance(t.data, np.ndarray)


def test_dvbsubenc_takes_the_pipelines_planes():
    """A reference fault (ROADMAP.md section 3): in a pipeline an AYUV
    buffer is four component planes of (batch, h, w); the reference reads
    them as one array of four frames and fails at batch 1.  The port
    encodes the first frame of the planes, as the direct call does."""
    img = ayuv_sub(24, 64, 3, 1)
    desc = ("appsrc name=in caps=video/x-raw,format=AYUV,width=64,height=24,"
            "framerate=30/1 ! dvbsubenc x=8 y=4 ! appsink name=out")
    planes = tuple(p[None] for p in img)
    with pytest.raises(IndexError):
        p = jparse_launch(desc, batch=1)
        p.get_by_name("in").push_buffer(JBuffer(data=planes, batch=1))
        p.get_by_name("in").end_of_stream()
        p.run()
    import gstreamer_tpu_torch
    t = gstreamer_tpu_torch.parse_launch(desc, batch=1, device="cpu")
    t.get_by_name("in").push_buffer(Buffer(data=planes, batch=1))
    t.get_by_name("in").end_of_stream()
    t.run()
    got = t.get_by_name("out").pull_sample().buffer.data
    want = jmake("dvbsubenc", x=8, y=4).host_process(
        JBuffer(data=img[None], batch=1)).data
    assert got.tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("pos", [(8, 4), (150, 100), (0, 0)])
@pytest.mark.parametrize("batch", [1, 2])
def test_dvbsuboverlay(pos, batch):
    """dvbsuboverlay over each tick: display sets made by the JAX encoder
    at positions inside and clipped by the frame; a tick whose text is no
    display set passes the video."""
    img = ayuv_sub(24, 64, 4, 2)
    blob = jmake("dvbsubenc", x=pos[0], y=pos[1]).host_process(
        JBuffer(data=img[None], batch=1)).data
    text = [dict(data=np.asarray(blob), pts=0),
            dict(data=np.frombuffer(b"\x00" * 8, np.uint8), pts=DUR)]
    _, _, tpipe, _ = pair(overlay_desc("dvbsuboverlay", 192, 128,
                                       "subpicture/x-dvb"),
                          {"v": video_pushes(192, 128, batch, 2),
                           "t": text}, batch=batch)
    assert tpipe.get_by_name("t") in tpipe._host_fed


def test_dvbsuboverlay_leaves_its_input():
    host = i420(96, 64, 2, 3)
    planes = tuple(torch.from_numpy(p.copy()) for p in host)
    blob = jmake("dvbsubenc", x=8, y=4).host_process(
        JBuffer(data=ayuv_sub(24, 64, 2, 3)[None], batch=1)).data
    e = host_element("dvbsuboverlay")
    out = e.host_aggregate({"video": Buffer(data=planes, batch=2),
                            "text": Buffer(data=np.asarray(blob))})
    assert all(np.array_equal(p.numpy(), h) for p, h in zip(planes, host))
    assert not np.array_equal(out.data[0].numpy(), host[0])
    assert e.host_aggregate({"video": Buffer(data=planes, batch=2)}
                            ).data is planes


# -- dvd ----------------------------------------------------------------------

def lpcm(width, rate_code, ch, frames, seed):
    rng = np.random.default_rng(seed)
    quant = {16: 0, 20: 1, 24: 2}[width]
    hdr = bytes([1, 0, 4, (quant << 6) | (rate_code << 4) | (ch - 1), 0x80])
    if width == 16:
        body = rng.integers(-32768, 32768, (frames, ch)).astype(
            ">i2").tobytes()
    else:
        body = rng.integers(0, 256, (frames // 2) * 6 * ch,
                            dtype=np.uint8).tobytes()
    return hdr + body


@pytest.mark.parametrize("width,rate,ch", [(16, 0, 2), (16, 1, 1),
                                           (24, 0, 2), (24, 3, 1),
                                           (20, 2, 2)])
def test_dvdlpcmdec(width, rate, ch):
    """private1 LPCM at 16 and 24 bits (20 raises in both), the stream
    parameters from the header; the samples on the pipeline's device."""
    blob = np.frombuffer(lpcm(width, rate, ch, 40, width + ch), np.uint8)
    j, t = jmake("dvdlpcmdec"), host_element("dvdlpcmdec")
    j.set_info(JCaps.from_string("audio/x-private1-lpcm"), None)
    t.set_info(Caps.from_string("audio/x-private1-lpcm"), None)
    if width == 20:
        with pytest.raises(ValueError):
            j.host_process(JBuffer(data=blob, batch=1))
        with pytest.raises(ValueError):
            t.host_process(Buffer(data=blob, batch=1))
        return
    jo = j.host_process(JBuffer(data=blob, batch=1))
    to = t.host_process(Buffer(data=blob, batch=1))
    assert isinstance(to.data, torch.Tensor) and to.data.device == CPU
    assert plain(to.data) == plain(jo.data)
    assert (t._rate, t._channels, t._width) == (j._rate, j._channels,
                                                 j._width)


def test_dvdlpcmdec_launch():
    """audio/x-lpcm from caps and private1 from the header, through a
    launch string: the source's bytes unstaged."""
    desc = ("appsrc name=in caps=audio/x-private1-lpcm ! dvdlpcmdec ! "
            "appsink name=out")
    bufs = [dict(data=np.frombuffer(lpcm(16, 0, 2, 30, k), np.uint8),
                 pts=k * 10 ** 7) for k in range(3)]
    _, _, tpipe, _ = pair(desc, {"in": bufs})
    assert tpipe.get_by_name("in") in tpipe._host_fed


def make_spu(w=8, h=4, color=1, alpha=15, sx=16, sy=20, display=True,
             rle=None):
    """A minimal SPU packet: a solid colour rectangle (or `rle` lines)."""
    line = bytes([0x00, color & 0x3])
    top = b"".join([line] * ((h + 1) // 2)) if rle is None else rle[0]
    bot = b"".join([line] * (h // 2)) if rle is None else rle[1]
    pxd = top + bot
    top_off, bot_off = 4, 4 + len(top)
    ctrl_off = 4 + len(pxd)
    ctrl = struct.pack(">HH", 0, ctrl_off)
    ctrl += bytes([0x01 if display else 0x02])
    ctrl += bytes([0x03, 0x32, 0x10])
    a = alpha & 0xF
    ctrl += bytes([0x04, (a << 4) | 7, (3 << 4) | a])
    ex, ey = sx + w - 1, sy + h - 1
    ctrl += bytes([0x05, sx >> 4, ((sx & 0xF) << 4) | (ex >> 8), ex & 0xFF,
                   sy >> 4, ((sy & 0xF) << 4) | (ey >> 8), ey & 0xFF])
    ctrl += bytes([0x06]) + struct.pack(">HH", top_off, bot_off)
    ctrl += bytes([0xFF])
    body = pxd + ctrl
    return struct.pack(">HH", 4 + len(body), ctrl_off) + body


def rle_lines(w, n, seed):
    """n RLE lines of runs of every code length (4, 8, 12 and 16 bits)."""
    rng = np.random.default_rng(seed)
    out = b""
    for _ in range(n):
        nibbles, x = [], 0
        while x < w:
            run = int(rng.choice([1, 3, 5, 17, 70]))
            c = int(rng.integers(0, 4))
            v = (run << 2) | c
            if run < 4:
                nibbles += [v]
            elif run < 16:
                nibbles += [v >> 4, v & 0xF]
            elif run < 64:
                nibbles += [0, v >> 4, v & 0xF]
            else:
                nibbles += [0, v >> 8, (v >> 4) & 0xF, v & 0xF]
            x += run
        if len(nibbles) % 2:
            nibbles.append(0)
        out += bytes((a << 4) | b for a, b in zip(nibbles[::2],
                                                   nibbles[1::2]))
    return out


SPUS = [make_spu(), make_spu(w=33, h=7, color=2, alpha=9, sx=3, sy=1),
        make_spu(display=False), make_spu(w=1, h=1),
        make_spu(w=90, h=6, rle=(rle_lines(90, 3, 0), rle_lines(90, 3, 1))),
        b"\x00\x02", make_spu()[:-3]]


@pytest.mark.parametrize("k", range(len(SPUS)))
def test_decode_spu(k):
    try:
        want = jdvd.decode_spu(SPUS[k])
    except Exception as e:          # a truncated packet fails alike
        with pytest.raises(type(e)):
            tdvd.decode_spu(SPUS[k])
        return
    assert plain(tdvd.decode_spu(SPUS[k])) == plain(want)


@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_dvdsubdec(k):
    j, t = jmake("dvdsubdec"), host_element("dvdsubdec")
    blob = np.frombuffer(SPUS[k], np.uint8)
    jo = j.host_process(JBuffer(data=blob, batch=1))
    to = t.host_process(Buffer(data=blob, batch=1))
    assert (to is None) == (jo is None)
    if jo is not None:
        assert to.data.device == CPU and plain(to.data) == plain(jo.data)
        assert t.last_region == j.last_region


@pytest.mark.parametrize("props", ["x=4 y=2", "", "x=150 y=100"])
def test_dvdspu_direct(props):
    """dvdspu over a batch: placed, centred and bottom (the defaults), and
    clipped by the frame's edges; without a subpicture the video passes."""
    kw = dict(p.split("=") for p in props.split())
    kw = {a: int(b) for a, b in kw.items()}
    img = jdvd.decode_spu(SPUS[1])["image"]
    sub = np.transpose(img, (2, 0, 1))[None]
    host = i420(160, 120, 2, 4)
    j = jmake("dvdspu", **kw).host_aggregate({
        "video": JBuffer(data=host, batch=2),
        "subpicture": JBuffer(data=sub, batch=1)})
    planes = tuple(torch.from_numpy(p.copy()) for p in host)
    e = host_element("dvdspu", **kw)
    t = e.host_aggregate({"video": Buffer(data=planes, batch=2),
                          "subpicture": Buffer(data=torch.from_numpy(sub),
                                               batch=1)})
    assert plain(t.data) == plain(j.data)
    assert all(np.array_equal(p.numpy(), h) for p, h in zip(planes, host))
    assert e.host_aggregate({"video": Buffer(data=planes, batch=2)}
                            ).data is planes


@pytest.mark.parametrize("cuts", [(), (3,), (1, 20, 21)])
def test_dvdsubparse(cuts):
    """Fragments (a packet cut at `cuts`, then two packets in one buffer)
    reassembled into whole packets with the first fragment's pts."""
    stream = SPUS[0] + SPUS[1]
    pieces, last = [], 0
    for c in cuts + (len(SPUS[0]), len(stream)):
        pieces.append(stream[last:c])
        last = c
    bufs = [dict(data=np.frombuffer(p, np.uint8), pts=k * DUR)
            for k, p in enumerate(pieces) if p]
    desc = ("appsrc name=in caps=subpicture/x-dvd ! dvdsubparse ! "
            "appsink name=out")
    _, _, tpipe, out = pair(desc, {"in": bufs})
    assert tpipe.get_by_name("in") in tpipe._host_fed
