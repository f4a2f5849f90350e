"""The port's analytics path against the JAX package, bit for bit.

``jaxinference ! yolov8tensordec ! ioutracker ! objectdetectionoverlay``
and the other decoders of ``elements/analytics_elements.py``: the same
fixed or seeded model tensors are registered as models in both packages
(a fresh model per run hands out one tick's tensor a call), the same
seeded frames go through both launch strings, and every sample's planes,
every attached Mtd (its fields, its tensor's bytes) and every relation
must be equal, tolerance 0.  The meta library's API, the decoders and the
tracker alone, the overlay's RGB fault (ROADMAP.md section 3) and the
``tools.launch`` CLI in a subprocess close the file.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gstreamer_tpu import analytics as janalytics
from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.element import element_factory_make as jmake
from gstreamer_tpu.core.element import get_factory_class as jget
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements.analytics_elements import \
    register_model as jregister

import gstreamer_tpu_torch
from gstreamer_tpu_torch import analytics as tanalytics
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.element import element_factory_make as tmake
from gstreamer_tpu_torch.core.element import get_factory_class as tget
from gstreamer_tpu_torch.elements.analytics_elements import \
    register_model as tregister
from gstreamer_tpu_torch.interop import negotiated_caps

from test_torch_compositor import _run, assert_same_samples, planes

FACTORIES = ("jaxinference", "yolov8tensordec", "ssdobjectdetector",
             "classifiertensordecoder", "ioutracker", "tensordecodebin",
             "objectdetectionoverlay")
DUR = 33333333
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same_spec(factory):
    """Properties, pad templates, description and HOST_ELEMENT as the
    JAX package's class of the same factory."""
    j, t = jget(factory), tget(factory)

    def props(cls):       # a default by its string (each its own Fraction)
        return {k: (v[0], str(v[1]), v[2]) for k, v in cls.PROPERTIES.items()}
    assert props(t) == props(j)
    assert [(p.name, p.direction, p.presence, str(p.caps))
            for p in t.PAD_TEMPLATES] == \
        [(p.name, p.direction, p.presence, str(p.caps))
         for p in j.PAD_TEMPLATES]
    assert t.DESCRIPTION == j.DESCRIPTION
    assert getattr(t, "HOST_ELEMENT", False) == \
        getattr(j, "HOST_ELEMENT", False)


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


# -- helpers: metas of both packages, launch strings through both ----------

def describe(rm):
    """A RelationMeta (either package's) as plain data: each Mtd's kind and
    fields (a tensor by id, dims, dtype and bytes; a mask by shape, dtype
    and bytes) in order, and the relation matrix."""
    out = []
    for m in rm.iter_mtds():
        d = dict(vars(m))
        if d.get("tensor") is not None:
            t = d.pop("tensor")
            a = t.numpy()
            d["tensor"] = (t.id, tuple(t.dims), a.dtype.str, a.shape,
                           a.tobytes())
        if d.get("mask") is not None:
            a = np.asarray(d.pop("mask"))
            d["mask"] = (a.shape, a.dtype.str, a.tobytes())
        out.append((type(m).__name__, sorted(d.items())))
    return out, dict(rm._rel)


def all_metas(buf, relation_meta_of):
    return {k: describe(rm) for k, rm in relation_meta_of(buf).items()}


def assert_same_metas(out, ref, sinks=("out",)):
    n = 0
    for s in sinks:
        for o, r in zip(out[s], ref[s]):
            tm = all_metas(o.buffer, tanalytics.relation_meta_of)
            jm = all_metas(r.buffer, janalytics.relation_meta_of)
            assert tm == jm
            n += sum(len(v[0]) for v in tm.values())
    return n


def ticking(ticks):
    """A model handing out one tick's tensors a call (a fresh one per
    run: each package gets its own)."""
    it = iter(ticks)
    return lambda frames: next(it)


def run_models(desc, models, pushes=None, batch=1, sinks=("out",)):
    """Register `models` ({name: list of per-tick outputs or a fixed
    output}) in both packages, run `desc` through both; samples, caps and
    metas equal.  Returns (torch pipeline, torch samples, number of Mtds
    compared)."""
    for name, m in models.items():
        for reg in (jregister, tregister):
            reg(name, ticking(m) if isinstance(m, list) else
                (lambda frames, m=m: m))
    jpipe, ref = _run(jparse_launch, JBuffer, desc, pushes or {}, sinks,
                      batch)
    tpipe, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc,
                      pushes or {}, sinks, batch, device="cpu")
    assert_same_samples(out, ref, sinks)
    assert negotiated_caps(tpipe) == negotiated_caps(jpipe)
    return tpipe, out, assert_same_metas(out, ref, sinks)


def frames(fmt, w, h, batch, ticks, seed=0):
    return {"in": [dict(data=planes(fmt, w, h, batch, seed + t),
                        pts=t * batch * DUR, duration=DUR, batch=batch)
                   for t in range(ticks)]}


def src(fmt, w, h):
    return (f"appsrc name=in caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=30/1 ! ")


def yolo_ticks(seed, ticks, batch, ncls=3, n=48, w=64, h=48):
    """Seeded YOLOv8 outputs (batch, 4 + ncls, n) a tick: boxes drifting
    2 px a frame, about a third of them above 0.3 in one class, every
    fourth box a 1-px shifted near-duplicate of the one before (what NMS
    removes), sizes from 4 to 20 px."""
    rng = np.random.default_rng(seed)
    cxy = rng.uniform([0, 0], [w, h], (n, 2)).astype(np.float32)
    wh = rng.uniform(4, 20, (n, 2)).astype(np.float32)
    cxy[3::4] = cxy[2::4][:len(cxy[3::4])] + 1
    wh[3::4] = wh[2::4][:len(wh[3::4])]
    hot = rng.random(n) < 0.35
    hot_cls = rng.integers(0, ncls, n)
    out = []
    for t in range(ticks):
        a = np.empty((batch, 4 + ncls, n), np.float32)
        for k in range(batch):
            f = t * batch + k
            a[k, 0] = cxy[:, 0] + 2 * f
            a[k, 1] = cxy[:, 1] + f
            a[k, 2:4] = wh.T
            sc = rng.uniform(0, 0.3, (ncls, n))
            sc[hot_cls[hot], np.nonzero(hot)[0]] = rng.uniform(
                0.3, 0.99, hot.sum())
            a[k, 4:] = sc
        out.append(a)
    return out


# -- the detection path -------------------------------------------------------

CHAIN = ("jaxinference model={m} ! yolov8tensordec "
         "class-confidence-threshold={thr} iou-threshold={iou} "
         "max-detections={md} ! ioutracker iou-score-threshold=0.3 "
         "min-frame-count-for-lost-track=2 ! {tail}appsink name=out")


@pytest.mark.parametrize("fmt", ["GRAY8", "I420", "NV12", "Y444", "Y42B"])
@pytest.mark.parametrize("batch", [1, 3])
def test_detection_chain(fmt, batch):
    """appsrc ! jaxinference ! yolov8tensordec ! ioutracker !
    objectdetectionoverlay: the seeded per-frame tensors of 3 ticks."""
    ticks = 3
    desc = src(fmt, 64, 48) + CHAIN.format(
        m=f"yolo-{fmt}-{batch}", thr=0.3, iou=0.45, md=100,
        tail="objectdetectionoverlay line-width=2 ! ")
    _, out, n = run_models(desc, {f"yolo-{fmt}-{batch}": yolo_ticks(
        batch, ticks, batch)}, frames(fmt, 64, 48, batch, ticks), batch)
    assert n > 20 * batch


@pytest.mark.parametrize("thr,iou,md", [(0.25, 0.45, 100), (0.5, 0.3, 4),
                                        (0.9, 0.7, 100), (0.3, 0.0, 100)])
def test_detection_thresholds(thr, iou, md):
    desc = src("GRAY8", 64, 48) + CHAIN.format(
        m="yolo-thr", thr=thr, iou=iou, md=md, tail="")
    run_models(desc, {"yolo-thr": yolo_ticks(7, 3, 2)},
               frames("GRAY8", 64, 48, 2, 3), 2)


def _yolo_tensor():
    # tests/test_analytics.py's: two overlapping class-0, one class-1
    t = np.zeros((6, 3), np.float32)
    t[:, 0] = [32, 24, 20, 16, 0.9, 0.1]
    t[:, 1] = [33, 24, 20, 16, 0.85, 0.1]
    t[:, 2] = [10, 10, 8, 8, 0.1, 0.7]
    return t


def test_fixed_model_chain():
    """The JAX package's own chain: one fixed tensor for every frame
    (broadcast to each batch entry), videotestsrc, the overlay."""
    desc = ("videotestsrc num-buffers=4 ! video/x-raw,format=GRAY8,"
            "width=64,height=48 ! jaxinference model=toy-yolo ! "
            "yolov8tensordec class-confidence-threshold=0.5 "
            "iou-threshold=0.5 ! ioutracker ! objectdetectionoverlay ! "
            "appsink name=out")
    _, out, n = run_models(desc, {"toy-yolo": _yolo_tensor()}, batch=2)
    trk = tanalytics.TrackingMtd
    for s in out["out"]:
        for rm in tanalytics.relation_meta_of(s.buffer).values():
            assert {t.track_id for t in rm.iter_mtds(trk)} == {1, 2}


def test_classifier_chain():
    logits = np.random.default_rng(2).normal(0, 2, (3, 10)).astype(
        np.float32)
    desc = (src("GRAY8", 16, 16) + "jaxinference model=cls ! "
            "classifiertensordecoder top-k=3 threshold=0.05 ! "
            "appsink name=out")
    run_models(desc, {"cls": [logits]}, frames("GRAY8", 16, 16, 3, 1), 3)


@pytest.mark.parametrize("kind", ["yolo", "classifier"])
def test_tensordecodebin_chain(kind):
    """tensordecodebin picks yolov8tensordec for a (4+C, N) tensor, the
    classifier for a vector."""
    t = (yolo_ticks(3, 2, 2) if kind == "yolo" else
         [np.random.default_rng(t).normal(0, 1, (2, 6)).astype(np.float32)
          for t in range(2)])
    desc = (src("GRAY8", 64, 48) + "jaxinference model=bin ! "
            "tensordecodebin ! appsink name=out")
    _, out, _ = run_models(desc, {"bin": t}, frames("GRAY8", 64, 48, 2, 2), 2)
    want = (tanalytics.ObjectDetectionMtd if kind == "yolo"
            else tanalytics.ClassificationMtd)
    rm = tanalytics.relation_meta_of(out["out"][0].buffer)[0]
    assert rm.iter_mtds(want)


def test_named_outputs_and_ssd_chain():
    """A model returning {id: tensor}: ssdobjectdetector's boxes and
    scores, each output sliced by frame."""
    rng = np.random.default_rng(5)
    ticks = [{"boxes": rng.uniform(0, 1, (2, 30, 4)).astype(np.float32),
              "scores": rng.uniform(0, 1, (2, 30, 4)).astype(np.float32)}
             for _ in range(2)]
    desc = (src("I420", 32, 24) + "jaxinference model=ssd ! "
            "ssdobjectdetector score-threshold=0.6 ! appsink name=out")
    _, _, n = run_models(desc, {"ssd": ticks},
                         frames("I420", 32, 24, 2, 2), 2)
    assert n > 2 * 2 * 2


def test_torch_model_on_frames():
    """A model that reads its frames: the port's gets torch tensors where
    the frames are, the JAX package's gets jax arrays; the same function of
    the pixels gives the same tensors."""
    def jmodel(frames):
        import jax.numpy as jnp
        y = frames[0].astype(jnp.float32)
        return y[:, None, :4, :8]

    def tmodel(frames):
        assert isinstance(frames[0], torch.Tensor)
        y = frames[0].float()
        return y[:, None, :4, :8]

    jregister("pix", jmodel)
    tregister("pix", tmodel)
    desc = (src("GRAY8", 16, 16) + "jaxinference model=pix ! "
            "appsink name=out")
    push = frames("GRAY8", 16, 16, 2, 2)
    _, ref = _run(jparse_launch, JBuffer, desc, push, ("out",), 2)
    _, out = _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, push,
                  ("out",), 2, device="cpu")
    assert_same_samples(out, ref, ("out",))
    assert_same_metas(out, ref)


# -- the meta library ----------------------------------------------------------

def both_metas():
    return janalytics.RelationMeta(), tanalytics.RelationMeta()


def test_relation_meta_api():
    """add_*, relations, related_to, iter_mtds, top(), get_location()
    and iou() give the same answers in both packages."""
    res = []
    for lib, rm in zip((janalytics, tanalytics), both_metas()):
        a = rm.add_od_mtd("person", 0, 0, 50, 100, 0.8)
        b = rm.add_od_mtd("face", 10, 5, 20, 20, 0.7)
        c = rm.add_cls_mtd([0.2, 0.7, 0.1], ["x", "y", "z"])
        t = rm.add_trk_mtd(4, ts=99)
        s = rm.add_segmentation_mtd(np.eye(3, dtype=np.uint8), [1, 2])
        rm.set_relation(lib.REL_TYPE_CONTAIN, a, b)
        rm.set_relation(lib.REL_TYPE_RELATE_TO, t, a)
        rm.set_relation(lib.REL_TYPE_RELATE_TO, t, b)
        res.append((describe(rm), rm.exists(a, b, lib.REL_TYPE_CONTAIN),
                    rm.exists(b, a), [m.mtd_id for m in rm.related_to(t)],
                    [m.mtd_id for m in rm.related_to(
                        t, mtd_cls=lib.ObjectDetectionMtd)],
                    c.top(), a.get_location(), a.iou(b), len(rm),
                    s.region_ids, rm.get_relation(a, b)))
    assert res[0] == res[1]


def test_buffer_attachment_and_tensor_on_device():
    """get_relation_meta attaches a RelationMeta; a Tensor holding a torch
    tensor keeps it and gives its host array."""
    buf = Buffer(data=(torch.zeros(2, 4, 4, dtype=torch.uint8),), pts=0)
    assert tanalytics.get_relation_meta(buf, 0) is None
    rm = tanalytics.get_relation_meta(buf, 1, create=True)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tm = rm.add_tensor_mtd(tanalytics.Tensor(id="t", data=x))
    assert tm.tensor.dims == (3, 4) and tm.tensor.data is x
    assert np.array_equal(tm.tensor.numpy(), x.numpy())
    assert list(tanalytics.relation_meta_of(buf)) == [1]


# -- the decoders and the tracker alone ---------------------------------------

def one_frame(pkg, tensors, frame=np.zeros((48, 64), np.uint8)):
    lib, B = (janalytics, JBuffer) if pkg == "jax" else (tanalytics, Buffer)
    buf = B(data=frame, pts=0, batch=1)
    rm = lib.get_relation_meta(buf, 0, create=True)
    for tid, arr in tensors.items():
        rm.add_tensor_mtd(lib.Tensor(id=tid, data=arr))
    return buf


def decode_both(factory, props, tensors):
    res = []
    for pkg, make, lib in (("jax", jmake, janalytics),
                           ("torch", tmake, tanalytics)):
        dec = make(factory, **props)
        out = dec.host_process(one_frame(pkg, tensors))
        res.append(all_metas(out, lib.relation_meta_of))
    assert res[0] == res[1]
    return res[1]


@pytest.mark.parametrize("seed", range(4))
def test_yolo_decoder_alone(seed):
    t = yolo_ticks(seed, 1, 1, ncls=80, n=400, w=640, h=640)[0][0]
    m = decode_both("yolov8tensordec", {"max-detections": 30},
                    {"output": t})
    assert len(m[0][0]) > 5


@pytest.mark.parametrize("shape", [(20, 1), (20, 5), (20,)])
def test_ssd_decoder_alone(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    decode_both("ssdobjectdetector", {"score-threshold": 0.5},
                {"boxes": rng.uniform(0, 1, (20, 4)).astype(np.float32),
                 "scores": rng.uniform(0, 1, shape).astype(np.float32)})


@pytest.mark.parametrize("topk,thr", [(5, 0.0), (2, 0.0), (10, 0.1)])
def test_classifier_decoder_alone(topk, thr, tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"class{i}" for i in range(6)) + "\n")
    logits = np.random.default_rng(topk).normal(0, 2, 12).astype(np.float32)
    decode_both("classifiertensordecoder",
                {"top-k": topk, "threshold": thr, "label-file": str(labels)},
                {"output": logits})


@pytest.mark.parametrize("thr,lost", [(0.3, 2), (0.5, 5), (0.1, 1)])
def test_tracker_motion_and_loss(thr, lost):
    """Two objects moving and one appearing and vanishing over 12
    frames: the same tracks, ids and relations in both packages."""
    res = []
    for pkg, make, lib in (("jax", jmake, janalytics),
                           ("torch", tmake, tanalytics)):
        trk = make("ioutracker", **{"iou-score-threshold": thr,
                                    "min-frame-count-for-lost-track": lost})
        trk.start()
        got = []
        r = np.random.default_rng(0)
        for f in range(12):
            B = JBuffer if pkg == "jax" else Buffer
            buf = B(data=np.zeros(4), pts=f * DUR, batch=1)
            rm = lib.get_relation_meta(buf, 0, create=True)
            rm.add_od_mtd("a", 3 * f, 0, 20, 20, 0.9)
            rm.add_od_mtd("b", 60 - 4 * f, 30, 16, 16, 0.8)
            if f % 5 < 2:
                rm.add_od_mtd("c", *r.uniform(0, 80, 2), 10, 10, 0.5)
            got.append(all_metas(trk.host_process(buf), lib.relation_meta_of))
        res.append(got)
    assert res[0] == res[1]


def test_overlay_draws_like_reference_on_planar_formats():
    """The boxes on a batch of I420 frames: luma only, 2 px and 3 px."""
    rng = np.random.default_rng(1)
    for lw in (2, 3):
        boxes = rng.uniform(-10, 60, (2, 3, 2))
        res = []
        for pkg, make, lib, B in (("jax", jmake, janalytics, JBuffer),
                                  ("torch", tmake, tanalytics, Buffer)):
            ov = make("objectdetectionoverlay", **{"line-width": lw})
            pl = planes("I420", 64, 48, 2, 4)
            if pkg == "torch":
                pl = tuple(torch.from_numpy(p) for p in pl)
            buf = B(data=pl, pts=0, batch=2)
            for k in range(2):
                rm = lib.get_relation_meta(buf, k, create=True)
                for x, y in boxes[k]:
                    rm.add_od_mtd("o", x, y, 17.5, 12.25, 0.9)
            out = ov.host_process(buf)
            res.append([np.asarray(p) for p in out.data])
        for a, b in zip(*res):
            assert np.array_equal(a, b)


def test_overlay_rgb_is_a_reference_fault():
    """On RGB the JAX package draws 255 into the R plane only (its first
    component plane), so a box comes out red, not white; the port raises
    NotImplementedError naming ROADMAP.md instead of copying that."""
    desc = (src("RGB", 32, 24) + "jaxinference model=toy-yolo ! "
            "yolov8tensordec class-confidence-threshold=0.5 ! "
            "objectdetectionoverlay ! appsink name=out")
    jregister("toy-yolo", lambda frames: _yolo_tensor())
    tregister("toy-yolo", lambda frames: _yolo_tensor())
    push = {"in": [dict(data=tuple(np.zeros((1, 24, 32), np.uint8)
                                   for _ in range(3)),
                        pts=0, duration=DUR, batch=1)]}
    _, ref = _run(jparse_launch, JBuffer, desc, push, ("out",), 1)
    r, g, b = (np.asarray(p) for p in ref["out"][0].buffer.data)
    assert r.max() == 255 and g.max() == 0 and b.max() == 0
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, push,
             ("out",), 1, device="cpu")


# -- the launch CLI -------------------------------------------------------------

def _cli(code):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_launch_cli_cpu():
    """python -m gstreamer_tpu_torch.tools.launch --cpu runs a string to
    EOS on the CPU."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run(
        [sys.executable, "-m", "gstreamer_tpu_torch.tools.launch", "--cpu",
         "--batch", "2", "videotestsrc num-buffers=4 ! video/x-raw,"
         "format=I420,width=32,height=24 ! smooth ! fakesink"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "Got EOS from pipeline" in p.stderr


def test_launch_cli_detection_string():
    """The detection string through tools.launch's main, a model
    registered first; the decoded detections reach the appsink."""
    code = (
        "import numpy as np, torch\n"
        "from gstreamer_tpu_torch.elements.analytics_elements import "
        "register_model\n"
        "from gstreamer_tpu_torch.tools import launch\n"
        "t = torch.zeros(6, 3)\n"
        "t[:, 0] = torch.tensor([32, 24, 20, 16, 0.9, 0.1])\n"
        "t[:, 2] = torch.tensor([10, 10, 8, 8, 0.1, 0.7])\n"
        "register_model('toy', lambda frames: t)\n"
        "raise SystemExit(launch.main(['--cpu', 'videotestsrc "
        "num-buffers=2 ! videoconvertscale ! video/x-raw,format=I420,"
        "width=64,height=48 ! jaxinference model=toy ! yolov8tensordec ! "
        "ioutracker ! objectdetectionoverlay ! fakesink']))\n")
    p = _cli(code)
    assert p.returncode == 0, p.stderr
    assert "Got EOS from pipeline" in p.stderr


def test_inspect_cli_lists_the_port():
    p = _cli("from gstreamer_tpu_torch.tools import inspect\n"
             "raise SystemExit(inspect.main([]) or inspect.main("
             "['yolov8tensordec']))\n")
    from test_torch_flow import (CODEC_TAIL_FACTORIES, LEAVES_FACTORIES,
                                 TAGS_SUBS_FACTORIES)
    assert p.returncode == 0, p.stderr
    total = 571 + len(CODEC_TAIL_FACTORIES) + len(TAGS_SUBS_FACTORIES) \
        + len(LEAVES_FACTORIES)
    assert f"Total count: {total} elements" in p.stdout
    assert "class-confidence-threshold" in p.stdout
