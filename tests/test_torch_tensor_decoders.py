"""The port's second tensor-decoder family against the JAX package, bit
for bit.

yolo26tensordec, yolosegv8tensordec, yoloobbv8tensordec,
ultralightfacedetectortensordec and segmentationoverlay
(``elements/tensor_decoders2.py``): seeded tensors through each decoder
alone in both packages, then through launch strings where the same
tensors are registered as models (``test_torch_analytics.run_models``):
every Mtd, mask and relation, every sample's planes, tolerance 0.
segmentationoverlay's RGB fault is ROADMAP.md section 3's.
"""

import numpy as np
import pytest

from gstreamer_tpu.core.buffer import Buffer as JBuffer
from gstreamer_tpu.core.parse import parse_launch as jparse_launch
from gstreamer_tpu.elements import tensor_decoders2 as jtd
from gstreamer_tpu.elements.analytics_elements import \
    register_model as jregister

import gstreamer_tpu_torch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.elements import tensor_decoders2 as ttd
from gstreamer_tpu_torch.elements.analytics_elements import \
    register_model as tregister

from test_torch_analytics import (decode_both, frames, run_models, same_spec,
                                  src)
from test_torch_compositor import _run

FACTORIES = ("yolo26tensordec", "yolosegv8tensordec", "yoloobbv8tensordec",
             "ultralightfacedetectortensordec", "segmentationoverlay")


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_matches_reference(factory):
    same_spec(factory)


def yolo26(rng, n=40, w=64, h=48, ncls=5):
    """(n, 6) rows x1, y1, x2, y2, score, class."""
    x1 = rng.uniform(0, w, n)
    y1 = rng.uniform(0, h, n)
    return np.stack([x1, y1, x1 + rng.uniform(2, 20, n),
                     y1 + rng.uniform(2, 20, n), rng.uniform(0, 1, n),
                     rng.integers(0, ncls, n)], 1).astype(np.float32)


def yoloseg(rng, n=30, ncls=3, nmask=4, mh=12, mw=16, w=64, h=48):
    """A (4 + ncls + nmask, n) detections tensor (near-duplicates every
    third box) and (nmask, mh, mw) prototypes."""
    cxy = rng.uniform([0, 0], [w, h], (n, 2))
    cxy[2::3] = cxy[1::3][:len(cxy[2::3])] + 0.5
    wh = rng.uniform(6, 30, (n, 2))
    sc = rng.uniform(0, 0.6, (ncls, n))
    co = rng.normal(0, 2, (nmask, n))
    det = np.concatenate([cxy.T, wh.T, sc, co]).astype(np.float32)
    protos = rng.normal(0, 1, (nmask, mh, mw)).astype(np.float32)
    return det, protos


def obb(rng, n=30, ncls=3, w=64, h=48):
    cxy = rng.uniform([0, 0], [w, h], (n, 2))
    cxy[1::2] = cxy[0::2][:len(cxy[1::2])] + 1.0
    wh = rng.uniform(4, 24, (n, 2))
    sc = rng.uniform(0, 0.7, (ncls, n))
    ang = rng.uniform(-np.pi, np.pi, (1, n))
    return np.concatenate([cxy.T, wh.T, sc, ang]).astype(np.float32)


def face(rng, n=40):
    x1 = rng.uniform(0, 0.8, (n, 2))
    boxes = np.concatenate([x1, x1 + rng.uniform(0.05, 0.2, (n, 2))], 1)
    boxes[1::3] = boxes[0::3][:len(boxes[1::3])] + 0.01
    p = rng.uniform(0, 1, n)
    return (boxes.astype(np.float32),
            np.stack([1 - p, p], 1).astype(np.float32))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("thr", [0.25, 0.6])
def test_yolo26_alone(seed, thr):
    decode_both("yolo26tensordec", {"score-threshold": thr},
                {"output": yolo26(np.random.default_rng(seed))})


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mask_thr", [0.5, 0.8])
def test_yoloseg_alone(seed, mask_thr):
    det, protos = yoloseg(np.random.default_rng(seed))
    m = decode_both("yolosegv8tensordec",
                    {"class-confidence-threshold": 0.3,
                     "mask-threshold": mask_thr, "iou-threshold": 0.4},
                    {"output": det, "protos": protos})
    assert any(k == "SegmentationMtd" for k, _ in m[0][0])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("iou", [0.1, 0.45])
def test_yoloobb_alone(seed, iou):
    m = decode_both("yoloobbv8tensordec",
                    {"class-confidence-threshold": 0.3, "iou-threshold": iou,
                     "max-detections": 20},
                    {"output": obb(np.random.default_rng(seed))})
    assert m[0][0]


@pytest.mark.parametrize("seed", range(3))
def test_ultralight_face_alone(seed):
    boxes, scores = face(np.random.default_rng(seed))
    decode_both("ultralightfacedetectortensordec", {"score-threshold": 0.6},
                {"boxes": boxes, "scores": scores})


def test_obb_geometry_helpers():
    """The rotated IoU and the polygon area of both packages on seeded
    boxes (the float64 clip is the same host code)."""
    rng = np.random.default_rng(9)
    for _ in range(50):
        a, b = ({"x": rng.uniform(0, 20), "y": rng.uniform(0, 20),
                 "w": rng.uniform(1, 15), "h": rng.uniform(1, 15),
                 "angle": rng.uniform(-3, 3)} for _ in range(2))
        assert ttd._rotated_iou(a, b) == jtd._rotated_iou(a, b)
        pa = jtd._obb_corners(a)
        assert ttd._poly_area(pa) == jtd._poly_area(pa)


def test_frame_dims_reads_a_tensor_without_a_copy():
    """yolosegv8tensordec's mask gain comes from the frame's size: the
    port reads it off the tensor's shape."""
    import torch
    buf = Buffer(data=(torch.zeros(2, 48, 64, dtype=torch.uint8),))
    assert ttd._frame_dims(buf) == (48, 64)
    assert ttd._frame_dims(Buffer(data=np.zeros(4))) == (None, None)


# -- launch strings: the models registered in both packages ------------------

def _seg_model(frames):
    det = np.zeros((9, 1), np.float32)
    det[:, 0] = [32, 24, 64, 48, 0.9, 0.1, 8.0, 0.0, 0.0]
    protos = np.zeros((3, 12, 16), np.float32)
    protos[0, :6] = 1.0
    protos[0, 6:] = -1.0
    return {"output": det, "protos": protos}


@pytest.mark.parametrize("fmt", ["GRAY8", "I420", "Y444", "NV12"])
@pytest.mark.parametrize("alpha", [1.0, 0.35])
def test_segmentation_chain(fmt, alpha):
    """jaxinference ! yolosegv8tensordec ! segmentationoverlay on seeded
    frames: seeded detections and prototypes a frame, 2 ticks of 2."""
    rng = np.random.default_rng(len(fmt))
    ticks = []
    for _ in range(2):
        dp = [yoloseg(rng) for _ in range(2)]
        ticks.append({"output": np.stack([d for d, _ in dp]),
                      "protos": np.stack([p for _, p in dp])})
    desc = (src(fmt, 64, 48) + "jaxinference model=seg ! yolosegv8tensordec "
            "class-confidence-threshold=0.3 logits-tensor-id=protos ! "
            f"segmentationoverlay alpha={alpha} ! appsink name=out")
    _, _, n = run_models(desc, {"seg": ticks}, frames(fmt, 64, 48, 2, 2), 2)
    assert n > 8


def test_segmentation_chain_fixed_model():
    """tests/test_tensor_decoders2.py's chain: videotestsrc, one fixed
    model for every frame."""
    desc = ("videotestsrc num-buffers=2 pattern=black ! "
            "video/x-raw,format=GRAY8,width=64,height=48 ! "
            "jaxinference model=toy-seg ! "
            "yolosegv8tensordec class-confidence-threshold=0.5 "
            "logits-tensor-id=protos ! "
            "segmentationoverlay alpha=1.0 ! appsink name=out")
    run_models(desc, {"toy-seg": _seg_model(None)})


@pytest.mark.parametrize("factory,model", [
    ("yolo26tensordec", "y26"), ("yoloobbv8tensordec", "obb"),
    ("ultralightfacedetectortensordec", "face")])
def test_decoder_chains(factory, model):
    rng = np.random.default_rng(4)
    if model == "y26":
        ticks = [np.stack([yolo26(rng) for _ in range(2)]) for _ in range(2)]
    elif model == "obb":
        ticks = [np.stack([obb(rng) for _ in range(2)]) for _ in range(2)]
    else:
        ticks = []
        for _ in range(2):
            bs = [face(rng) for _ in range(2)]
            ticks.append({"boxes": np.stack([b for b, _ in bs]),
                          "scores": np.stack([s for _, s in bs])})
    desc = (src("I420", 64, 48) + f"jaxinference model={model} ! "
            f"{factory} ! appsink name=out")
    run_models(desc, {model: ticks}, frames("I420", 64, 48, 2, 2), 2)


def test_segmentation_overlay_rgb_is_a_reference_fault():
    """On RGB the JAX package blends the masks into the R plane only; the
    port raises NotImplementedError naming ROADMAP.md."""
    for reg in (jregister, tregister):
        reg("toy-seg", _seg_model)
    desc = (src("RGB", 64, 48) + "jaxinference model=toy-seg ! "
            "yolosegv8tensordec class-confidence-threshold=0.5 "
            "logits-tensor-id=protos ! segmentationoverlay alpha=1.0 ! "
            "appsink name=out")
    push = {"in": [dict(data=tuple(np.zeros((1, 48, 64), np.uint8)
                                   for _ in range(3)),
                        pts=0, duration=33333333, batch=1)]}
    _, ref = _run(jparse_launch, JBuffer, desc, push, ("out",), 1)
    r, g, b = (np.asarray(p) for p in ref["out"][0].buffer.data)
    assert r.max() > 0 and g.max() == 0 and b.max() == 0
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _run(gstreamer_tpu_torch.parse_launch, Buffer, desc, push,
             ("out",), 1, device="cpu")
