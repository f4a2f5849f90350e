"""Analytics / ML elements: inference + tensor decoders + tracker +
overlay, in torch.

A port of the JAX package's ``elements/analytics_elements.py``
(references:
* gst-plugins-bad/ext/onnx/gstonnxinference.cpp — the inference
  element contract: video in, same video out with a GstTensorMeta
  attached.  `jaxinference` keeps its factory name so that launch
  strings stay the same; its model is a REGISTERED TORCH CALLABLE
  (register_model) run on the frames where they already are (the card,
  unless the pipeline runs on the CPU).
* gst/tensordecoders/gstyolotensordecoder.c ("yolov8tensordec") —
  YOLOv8 output [1, 4+C, N]: candidates where max class confidence
  passes class-confidence-threshold, xywh given center+size, then
  greedy IoU NMS (:509-560).
* gstssdtensordec.c ("ssdobjectdetector") — paired boxes [N,4]
  (normalized y1,x1,y2,x2) + scores [N,C] tensors.
* gstclassifiertensordecoder.c ("classifiertensordecoder") — softmax
  logits -> top-class ClassificationMtd.
* gstioutracker.c ("ioutracker") — greedy IoU association against
  live tracks, new ids for unmatched, tracks dropped after
  min-frame-count-for-lost-track misses.
* ext/analyticsoverlay (objectdetectionoverlay) — draws OD boxes.)

The model's outputs are copied to the host once a tick, each output
tensor in one copy; every frame's TensorMtd holds its row of that host
array.  The decoders, ``_nms`` and the tracker are the JAX package's host
code, unchanged.  objectdetectionoverlay draws on the host copy of the
tick's planes and puts them back on the buffer's device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..analytics.meta import (ObjectDetectionMtd, Tensor, TensorMtd,
                              TrackingMtd, get_relation_meta,
                              relation_meta_of)
from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo

_MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str, fn: Callable) -> None:
    """Register a torch callable: fn(frames) -> tensor or
    {tensor_id: tensor}; `frames` is the buffer's data (a tuple of
    planes on the pipeline's device).  Referenced by jaxinference
    `model`."""
    _MODEL_REGISTRY[name] = fn


def _video_caps():
    return ("video/x-raw, width=[1,32767], height=[1,32767], "
            "framerate=[0/1,2147483647/1]")


def writable_planes(buf: Buffer) -> List[np.ndarray]:
    """Writable host copies of a video buffer's planes (a lone plane is
    a list of one)."""
    d = buf.data if isinstance(buf.data, (list, tuple)) else [buf.data]
    return [np.array(host_array(p)) for p in d]


def luma_only(elem, what: str) -> None:
    """Refuse an RGB-family format: the JAX package draws into the first
    component plane only (R, B or A there, not every colour plane;
    ROADMAP.md section 3)."""
    info = getattr(elem, "_info", None)
    if info is not None and info.finfo.is_rgb:
        raise NotImplementedError(
            f"{elem.FACTORY}: {what} on {info.finfo.name} is not ported: the "
            f"JAX package draws into its first component plane only "
            f"(ROADMAP.md section 3); use a YUV or GRAY format")


@register_element
class JaxInference(TransformElement):
    """jaxinference: run a registered torch model over the frame batch
    and attach the outputs as TensorMtds (the onnxinference
    equivalent; the model runs on the pipeline's device)."""
    FACTORY = "jaxinference"
    DESCRIPTION = "Run a registered JAX model on video frames and " \
                  "attach tensors"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _video_caps()),
        PadTemplate("src", PadDirection.SRC, _video_caps()),
    ]
    PROPERTIES = {
        "model": (str, "", "registered model name"),
        "tensor-id": (str, "output", "id for the attached tensor"),
    }

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        fn = _MODEL_REGISTRY.get(self.props["model"])
        if fn is None:
            raise ValueError(
                f"jaxinference: model {self.props['model']!r} not "
                f"registered (use analytics register_model)")
        out = fn(buf.data)
        outs = out if isinstance(out, dict) \
            else {self.props["tensor-id"]: out}
        host = {tid: host_array(arr) for tid, arr in outs.items()}
        n = buf.batch or 1
        buf = buf.with_(meta=dict(buf.meta or {}))
        for k in range(n):
            rmeta = get_relation_meta(buf, k, create=True)
            for tid, a in host.items():
                entry = a[k] if a.ndim > 0 and a.shape[0] == n else a
                rmeta.add_tensor_mtd(Tensor(id=tid, data=entry))
        return buf


def _nms(cands: List[dict], iou_thresh: float,
         max_det: int) -> List[dict]:
    """Greedy IoU NMS on xywh dicts sorted by confidence."""
    cands = sorted(cands, key=lambda c: -c["conf"])
    kept: List[dict] = []

    def iou(a, b):
        x1 = max(a["x"], b["x"])
        y1 = max(a["y"], b["y"])
        x2 = min(a["x"] + a["w"], b["x"] + b["w"])
        y2 = min(a["y"] + a["h"], b["y"] + b["h"])
        inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
        union = a["w"] * a["h"] + b["w"] * b["h"] - inter
        return inter / union if union > 0 else 0.0

    for c in cands:
        if len(kept) >= max_det:
            break
        if all(iou(c, k) < iou_thresh for k in kept):
            kept.append(c)
    return kept


class _TensorDecoderBase(TransformElement):
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]

    def _labels(self) -> List[str]:
        lf = self.props.get("label-file") or ""
        if lf:
            with open(lf) as f:
                return [ln.strip() for ln in f if ln.strip()]
        return []

    def _label(self, idx: int) -> str:
        labels = self._labels()
        return labels[idx] if idx < len(labels) else str(idx)


@register_element
class YoloTensorDecoder(_TensorDecoderBase):
    FACTORY = "yolov8tensordec"
    DESCRIPTION = "Decode YOLOv8 detection tensors into analytics " \
                  "object-detection metas"
    PROPERTIES = {
        "class-confidence-threshold": (float, 0.25, ""),
        "iou-threshold": (float, 0.45, "NMS threshold"),
        "max-detections": (int, 100, ""),
        "tensor-id": (str, "output", "tensor to decode"),
        "label-file": (str, "", "newline-separated class names"),
    }

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        for k, rmeta in relation_meta_of(buf).items():
            for tm in rmeta.iter_mtds(TensorMtd):
                if tm.tensor.id != self.props["tensor-id"]:
                    continue
                t = tm.tensor.numpy()
                t = t.reshape(t.shape[-2], t.shape[-1])  # (4+C, N)
                boxes = t[:4]                    # xc, yc, w, h
                scores = t[4:]                   # (C, N)
                conf = scores.max(axis=0)
                cls = scores.argmax(axis=0)
                keep = conf >= self.props[
                    "class-confidence-threshold"]
                cands = [{"x": float(boxes[0, i] - boxes[2, i] / 2),
                          "y": float(boxes[1, i] - boxes[3, i] / 2),
                          "w": float(boxes[2, i]),
                          "h": float(boxes[3, i]),
                          "conf": float(conf[i]),
                          "cls": int(cls[i])}
                         for i in np.nonzero(keep)[0]]
                for c in _nms(cands, self.props["iou-threshold"],
                              self.props["max-detections"]):
                    od = rmeta.add_od_mtd(self._label(c["cls"]),
                                          c["x"], c["y"], c["w"],
                                          c["h"], c["conf"])
                    rmeta.set_relation(1 << 3, tm, od)   # RELATE_TO
        return buf


@register_element
class SsdObjectDetector(_TensorDecoderBase):
    FACTORY = "ssdobjectdetector"
    DESCRIPTION = "Decode SSD detection tensors (boxes + scores)"
    PROPERTIES = {
        "score-threshold": (float, 0.3, ""),
        "boxes-tensor-id": (str, "boxes", "[N,4] y1,x1,y2,x2"),
        "scores-tensor-id": (str, "scores", "[N] or [N,C]"),
        "label-file": (str, "", ""),
    }

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        for k, rmeta in relation_meta_of(buf).items():
            tensors = {tm.tensor.id: tm.tensor.numpy()
                       for tm in rmeta.iter_mtds(TensorMtd)}
            boxes = tensors.get(self.props["boxes-tensor-id"])
            scores = tensors.get(self.props["scores-tensor-id"])
            if boxes is None or scores is None:
                continue
            boxes = boxes.reshape(-1, 4)
            scores = scores.reshape(boxes.shape[0], -1)
            conf = scores.max(axis=1)
            cls = scores.argmax(axis=1)
            for i in np.nonzero(
                    conf >= self.props["score-threshold"])[0]:
                y1, x1, y2, x2 = boxes[i]
                rmeta.add_od_mtd(self._label(int(cls[i])),
                                 float(x1), float(y1),
                                 float(x2 - x1), float(y2 - y1),
                                 float(conf[i]))
        return buf


@register_element
class ClassifierTensorDecoder(_TensorDecoderBase):
    FACTORY = "classifiertensordecoder"
    DESCRIPTION = "Decode classification tensors into analytics " \
                  "classification metas"
    PROPERTIES = {
        "threshold": (float, 0.0, "minimum softmax confidence"),
        "top-k": (int, 5, ""),
        "tensor-id": (str, "output", ""),
        "label-file": (str, "", ""),
    }

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        for k, rmeta in relation_meta_of(buf).items():
            for tm in rmeta.iter_mtds(TensorMtd):
                if tm.tensor.id != self.props["tensor-id"]:
                    continue
                logits = tm.tensor.numpy().reshape(-1)
                e = np.exp(logits - logits.max())
                prob = e / e.sum()
                order = np.argsort(prob)[::-1][:self.props["top-k"]]
                order = [i for i in order
                         if prob[i] >= self.props["threshold"]]
                rmeta.add_cls_mtd([float(prob[i]) for i in order],
                                  [self._label(int(i))
                                   for i in order])
        return buf


@register_element
class IouTracker(TransformElement):
    FACTORY = "ioutracker"
    DESCRIPTION = "Tracking element using iou scores"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "iou-score-threshold": (float, 0.5, ""),
        "min-frame-count-for-lost-track": (int, 5, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._tracks: Dict[int, dict] = {}
        self._next_id = 1

    def start(self):
        self._tracks = {}
        self._next_id = 1

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        thresh = self.props["iou-score-threshold"]
        max_lost = self.props["min-frame-count-for-lost-track"]
        ts = buf.pts or 0
        for k, rmeta in relation_meta_of(buf).items():
            dets = rmeta.iter_mtds(ObjectDetectionMtd)
            unmatched = set(self._tracks)
            for det in dets:
                best_id, best_iou = None, thresh
                for tid in unmatched:
                    iou = det.iou(self._tracks[tid]["od"])
                    if iou >= best_iou:
                        best_id, best_iou = tid, iou
                if best_id is None:
                    best_id = self._next_id
                    self._next_id += 1
                    self._tracks[best_id] = {
                        "od": det, "first": ts, "miss": 0}
                else:
                    unmatched.discard(best_id)
                    self._tracks[best_id]["od"] = det
                    self._tracks[best_id]["miss"] = 0
                tr = self._tracks[best_id]
                trk = rmeta.add(TrackingMtd(
                    track_id=best_id, first_seen=tr["first"],
                    last_seen=ts))
                rmeta.set_relation(1 << 3, trk, det)     # RELATE_TO
                rmeta.set_relation(1 << 3, det, trk)
            for tid in list(unmatched):
                self._tracks[tid]["miss"] += 1
                if self._tracks[tid]["miss"] >= max_lost:
                    del self._tracks[tid]
        return buf


@register_element
class TensorDecodeBin(_TensorDecoderBase):
    """tensordecodebin (gsttensordecodebin.c): picks the decoder for
    the attached tensors; collapsed to shape-based dispatch between
    the yolo and classifier decoders."""
    FACTORY = "tensordecodebin"
    DESCRIPTION = "Auto-plug tensor decoders based on tensor metas"
    PROPERTIES = {
        "label-file": (str, "", ""),
        "tensor-id": (str, "output", ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._inner = None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        if self._inner is None:
            from ..core.element import element_factory_make
            for rmeta in relation_meta_of(buf).values():
                for tm in rmeta.iter_mtds(TensorMtd):
                    shape = tm.tensor.numpy().shape
                    factory = ("yolov8tensordec"
                               if len(shape) >= 2 and shape[-2] > 4
                               else "classifiertensordecoder")
                    self._inner = element_factory_make(
                        factory, **{"tensor-id": self.props["tensor-id"],
                                    "label-file": self.props["label-file"]})
                    break
                break
        return (self._inner.host_process(buf)
                if self._inner is not None else buf)


@register_element
class ObjectDetectionOverlay(TransformElement):
    """objectdetectionoverlay (ext/analyticsoverlay): draws OD boxes
    into the luma plane (2px rectangle outline).  An RGB-family format
    raises NotImplementedError (``luma_only``)."""
    FACTORY = "objectdetectionoverlay"
    DESCRIPTION = "Overlay analytics object-detection results on video"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _video_caps()),
        PadTemplate("src", PadDirection.SRC, _video_caps()),
    ]
    PROPERTIES = {"line-width": (int, 2, "")}

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        metas = relation_meta_of(buf)
        if not metas:
            return buf
        luma_only(self, "drawing boxes")
        planes = writable_planes(buf)
        y = planes[0]
        lw = self.props["line-width"]
        h, w = y.shape[-2], y.shape[-1]
        for k, rmeta in metas.items():
            for od in rmeta.iter_mtds(ObjectDetectionMtd):
                x1 = int(max(0, min(od.x, w - 1)))
                y1 = int(max(0, min(od.y, h - 1)))
                x2 = int(max(0, min(od.x + od.w, w)))
                y2 = int(max(0, min(od.y + od.h, h)))
                tgt = y[k] if y.ndim == 3 else y
                tgt[y1:y1 + lw, x1:x2] = 255
                tgt[max(0, y2 - lw):y2, x1:x2] = 255
                tgt[y1:y2, x1:x1 + lw] = 255
                tgt[y1:y2, max(0, x2 - lw):x2] = 255
        dev = [device_array(p, buf.data) for p in planes]
        return buf.with_(data=tuple(dev) if len(dev) > 1 else dev[0])
