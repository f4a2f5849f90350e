"""Tensor-decoder family batch 2: segmentation / oriented-box / NMS-free
YOLO variants, the UltraLight face detector, and segmentationoverlay.

References (gst-plugins-bad/gst/tensordecoders/):
* gstyolosegtensordecoder.c ("yolosegv8tensordec") — FastSAM/YOLOv8-seg:
  detections tensor [1, 4+C+M, N] plus mask-prototype ("logits") tensor
  [1, M, mh, mw]; per kept detection mask = sigmoid(coeffs · protos),
  cropped to the detection box (":285 the detections need to be cropped").
* gstyoloobbtensordecoder.c ("yoloobbv8tensordec") — oriented boxes
  [1, 4+C+1, N] with the rotation angle in the last row; NMS uses
  rotated-polygon IoU (get_rotated_corners :225, polygon clip :359).
* gstyolo26tensordecoder.c ("yolo26tensordec") — NMS-free end-to-end
  YOLO26 output [1, N, 6] rows x1,y1,x2,y2,score,class (:371-397),
  score-threshold only.
* gstfacedetectortensordecoder.c ("ultralightfacedetectortensordec") —
  UltraLight face detection: boxes [1, N, 4] normalized x1,y1,x2,y2 +
  scores [1, N, 2] (background, face); hard NMS (iou_box :526).
* ext/analyticsoverlay/gstsegmentationoverlay.c ("segmentationoverlay")
  — color-codes attached segmentation masks onto the frame.

A port of the JAX package's ``elements/tensor_decoders2.py``: the decoders
are its host code, unchanged, on the host copies of the tensors that
jaxinference attached.  segmentationoverlay blends on the host copy of the
tick's planes and puts them back on the buffer's device; an RGB-family
format raises NotImplementedError (``analytics_elements.luma_only``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..analytics.meta import (ObjectDetectionMtd, SegmentationMtd,
                              TensorMtd, relation_meta_of)
from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo
from .analytics_elements import (_TensorDecoderBase, _nms, _video_caps,
                                 device_array, writable_planes, luma_only)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _frame_dims(buf: Buffer):
    """(h, w) of the video frame carrying the tensors, if the buffer
    holds array planes (None, None otherwise)."""
    d = buf.data
    p = d[0] if isinstance(d, (list, tuple)) else d
    if isinstance(p, torch.Tensor):
        shape = p.shape                 # no copy of a tensor on the card
    else:
        try:
            shape = np.asarray(p).shape
        except Exception:
            return None, None
    if len(shape) >= 2:
        return int(shape[-2]), int(shape[-1])
    return None, None


@register_element
class Yolo26TensorDec(_TensorDecoderBase):
    FACTORY = "yolo26tensordec"
    DESCRIPTION = "Decode NMS-free YOLO26 detection tensors"
    PROPERTIES = {
        "score-threshold": (float, 0.25, ""),
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
                t = tm.tensor.numpy()
                t = t.reshape(-1, t.shape[-1])
                if t.shape[-1] != 6:
                    continue
                for det in t:
                    x1, y1, x2, y2, score, cls = det
                    if score < self.props["score-threshold"]:
                        continue
                    od = rmeta.add_od_mtd(
                        self._label(int(cls)), float(x1), float(y1),
                        float(x2 - x1), float(y2 - y1), float(score))
                    rmeta.set_relation(1 << 3, tm, od)
        return buf


@register_element
class YoloSegTensorDecoder(_TensorDecoderBase):
    FACTORY = "yolosegv8tensordec"
    DESCRIPTION = "Decode YOLOv8/FastSAM segmentation tensors into " \
                  "detection + mask metas"
    PROPERTIES = {
        "class-confidence-threshold": (float, 0.25, ""),
        "iou-threshold": (float, 0.45, "NMS threshold"),
        "max-detections": (int, 100, ""),
        "mask-threshold": (float, 0.5, "sigmoid cutoff"),
        "tensor-id": (str, "output", "detections tensor"),
        "logits-tensor-id": (str, "protos", "mask prototype tensor"),
        "label-file": (str, "", ""),
    }

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        for k, rmeta in relation_meta_of(buf).items():
            tensors = {tm.tensor.id: tm for tm
                       in rmeta.iter_mtds(TensorMtd)}
            dtm = tensors.get(self.props["tensor-id"])
            ptm = tensors.get(self.props["logits-tensor-id"])
            if dtm is None or ptm is None:
                continue
            det = dtm.tensor.numpy()
            det = det.reshape(det.shape[-2], det.shape[-1])
            protos = ptm.tensor.numpy()
            protos = protos.reshape(protos.shape[-3],
                                    protos.shape[-2],
                                    protos.shape[-1])   # (M, mh, mw)
            nmask = protos.shape[0]
            ncls = det.shape[0] - 4 - nmask
            if ncls < 1:
                continue
            boxes = det[:4]
            scores = det[4:4 + ncls]
            coeffs = det[4 + ncls:]
            conf = scores.max(axis=0)
            cls = scores.argmax(axis=0)
            keep = conf >= self.props["class-confidence-threshold"]
            cands = [{"x": float(boxes[0, i] - boxes[2, i] / 2),
                      "y": float(boxes[1, i] - boxes[3, i] / 2),
                      "w": float(boxes[2, i]), "h": float(boxes[3, i]),
                      "conf": float(conf[i]), "cls": int(cls[i]),
                      "i": int(i)}
                     for i in np.nonzero(keep)[0]]
            mh, mw = protos.shape[1], protos.shape[2]
            # bb2mask gain from the actual frame size
            # (gstyolosegtensordecoder.c:299 uses video_info.width)
            fh, fw = _frame_dims(buf)
            gain_x = mw / fw if fw else mw / max(
                float(boxes[0].max()) * 2, 1.0)
            gain_y = mh / fh if fh else mh / max(
                float(boxes[1].max()) * 2, 1.0)
            for c in _nms(cands, self.props["iou-threshold"],
                          self.props["max-detections"]):
                od = rmeta.add_od_mtd(self._label(c["cls"]), c["x"],
                                      c["y"], c["w"], c["h"],
                                      c["conf"])
                m = _sigmoid(np.tensordot(coeffs[:, c["i"]], protos,
                                          axes=(0, 0)))
                mask = (m >= self.props["mask-threshold"])
                # crop to the detection box in prototype coordinates
                # (gstyolosegtensordecoder.c:285 — masks only valid
                # inside their box)
                x1 = max(0, int(c["x"] * gain_x))
                y1 = max(0, int(c["y"] * gain_y))
                x2 = min(mw, int(math.ceil((c["x"] + c["w"]) * gain_x)))
                y2 = min(mh, int(math.ceil((c["y"] + c["h"]) * gain_y)))
                crop = np.zeros_like(mask)
                crop[y1:y2, x1:x2] = mask[y1:y2, x1:x2]
                seg = rmeta.add_segmentation_mtd(
                    crop.astype(np.uint8), [1])
                rmeta.set_relation(1 << 3, od, seg)
                rmeta.set_relation(1 << 3, dtm, od)
        return buf


def _obb_corners(c) -> np.ndarray:
    """Corner points of a rotated box dict (cx, cy, w, h, angle)."""
    cx, cy = c["x"] + c["w"] / 2, c["y"] + c["h"] / 2
    dx, dy = c["w"] / 2, c["h"] / 2
    cs, sn = math.cos(c["angle"]), math.sin(c["angle"])
    pts = []
    for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        px, py = sx * dx, sy * dy
        pts.append((cx + px * cs - py * sn, cy + px * sn + py * cs))
    return np.array(pts)


def _poly_area(p: np.ndarray) -> float:
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1))
                           - np.dot(y, np.roll(x, -1))))


def _poly_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman convex polygon clipping."""
    out = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        inp, out = out, []
        if not inp:
            break
        ex, ey = b[0] - a[0], b[1] - a[1]

        def inside(p):
            # interior is LEFT of each CCW edge (cross >= 0)
            return ex * (p[1] - a[1]) - ey * (p[0] - a[0]) >= 0

        def isect(p, q):
            dx, dy = q[0] - p[0], q[1] - p[1]
            denom = ex * dy - ey * dx
            if abs(denom) < 1e-12:
                return q
            t = (ey * (p[0] - a[0]) - ex * (p[1] - a[1])) / denom
            return (p[0] + t * dx, p[1] + t * dy)

        for j, p in enumerate(inp):
            q = inp[(j + 1) % len(inp)]
            if inside(p):
                out.append(p)
                if not inside(q):
                    out.append(isect(p, q))
            elif inside(q):
                out.append(isect(p, q))
    return np.array(out) if out else np.zeros((0, 2))


def _rotated_iou(a, b) -> float:
    pa, pb = _obb_corners(a), _obb_corners(b)
    inter_poly = _poly_clip(pa, pb)
    if len(inter_poly) < 3:
        return 0.0
    inter = _poly_area(inter_poly)
    union = _poly_area(pa) + _poly_area(pb) - inter
    return inter / union if union > 0 else 0.0


@register_element
class YoloObbTensorDecoder(_TensorDecoderBase):
    FACTORY = "yoloobbv8tensordec"
    DESCRIPTION = "Decode YOLOv8 oriented-bounding-box tensors"
    PROPERTIES = {
        "class-confidence-threshold": (float, 0.25, ""),
        "iou-threshold": (float, 0.45, "rotated-IoU NMS threshold"),
        "max-detections": (int, 100, ""),
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
                t = tm.tensor.numpy()
                t = t.reshape(t.shape[-2], t.shape[-1])
                if t.shape[0] < 6:        # 4 + >=1 class + angle
                    continue
                boxes = t[:4]
                scores = t[4:-1]
                angle = t[-1]
                conf = scores.max(axis=0)
                cls = scores.argmax(axis=0)
                keep = conf >= self.props[
                    "class-confidence-threshold"]
                cands = [{"x": float(boxes[0, i] - boxes[2, i] / 2),
                          "y": float(boxes[1, i] - boxes[3, i] / 2),
                          "w": float(boxes[2, i]),
                          "h": float(boxes[3, i]),
                          "angle": float(angle[i]),
                          "conf": float(conf[i]), "cls": int(cls[i])}
                         for i in np.nonzero(keep)[0]]
                cands.sort(key=lambda c: -c["conf"])
                kept: List[dict] = []
                for c in cands:
                    if len(kept) >= self.props["max-detections"]:
                        break
                    if all(_rotated_iou(c, k2)
                           < self.props["iou-threshold"]
                           for k2 in kept):
                        kept.append(c)
                for c in kept:
                    od = rmeta.add(ObjectDetectionMtd(
                        x=c["x"], y=c["y"], w=c["w"], h=c["h"],
                        confidence=c["conf"],
                        label=self._label(c["cls"]),
                        rotation=c["angle"]))
                    rmeta.set_relation(1 << 3, tm, od)
        return buf


@register_element
class FaceDetectorTensorDecoder(_TensorDecoderBase):
    FACTORY = "ultralightfacedetectortensordec"
    DESCRIPTION = "Decode UltraLight face-detection tensors " \
                  "(boxes + background/face scores)"
    PROPERTIES = {
        "score-threshold": (float, 0.7, ""),
        "iou-threshold": (float, 0.5, "hard-NMS threshold"),
        "boxes-tensor-id": (str, "boxes", "[N,4] normalized "
                            "x1,y1,x2,y2"),
        "scores-tensor-id": (str, "scores", "[N,2] bg,face"),
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
            scores = scores.reshape(-1, 2)[:, 1]      # face prob
            keep = scores >= self.props["score-threshold"]
            cands = [{"x": float(boxes[i, 0]),
                      "y": float(boxes[i, 1]),
                      "w": float(boxes[i, 2] - boxes[i, 0]),
                      "h": float(boxes[i, 3] - boxes[i, 1]),
                      "conf": float(scores[i])}
                     for i in np.nonzero(keep)[0]]
            for c in _nms(cands, self.props["iou-threshold"], 200):
                rmeta.add_od_mtd("face", c["x"], c["y"], c["w"],
                                 c["h"], c["conf"])
        return buf


# Fixed color cycle for segment region ids (BT.601-ish primaries)
_SEG_COLORS = np.array([
    [255, 64, 64], [64, 255, 64], [64, 64, 255], [255, 255, 64],
    [255, 64, 255], [64, 255, 255], [255, 160, 64], [160, 64, 255],
], np.uint8)


@register_element
class SegmentationOverlay(TransformElement):
    """segmentationoverlay (ext/analyticsoverlay/
    gstsegmentationoverlay.c): alpha-blends a color-coded rendition of
    every attached segmentation mask onto the frame (masks are scaled
    to the frame with nearest-neighbour, like the reference's
    gst_video_scaler path for mask planes)."""
    FACTORY = "segmentationoverlay"
    DESCRIPTION = "Overlay analytics segmentation masks on video"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _video_caps()),
        PadTemplate("src", PadDirection.SRC, _video_caps()),
    ]
    PROPERTIES = {
        "alpha": (float, 0.5, "mask blend alpha"),
    }

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        metas = relation_meta_of(buf)
        if not metas:
            return buf
        luma_only(self, "blending masks")
        planes = writable_planes(buf)
        y = planes[0]
        h, w = y.shape[-2], y.shape[-1]
        alpha = float(self.props["alpha"])
        for k, rmeta in metas.items():
            for ci, seg in enumerate(rmeta.iter_mtds(SegmentationMtd)):
                if seg.mask is None or seg.mask.size == 0:
                    continue
                mask = np.asarray(seg.mask)
                # nearest-neighbour scale mask -> frame
                yi = (np.arange(h) * mask.shape[0] // h)
                xi = (np.arange(w) * mask.shape[1] // w)
                up = mask[yi[:, None], xi[None, :]] > 0
                lum = int(_SEG_COLORS[ci % len(_SEG_COLORS)].mean())
                tgt = y[k] if y.ndim == 3 else y
                blended = (tgt * (1 - alpha) + lum * alpha)
                tgt[...] = np.where(
                    up, blended.astype(tgt.dtype), tgt)
        dev = [device_array(p, buf.data) for p in planes]
        return buf.with_(data=tuple(dev) if len(dev) > 1 else dev[0])
