"""Analytics relation metadata — the ML-meta layer.

Reference: gst-plugins-bad/gst-libs/gst/analytics/ —
gstanalyticsmeta.c (GstAnalyticsRelationMeta: a growable container of
"Mtd" entries plus an adjacency matrix of typed relations,
:196-212 relation enum), gstanalyticsobjectdetectionmtd.c (location +
confidence + object label), gstanalyticsclassificationmtd.c (parallel
label/confidence arrays), gstanalyticsobjecttrackingmtd.c (track id +
first/last observation + lost flag), gstanalyticssegmentationmtd.c
(mask tensor + region ids), gsttensor.c / gsttensormeta.c (named
N-dim tensors riding on buffers).

A copy of the JAX package's ``analytics/meta.py``.  A Tensor holds a numpy
array or a torch tensor, on the host or on the card; ``Tensor.numpy()``
returns the host array (a tensor on the card is copied).  Metas ride in
Buffer.meta["analytics"] (one RelationMeta per frame batch entry is the
reference's per-buffer granularity; batched buffers carry a dict by
entry).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

REL_TYPE_NONE = 0
REL_TYPE_IS_PART_OF = 1 << 1
REL_TYPE_CONTAIN = 1 << 2
REL_TYPE_RELATE_TO = 1 << 3
REL_TYPE_ANY = (REL_TYPE_IS_PART_OF | REL_TYPE_CONTAIN
                | REL_TYPE_RELATE_TO)


def _host(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.cpu().numpy()
    return np.asarray(data)


@dataclass
class Tensor:
    """gst_tensor: named n-dim data (dims in row-major order)."""
    id: str
    data: Any                           # np.ndarray or torch.Tensor
    dims: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.dims is None:
            self.dims = tuple(self.data.shape
                              if isinstance(self.data, torch.Tensor)
                              else np.asarray(self.data).shape)

    def numpy(self) -> np.ndarray:
        return _host(self.data)


class _Mtd:
    """Base handle; `mtd_id` is assigned by the RelationMeta."""
    mtd_id: int = -1


@dataclass
class ObjectDetectionMtd(_Mtd):
    x: float = 0.0
    y: float = 0.0
    w: float = 0.0
    h: float = 0.0
    confidence: float = 0.0
    label: str = ""
    rotation: float = 0.0     # radians, oriented boxes (gst 1.28 OBB)

    def get_location(self):
        return self.x, self.y, self.w, self.h, self.confidence

    def iou(self, other: "ObjectDetectionMtd") -> float:
        x1 = max(self.x, other.x)
        y1 = max(self.y, other.y)
        x2 = min(self.x + self.w, other.x + other.w)
        y2 = min(self.y + self.h, other.y + other.h)
        inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
        union = self.w * self.h + other.w * other.h - inter
        return inter / union if union > 0 else 0.0


@dataclass
class ClassificationMtd(_Mtd):
    labels: List[str] = field(default_factory=list)
    confidences: List[float] = field(default_factory=list)

    def top(self) -> Tuple[str, float]:
        if not self.labels:
            return "", 0.0
        i = int(np.argmax(self.confidences))
        return self.labels[i], self.confidences[i]


@dataclass
class TrackingMtd(_Mtd):
    track_id: int = 0
    first_seen: int = 0                 # ns timestamps
    last_seen: int = 0
    lost: bool = False


@dataclass
class SegmentationMtd(_Mtd):
    mask: Optional[np.ndarray] = None   # (h, w) region-id map
    region_ids: List[int] = field(default_factory=list)


@dataclass
class TensorMtd(_Mtd):
    tensor: Optional[Tensor] = None


class RelationMeta:
    """gst_analytics_relation_meta: ordered mtd store + typed
    relation adjacency."""

    def __init__(self):
        self._mtds: List[_Mtd] = []
        self._rel: Dict[Tuple[int, int], int] = {}

    def add(self, mtd: _Mtd) -> _Mtd:
        mtd.mtd_id = len(self._mtds)
        self._mtds.append(mtd)
        return mtd

    def add_od_mtd(self, label, x, y, w, h,
                   confidence=0.0) -> ObjectDetectionMtd:
        return self.add(ObjectDetectionMtd(
            x=float(x), y=float(y), w=float(w), h=float(h),
            confidence=float(confidence), label=str(label)))

    def add_cls_mtd(self, confidences: Sequence[float],
                    labels: Sequence[str]) -> ClassificationMtd:
        return self.add(ClassificationMtd(
            labels=list(labels),
            confidences=[float(c) for c in confidences]))

    def add_trk_mtd(self, track_id: int,
                    ts: int = 0) -> TrackingMtd:
        return self.add(TrackingMtd(track_id=track_id, first_seen=ts,
                                    last_seen=ts))

    def add_tensor_mtd(self, tensor: Tensor) -> TensorMtd:
        return self.add(TensorMtd(tensor=tensor))

    def add_segmentation_mtd(self, mask: np.ndarray,
                             region_ids=()) -> SegmentationMtd:
        return self.add(SegmentationMtd(mask=mask,
                                        region_ids=list(region_ids)))

    # -- relations ---------------------------------------------------------
    def set_relation(self, rel_type: int, a: _Mtd, b: _Mtd) -> None:
        key = (a.mtd_id, b.mtd_id)
        self._rel[key] = self._rel.get(key, 0) | rel_type

    def get_relation(self, a: _Mtd, b: _Mtd) -> int:
        return self._rel.get((a.mtd_id, b.mtd_id), REL_TYPE_NONE)

    def exists(self, a: _Mtd, b: _Mtd,
               rel_type: int = REL_TYPE_ANY) -> bool:
        return bool(self.get_relation(a, b) & rel_type)

    def related_to(self, a: _Mtd, rel_type: int = REL_TYPE_ANY,
                   mtd_cls=None) -> List[_Mtd]:
        out = []
        for b in self._mtds:
            if b is a:
                continue
            if self.get_relation(a, b) & rel_type:
                if mtd_cls is None or isinstance(b, mtd_cls):
                    out.append(b)
        return out

    # -- iteration ---------------------------------------------------------
    def iter_mtds(self, mtd_cls=None) -> List[_Mtd]:
        if mtd_cls is None:
            return list(self._mtds)
        return [m for m in self._mtds if isinstance(m, mtd_cls)]

    def __len__(self):
        return len(self._mtds)


def get_relation_meta(buf, index: int = 0,
                      create: bool = False) -> Optional[RelationMeta]:
    """Fetch (or attach) the RelationMeta for batch entry `index` of
    a Buffer (gst_buffer_get_analytics_relation_meta)."""
    metas = (buf.meta or {}).get("analytics")
    if metas is None:
        if not create:
            return None
        metas = {}
        buf.meta = dict(buf.meta or {}, analytics=metas)
    if index not in metas and create:
        metas[index] = RelationMeta()
    return metas.get(index)


def relation_meta_of(buf) -> Dict[int, RelationMeta]:
    return (buf.meta or {}).get("analytics", {})
