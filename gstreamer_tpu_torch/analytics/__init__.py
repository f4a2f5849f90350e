"""Analytics/ML metadata library (gst-libs/gst/analytics port)."""

from .meta import (REL_TYPE_CONTAIN, REL_TYPE_IS_PART_OF,
                   REL_TYPE_NONE, REL_TYPE_RELATE_TO,
                   ClassificationMtd, ObjectDetectionMtd,
                   RelationMeta, SegmentationMtd, Tensor, TensorMtd,
                   TrackingMtd, get_relation_meta,
                   relation_meta_of)

__all__ = [
    "RelationMeta", "Tensor", "TensorMtd", "ObjectDetectionMtd",
    "ClassificationMtd", "TrackingMtd", "SegmentationMtd",
    "REL_TYPE_NONE", "REL_TYPE_IS_PART_OF", "REL_TYPE_CONTAIN",
    "REL_TYPE_RELATE_TO", "get_relation_meta", "relation_meta_of",
]
