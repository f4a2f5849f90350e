"""Queries — synchronous introspection of element state (host only).

A copy of the JAX package's ``core/query.py``: GstQuery (reference:
subprojects/gstreamer/gst/gstquery.c — CAPS, ACCEPT_CAPS, ALLOCATION,
LATENCY, POSITION, DURATION, SEEKING; dispatch gstpad.c gst_pad_query).

A Query is a mutable request object: the asker constructs it, `query()`
handlers fill `result` and return True when answered.  The graph is on the
host, so dispatch is a direct recursive walk.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class QueryType:
    POSITION = "position"          # gstquery.c gst_query_new_position
    DURATION = "duration"
    LATENCY = "latency"
    SEEKING = "seeking"
    CAPS = "caps"
    ACCEPT_CAPS = "accept-caps"
    ALLOCATION = "allocation"
    CONTEXT = "context"
    CUSTOM = "custom"


@dataclass
class Query:
    type: str
    # request parameters (e.g. {"format": "time"} or {"caps": Caps})
    params: Dict[str, Any] = field(default_factory=dict)
    # answer, filled by the handler
    result: Dict[str, Any] = field(default_factory=dict)

    def __repr__(self):
        return f"<Query {self.type} {self.params} -> {self.result}>"


def position_query() -> Query:
    return Query(QueryType.POSITION, {"format": "time"})


def duration_query() -> Query:
    return Query(QueryType.DURATION, {"format": "time"})


def latency_query() -> Query:
    return Query(QueryType.LATENCY)


def seeking_query() -> Query:
    return Query(QueryType.SEEKING, {"format": "time"})


def caps_query(filter=None) -> Query:
    return Query(QueryType.CAPS, {"filter": filter})


def accept_caps_query(caps) -> Query:
    return Query(QueryType.ACCEPT_CAPS, {"caps": caps})


def allocation_query(caps) -> Query:
    return Query(QueryType.ALLOCATION, {"caps": caps})
