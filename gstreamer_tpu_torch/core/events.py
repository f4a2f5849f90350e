"""Events — control-plane stream signals (host only).

A copy of the JAX package's ``core/events.py``: GstEvent (reference:
subprojects/gstreamer/gst/gstevent.c — sticky STREAM_START/CAPS/SEGMENT/
TAG/EOS, FLUSH_START/STOP, upstream QOS :1224, SEEK, RECONFIGURE).  Caps
are fixed pad state after negotiation; the pipeline replays the sticky
events through the pads when it starts, and pushes EOS at the end.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class EventType:
    STREAM_START = "stream-start"
    CAPS = "caps"
    SEGMENT = "segment"
    TAG = "tag"
    EOS = "eos"
    FLUSH_START = "flush-start"
    FLUSH_STOP = "flush-stop"
    SEEK = "seek"
    RECONFIGURE = "reconfigure"
    GAP = "gap"
    QOS = "qos"
    CUSTOM_DOWNSTREAM = "custom-downstream"
    CUSTOM_UPSTREAM = "custom-upstream"

    STICKY = {STREAM_START, CAPS, SEGMENT, TAG, EOS}


@dataclass
class Event:
    type: str
    data: Dict[str, Any] = field(default_factory=dict)

    @property
    def is_sticky(self) -> bool:
        return self.type in EventType.STICKY

    def __repr__(self):
        return f"<Event {self.type} {self.data}>"


def seek_event(start: int, stop: Optional[int] = None, rate: float = 1.0,
               flush: bool = True) -> Event:
    return Event(EventType.SEEK, {"start": start, "stop": stop,
                                  "rate": rate, "flush": flush})


def stream_start_event(stream_id: str) -> Event:
    """gst_event_new_stream_start (gstevent.c)."""
    return Event(EventType.STREAM_START, {"stream-id": stream_id})


def caps_event(caps) -> Event:
    """gst_event_new_caps (gstevent.c:905) — sticky, per-pad."""
    return Event(EventType.CAPS, {"caps": caps})


def segment_event(segment) -> Event:
    return Event(EventType.SEGMENT, {"segment": segment})


def tag_event(tags) -> Event:
    return Event(EventType.TAG, {"tags": tags})


def eos_event() -> Event:
    return Event(EventType.EOS)


def gap_event(pts: int, duration: int) -> Event:
    """gst_event_new_gap: 'no data for this interval' marker."""
    return Event(EventType.GAP, {"pts": pts, "duration": duration})


def reconfigure_event() -> Event:
    """gst_event_new_reconfigure — upstream 'renegotiate please'."""
    return Event(EventType.RECONFIGURE)


def qos_event(qtype: str, proportion: float, diff: int,
              timestamp: int) -> Event:
    """gst_event_new_qos (gstevent.c:1224) — upstream."""
    return Event(EventType.QOS, {"qos-type": qtype,
                                 "proportion": proportion,
                                 "diff": diff, "timestamp": timestamp})


def flush_start_event() -> Event:
    return Event(EventType.FLUSH_START)


def flush_stop_event(reset_time: bool = True) -> Event:
    return Event(EventType.FLUSH_STOP, {"reset-time": reset_time})


UPSTREAM_TYPES = {EventType.SEEK, EventType.QOS, EventType.RECONFIGURE,
                  EventType.CUSTOM_UPSTREAM}

