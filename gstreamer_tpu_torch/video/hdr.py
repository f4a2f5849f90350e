"""HDR metadata + convertframe + navigation events.

TPU-native equivalents of the peripheral video-lib pieces:
* video-hdr.c — mastering display info + content light level structs
  with the caps string encoding used in GStreamer caps;
* convertframe.c:984 — gst_video_convert_sample: one-shot snapshot
  conversion through the converter;
* navigation.c — navigation event constructors (key/mouse) delivered
  upstream through the event flow.

A port of the JAX package's ``video/hdr.py``.  ``convert_sample`` runs the
port's ``VideoConverter`` on the caller's device (CUDA unless ``device``
names another; no fallback to the CPU), where the JAX package runs the
converter's numpy gold: the bytes are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..core.events import Event, EventType


@dataclass(frozen=True)
class MasteringDisplayInfo:
    """gst_video_mastering_display_info: CIE xy primaries (0.00002
    units), white point, luminance (max in 1 cd/m2, min in 0.0001)."""
    display_primaries: Tuple[Tuple[int, int], ...]   # 3x (x, y)
    white_point: Tuple[int, int]
    max_display_mastering_luminance: int
    min_display_mastering_luminance: int

    def to_string(self) -> str:
        p = self.display_primaries
        w = self.white_point
        return (f"{p[0][0]}:{p[0][1]}:{p[1][0]}:{p[1][1]}:"
                f"{p[2][0]}:{p[2][1]}:{w[0]}:{w[1]}:"
                f"{self.max_display_mastering_luminance}:"
                f"{self.min_display_mastering_luminance}")

    @classmethod
    def from_string(cls, s: str) -> "MasteringDisplayInfo":
        v = [int(x) for x in s.split(":")]
        if len(v) != 10:
            raise ValueError(f"bad mastering-display-info {s!r}")
        return cls(((v[0], v[1]), (v[2], v[3]), (v[4], v[5])),
                   (v[6], v[7]), v[8], v[9])


@dataclass(frozen=True)
class ContentLightLevel:
    """gst_video_content_light_level (maxCLL:maxFALL, cd/m2)."""
    max_content_light_level: int
    max_frame_average_light_level: int

    def to_string(self) -> str:
        return (f"{self.max_content_light_level}:"
                f"{self.max_frame_average_light_level}")

    @classmethod
    def from_string(cls, s: str) -> "ContentLightLevel":
        a, b = (int(x) for x in s.split(":"))
        return cls(a, b)


# ---------------------------------------------------------------------------
# convertframe.c — one-shot sample conversion
# ---------------------------------------------------------------------------

def convert_sample(planes, from_caps, to_caps, config=None, device=None):
    """gst_video_convert_sample: convert one frame between caps
    (snapshot path).  planes: component planes per from_caps (numpy
    arrays or tensors, optionally batched in front); returns component
    planes per to_caps, tensors on `device` (CUDA unless it names
    another), the bytes of the reference arithmetic."""
    from ..core.caps import Caps
    from .converter import VideoConverter
    from .info import VideoInfo

    if isinstance(from_caps, str):
        from_caps = Caps.from_string(from_caps)
    if isinstance(to_caps, str):
        to_caps = Caps.from_string(to_caps)
    ii = VideoInfo.from_caps_structure(from_caps[0])
    oi = VideoInfo.from_caps_structure(to_caps[0])
    return VideoConverter(ii, oi, config, device=device).convert(planes)


# ---------------------------------------------------------------------------
# navigation.c — navigation events (upstream)
# ---------------------------------------------------------------------------

def navigation_key_event(action: str, key: str) -> Event:
    """gst_navigation_event_new_key_* (action: key-press|key-release)."""
    return Event(EventType.CUSTOM_UPSTREAM,
                 {"structure": "application/x-gst-navigation",
                  "event": action, "key": key})


def navigation_mouse_event(action: str, x: float, y: float,
                           button: int = 0) -> Event:
    """mouse-move / mouse-button-press / mouse-button-release."""
    return Event(EventType.CUSTOM_UPSTREAM,
                 {"structure": "application/x-gst-navigation",
                  "event": action, "pointer_x": x, "pointer_y": y,
                  "button": button})
