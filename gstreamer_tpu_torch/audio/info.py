"""AudioInfo — negotiated per-stream audio configuration.

A copy of the JAX package's ``audio/info.py`` (GstAudioInfo, reference:
gst-libs/gst/audio/audio-info.c — rate/channels/layout -> bpf;
audio-channels.c default positions) over the port's own Structure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..core.structure import Structure
from .format import AudioFormatInfo, format_info

# channel positions (GstAudioChannelPosition subset)
MONO = "mono"
FL, FR, FC = "front-left", "front-right", "front-center"
LFE1 = "lfe1"
RL, RR, RC = "rear-left", "rear-right", "rear-center"
FLC, FRC = "front-left-of-center", "front-right-of-center"
SL, SR = "side-left", "side-right"

# default positions per channel count (gst_audio_channel_positions_from_mask
# defaults, audio-channels.c)
DEFAULT_POSITIONS = {
    1: (MONO,),
    2: (FL, FR),
    3: (FL, FR, FC),
    4: (FL, FR, RL, RR),
    5: (FL, FR, FC, RL, RR),
    6: (FL, FR, FC, LFE1, RL, RR),
    7: (FL, FR, FC, LFE1, RL, RR, RC),
    8: (FL, FR, FC, LFE1, RL, RR, SL, SR),
}


@dataclass(frozen=True)
class AudioInfo:
    format: str = "S16LE"
    rate: int = 44100
    channels: int = 2
    layout: str = "interleaved"
    positions: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        _ = self.finfo
        if self.positions is None:
            object.__setattr__(
                self, "positions",
                DEFAULT_POSITIONS.get(self.channels,
                                      tuple(f"ch{i}" for i in range(self.channels))))

    @property
    def finfo(self) -> AudioFormatInfo:
        return format_info(self.format)

    @property
    def bpf(self) -> int:
        """bytes per frame"""
        return (self.finfo.width // 8) * self.channels

    def to_caps_structure(self) -> Structure:
        return Structure("audio/x-raw", format=self.format, rate=self.rate,
                         channels=self.channels, layout=self.layout)

    @staticmethod
    def from_caps_structure(s: Structure) -> "AudioInfo":
        if s.name != "audio/x-raw":
            raise ValueError(f"not raw audio caps: {s!r}")
        return AudioInfo(
            format=s.get("format", "S16LE"),
            rate=int(s.get("rate", 44100)),
            channels=int(s.get("channels", 2)),
            layout=s.get("layout", "interleaved"),
        )
