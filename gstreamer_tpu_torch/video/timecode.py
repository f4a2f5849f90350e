"""SMPTE timecode arithmetic (gstvideotimecode.c, 1102 LoC).

Supports drop-frame and non-drop-frame timecodes, frame<->timecode
conversion, increment, nsec conversion, and string parsing — the
arithmetic surface of GstVideoTimeCode.

A copy of the JAX package's ``video/timecode.py`` (host integers only).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from ..core.value import Fraction


class TimeCodeFlags:
    NONE = 0
    DROP_FRAME = 1 << 0
    INTERLACED = 1 << 1


@dataclass
class VideoTimeCode:
    fps: Fraction = field(default_factory=lambda: Fraction(30, 1))
    flags: int = TimeCodeFlags.NONE
    hours: int = 0
    minutes: int = 0
    seconds: int = 0
    frames: int = 0
    field_count: int = 0

    def _fps_int(self) -> int:
        return -(-self.fps.num // self.fps.denom)

    def _drop(self) -> int:
        # 29.97 drops 2/minute, 59.94 drops 4 (gstvideotimecode.c)
        return (self.fps.num // 1000) // 15 \
            if self.flags & TimeCodeFlags.DROP_FRAME else 0

    # -- validity (gst_video_time_code_is_valid) ---------------------------
    def is_valid(self) -> bool:
        if not (0 <= self.hours < 24 and 0 <= self.minutes < 60
                and 0 <= self.seconds < 60
                and 0 <= self.frames < max(self._fps_int(), 1)):
            return False
        if self.flags & TimeCodeFlags.DROP_FRAME:
            if self.fps.denom != 1001:
                return False
            if (self.minutes % 10 and self.seconds == 0
                    and self.frames < self._drop()):
                return False
        return True

    # -- conversions --------------------------------------------------------
    def frames_since_daily_jam(self) -> int:
        """gst_video_time_code_frames_since_daily_jam."""
        fi = self._fps_int()
        base = (self.frames + fi * (self.seconds + 60 * self.minutes
                                    + 3600 * self.hours))
        d = self._drop()
        if d:
            total_minutes = 60 * self.hours + self.minutes
            base -= d * (total_minutes - total_minutes // 10)
        return base

    @classmethod
    def from_frames(cls, frames: int, fps: Fraction,
                    flags: int = TimeCodeFlags.NONE) -> "VideoTimeCode":
        return cls(fps=fps, flags=flags).add_frames(frames)

    def add_frames(self, n: int) -> "VideoTimeCode":
        """gst_video_time_code_add_frames (returns a new timecode)."""
        fi = self._fps_int()
        total = self.frames_since_daily_jam() + n
        d = self._drop()
        if d:
            fpm = 60 * fi - d                       # dropped minute
            fp10 = 10 * fpm + d                     # 10-minute block
            tens, rem = divmod(total, fp10)
            if rem < 60 * fi:                       # minute 0: no drop
                ones = 0
                in_min = rem
            else:
                ones = 1 + (rem - 60 * fi) // fpm
                in_min = (rem - 60 * fi) % fpm + d
            minutes = 10 * tens + ones
            sec, fr = divmod(in_min, fi)
            h, m = divmod(minutes, 60)
            return replace(self, hours=h % 24, minutes=m, seconds=sec,
                           frames=fr)
        fr = total % fi
        total //= fi
        sec = total % 60
        total //= 60
        m = total % 60
        h = (total // 60) % 24
        return replace(self, hours=h, minutes=m, seconds=sec, frames=fr)

    def increment(self) -> "VideoTimeCode":
        return self.add_frames(1)

    def to_ns(self) -> int:
        """gst_video_time_code_nsec_since_daily_jam."""
        return (self.frames_since_daily_jam() * 1_000_000_000
                * self.fps.denom // self.fps.num)

    def to_string(self) -> str:
        sep = ";" if self.flags & TimeCodeFlags.DROP_FRAME else ":"
        return (f"{self.hours:02d}:{self.minutes:02d}:"
                f"{self.seconds:02d}{sep}{self.frames:02d}")

    @classmethod
    def from_string(cls, s: str, fps: Fraction) -> "VideoTimeCode":
        drop = ";" in s
        parts = s.replace(";", ":").split(":")
        h, m, sec, fr = (int(x) for x in parts)
        return cls(fps=fps, hours=h, minutes=m, seconds=sec, frames=fr,
                   flags=TimeCodeFlags.DROP_FRAME if drop else 0)
