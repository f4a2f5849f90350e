"""Audio stream alignment (gstaudiostreamalign.c, 477 LoC).

Tracks expected timestamps against incoming buffer timestamps and
flags/repairs discontinuities: small drifts within the alignment
threshold are smoothed to the expected timeline; persistent drift
beyond `discont_wait` resyncs to the incoming timestamps.

A copy of the JAX package's ``audio/streamalign.py``: timestamps are
host integers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class AudioStreamAlign:
    rate: int
    alignment_threshold: int = 40_000_000      # ns (property default)
    discont_wait: int = 1_000_000_000

    def __post_init__(self):
        self._timestamp: Optional[int] = None   # expected next pts
        self._samples = 0                       # samples since resync
        self._t0 = 0
        self._drift_start: Optional[int] = None

    def mark_discont(self):
        self._timestamp = None
        self._drift_start = None

    def process(self, pts: Optional[int],
                n_samples: int) -> Tuple[int, int, bool]:
        """-> (out_pts, out_duration, discont).

        gst_audio_stream_align_process: aligned output timestamps come
        from the sample counter; input drift within the threshold is
        absorbed, longer drift (for discont_wait) resyncs."""
        duration = n_samples * 1_000_000_000 // self.rate
        discont = False
        if self._timestamp is None:
            # first buffer / after discont: adopt input timeline
            self._t0 = pts or 0
            self._samples = 0
            self._timestamp = self._t0
            discont = True
        expected = self._t0 + self._samples * 1_000_000_000 // self.rate
        if pts is not None:
            drift = abs(pts - expected)
            if drift > self.alignment_threshold:
                if self._drift_start is None:
                    self._drift_start = pts
                    self._drift_elapsed = 0
                self._drift_elapsed = getattr(self, "_drift_elapsed", 0) \
                    + duration
                if (drift > self.discont_wait
                        or self._drift_elapsed >= self.discont_wait):
                    # resync to the input timeline
                    self._t0 = pts
                    self._samples = 0
                    self._drift_start = None
                    expected = pts
                    discont = True
            else:
                self._drift_start = None
        out_pts = expected
        self._samples += n_samples
        return out_pts, duration, discont
