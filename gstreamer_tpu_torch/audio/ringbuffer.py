"""Audio ring buffer — GstAudioRingBuffer equivalent (reduced).

A copy of the JAX package's ``audio/ringbuffer.py``: host numpy, as the
sinks that own it take their samples to the host.

Reference: gst-plugins-base/gst-libs/gst/audio/gstaudioringbuffer.c —
a segment ring between the streaming side (commit at sample offsets)
and the device side (segdone advances as segments play out).  The
reduced model keeps the segment accounting exact (segdone/segbase,
delay = queued samples, samples_done = played samples, commit clipping
of samples that fall behind the playout position or beyond the ring
capacity) but replaces the device thread with an explicit `advance()`
the owner drives (a test clock, a sink's pace loop, or a real audio
callback).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .info import AudioInfo


class AudioRingBufferSpec:
    """gstringbuffer spec: latency/buffer times in ns -> segment
    geometry (gst_audio_ring_buffer_parse_caps semantics)."""

    def __init__(self, info: AudioInfo, latency_time: int = 10_000_000,
                 buffer_time: int = 200_000_000):
        self.info = info
        self.latency_time = latency_time
        self.buffer_time = buffer_time
        bpf = info.bpf
        # segsize = latency_time worth of samples (rounded to frames)
        spf = max(1, info.rate * latency_time // 1_000_000_000)
        self.segsize = spf * bpf
        self.segtotal = max(2, buffer_time // latency_time)

    @property
    def samples_per_seg(self) -> int:
        return self.segsize // self.info.bpf


class AudioRingBuffer:
    """Segment ring with GStreamer's accounting semantics."""

    def __init__(self):
        self.spec: Optional[AudioRingBufferSpec] = None
        self._data: Optional[np.ndarray] = None
        self.segdone = 0            # segments fully processed by device
        self.segbase = 0            # segment corresponding to sample 0
        self._started = False
        self._callback: Optional[Callable[[int], None]] = None
        self.acquired = False

    # -- lifecycle (gst_audio_ring_buffer_acquire/release) ------------------
    def acquire(self, spec: AudioRingBufferSpec) -> bool:
        self.spec = spec
        sps = spec.samples_per_seg
        self._data = np.zeros(
            (spec.segtotal, sps, spec.info.channels),
            np.int16 if not spec.info.finfo.is_float else np.float32)
        self.segdone = 0
        self.segbase = 0
        self.acquired = True
        return True

    def release(self) -> bool:
        self._data = None
        self.acquired = False
        return True

    def start(self) -> bool:
        self._started = True
        return True

    def pause(self) -> bool:
        self._started = False
        return True

    def stop(self) -> bool:
        self._started = False
        return True

    def is_started(self) -> bool:
        return self._started

    def set_callback(self, cb: Optional[Callable[[int], None]]) -> None:
        """cb(segment_index) fires when the device consumes a segment."""
        self._callback = cb

    # -- accounting ----------------------------------------------------------
    def samples_done(self) -> int:
        """gst_audio_ring_buffer_samples_done: samples played out."""
        return (self.segdone - self.segbase) * self.spec.samples_per_seg

    def delay(self) -> int:
        """gst_audio_ring_buffer_delay: samples committed but not yet
        played (the written high-water mark minus samples_done)."""
        return max(0, self._high_water - self.samples_done())

    _high_water = 0

    def clear_all(self) -> None:
        if self._data is not None:
            self._data[:] = 0
        self.segbase = self.segdone
        self._high_water = 0

    # -- streaming side -------------------------------------------------------
    def commit(self, sample: int, data: np.ndarray) -> int:
        """Write sample frames at absolute sample offset `sample`.

        Samples already played (behind samples_done) are clipped; writes
        beyond the ring capacity (samples_done + segtotal*sps) are
        clipped too (the reference blocks there; the reduced model is
        non-blocking and reports what fit).  Returns frames written."""
        assert self.acquired
        sps = self.spec.samples_per_seg
        n = data.shape[0]
        lo = self.samples_done()
        hi = lo + self.spec.segtotal * sps
        begin = max(sample, lo)
        end = min(sample + n, hi)
        if end <= begin:
            return 0
        src = data[begin - sample:end - sample]
        pos = np.arange(begin, end)
        seg = (self.segbase + pos // sps) % self.spec.segtotal
        self._data[seg, pos % sps] = src
        self._high_water = max(self._high_water, end)
        return int(end - begin)

    def read(self, sample: int, n: int) -> np.ndarray:
        sps = self.spec.samples_per_seg
        pos = np.arange(sample, sample + n)
        seg = (self.segbase + pos // sps) % self.spec.segtotal
        return self._data[seg, pos % sps].copy()

    # -- device side -----------------------------------------------------------
    def advance(self, n_segments: int = 1) -> None:
        """Device consumed n segments (gst_audio_ring_buffer_advance):
        clears them for reuse and fires the refill callback."""
        for _ in range(n_segments):
            seg = self.segdone % self.spec.segtotal
            self._data[seg] = 0
            self.segdone += 1
            if self._callback is not None:
                self._callback(seg)
