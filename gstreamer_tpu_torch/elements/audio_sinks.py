"""Audio sink scaffolding — GstAudioBaseSink equivalent (reduced) and a
fakeaudiosink-style concrete sink.

Reference: gst-plugins-base/gst-libs/gst/audio/gstaudiobasesink.c —
buffers are aligned into the ring buffer at the sample position implied
by their timestamps; small timestamp drift (below alignment-threshold)
is ignored in favor of sample continuity, larger drift resyncs
(gst_audio_base_sink_get_alignment), and the `skew` slave method tracks
clock skew between pipeline time and ring playout.  The reduced model
keeps the alignment/resync accounting and drives the ring's device side
from buffer durations (no realtime audio device exists here).

A copy of the JAX package's ``elements/audio_sinks.py``: the ring lives on
the host (``audio/ringbuffer.py``), so ``render`` takes each buffer's
samples there.
"""

from __future__ import annotations

from typing import Optional

from ..audio.info import AudioInfo
from ..audio.ringbuffer import AudioRingBuffer, AudioRingBufferSpec
from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            register_element)

AUDIO_SINK_CAPS = ("audio/x-raw, format=S16LE, layout=interleaved, "
                   "rate=[1,2147483647], channels=[1,64]")


class AudioBaseSink(SinkElement):
    """Ring-buffer-backed audio sink scaffold."""

    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 AUDIO_SINK_CAPS)]
    PROPERTIES = {
        "latency-time": (int, 10_000, "ring segment length (us)"),
        "buffer-time": (int, 200_000, "ring total length (us)"),
        "alignment-threshold": (int, 40_000_000,
                                "timestamp drift tolerated before a "
                                "resync (ns)"),
        "slave-method": (str, "skew", "none | skew"),
        "drift-tolerance": (int, 40_000, "skew slaving tolerance (us)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.ring = AudioRingBuffer()
        self._info: Optional[AudioInfo] = None
        self._next_sample: Optional[int] = None
        self._resyncs = 0
        self._skew_shift_ns = 0

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def start(self):
        info = self._info
        spec = AudioRingBufferSpec(
            info, latency_time=self.props["latency-time"] * 1000,
            buffer_time=self.props["buffer-time"] * 1000)
        self.ring.acquire(spec)
        self.ring.start()
        self._next_sample = None
        self._resyncs = 0
        self._skew_shift_ns = 0

    def stop(self):
        if self.ring.acquired:
            self.ring.stop()
            self.ring.release()

    # -- alignment (gst_audio_base_sink_get_alignment, reduced) -------------
    def _align(self, pts: Optional[int], n: int) -> int:
        rate = self._info.rate
        if pts is None:
            ts_sample = self._next_sample or 0
        else:
            ts_sample = (pts + self._skew_shift_ns) * rate // 1_000_000_000
        if self._next_sample is None:
            return ts_sample
        diff_ns = abs(ts_sample - self._next_sample) * 1_000_000_000 // rate
        if diff_ns <= self.props["alignment-threshold"]:
            # tolerate drift: keep sample continuity
            return self._next_sample
        self._resyncs += 1
        if self.props["slave-method"] == "skew":
            # resync by shifting our notion of pipeline time so the
            # stream continues from the next ring sample (skew slaving)
            self._skew_shift_ns += (self._next_sample - ts_sample) \
                * 1_000_000_000 // rate
            return self._next_sample
        return ts_sample

    def render(self, buf: Buffer) -> str:
        samples = host_array(buf.data)
        if samples.ndim == 1:
            samples = samples[:, None]
        n = samples.shape[0]
        write_at = self._align(buf.pts, n)
        self.ring.commit(write_at, samples.astype(self.ring._data.dtype))
        self._next_sample = write_at + n
        # device side: consume whatever full segments are now queued
        # (no realtime device — playout paces with the stream)
        sps = self.ring.spec.samples_per_seg
        while self.ring.delay() >= 2 * sps:
            self.ring.advance()
        return FlowReturn.OK

    # -- introspection ---------------------------------------------------------
    @property
    def resync_count(self) -> int:
        return self._resyncs


@register_element
class FakeAudioSink(AudioBaseSink):
    """fakeaudiosink (gst-plugins-bad/gst/debugutils/gstfakeaudiosink.c
    capability): a sink with real audio-sink semantics and no device."""
    FACTORY = "fakeaudiosink"
    DESCRIPTION = "Fake audio renderer with audio-sink timing semantics"
