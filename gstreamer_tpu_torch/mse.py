"""W3C Media Source Extensions API (GstMediaSource analog).

Reference: gst-plugins-bad/gst-libs/gst/mse/ — gstmediasource.c
(GstMediaSource entry point), gstsourcebuffer.c (append/abort/remove,
buffered ranges), gstmsesrc.c (the msesrc element a MediaSource
attaches to).  The reference runs appended bytes through an internal
append-pipeline (parsebin); here appended segments accumulate per
SourceBuffer and the attached msesrc element demuxes/decodes them
with the framework's own container elements when the pipeline runs.

Usage mirrors the W3C shape:

    ms = MediaSource()
    src = element_factory_make("msesrc")
    ms.attach(src)
    sb = ms.add_source_buffer("video/webm")
    sb.append_buffer(webm_bytes)
    ms.end_of_stream()
    # run the pipeline containing `src`

A port of the JAX package's ``mse.py``.  msesrc's inner demux (and decode)
chain is a ``playback._ChainSrc`` on msesrc's own device: the outer
pipeline's, set at its compile, or CUDA unless ``device`` names another.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .core.buffer import Buffer
from .core.caps import Caps
from .core.element import (PadDirection, PadTemplate, SourceElement,
                           register_element)


class SourceBuffer:
    """gstsourcebuffer.c analog: a byte accumulator with W3C-style
    state (updating flag, buffered ranges, timestamp-offset)."""

    def __init__(self, media_source: "MediaSource", mime: str):
        self._ms = media_source
        self.content_type = mime
        self.updating = False
        self.timestamp_offset = 0.0
        self.append_window_start = 0.0
        self.append_window_end = float("inf")
        self._data = bytearray()
        self._aborted = False
        self.on_update = None          # callback(self)

    def append_buffer(self, data: bytes) -> bool:
        if self._ms.ready_state == "closed":
            raise RuntimeError("source buffer: MediaSource closed")
        if self.updating:
            raise RuntimeError("source buffer: append in progress")
        self.updating = True
        try:
            self._data += bytes(data)
            if self._ms.ready_state == "ended":
                self._ms.ready_state = "open"
        finally:
            self.updating = False
        if self.on_update:
            self.on_update(self)
        return True

    def abort(self) -> None:
        self._aborted = True
        self.updating = False

    def remove(self, start: float, end: float) -> None:
        if start >= end:
            raise ValueError("source buffer: invalid remove range")
        # byte-accurate removal needs a parse; the reduced model only
        # supports removing everything (the common eviction pattern)
        if start <= 0 and end >= self._duration_estimate():
            self._data.clear()

    @property
    def buffered(self) -> List[Tuple[float, float]]:
        d = self._duration_estimate()
        return [(0.0, d)] if d else []

    def _duration_estimate(self) -> float:
        if not self._data:
            return 0.0
        import os
        import tempfile
        from .utils.discoverer import Discoverer
        fd, path = tempfile.mkstemp(suffix=".mse")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(self._data)
            info = Discoverer().discover(path)
            if info.duration_ns:
                return info.duration_ns / 1e9
            return 0.0
        except Exception:
            return 0.0
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass

    def bytes(self) -> bytes:
        return bytes(self._data)


class MediaSource:
    """gstmediasource.c analog: ready-state machine + source-buffer
    registry, attachable to a msesrc element."""

    def __init__(self):
        self.ready_state = "closed"
        self.duration = float("nan")
        self.source_buffers: List[SourceBuffer] = []
        self._src: Optional["MseSrc"] = None
        self.live_seekable_range: Optional[Tuple[float, float]] = None

    def attach(self, src: "MseSrc") -> None:
        src._media_source = self
        self._src = src
        self.ready_state = "open"

    def detach(self) -> None:
        if self._src is not None:
            self._src._media_source = None
        self._src = None
        self.ready_state = "closed"

    def add_source_buffer(self, mime: str) -> SourceBuffer:
        if self.ready_state != "open":
            raise RuntimeError("media source: not open")
        sb = SourceBuffer(self, mime)
        self.source_buffers.append(sb)
        return sb

    @property
    def active_source_buffers(self) -> List[SourceBuffer]:
        return [sb for sb in self.source_buffers if sb._data]

    def remove_source_buffer(self, sb: SourceBuffer) -> None:
        self.source_buffers.remove(sb)

    def end_of_stream(self, error: Optional[str] = None) -> None:
        if self.ready_state != "open":
            raise RuntimeError("media source: not open")
        self.ready_state = "ended"
        durs = [sb._duration_estimate() for sb in self.source_buffers]
        if any(durs):
            self.duration = max(durs)

    def set_live_seekable_range(self, start: float,
                                end: float) -> None:
        self.live_seekable_range = (start, end)

    def clear_live_seekable_range(self) -> None:
        self.live_seekable_range = None


@register_element
class MseSrc(SourceElement):
    """msesrc (gstmsesrc.c): the pipeline-facing element a
    MediaSource attaches to.  Decodes the appended segments with the
    framework's demuxers once the pipeline runs; `stream` picks the
    track like the other demuxing sources."""
    FACTORY = "msesrc"
    DESCRIPTION = "Media Source"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "stream": (str, "video", "video | audio | stream index"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._media_source: Optional[MediaSource] = None
        self._inner = None
        self._tmppath = None
        self.position = 0
        self.n_audio = 0
        self.n_video = 0

    @property
    def ready_state(self) -> str:
        return (self._media_source.ready_state
                if self._media_source else "closed")

    def _ensure_inner(self):
        if self._inner is not None:
            return
        ms = self._media_source
        if ms is None or not ms.source_buffers:
            raise RuntimeError("msesrc: no MediaSource attached or "
                               "no data appended")
        blob = b""
        for sb in ms.source_buffers:
            if sb._data:
                blob = sb.bytes()
                break
        if not blob:
            raise RuntimeError("msesrc: no appended data")
        import os
        import tempfile
        from .elements.playback import _ChainSrc, _decoder_for_caps
        from .core.element import element_factory_make
        from .utils.typefind import decodable_for, type_find_data
        mtype, _prob = type_find_data(blob[:64])
        factory = decodable_for(mtype)
        if factory is None:
            raise ValueError(f"msesrc: cannot demux {mtype!r}")
        fd, path = tempfile.mkstemp(suffix=".mse")
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        self._tmppath = path
        want = self.props["stream"]
        probe = element_factory_make(factory, location=path,
                                     stream=want)
        caps = probe.get_caps()
        dec = _decoder_for_caps(caps)
        desc = (f"{factory} location={path} stream={want}"
                + (f" ! {dec}" if dec else ""))
        self._inner = _ChainSrc(description=desc)
        self._inner.device = self.device

    def get_caps(self, filter=None):
        try:
            self._ensure_inner()
        except (RuntimeError, ValueError, OSError):
            return Caps.any()
        return self._inner.get_caps(filter)

    def start(self):
        self._ensure_inner()
        self._inner.device = self.device
        self._inner.start()
        self.position = 0

    def stop(self):
        if self._tmppath:
            import os
            try:
                os.unlink(self._tmppath)
            except OSError:
                pass
            self._tmppath = None
        self._inner = None

    def create(self, n_frames: int) -> Optional[Buffer]:
        buf = self._inner.create(n_frames)
        if buf is not None and buf.duration:
            self.position += buf.duration
        return buf
