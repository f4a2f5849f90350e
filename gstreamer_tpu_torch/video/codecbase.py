"""Video/audio codec base-class scaffolds.

TPU-native equivalents of GstVideoDecoder/GstVideoEncoder
(gstvideodecoder.c:5574, gstvideoencoder.c:3640) and
GstAudioDecoder/GstAudioEncoder — the scaffolding only (frame
bookkeeping, timestamp tracking, output negotiation); actual codecs are
out of the DSP scope, but subclasses plug in via handle_frame exactly
like the reference vfuncs.

A copy of the JAX package's ``video/codecbase.py`` on the port's
``TransformElement``: a codec is a host element (``HOST_ELEMENT``), its
frames whatever ``handle_frame`` makes of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import TransformElement


@dataclass
class CodecFrame:
    """GstVideoCodecFrame: one frame through the codec with its
    bookkeeping (system_frame_number, pts/dts/duration, input/output)."""
    system_frame_number: int
    pts: Optional[int] = None
    dts: Optional[int] = None
    duration: Optional[int] = None
    input_data: Optional[object] = None
    output_data: Optional[object] = None


class VideoCodecBase(TransformElement):
    """Shared scaffold: frames get numbered, queued, and finished in
    order (gst_video_decoder_finish_frame semantics)."""

    HOST_ELEMENT = True

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._frame_number = 0
        self._pending: List[CodecFrame] = []
        self._output_caps: Optional[Caps] = None

    def start(self):
        self._frame_number = 0
        self._pending = []

    # -- subclass API -------------------------------------------------------
    def set_output_state(self, caps: Caps) -> None:
        """gst_video_decoder_set_output_state."""
        self._output_caps = caps

    def handle_frame(self, frame: CodecFrame) -> Optional[CodecFrame]:
        """Process one frame; return it with output_data set to emit
        (or None to hold it for reordering/lookahead)."""
        raise NotImplementedError

    def finish_frame(self, frame: CodecFrame) -> None:
        """Queue a completed frame for in-order output."""
        frame._done = True

    def drain(self) -> List[CodecFrame]:
        """Flush pending frames at EOS (gst_video_decoder_drain)."""
        out, self._pending = self._pending, []
        return out

    # -- element ------------------------------------------------------------
    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        outs = []
        datas = buf.data if isinstance(buf.data, list) else [buf.data]
        dur = buf.duration
        for k, data in enumerate(datas):
            frame = CodecFrame(
                system_frame_number=self._frame_number,
                pts=(buf.pts + k * dur) if (buf.pts is not None and dur)
                else buf.pts,
                duration=dur, input_data=data)
            self._frame_number += 1
            done = self.handle_frame(frame)
            if done is not None:
                outs.append(done)
        if not outs:
            return None
        return buf.with_(
            data=[f.output_data for f in outs],
            pts=outs[0].pts, batch=len(outs))


class VideoDecoderBase(VideoCodecBase):
    """GstVideoDecoder scaffold: packets in -> raw frames out."""


class VideoEncoderBase(VideoCodecBase):
    """GstVideoEncoder scaffold: raw frames in -> packets out."""
