"""camerabin — high-level capture bin (reduced).

Reference: gst-plugins-bad/gst/camerabin2/gstcamerabin2.c — a bin
with a `mode` property (1 = image, 2 = video), `location` for the
capture target, and start-capture / stop-capture signals.

Reduction: the camera source is any launch fragment (`camera-source`,
default videotestsrc); start_capture() in image mode grabs one frame
and writes a JPEG through the clean-room codec, in video mode records
frames until stop_capture() and writes a Matroska file through
matroskamux.  The `%d`-style location template indexes successive
captures like the reference.

A port of the JAX package's ``elements/camerabin.py``: the source and the
recorder are inner pipelines on the element's own device (the outer
pipeline's, or CUDA unless ``device`` names another), and the frames stay
tensors there; the JPEG's transform runs on their device."""

from __future__ import annotations

from typing import List, Optional

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            register_element)

MODE_IMAGE = 1
MODE_VIDEO = 2


@register_element
class CameraBin(SinkElement):
    FACTORY = "camerabin"
    DESCRIPTION = "Take image snapshots and record movies from camera"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 Caps.any())]
    PROPERTIES = {
        "mode": (int, MODE_IMAGE, "1=image capture, 2=video record"),
        "location": (str, "cap_%d", "capture filename template"),
        "camera-source": (str,
                          "videotestsrc num-buffers=1 ! "
                          "video/x-raw,format=I420,width=320,"
                          "height=240,framerate=30/1",
                          "launch fragment producing frames"),
        "width": (int, 320, "capture width"),
        "height": (int, 240, "capture height"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._index = 0
        self._recording = False
        self._frames: List[tuple] = []
        self.captures: List[str] = []

    # -- source plumbing ------------------------------------------------------
    def _pull_frames(self, n: int) -> List[tuple]:
        import re

        from ..core.parse import parse_launch
        launch = self.props["camera-source"]
        # ask the source for exactly n buffers when it supports it
        launch = re.sub(r"num-buffers=\d+", f"num-buffers={n}",
                        launch)
        p = parse_launch(f"{launch} ! appsink name=__cap__",
                         device=self.device)
        p.run()
        sink = p.get_by_name("__cap__")
        frames = []
        while len(frames) < n:
            s = sink.pull_sample()
            if s is None:
                break
            d = s.buffer.data
            planes = list(d) if isinstance(d, (tuple, list)) else [d]
            for k in range(planes[0].shape[0]):
                frames.append(tuple(x[k] for x in planes))
                if len(frames) >= n:
                    break
        p.set_state("null")
        return frames

    def _location(self, ext: str) -> str:
        loc = self.props["location"]
        if "%d" in loc:
            loc = loc % self._index
        self._index += 1
        if not loc.endswith(ext):
            loc += ext
        return loc

    # -- capture API (start-capture / stop-capture signals) -------------------
    def start_capture(self) -> Optional[str]:
        """Image mode: write one JPEG and return its path.
        Video mode: start recording (returns None)."""
        if self.props["mode"] == MODE_IMAGE:
            frames = self._pull_frames(1)
            if not frames:
                raise RuntimeError("camerabin: source gave no frame")
            from ..codecs.jpeg import jpeg_encode
            y, u, v = frames[0][:3]
            h, w = y.shape
            path = self._location(".jpg")
            with open(path, "wb") as f:
                f.write(jpeg_encode((y, u, v), w, h))
            self.captures.append(path)
            return path
        self._recording = True
        self._frames = []
        return None

    def stop_capture(self) -> Optional[str]:
        """Video mode: finish recording and write the file."""
        if self.props["mode"] != MODE_VIDEO or not self._recording:
            return None
        self._recording = False
        frames = self._pull_frames(10) if not self._frames \
            else self._frames
        if not frames:
            raise RuntimeError("camerabin: source gave no frames")
        path = self._location(".mkv")
        from ..core.parse import parse_launch
        h, w = frames[0][0].shape
        p = parse_launch(
            "appsrc name=__in__ caps=video/x-raw,format=I420,"
            f"width={w},height={h},framerate=30/1 ! "
            f"matroskamux location={path}", device=self.device)
        src = p.get_by_name("__in__")
        for k, fr in enumerate(frames):
            src.push_buffer(Buffer(
                data=tuple(x[None] for x in fr),
                pts=k * 33_333_333, duration=33_333_333, batch=1))
        src.end_of_stream()
        p.run()
        p.set_state("null")
        self.captures.append(path)
        return path

    def render(self, buf: Buffer) -> str:
        # frames pushed into the bin while recording are captured
        if self._recording:
            d = buf.data
            planes = list(d) if isinstance(d, (tuple, list)) else [d]
            for k in range(planes[0].shape[0]):
                self._frames.append(tuple(x[k] for x in planes))
        return "ok"
