"""rawvideoparse / rawaudioparse — chop byte streams into raw frames.

Reference: subprojects/gst-plugins-bad/gst/rawparse/gstrawvideoparse.c
(properties width/height/format/framerate, frame-size derivation),
gstrawaudioparse.c (pcm format/sample-rate/num-channels/interleaved),
both built on gstrawbaseparse.c's adapter loop.

Byte buffers (numpy uint8, filesrc's unknown-data convention) accumulate
in an Adapter (core/adapter.py); every complete frame is decoded into
the canonical plane layout and emitted as one batched Buffer per tick.
The JAX package's ``elements/rawparse.py``; the parsed planes and samples
go to the pipeline's device (the parsers are host elements, so the
pipeline hands them the source's host bytes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.adapter import Adapter
from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.value import Fraction
from ..audio.format import format_info as ainfo, from_bytes as afrom
from ..video.format import frame_size, from_bytes
from ..video.info import VideoInfo

BYTES_CAPS = Caps.any()


@register_element
class RawVideoParse(TransformElement):
    FACTORY = "rawvideoparse"
    DESCRIPTION = "Parses byte streams into raw video frames"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/octet-stream"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, width=[1,32767], height=[1,32767]"),
    ]
    PROPERTIES = {
        "width": (int, 320, "frame width"),
        "height": (int, 240, "frame height"),
        "format": (str, "I420", "pixel format"),
        "framerate": (object, Fraction(25, 1), "frame rate"),
    }

    def __init__(self, name=None, **props):
        if isinstance(props.get("framerate"), str):
            n, d = props["framerate"].split("/")
            props["framerate"] = Fraction(int(n), int(d))
        super().__init__(name=name, **props)
        self._adapter = Adapter()
        self._frame_idx = 0

    def _out_info(self) -> VideoInfo:
        return VideoInfo(format=self.props["format"],
                         width=self.props["width"],
                         height=self.props["height"],
                         fps=self.props["framerate"])

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = Caps([self._out_info().to_caps_structure()])
        else:
            res = Caps.from_string("application/octet-stream")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def start(self):
        self._adapter.clear()
        self._frame_idx = 0

    def flush(self):
        self.start()

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        info = self._out_info()
        fsz = frame_size(info.finfo, info.width, info.height)
        self._adapter.push(host_array(buf.data), pts=buf.pts)
        n = self._adapter.available() // fsz
        if n == 0:
            return None
        raw = self._adapter.take(n * fsz).reshape(n, fsz)
        planes = [from_bytes(info.finfo, raw[k], info.width, info.height)
                  for k in range(n)]
        data = tuple(torch.from_numpy(np.stack([p[c] for p in planes]))
                     .to(self.device) for c in range(len(planes[0])))
        fps = info.fps
        pts = self._frame_idx * 1_000_000_000 * fps.denom // fps.num
        dur = 1_000_000_000 * fps.denom // fps.num
        self._frame_idx += n
        return Buffer(data=data, pts=pts, duration=dur, batch=n)


@register_element
class RawAudioParse(TransformElement):
    FACTORY = "rawaudioparse"
    DESCRIPTION = "Parses byte streams into raw audio"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/octet-stream"),
        PadTemplate("src", PadDirection.SRC, "audio/x-raw"),
    ]
    PROPERTIES = {
        "pcm-format": (str, "S16LE", "sample format"),
        "sample-rate": (int, 44100, "sample rate"),
        "num-channels": (int, 2, "channel count"),
        "interleaved": (bool, True, "interleaved layout"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._adapter = Adapter()
        self._pos = 0

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            res = Caps.from_string(
                f"audio/x-raw, format={self.props['pcm-format']}, "
                f"rate={self.props['sample-rate']}, "
                f"channels={self.props['num-channels']}, "
                f"layout=interleaved")
        else:
            res = Caps.from_string("application/octet-stream")
        if filter is not None:
            res = res.intersect(filter)
        return res

    def start(self):
        self._adapter.clear()
        self._pos = 0

    def flush(self):
        self.start()

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        fmt = ainfo(self.props["pcm-format"])
        ch = self.props["num-channels"]
        bpf = (fmt.width // 8) * ch
        self._adapter.push(host_array(buf.data), pts=buf.pts)
        n = self._adapter.available() // bpf
        if n == 0:
            return None
        raw = self._adapter.take(n * bpf)
        samples = afrom(fmt, raw, ch)
        rate = self.props["sample-rate"]
        pts = self._pos * 1_000_000_000 // rate
        dur = n * 1_000_000_000 // rate
        self._pos += n
        samples = torch.from_numpy(samples.astype(
            samples.dtype.newbyteorder("="))).to(self.device)
        return Buffer(data=samples, pts=pts, duration=dur, batch=1)
