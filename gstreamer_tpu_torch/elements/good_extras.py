"""Assorted gst-plugins-good leftovers: aspectratiocrop,
imagesequencesrc, pushfilesrc, splitfilesrc, rndbuffersize,
capsdebug, testsink, navseek, navigationtest.

References:
* gst/videocrop/gstaspectratiocrop.c — computes symmetric crop so
  the output matches `aspect-ratio`, delegating to videocrop;
  passthrough when already correct.
* gst/multifile/gstimagesequencesrc.c — numbered image files pushed
  at `framerate` with image caps.
* gst/multifile/gstsplitfilesrc.c — a glob of part files read as one
  continuous stream.
* gst/debugutils/gstpushfilesrc.c — filesrc forced into push mode
  (identical in the batched model) with time-segment shaping props.
* gst/debugutils/rndbuffersize.c — re-chunks the stream into random
  [min,max] sized buffers from `seed`.
* gst/debugutils/gstcapsdebug.c, gsttestsink (testsink) — observe
  caps/buffer flow.
* gst/debugutils/gstnavseek.c, gstnavigationtest.c — keyboard-driven
  seeking / pointer trails; the offline runtime records the
  navigation events it would act on.

A port of the JAX package's ``elements/good_extras.py`` on the port's
videocrop, filesrc and multifilesrc.  rndbuffersize takes its source's
host bytes unstaged and gives host bytes; testsink copies each tick's
data to the host to hash it; the others pass the buffer's tensors as they
are.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            TransformElement, register_element)
from ..core.value import Fraction
from .file_elements import FileSrc, MultiFileSrc
from .videofilter import VideoCrop


@register_element
class AspectRatioCrop(VideoCrop):
    """aspect-ratio property computes the videocrop top/bottom or
    left/right pair (gstaspectratiocrop.c recalculate_cropping)."""
    FACTORY = "aspectratiocrop"
    DESCRIPTION = "Crops video into a user-defined aspect-ratio"
    PROPERTIES = dict(VideoCrop.PROPERTIES,
                      **{"aspect-ratio": (object, None,
                                          "target x/y fraction")})

    def _target(self) -> Optional[Fraction]:
        ar = self.props["aspect-ratio"]
        if ar in (None, ""):
            return None
        if isinstance(ar, Fraction):
            return ar
        n, _, d = str(ar).partition("/")
        return Fraction(int(n), int(d or "1"))

    def transform_caps(self, direction, caps, filter=None):
        # compute crop amounts from the INPUT caps before delegating
        if direction == PadDirection.SINK:
            tgt = self._target()
            for s in caps:
                w = s.fields.get("width")
                h = s.fields.get("height")
                if tgt and isinstance(w, int) and isinstance(h, int):
                    # current ratio vs target: crop the larger axis
                    if w * tgt.denom > h * tgt.num:      # too wide
                        new_w = h * tgt.num // tgt.denom
                        d = w - new_w
                        self.props["left"] = d // 2
                        self.props["right"] = d - d // 2
                        self.props["top"] = self.props["bottom"] = 0
                    elif w * tgt.denom < h * tgt.num:    # too tall
                        new_h = w * tgt.denom // tgt.num
                        d = h - new_h
                        self.props["top"] = d // 2
                        self.props["bottom"] = d - d // 2
                        self.props["left"] = self.props["right"] = 0
                    else:
                        self.props["top"] = self.props["bottom"] = 0
                        self.props["left"] = self.props["right"] = 0
                break
        return super().transform_caps(direction, caps, filter)


@register_element
class ImageSequenceSrc(MultiFileSrc):
    """imagesequencesrc: numbered images at a fixed framerate
    (gstimagesequencesrc.c); start-index/stop-index select the span."""
    FACTORY = "imagesequencesrc"
    DESCRIPTION = "Create a video stream from a sequence of image " \
                  "files"
    PROPERTIES = dict(
        MultiFileSrc.PROPERTIES,
        **{"framerate": (object, Fraction(30, 1), "stream framerate"),
           "start-index": (int, 0, "first file index")})

    def __init__(self, name=None, **props):
        if isinstance(props.get("framerate"), str):
            n, _, d = props["framerate"].partition("/")
            props["framerate"] = Fraction(int(n), int(d or "1"))
        if "start-index" in props:
            props.setdefault("index", props["start-index"])
        super().__init__(name=name, **props)

    def create(self, n_frames: int) -> Optional[Buffer]:
        buf = super().create(n_frames)
        if buf is None:
            return None
        fr = self.props["framerate"]
        if isinstance(fr, Fraction) and fr.num:
            dur = 1_000_000_000 * fr.denom // fr.num
            n = buf.batch or 1
            buf = buf.with_(duration=dur * n)
        return buf


@register_element
class PushFileSrc(FileSrc):
    """pushfilesrc: filesrc that never operates pull-based — the
    batched pipeline is push-shaped already (gstpushfilesrc.c)."""
    FACTORY = "pushfilesrc"
    DESCRIPTION = "Implements a pushfile:// URI-handler for push-" \
                  "based file access"
    PROPERTIES = dict(
        FileSrc.PROPERTIES,
        **{"initial-timestamp": (int, -1, "pts of the first buffer"),
           "rate": (float, 1.0, "segment rate"),
           "applied-rate": (float, 1.0, "segment applied rate")})

    def create(self, n_frames: int) -> Optional[Buffer]:
        buf = super().create(n_frames)
        if buf is not None and self.props["initial-timestamp"] >= 0 \
                and buf.pts in (None, 0):
            buf = buf.with_(pts=self.props["initial-timestamp"])
        return buf


@register_element
class SplitFileSrc(FileSrc):
    """splitfilesrc: a wildcard of file parts read as one stream
    (gstsplitfilesrc.c location supports '*' and '?')."""
    FACTORY = "splitfilesrc"
    DESCRIPTION = "Read a sequentially named set of files as if it " \
                  "were one large file"

    def start(self):
        import glob
        parts = sorted(glob.glob(self.props["location"]))
        if not parts:
            raise FileNotFoundError(self.props["location"])
        self._parts = parts
        self._part_idx = 0
        self._file = open(parts[0], "rb")
        self._y4m_frame_prefix = False
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        want = self.props["blocksize"] * max(1, n_frames)
        chunks = []
        got = 0
        while got < want:
            raw = self._file.read(want - got)
            if raw:
                chunks.append(raw)
                got += len(raw)
                continue
            self._part_idx += 1
            if self._part_idx >= len(self._parts):
                break
            self._file.close()
            self._file = open(self._parts[self._part_idx], "rb")
        if not chunks:
            return None
        return Buffer(data=np.frombuffer(b"".join(chunks), np.uint8),
                      batch=1)


@register_element
class RndBufferSize(TransformElement):
    """rndbuffersize: re-chunk into random [min,max] byte buffers
    (rndbuffersize.c; seeded GRand)."""
    FACTORY = "rndbuffersize"
    DESCRIPTION = "pull random sized buffers"
    HOST_ELEMENT = True
    HOST_INPUT = True       # takes the source's host bytes
    _decouple = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "seed": (int, 0, "random number seed"),
        "min": (int, 1, "minimum buffer size"),
        "max": (int, 8 * 1024, "maximum buffer size"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._rest = b""
        self._rng = None

    def start(self):
        self._rest = b""
        self._rng = np.random.default_rng(self.props["seed"])

    @property
    def _pending_buf(self):
        return True if self._rest else None

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            if not self._rest:
                return None
            out, self._rest = self._rest, b""
            return Buffer(data=np.frombuffer(out, np.uint8), batch=1)
        d = buf.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        raw = self._rest + b"".join(
            bytes(b) if isinstance(b, (bytes, bytearray))
            else host_array(b).tobytes() for b in blobs)
        lo, hi = self.props["min"], max(self.props["min"],
                                        self.props["max"])
        out: List[np.ndarray] = []
        pos = 0
        while len(raw) - pos >= hi:
            n = int(self._rng.integers(lo, hi + 1))
            out.append(np.frombuffer(raw[pos:pos + n], np.uint8))
            pos += n
        self._rest = raw[pos:]
        if not out:
            return None
        return buf.with_(data=out if len(out) > 1 else out[0],
                         batch=len(out))


@register_element
class CapsDebug(TransformElement):
    """capsdebug: passthrough that records the caps it sees."""
    FACTORY = "capsdebug"
    DESCRIPTION = "Relay caps and buffers, logging caps information"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.seen_caps: List[str] = []

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self.seen_caps.append(str(incaps))


@register_element
class TestSink(SinkElement):
    """testsink: checksums the stream for comparison runs
    (gst/debugutils/tests.c md5/timestamp/buffer-count checks)."""
    FACTORY = "testsink"
    DESCRIPTION = "perform tests on buffer sequences"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.buffer_count = 0
        self.byte_count = 0
        self._md5 = None

    def start(self):
        import hashlib
        self.buffer_count = 0
        self.byte_count = 0
        self._md5 = hashlib.md5()

    def render(self, buf: Buffer) -> str:
        d = buf.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            self._md5.update(raw)
            self.byte_count += len(raw)
        self.buffer_count += buf.batch or 1
        return FlowReturn.OK

    @property
    def md5(self) -> str:
        return self._md5.hexdigest()


@register_element
class NavSeek(TransformElement):
    """navseek: seek on key navigation events (gstnavseek.c); the
    offline runtime records the requested seek offsets."""
    FACTORY = "navseek"
    DESCRIPTION = "Seek based on navigation keys left-right"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {"seek-offset": (float, 5.0, "seconds per keypress")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.requested_seeks: List[float] = []

    def src_event(self, pad, event) -> bool:
        if getattr(event, "type", None) == "navigation":
            key = (event.data or {}).get("key")
            if key in ("Left", "Right"):
                sign = -1.0 if key == "Left" else 1.0
                self.requested_seeks.append(
                    sign * self.props["seek-offset"])
                return True
        return super().src_event(pad, event)


@register_element
class NavigationTest(TransformElement):
    """navigationtest: records pointer navigation events (the
    reference draws a cursor trail; offline we keep the log)."""
    FACTORY = "navigationtest"
    DESCRIPTION = "Handle navigation events, showing a black box " \
                  "following mouse pointer"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format=I420"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format=I420"),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.events: List[dict] = []

    def src_event(self, pad, event) -> bool:
        if getattr(event, "type", None) == "navigation":
            self.events.append(dict(event.data or {}))
            return True
        return super().src_event(pad, event)
