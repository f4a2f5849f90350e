"""-bad videofilters (zebrastripe, scenechangedetect, videodiff) and
accurip.

* zebrastripe (gstzebrastripe.c): luma >= 16+round(2.19*threshold)
  gets a moving diagonal stripe — Y=16 where (i+j+t)&4, t increments
  per frame.  One device select expression.
* scenechangedetect (gstscenechange.c): mean abs luma diff against
  the previous frame; a 5-deep diff window drives the
  1.8*max-0.8*min adaptive threshold and the exact decision ladder
  (:214-235); a detected cut posts a force-key-unit-style message and
  resets the window.
* videodiff (gstvideodiff.c): |cur-prev| > threshold pixels render as
  an animated 16/240 stripe, others pass through; chroma copied.
* accurip (gst-plugins-bad/gst/accurip/): AccurateRip v1+v2 checksums
  over stereo S16 frames (32-bit L|R words x 1-based sample index),
  first/last-track 5-sector skip/rollback rings, CRC tags at EOS.

A port of the JAX package's ``elements/videofilters_bad.py``: each
element reads a host copy of the tick's luma plane (accurip: of its
samples); zebrastripe's and videodiff's luma goes back to the buffer's
device, the chroma planes stay there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, device_array, host_array
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo

_PLANAR_CAPS = ("video/x-raw, format={ I420, YV12, Y444, Y42B, Y41B }, "
                "width=[1,32767], height=[1,32767], "
                "framerate=[0/1,2147483647/1]")


def _root(elem):
    root = elem
    while getattr(root, "parent", None) is not None:
        root = root.parent
    return root


@register_element
class ZebraStripe(TransformElement):
    FACTORY = "zebrastripe"
    DESCRIPTION = "Overlays zebra striping on overexposed areas of video"
    HOST_ELEMENT = True               # t carries across ticks
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _PLANAR_CAPS),
        PadTemplate("src", PadDirection.SRC, _PLANAR_CAPS),
    ]
    PROPERTIES = {"threshold": (int, 90, "threshold in percent")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._t = 0

    def start(self):
        self._t = 0

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        import math
        y_thr = 16 + math.floor(0.5 + 2.19 * self.props["threshold"])
        data = list(buf.data) if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        y = host_array(data[0]).copy()
        batch = y.shape[0]
        h, w = y.shape[-2:]
        jj, ii = np.mgrid[0:h, 0:w]
        for k in range(batch):
            stripe = ((ii + jj + self._t) & 0x4).astype(bool)
            frame = y[k]
            frame[(frame >= y_thr) & stripe] = 16
            self._t += 1
        out = [device_array(y, buf.data)] + list(data[1:])
        if not isinstance(buf.data, (list, tuple)):
            out = out[0]
        return buf.with_(data=out)


@register_element
class SceneChange(TransformElement):
    FACTORY = "scenechange"
    DESCRIPTION = "Detects scene changes in video"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _PLANAR_CAPS),
        PadTemplate("src", PadDirection.SRC, _PLANAR_CAPS),
    ]
    PROPERTIES = {}

    N_DIFFS = 5

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._reset()

    def _reset(self):
        self._old = None
        self._diffs = [0.0] * self.N_DIFFS
        self._n_diffs = 0
        self._count = 0

    def start(self):
        self._reset()

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def _frame_score(self, old, new) -> float:
        h, w = new.shape
        sad = np.abs(new.astype(np.int64)
                     - old.astype(np.int64)).sum()
        return float(sad) / (w * h)

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        data = buf.data if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        y = host_array(data[0])
        batch = y.shape[0]
        for k in range(batch):
            frame = y[k]
            if self._old is None:
                self._diffs = [0.0] * self.N_DIFFS
                self._n_diffs = 0
                self._old = frame.copy()
                continue
            score = self._frame_score(self._old, frame)
            self._old = frame.copy()
            self._diffs = self._diffs[1:] + [score]
            self._n_diffs += 1
            mn = mx = self._diffs[0]
            for v in self._diffs[1:self.N_DIFFS - 1]:
                mn = min(mn, v)
                mx = max(mx, v)
            threshold = 1.8 * mx - 0.8 * mn
            change = False
            if self._n_diffs > self.N_DIFFS - 1:
                if score < 5:
                    change = False
                elif threshold and score / threshold < 1.0:
                    change = False
                elif (score > 30
                      and self._diffs[self.N_DIFFS - 2]
                      and score / self._diffs[self.N_DIFFS - 2] > 1.4):
                    change = True
                elif threshold and score / threshold > 2.3:
                    change = True
                elif score > 50:
                    change = True
            if change:
                self._diffs = [0.0] * self.N_DIFFS
                self._n_diffs = 0
                root = _root(self)
                if hasattr(root, "bus"):
                    from ..core.pipeline import Message
                    pts = buf.pts
                    if pts is not None and buf.duration and buf.batch:
                        pts = pts + k * buf.duration // buf.batch
                    root.bus.post(Message("element", self.name, {
                        "name": "GstForceKeyUnit",
                        "timestamp": pts,
                        "count": self._count,
                    }))
                self._count += 1
        return buf


@register_element
class VideoDiff(TransformElement):
    FACTORY = "videodiff"
    DESCRIPTION = "Visualize differences between adjacent video frames"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, format={ I420, Y444, Y42B, Y41B }, "
                    "width=[1,32767], height=[1,32767], "
                    "framerate=[0/1,2147483647/1]"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ I420, Y444, Y42B, Y41B }, "
                    "width=[1,32767], height=[1,32767], "
                    "framerate=[0/1,2147483647/1]"),
    ]
    PROPERTIES = {"threshold": (int, 10, "luma difference threshold")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._old = None
        self._t = 0

    def start(self):
        self._old = None
        self._t = 0

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        thr = self.props["threshold"]
        data = list(buf.data) if isinstance(buf.data, (list, tuple)) \
            else [buf.data]
        y = host_array(data[0])
        out = y.copy()
        batch = y.shape[0]
        h, w = y.shape[-2:]
        jj, ii = np.mgrid[0:h, 0:w]
        for k in range(batch):
            cur = y[k].astype(np.int64)
            if self._old is not None:
                old = self._old.astype(np.int64)
                differs = (cur < old - thr) | (cur > old + thr)
                stripe = ((ii + jj + self._t) & 0x4).astype(bool)
                frame = out[k]
                frame[differs & stripe] = 16
                frame[differs & ~stripe] = 240
            self._old = y[k].copy()
            self._t += 1
        res = [device_array(out, buf.data)] + list(data[1:])
        if not isinstance(buf.data, (list, tuple)):
            res = res[0]
        return buf.with_(data=res)


_IGNORED = 2352 * 5 // 4            # samples in 5 CD sectors


@register_element
class AccuRip(TransformElement):
    FACTORY = "accurip"
    DESCRIPTION = "Computes an AccurateRip CRC"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "audio/x-raw, format=S16LE, rate=44100, "
                    "channels=2, layout=interleaved"),
        PadTemplate("src", PadDirection.SRC,
                    "audio/x-raw, format=S16LE, rate=44100, "
                    "channels=2, layout=interleaved"),
    ]
    PROPERTIES = {
        "first-track": (bool, False, "skip the first 5 CD sectors"),
        "last-track": (bool, False, "ignore the last 5 CD sectors"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._reset()

    def _reset(self):
        self.crc = 0
        self.crc_v2 = 0
        self._num = 0
        self._ring = [(0, 0)] * (_IGNORED + 1)
        self._ring_samples = 0

    def start(self):
        self._reset()

    def set_info(self, incaps, outcaps):
        pass

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        x = host_array(buf.data).astype(np.int16)
        # 32-bit little-endian words: R<<16 | L (memory order L,R)
        words = (x[:, 0].astype(np.uint16).astype(np.uint64)
                 | (x[:, 1].astype(np.uint16).astype(np.uint64) << 16))
        n = len(words)
        idx = np.arange(self._num + 1, self._num + n + 1, dtype=np.uint64)
        keep = np.ones(n, bool)
        if self.props["first-track"]:
            keep &= idx >= _IGNORED          # num_samples < N skipped
        mult = words * idx
        m = mult[keep]
        self.crc = int((np.uint64(self.crc) + m.sum(dtype=np.uint64))
                       & np.uint64(0xFFFFFFFF))
        v2 = (m & np.uint64(0xFFFFFFFF)).sum(dtype=np.uint64) \
            + (m >> np.uint64(32)).sum(dtype=np.uint64)
        self.crc_v2 = int((np.uint64(self.crc_v2) + v2)
                          & np.uint64(0xFFFFFFFF))
        self._num += n
        if self.props["last-track"]:
            # keep a rollback ring of running values (scalar walk only
            # over this buffer's kept samples)
            run_c = np.uint64(0)
            run_v = np.uint64(0)
            # recompute running sums efficiently via cumsum
            cs = np.cumsum(m, dtype=np.uint64)
            cv = (np.cumsum(m & np.uint64(0xFFFFFFFF),
                            dtype=np.uint64)
                  + np.cumsum(m >> np.uint64(32), dtype=np.uint64))
            with np.errstate(over="ignore"):
                base_c = (np.uint64(self.crc) - cs[-1]
                          if len(cs) else np.uint64(0))
                base_v = (np.uint64(self.crc_v2) - cv[-1]
                          if len(cv) else np.uint64(0))
            # modular uint32 arithmetic done in Python ints: mixing
            # Python int + np.uint64 raises overflow RuntimeWarnings
            # and relies on numpy wraparound semantics
            base_c_i, base_v_i = int(base_c), int(base_v)
            for i in range(len(m)):
                slot = self._ring_samples % (_IGNORED + 1)
                self._ring_samples += 1
                self._ring[slot] = (
                    (base_c_i + int(cs[i])) & 0xFFFFFFFF,
                    (base_v_i + int(cv[i])) & 0xFFFFFFFF)
        return buf

    def sink_event(self, pad, event) -> bool:
        from ..core.events import EventType

        if event.type == EventType.EOS:
            crc, crc_v2 = self.crc, self.crc_v2
            if self.props["last-track"] \
                    and self._ring_samples > _IGNORED:
                index = (self._ring_samples - _IGNORED) \
                    % (_IGNORED + 1)
                crc, crc_v2 = self._ring[index]
            root = _root(self)
            if hasattr(root, "bus"):
                from ..core.pipeline import Message
                root.bus.post(Message("tag", self.name, {
                    "accurip-crc": crc, "accurip-crc-v2": crc_v2}))
        return super().sink_event(pad, event)
