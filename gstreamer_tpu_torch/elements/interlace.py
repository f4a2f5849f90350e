"""interlace — progressive to interlaced conversion with telecine.

Reference: subprojects/gst-plugins-bad/gst/interlace/gstinterlace.c —
PulldownFormat table :364 (ratio = outgoing-field-rate/2 over incoming
frame rate, n_fields per input frame), field assembly loop in
gst_interlace_chain (weave one field from the stored frame with one
from the current when fields straddle frames; pass whole frames
through otherwise, optionally flagging 3-field frames RFF), buffer
decoration gst_interlace_decorate_buffer (TFF when field_index==0,
RFF at 3 fields, INTERLACED for telecine mixed frames) and timestamps
gst_interlace_decorate_buffer_ts (timebase + fields_since * field_dur
where field_dur = out_fps_d / (2 * out_fps_n)).

Per-frame decoration of batched buffers rides Buffer.meta["frames"]
(list of dicts with pts/duration/flags), since one Buffer carries a
whole batch.

A port of the JAX package's ``elements/interlace.py``: the field
assembly runs on a host copy of the tick's planes; the woven frames go
back to the buffer's device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer, BufferFlags, device_array, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.value import Fraction
from ..video.info import VideoInfo
from .videotestsrc import FORMAT_LIST

VIDEO_CAPS = (f"video/x-raw, format={FORMAT_LIST}, width=[1,32767], "
              f"height=[1,32767], framerate=[0/1,2147483647/1]")

SECOND = 1_000_000_000

# gstinterlace.c:364 — name: (ratio_n, ratio_d, n_fields per input frame)
FORMATS = {
    "1:1": (1, 2, (1,)),
    "2:2": (1, 1, (2,)),
    "2:3": (5, 4, (2, 3)),
    "2:3:3:2": (5, 4, (2, 3, 3, 2)),
    "2-11:3": (25, 24, (2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3)),
    "3:4-3": (15, 8, (3, 4, 4, 4)),
    "3-7:4": (25, 16, (3, 3, 3, 3, 3, 3, 3, 4)),
    "3:3:4": (5, 3, (3, 3, 4)),
    "3:3": (3, 2, (3, 3)),
    "3:2-4": (11, 10, (3, 2, 2, 2, 2)),
    "1:2-4": (9, 10, (1, 2, 2, 2, 2)),
}

# patterns beyond 2:2 produce mixed progressive/interlaced streams
_TELECINE = {k for k in FORMATS if k not in ("1:1", "2:2")}


def _scale(num: int, n: int, d: int) -> int:
    return num * n // d


@register_element
class Interlace(TransformElement):
    FACTORY = "interlace"
    DESCRIPTION = "Creates an interlaced video from progressive frames"
    HOST_ELEMENT = True   # stateful field assembly across frames
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, VIDEO_CAPS),
        PadTemplate("src", PadDirection.SRC, VIDEO_CAPS),
    ]
    PROPERTIES = {
        "field-pattern": (str, "2:3", "|".join(FORMATS)),
        "pattern-offset": (int, 0, "initial field pattern offset (0-12)"),
        "top-field-first": (bool, False, "field order"),
        "allow-rff": (bool, False, "emit 3-field (RFF) buffers"),
    }

    def __init__(self, name=None, **props):
        if props.get("field-pattern") not in FORMATS:
            props.pop("field-pattern", None)
        super().__init__(name=name, **props)
        self._info: Optional[VideoInfo] = None
        self._out_fps: Optional[Fraction] = None
        self._reset()

    def _reset(self):
        self._stored: Optional[List[np.ndarray]] = None
        self._stored_fields = 0
        self._phase = int(self.props.get("pattern-offset", 0))
        self._field_index = 0 if self.props["top-field-first"] else 1
        self._timebase: Optional[int] = None
        self._fields_since = 0

    def transform_caps(self, direction, caps, filter=None):
        rn, rd, _ = FORMATS[self.props["field-pattern"]]
        out = []
        for s in caps:
            ns = s.copy()
            fr = ns.fields.get("framerate")
            if isinstance(fr, Fraction):
                if direction == PadDirection.SINK:
                    ns["framerate"] = Fraction(fr.num * rn, fr.denom * rd)
                else:
                    ns["framerate"] = Fraction(fr.num * rd, fr.denom * rn)
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._info = VideoInfo.from_caps_structure(incaps[0])
            fr = incaps[0].fields.get("framerate")
            rn, rd, _ = FORMATS[self.props["field-pattern"]]
            if isinstance(fr, Fraction) and fr.num:
                self._out_fps = Fraction(fr.num * rn, fr.denom * rd)

    def start(self):
        self._reset()

    def flush(self):
        self._reset()

    # -- timestamping (gst_interlace_decorate_buffer_ts) ------------------
    def _ts(self, n_fields: int):
        if self._out_fps is None or self._out_fps.num == 0:
            return None, None
        fn, fd = self._out_fps.num, self._out_fps.denom
        pts = (self._timebase or 0) + _scale(
            SECOND, fd * self._fields_since, fn * 2)
        dur = _scale(SECOND, fd * n_fields, fn * 2)
        return pts, dur

    def _decorate(self, n_fields: int, interlaced: bool) -> dict:
        pts, dur = self._ts(n_fields)
        flags = 0
        if self._field_index == 0:
            flags |= BufferFlags.INTERLACED_TFF
        if n_fields == 3:
            flags |= BufferFlags.RFF
        if n_fields == 1:
            flags |= BufferFlags.ONEFIELD
        pattern = self.props["field-pattern"]
        if pattern in _TELECINE and n_fields == 2 and interlaced:
            flags |= BufferFlags.INTERLACED
        return {"pts": pts, "duration": dur, "flags": flags}

    def _weave(self, cur: List[np.ndarray]) -> List[np.ndarray]:
        """copy_fields: field_index rows from stored, others from cur."""
        fi = self._field_index
        out = []
        for sp, cp in zip(self._stored, cur):
            o = cp.copy()
            o[fi::2] = sp[fi::2]
            out.append(o)
        return out

    def _frame(self, cur: List[np.ndarray], pts: Optional[int]):
        """One input frame through the pulldown state machine."""
        fmt = FORMATS[self.props["field-pattern"]]
        n_fields_tab = fmt[2]
        allow_rff = self.props["allow-rff"]
        pattern_offset = int(self.props.get("pattern-offset", 0))

        if self._timebase is None:
            self._timebase = pts
        if (self._stored_fields == 0 and self._phase == pattern_offset
                and pts is not None):
            self._timebase = pts
            self._fields_since = 0

        current = n_fields_tab[self._phase]
        self._phase += 1
        if self._phase >= len(n_fields_tab):
            self._phase = 0

        outs = []
        num = self._stored_fields + current
        while num >= 2:
            if self._stored_fields > 0:
                frame = self._weave(cur)
                self._stored_fields -= 1
                current -= 1
                n_out, interlaced = 2, True
            else:
                frame = [p.copy() for p in cur]
                if num >= 3 and allow_rff:
                    current -= 3
                    n_out = 3
                else:
                    current -= 2
                    n_out = 2
                interlaced = False
            meta = self._decorate(n_out, interlaced)
            self._fields_since += n_out
            self._field_index ^= n_out & 1
            outs.append((frame, meta))
            num -= n_out

        self._stored = None
        self._stored_fields = 0
        if current > 0:
            self._stored = [p.copy() for p in cur]
            self._stored_fields = current
        return outs

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        planes = [host_array(p) for p in buf.data]
        b = planes[0].shape[0]
        dur_in = buf.duration or 0
        outs = []
        for i in range(b):
            pts = None if buf.pts is None else buf.pts + i * dur_in
            outs.extend(self._frame([p[i] for p in planes], pts))
        if not outs:
            return None
        data = tuple(device_array(np.stack([o[0][pi] for o in outs]),
                                  buf.data)
                     for pi in range(len(planes)))
        metas = [o[1] for o in outs]
        first = metas[0]
        return Buffer(data=data, pts=first["pts"],
                      duration=first["duration"], batch=len(outs),
                      flags=first["flags"],
                      meta={**buf.meta, "frames": metas})
