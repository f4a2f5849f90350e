"""videorate — frame-rate correction by dropping/duplicating frames.

A copy of the JAX package's ``elements/videorate.py`` (reference:
subprojects/gst-plugins-base/gst/videorate/gstvideorate.c — retiming by
drop/duplicate to the nearest timestamp, doc :27-47; drop/dup/in/out
counters).

Timestamp logic is control-plane work and runs on the host; the data
plane only sees an index selection over the batch axis, made on the
device with an index tensor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.buffer import Buffer, map_leaves
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.value import Fraction, FractionRange, fixate_nearest_fraction


@register_element
class VideoRate(TransformElement):
    FACTORY = "videorate"
    DESCRIPTION = "Drops/duplicates frames to match the output framerate"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK,
                    "video/x-raw, framerate=[0/1,2147483647/1]"),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, framerate=[0/1,2147483647/1]"),
    ]
    PROPERTIES = {
        "drop-only": (bool, False, "only drop, never duplicate"),
        "silent": (bool, True, ""),
        "skip-to-first": (bool, False, ""),
        "max-rate": (int, 2147483647, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.in_count = 0
        self.out_count = 0
        self.drop_count = 0
        self.dup_count = 0

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            ns = s.copy()
            ns["framerate"] = FractionRange(Fraction(0), Fraction(2147483647))
            out.append(ns)
        res = Caps(out)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction, caps, othercaps):
        s_in = caps[0]
        out = othercaps.truncate()[0].copy()
        fr = s_in.get("framerate", Fraction(30))
        if "framerate" in out.fields:
            out["framerate"] = fixate_nearest_fraction(out["framerate"], fr)
        return Caps([out]).fixate()

    def set_info(self, incaps, outcaps):
        self._in_fps = incaps[0].get("framerate", Fraction(30))
        self._out_fps = outcaps[0].get("framerate", self._in_fps)
        self._next_out_ts = None

    def start(self):
        self.in_count = self.out_count = 0
        self.drop_count = self.dup_count = 0
        self._next_out_ts = None

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        inf, outf = self._in_fps, self._out_fps
        if inf == outf:
            return buf
        in_dur = 1_000_000_000 * inf.denom // inf.num if inf.num else 0
        out_dur = 1_000_000_000 * outf.denom // outf.num
        n = buf.batch
        base_pts = buf.pts or 0
        in_ts = [base_pts + i * in_dur for i in range(n)]
        self.in_count += n

        if self._next_out_ts is None:
            self._next_out_ts = in_ts[0]
        sel = []
        out_ts = []
        t = self._next_out_ts
        # emit an output for every slot whose center is covered by this
        # batch; pick the input frame nearest in time (gstvideorate doc)
        end = in_ts[-1] + in_dur
        while t + out_dur // 2 <= end:
            diffs = [abs(ts - t) for ts in in_ts]
            sel.append(int(np.argmin(diffs)))
            out_ts.append(t)
            t += out_dur
        self._next_out_ts = t
        if not sel:
            self.drop_count += n
            return None

        picked = set(sel)
        self.drop_count += n - len(picked)
        self.dup_count += max(0, len(sel) - len(picked))
        self.out_count += len(sel)

        def take(p):
            if not isinstance(p, torch.Tensor):
                return p
            return p.index_select(0, torch.as_tensor(sel, device=p.device))

        data = map_leaves(take, buf.data)
        return buf.with_(data=data, pts=out_ts[0], duration=out_dur,
                         batch=len(sel))
