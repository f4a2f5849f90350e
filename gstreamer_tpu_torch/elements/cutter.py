"""cutter — audio silence gate (gst-plugins-good/gst/cutter/).

A host copy of the JAX package's ``elements/cutter.py``: the RMS is taken
on the host; held and flushed buffers keep their samples on their device.
Port of gstcutter.c:
* per-buffer RMS over all channels: NMS = sum(x^2)/2^(2*res)/n
  (DEFINE_CUTTER_CALCULATOR :216-240, S16 res=15 / S8 res=7);
* RMS < threshold accumulates silent_run_length; beyond
  `run-length` ns flags silence (gstcutter.c:396-407);
* "cutter" element messages with above/timestamp on every transition
  (gst_cutter_message_new :199);
* while silent, buffers are held in a pre-roll list trimmed to
  `pre-length` ns; on silence->active the list is flushed downstream
  so the attack is preserved; `leaky` drops instead (:438-465).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

_CAPS = ("audio/x-raw, format={ S16LE, S8 }, rate=[1,2147483647], "
         "channels=[1,2], layout=interleaved")


@register_element
class Cutter(TransformElement):
    FACTORY = "cutter"
    DESCRIPTION = "Audio Cutter to split audio into non-silent bits"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CAPS),
        PadTemplate("src", PadDirection.SRC, _CAPS),
    ]
    PROPERTIES = {
        "threshold": (float, 0.1, "volume threshold before trigger"),
        "threshold-dB": (float, -20.0, "threshold in dB (writes "
                         "threshold)"),
        "run-length": (int, 500_000_000, "silence ns before cut_stop"),
        "pre-length": (int, 200_000_000, "pre-record buffer ns"),
        "leaky": (bool, False, "drop buffers when below threshold"),
    }

    def __init__(self, name=None, **props):
        # a launch string gives the dB value as a string, which the JAX
        # package divides as it is (TypeError; ROADMAP.md section 3)
        if "threshold-dB" in props and "threshold" not in props:
            props["threshold"] = 10.0 ** (float(props["threshold-dB"])
                                          / 20.0)
        super().__init__(name=name, **props)
        self._reset()

    def _reset(self):
        self._silent = True
        self._silent_run = 0.0
        self._pre: List[Buffer] = []
        self._pre_run = 0.0

    def start(self):
        self._reset()

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def _post(self, above, pts):
        root = self
        while getattr(root, "parent", None) is not None:
            root = root.parent
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            root.bus.post(Message("element", self.name, {
                "name": "cutter", "above": above, "timestamp": pts}))

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        x = host_array(buf.data)
        res = 15 if x.dtype == np.int16 else 7
        num = x.size
        ncs = float((x.astype(np.float64) ** 2).sum()) \
            / float(1 << (res * 2))
        rms = math.sqrt(ncs / num) if num else 0.0
        rate = self._info.rate
        duration = x.shape[0] * 1_000_000_000 / rate

        silent_prev = self._silent
        if rms < self.props["threshold"]:
            self._silent_run += duration
        else:
            self._silent_run = 0.0
            self._silent = False
        if self._silent_run > self.props["run-length"]:
            self._silent = True

        out: List[Buffer] = []
        if self._silent != silent_prev:
            self._post(not self._silent, buf.pts)
            if not self._silent:
                out.extend(self._pre)      # flush pre-roll
                self._pre = []
                self._pre_run = 0.0

        if self._silent:
            self._pre.append(buf)
            self._pre_run += duration
            while self._pre_run > self.props["pre-length"] and self._pre:
                old = self._pre.pop(0)
                odur = (old.data.shape[0]
                        * 1_000_000_000 / rate)
                self._pre_run -= odur
                if not self.props["leaky"]:
                    out.append(old)
        else:
            out.append(buf)

        if not out:
            return None
        if len(out) == 1:
            return out[0]
        data = torch.cat([b.data for b in out], dim=0)
        return out[0].with_(
            data=data,
            duration=int(data.shape[0] * 1_000_000_000 / rate))
