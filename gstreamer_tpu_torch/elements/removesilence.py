"""removesilence — VAD-driven silence removal, in torch.

A port of the JAX package's ``elements/removesilence.py`` (reference:
gst-plugins-bad gst/removesilence/):

* vad_private.c — the Q16 exponential power tracker updated per sample
  (:124-127), a zero-crossing score over the last 256 samples (+1 per sign
  change, -1 otherwise, :135-144), frame = VOICE iff power > threshold and
  zcr < 0; voice -> silence deferred until `hysteresis` samples accumulate
  (:149-163); threshold(dB) -> power via 10^(int(dB/10)) * (2^32-1)
  (vad_set_threshold :105-109).
* gstremovesilence.c — with remove=true, silent buffers past the
  minimum-silence-buffers/-time guards are dropped; squash=true shortens
  the output timeline by the removed duration; "removesilence" bus
  messages carry silence_detected / silence_finished timestamps.

The power recursion runs on the buffer's device (``ops/vad_kernel.py``:
the CUDA kernel on the card, its plain version on the CPU) and returns the
final power; the zero-crossing ring, the state machine, the guards and the
messages are host code, copied.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..audio.info import AudioInfo
from ..core.buffer import Buffer
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..ops import vad_kernel

_VAD_BUFFER = 256

_CAPS = ("audio/x-raw, format=S16LE, rate=[1,2147483647], channels=1, "
         "layout=interleaved")


class Vad:
    """The VADFilter state machine (vad_private.c)."""

    SILENCE, VOICE = 0, 1

    def __init__(self, hysteresis: int, threshold_db: int):
        self.hysteresis = hysteresis
        self.set_threshold(threshold_db)
        self.reset()

    def reset(self):
        self.power = 0
        self.state = self.SILENCE
        self.samples = 0
        self.ring = np.zeros(_VAD_BUFFER, np.int16)
        self.head = 0
        self.filled = 0

    def set_threshold(self, threshold_db: int):
        power = int(threshold_db / 10.0)
        self.threshold = int((10.0 ** power) * 4294967295)

    def update(self, data) -> int:
        """One buffer of int16 samples (a tensor on any device, or an
        array) -> the state after it."""
        data = torch.as_tensor(data).reshape(-1).to(torch.int16).contiguous()
        n = len(data)
        if n == 0:
            return self.state
        p0 = torch.tensor([self.power], dtype=torch.int64, device=data.device)
        self.power = int(vad_kernel.vad_power(data[None], p0)[0])
        # ring buffer of the last 256 samples
        take = data[-_VAD_BUFFER:].cpu().numpy()
        m = len(take)
        idx = (self.head + np.arange(m)) % _VAD_BUFFER
        self.ring[idx] = take
        self.head = (self.head + m) % _VAD_BUFFER
        self.filled = min(self.filled + m, _VAD_BUFFER)
        # zcr over the ring in insertion order, tail..head (vad_private.c:
        # the queue holds size-1 usable entries once full)
        if self.filled >= _VAD_BUFFER:
            order = (self.head + np.arange(_VAD_BUFFER)) % _VAD_BUFFER
        else:
            order = np.arange(self.filled)
        seq = self.ring[order]
        if len(seq) >= 2:
            signs = (seq.astype(np.uint16) & 0x8000)
            zcr = int(np.where(signs[:-1] != signs[1:], 1, -1).sum())
        else:
            zcr = 0
        frame = (self.VOICE if (self.power > self.threshold and zcr < 0)
                 else self.SILENCE)
        if self.state != frame:
            if self.state == self.VOICE:
                self.samples += n
                if self.samples >= self.hysteresis:
                    self.state = frame
                    self.samples = 0
            else:
                self.state = frame
                self.samples = 0
        else:
            self.samples = 0
        return self.state


@register_element
class RemoveSilence(TransformElement):
    FACTORY = "removesilence"
    DESCRIPTION = "Removes all the silence periods from the audio stream"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CAPS),
        PadTemplate("src", PadDirection.SRC, _CAPS),
    ]
    PROPERTIES = {
        "remove": (bool, False, "drop silent buffers"),
        "hysteresis": (int, 480, "voice->silence delay (samples)"),
        "threshold": (int, -60, "power threshold (dB)"),
        "squash": (bool, False, "compact the timeline"),
        "silent": (bool, True, "no bus messages"),
        "minimum-silence-buffers": (int, 0, "guard before dropping"),
        "minimum-silence-time": (int, 0, "guard ns before dropping"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.start()

    def start(self):
        self._vad = Vad(self.props["hysteresis"],
                        self.props["threshold"])
        self._consec = 0
        self._consec_ns = 0
        self._ts_offset = 0
        self._was_silence = False

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def _post(self, key: str, ts):
        if self.props["silent"]:
            return
        root = self
        while getattr(root, "parent", None) is not None:
            root = root.parent
        if hasattr(root, "bus"):
            from ..core.pipeline import Message
            root.bus.post(Message("element", self.name, {
                "name": "removesilence", key: ts}))

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        x = buf.data
        state = self._vad.update(x)
        silence = state == Vad.SILENCE
        dur = (len(x) * 1_000_000_000 // self._info.rate
               if buf.duration is None else buf.duration)
        if silence and not self._was_silence:
            self._post("silence_detected", buf.pts)
        elif not silence and self._was_silence:
            self._post("silence_finished", buf.pts)
            self._consec = 0
            self._consec_ns = 0
        self._was_silence = silence

        if silence and self.props["remove"]:
            self._consec += 1
            self._consec_ns += dur
            if (self._consec > self.props["minimum-silence-buffers"]
                    and self._consec_ns
                    >= self.props["minimum-silence-time"]):
                if self.props["squash"]:
                    self._ts_offset += dur
                return None                      # dropped
        if self._ts_offset and buf.pts is not None:
            return buf.with_(pts=buf.pts - self._ts_offset)
        return buf
