"""chromaprint — AcoustID audio fingerprinting.

Reference: gst-plugins-bad/ext/chromaprint/gstchromaprint.c — a
passthrough audio filter that feeds interleaved S16 samples to
libchromaprint, and once `duration` seconds (default 120) have been
accumulated — or at EOS, if more than 3 s were seen
(gstchromaprint.c:142) — finishes the fingerprint, exposes it as the
`fingerprint` property and posts it as the
``chromaprint-fingerprint`` tag.

Same architecture as the reference: a wrapper over the system
libchromaprint (present in this image); registered only when the
library loads.

A port of the JAX package's ``elements/chromaprint.py``: the samples are
fed to the library from the host, the buffer passes on where it lies.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)

_PCM = ("audio/x-raw, format=S16LE, rate=[1,2147483647], "
        "channels=[1,2], layout=interleaved")

_CHROMAPRINT_ALGORITHM_DEFAULT = 1      # TEST2


def _load():
    for name in ("libchromaprint.so.1", "libchromaprint.so",
                 ctypes.util.find_library("chromaprint")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.chromaprint_new.restype = ctypes.c_void_p
        lib.chromaprint_new.argtypes = [ctypes.c_int]
        lib.chromaprint_free.argtypes = [ctypes.c_void_p]
        lib.chromaprint_start.argtypes = [ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_int]
        lib.chromaprint_feed.argtypes = [ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_int]
        lib.chromaprint_finish.argtypes = [ctypes.c_void_p]
        lib.chromaprint_get_fingerprint.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)]
        lib.chromaprint_dealloc.argtypes = [ctypes.c_void_p]
        return lib
    return None


_LIB = _load()


class ChromaPrint(TransformElement):
    FACTORY = "chromaprint"
    DESCRIPTION = "Find an audio fingerprint using the Chromaprint " \
                  "library"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _PCM),
        PadTemplate("src", PadDirection.SRC, _PCM),
    ]
    PROPERTIES = {
        "duration": (int, 120, "seconds of audio to fingerprint "
                               "(0 = until EOS)"),
        "fingerprint": (str, "", "resulting fingerprint (read)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._ctx = None
        self._nsamples = 0
        self._rate = 0
        self._channels = 0
        self._record = True

    def start(self):
        self._close()
        self._ctx = _LIB.chromaprint_new(_CHROMAPRINT_ALGORITHM_DEFAULT)
        self._nsamples = 0
        self._record = True
        self.props["fingerprint"] = ""

    def stop(self):
        self._close()

    def _close(self):
        if self._ctx:
            _LIB.chromaprint_free(self._ctx)
            self._ctx = None

    def transform_caps(self, direction, caps, filter=None):
        out = []
        for s in caps:
            ns = Caps.from_string(_PCM)[0].copy()
            for key in ("rate", "channels"):
                if key in s.fields:
                    ns[key] = s[key]
            out.append(ns)
        res = Caps(out).simplify()
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        s = incaps[0]
        self._rate = s.get("rate") or 0
        self._channels = s.get("channels") or 0

    def _finish(self):
        if self._ctx is None or not self._record:
            return
        if self._rate and self._nsamples // self._rate <= 3:
            return                     # gstchromaprint.c:142
        self._record = False
        _LIB.chromaprint_finish(self._ctx)
        fp = ctypes.c_char_p()
        _LIB.chromaprint_get_fingerprint(self._ctx, ctypes.byref(fp))
        if fp.value:
            text = fp.value.decode("ascii", "replace")
            _LIB.chromaprint_dealloc(fp)
            self.props["fingerprint"] = text
            self._post_tags({"chromaprint-fingerprint": text})

    def _post_tags(self, tags):
        root = self
        while getattr(root, "parent", None) is not None:
            root = root.parent
        if getattr(root, "bus", None) is not None:
            from ..core.pipeline import Message
            root.bus.post(Message("tag", self.name, tags))
        from ..core.events import tag_event
        for sp in self.src_pads():
            ev = tag_event(tags)
            if sp.peer is not None:
                sp.push_event(ev)
            else:
                sp.sticky[ev.type] = ev

    def sink_event(self, pad, event) -> bool:
        from ..core.events import EventType
        if event.type == EventType.EOS:
            self._finish()
        return super().sink_event(pad, event)

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None or not self._record:
            return buf
        if self._ctx is None:
            self.start()
        if self._rate <= 0 or self._channels <= 0:
            return buf
        d = buf.data
        if isinstance(d, (list, tuple)):
            raw = b"".join(bytes(x) if isinstance(x, (bytes, bytearray))
                           else host_array(x).tobytes() for x in d)
        elif isinstance(d, (bytes, bytearray)):
            raw = bytes(d)
        else:
            raw = host_array(d).tobytes()
        n = len(raw) // (2 * self._channels)
        if n == 0:
            return buf
        if self._nsamples == 0:
            _LIB.chromaprint_start(self._ctx, self._rate,
                                   self._channels)
        self._nsamples += n
        _LIB.chromaprint_feed(self._ctx, raw, len(raw) // 2)
        md = self.props["duration"]
        if md and self._nsamples >= md * self._rate:
            self._finish()
        return buf


if _LIB is not None:
    register_element(ChromaPrint)
