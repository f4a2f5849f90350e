"""insertbin, testsrcbin, rtponviftimestamp/rtponvifparse,
face detector tensor decoder.

References (gst-plugins-bad):
* gst/insertbin/gstinsertbin.c — a bin whose filters can be
  appended/prepended/removed at runtime; the batched model applies
  the chain at negotiation time and re-compiles on change (the
  pipeline's RECONFIGURE path).
* gst/debugutils/gsttestsrcbin.c — one bin producing both audio and
  video test streams on request pads.
* gst/onvif/gstrtponviftimestamp.c — appends the ONVIF NTP 12-byte
  RTP header extension (0xABAC magic, 64-bit NTP timestamp, C/E/D
  flags + CSeq); gstrtponvifparse.c strips/uses it.
* gst/tensordecoders/gstfacedetectortensordecoder.c
  ("facedetectortensordecoder") — boxes+scores like SSD with the
  face label.

A port of the JAX package's ``elements/bad_bins.py``: insertbin runs its
chain's torch functions (or host steps) on the pipeline's device;
testsrcbin drives the port's videotestsrc / audiotestsrc through their
device generators; the ONVIF elements and the face decoder are the JAX
package's host code (RTP packets and tensors on the host).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadPresence, PadTemplate,
                            SourceElement, TransformElement,
                            element_factory_make, register_element)


@register_element
class InsertBin(TransformElement):
    """insertbin: an editable chain of filter elements applied in
    order.  append()/prepend()/remove() mutate the chain; the next
    negotiation pass rebuilds the composite."""
    FACTORY = "insertbin"
    DESCRIPTION = "Auto-linking bin of dynamically insertable " \
                  "elements"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._chain: List = []

    def append(self, elem_or_factory) -> None:
        self._chain.append(self._make(elem_or_factory))

    def prepend(self, elem_or_factory) -> None:
        self._chain.insert(0, self._make(elem_or_factory))

    def remove(self, elem) -> None:
        self._chain = [e for e in self._chain
                       if e is not elem and e.name != str(elem)]

    @staticmethod
    def _make(e):
        return element_factory_make(e) if isinstance(e, str) else e

    def transform_caps(self, direction, caps, filter=None):
        chain = (self._chain if direction == PadDirection.SINK
                 else list(reversed(self._chain)))
        res = caps
        for e in chain:
            res = e.transform_caps(direction, res, None)
        if filter is not None and not res.is_any:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        cur = incaps
        self._infos = []
        for e in self._chain:
            e.device = self.device
            out = e.transform_caps(PadDirection.SINK, cur, None)
            out = out.fixate() if not out.is_fixed() else out
            e.set_info(cur, out)
            e.start()
            self._infos.append((cur, out))
            cur = out

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        for e in self._chain:
            if buf is None:
                return None
            if getattr(e, "HOST_ELEMENT", False):
                buf = e.host_process(buf)
            else:
                fn = e.make_fn()
                if fn is not None and buf is not None:
                    buf = buf.with_(data=fn(buf.data))
        return buf


@register_element
class TestSrcBin(SourceElement):
    """testsrcbin: videotestsrc+audiotestsrc in one source; `stream`
    chooses which branch this instance feeds (per-branch collapse of
    the request-pad bin)."""
    FACTORY = "testsrcbin"
    DESCRIPTION = "Test source bin"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "stream": (str, "video", "video|audio"),
        "num-buffers": (int, 10, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._inner = None

    def _ensure(self):
        if self._inner is None:
            factory = ("videotestsrc" if self.props["stream"]
                       == "video" else "audiotestsrc")
            self._inner = element_factory_make(
                factory, **{"num-buffers": self.props["num-buffers"]})

    def get_caps(self, filter=None):
        self._ensure()
        return self._inner.get_caps(filter)

    def fixate(self, caps):
        self._ensure()
        return self._inner.fixate(caps)

    def set_info(self, incaps, outcaps):
        self._inner.device = self.device
        self._inner.set_info(incaps, outcaps)

    def start(self):
        self._ensure()
        self._inner.start()

    def stop(self):
        if self._inner:
            self._inner.stop()

    def generator_fn(self):
        return self._inner.generator_fn()

    def create(self, n_frames):
        return self._inner.create(n_frames)

    def __getattr__(self, item):
        inner = object.__getattribute__(self, "__dict__").get("_inner")
        if inner is not None and hasattr(inner, item):
            return getattr(inner, item)
        raise AttributeError(item)


_ONVIF_MAGIC = 0xABAC


def onvif_extension(ntp_ts: int, cseq: int = 0, c: bool = False,
                    e: bool = False, d: bool = False) -> bytes:
    """RFC 5285 one-word header ext: 0xABAC id + 3 words payload
    (gstrtponviftimestamp.c layout)."""
    flags = (0x80 if c else 0) | (0x40 if e else 0) \
        | (0x20 if d else 0)
    payload = struct.pack(">Q", ntp_ts) + bytes([flags, cseq & 0xFF,
                                                 0, 0])
    return struct.pack(">HH", _ONVIF_MAGIC, len(payload) // 4) \
        + payload


def parse_onvif_extension(ext: bytes) -> Optional[dict]:
    if len(ext) < 16:
        return None
    magic, words = struct.unpack(">HH", ext[:4])
    if magic != _ONVIF_MAGIC or words < 3:
        return None
    ntp = struct.unpack(">Q", ext[4:12])[0]
    flags, cseq = ext[12], ext[13]
    return {"ntp": ntp, "c": bool(flags & 0x80),
            "e": bool(flags & 0x40), "d": bool(flags & 0x20),
            "cseq": cseq}


def _set_ext_flag(pkt: bytes, ext: bytes) -> bytes:
    b = bytearray(pkt)
    b[0] |= 0x10                         # X bit
    return bytes(b[:12]) + ext + bytes(b[12:])


def _strip_ext(pkt: bytes):
    if not pkt[0] & 0x10:
        return pkt, None
    words = struct.unpack(">H", pkt[14:16])[0]
    ext = pkt[12:16 + words * 4]
    out = bytearray(pkt[:12]) + pkt[16 + words * 4:]
    out[0] &= ~0x10
    return bytes(out), ext


@register_element
class RtpOnvifTimestamp(TransformElement):
    FACTORY = "rtponviftimestamp"
    DESCRIPTION = "Add absolute timestamps and flags of recorded " \
                  "data in a playback session"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]
    PROPERTIES = {
        "ntp-offset": (int, 0, "ns offset added to pts"),
        "set-e-bit": (bool, False, "E on the stream's last packet"),
    }

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        d = buf.data
        pkts = [bytes(x) if isinstance(x, (bytes, bytearray))
                else host_array(x).tobytes()
                for x in (d if isinstance(d, (list, tuple)) else [d])]
        pts = (buf.pts or 0) + self.props["ntp-offset"]
        # ns -> NTP 64-bit (seconds << 32 | frac)
        sec, rem = divmod(pts, 1_000_000_000)
        ntp = (sec << 32) | (rem * (1 << 32) // 1_000_000_000)
        out = [_set_ext_flag(p, onvif_extension(ntp)) for p in pkts]
        return buf.with_(data=out)


@register_element
class RtpOnvifParse(TransformElement):
    FACTORY = "rtponvifparse"
    DESCRIPTION = "Extract ONVIF timestamps from RTP packets"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "application/x-rtp"),
        PadTemplate("src", PadDirection.SRC, "application/x-rtp"),
    ]

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        d = buf.data
        pkts = [bytes(x) if isinstance(x, (bytes, bytearray))
                else host_array(x).tobytes()
                for x in (d if isinstance(d, (list, tuple)) else [d])]
        out = []
        ntp = None
        for p in pkts:
            stripped, ext = _strip_ext(p)
            if ext is not None:
                info = parse_onvif_extension(ext)
                if info:
                    ntp = info["ntp"]
            out.append(stripped)
        meta = dict(buf.meta or {})
        if ntp is not None:
            meta["onvif-ntp"] = ntp
        return buf.with_(data=out, meta=meta)


@register_element
class FaceDetectorTensorDecoder(TransformElement):
    """facedetectortensordecoder: boxes+scores tensors -> OD metas
    labelled 'face' (gstfacedetectortensordecoder.c)."""
    FACTORY = "facedetectortensordecoder"
    DESCRIPTION = "Detect faces in video frames from inference " \
                  "tensors"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]
    PROPERTIES = {
        "score-threshold": (float, 0.5, ""),
        "boxes-tensor-id": (str, "boxes", ""),
        "scores-tensor-id": (str, "scores", ""),
    }

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if buf is None:
            return None
        from ..analytics.meta import TensorMtd, relation_meta_of
        for k, rmeta in relation_meta_of(buf).items():
            tensors = {tm.tensor.id: tm.tensor.numpy()
                       for tm in rmeta.iter_mtds(TensorMtd)}
            boxes = tensors.get(self.props["boxes-tensor-id"])
            scores = tensors.get(self.props["scores-tensor-id"])
            if boxes is None or scores is None:
                continue
            boxes = boxes.reshape(-1, 4)
            scores = scores.reshape(-1)
            for i in np.nonzero(
                    scores >= self.props["score-threshold"])[0]:
                y1, x1, y2, x2 = boxes[i]
                rmeta.add_od_mtd("face", float(x1), float(y1),
                                 float(x2 - x1), float(y2 - y1),
                                 float(scores[i]))
        return buf
