"""IPC + misc infrastructure elements: proxysink/proxysrc,
shmsink/shmsrc, souphttpsrc, streamsynchronizer, tsparse,
unalignedvideoparse/unalignedaudioparse.

References:
* gst-plugins-bad/gst/proxy/gstproxysink.c + gstproxysrc.c — a
  zero-copy in-process bridge between two pipelines; proxysrc has a
  `proxysink` property pointing at its peer.
* gst-plugins-bad/sys/shm/gstshmsink.c / gstshmsrc.c — shared-memory
  transport via `socket-path`; the batched model uses a file-backed
  length-prefixed frame log at that path (same cross-process
  observable contract, no live socket handshake).
* gst-plugins-good/ext/soup/gstsouphttpsrc.c — HTTP(S) source with
  location/user-agent/timeout; implemented over urllib so localhost
  servers work without libsoup (zero-egress environments simply get
  the connection error on the bus, as the reference would).
* gst-plugins-base/gst/playback/gststreamsynchronizer.c — aligns
  stream running times when streams switch; the batched single-clock
  graph is inherently aligned, so each instance is a per-stream
  passthrough that preserves the contract.
* gst-plugins-bad/gst/mpegtsdemux/mpegtsparse.c (tsparse) — frames a
  transport stream at 188-byte 0x47 sync boundaries.
* gst-plugins-bad/gst/rawparse/gstunalignedvideoparse.c /
  gstunalignedaudioparse.c — bin wrappers that re-align raw
  video/audio bytestreams (subclasses of our raw parsers).

A copy of the JAX package's ``elements/ipc_misc.py``, over the port's
raw parsers and ``_ParserBase``.  shmsink writes each tick's bytes from
the host (``host_array``); the sources give host bytes, which the pipeline
stages on its device unless their peers take host bytes; proxysrc hands
on proxysink's buffers as they are, on their device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, FlowReturn, host_array
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SinkElement,
                            SourceElement, TransformElement,
                            register_element)
from .audioparsers import _ParserBase
from .rawparse import RawAudioParse, RawVideoParse

# -- proxy pair (in-process pipeline bridge) -------------------------------

_PROXY_CHANNELS: Dict[str, List[Buffer]] = {}


@register_element
class ProxySink(SinkElement):
    FACTORY = "proxysink"
    DESCRIPTION = "Proxy source for internal process communication"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {"channel": (str, "", "bridge id (matching proxysrc)")}

    def start(self):
        key = self.props["channel"] or self.name
        _PROXY_CHANNELS.setdefault(key, [])
        self._caps_seen = None

    def render(self, buf: Buffer) -> str:
        key = self.props["channel"] or self.name
        caps = self.sink_pads()[0].caps
        if caps is not None:
            buf = buf.with_(meta=dict(buf.meta or {}, caps=caps))
        _PROXY_CHANNELS[key].append(buf)
        return FlowReturn.OK


@register_element
class ProxySrc(SourceElement):
    FACTORY = "proxysrc"
    DESCRIPTION = "Proxy sink for internal process communication"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"channel": (str, "", "bridge id (matching proxysink)")}

    def get_caps(self, filter=None):
        q = _PROXY_CHANNELS.get(self.props["channel"], [])
        if q and (q[0].meta or {}).get("caps") is not None:
            caps = q[0].meta["caps"]
            if filter is not None:
                caps = caps.intersect(filter)
            return caps
        if filter is not None and not filter.is_any:
            return filter
        return Caps.from_string("application/octet-stream")

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        q = _PROXY_CHANNELS.get(self.props["channel"], [])
        if self._pos >= len(q):
            return None
        buf = q[self._pos]
        self._pos += 1
        return buf


# -- shm pair (file-backed shared memory log) -------------------------------

@register_element
class ShmSink(SinkElement):
    FACTORY = "shmsink"
    DESCRIPTION = "Send data over shared memory"
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK, Caps.any())]
    PROPERTIES = {
        "socket-path": (str, "/tmp/gtpu-shm", "path of the shm log"),
        "shm-size": (int, 0x400000, "advisory size (unused)"),
        "wait-for-connection": (bool, False, ""),
    }

    def start(self):
        self._file = open(self.props["socket-path"], "wb")

    def stop(self):
        if getattr(self, "_file", None):
            self._file.close()
            self._file = None

    def render(self, buf: Buffer) -> str:
        d = buf.data
        blobs = d if isinstance(d, (list, tuple)) else [d]
        for b in blobs:
            raw = (bytes(b) if isinstance(b, (bytes, bytearray))
                   else host_array(b).tobytes())
            self._file.write(len(raw).to_bytes(8, "little") + raw)
        self._file.flush()
        return FlowReturn.OK


@register_element
class ShmSrc(SourceElement):
    FACTORY = "shmsrc"
    DESCRIPTION = "Receive data from the shared memory sink"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "socket-path": (str, "/tmp/gtpu-shm", "path of the shm log"),
        "is-live": (bool, False, ""),
    }

    def get_caps(self, filter=None):
        if filter is not None and not filter.is_any:
            return filter
        return Caps.from_string("application/octet-stream")

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        self._file = open(self.props["socket-path"], "rb")

    def stop(self):
        if getattr(self, "_file", None):
            self._file.close()
            self._file = None

    def create(self, n_frames: int) -> Optional[Buffer]:
        hdr = self._file.read(8)
        if len(hdr) < 8:
            return None
        size = int.from_bytes(hdr, "little")
        raw = self._file.read(size)
        if len(raw) < size:
            return None
        return Buffer(data=np.frombuffer(raw, np.uint8), batch=1)


# -- souphttpsrc ------------------------------------------------------------

@register_element
class SoupHttpSrc(SourceElement):
    FACTORY = "souphttpsrc"
    DESCRIPTION = "Receive data as a client over the network via " \
                  "HTTP using SOUP"
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "location": (str, "", "URI to read from"),
        "user-agent": (str, "gstreamer_tpu souphttpsrc", ""),
        "timeout": (int, 15, "seconds"),
        "blocksize": (int, 4096, "bytes per buffer"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._resp = None

    def get_caps(self, filter=None):
        if filter is not None and not filter.is_any:
            return filter
        return Caps.from_string("application/octet-stream")

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        import urllib.request
        req = urllib.request.Request(
            self.props["location"],
            headers={"User-Agent": self.props["user-agent"]})
        self._resp = urllib.request.urlopen(
            req, timeout=self.props["timeout"])

    def stop(self):
        if self._resp is not None:
            self._resp.close()
            self._resp = None

    def create(self, n_frames: int) -> Optional[Buffer]:
        raw = self._resp.read(self.props["blocksize"]
                              * max(1, n_frames))
        if not raw:
            return None
        return Buffer(data=np.frombuffer(raw, np.uint8), batch=1)


# -- streamsynchronizer -----------------------------------------------------

@register_element
class StreamSynchronizer(TransformElement):
    """Per-stream passthrough: the batched graph shares one clock so
    running-time alignment (the reference's job during stream
    switches) holds by construction."""
    FACTORY = "streamsynchronizer"
    DESCRIPTION = "Synchronizes a group of streams to have equal " \
                  "timestamps/running time"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]


# -- tsparse ----------------------------------------------------------------

@register_element
class TsParse(_ParserBase):
    FACTORY = "tsparse"
    DESCRIPTION = "Parses MPEG2 transport streams"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, "video/mpegts"),
        PadTemplate("src", PadDirection.SRC,
                    "video/mpegts, systemstream=true, packetsize=188"),
    ]
    _SRC_CAPS = "video/mpegts, systemstream=true, packetsize=188"

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.set_min_frame_size(188)

    def handle_frame(self, view):
        raw = bytes(view)
        if raw[0] != 0x47:
            nxt = raw.find(b"\x47", 1)
            return 0, (nxt if nxt > 0 else len(raw))
        # require the NEXT sync byte too unless draining
        if len(raw) >= 189 and raw[188] != 0x47:
            return 0, 1                  # false sync, resync
        if len(raw) < 188:
            return 0, 0
        return 188, 0


# -- unaligned raw parsers --------------------------------------------------

@register_element
class UnalignedVideoParse(RawVideoParse):
    """gstunalignedvideoparse.c: bin around rawvideoparse re-aligning
    arbitrary byte chunks to frame boundaries (our rawvideoparse
    already adapters unaligned input)."""
    FACTORY = "unalignedvideoparse"
    DESCRIPTION = "Parse unaligned raw video data"


@register_element
class UnalignedAudioParse(RawAudioParse):
    FACTORY = "unalignedaudioparse"
    DESCRIPTION = "Parse unaligned raw audio data"


@register_element
class NeonHttpSrc(SoupHttpSrc):
    """neonhttpsrc (gst-plugins-bad/ext/neon/gstneonhttpsrc.c): the
    libneon-based HTTP source — same surface as souphttpsrc here."""
    FACTORY = "neonhttpsrc"
    DESCRIPTION = "Receive data as a client over the network via " \
                  "HTTP using NEON"
