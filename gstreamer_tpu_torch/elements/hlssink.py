"""hlssink2 — HLS VOD authoring: rotating MPEG-TS segments + M3U8
playlist.

Reference: gst-plugins-bad/ext/hls/gsthlssink2.c (drives an internal
splitmuxsink with mpegtsmux and rewrites the playlist per segment).
Here the TS writing is delegated to an internal mpegtsmux instance
that is restarted per segment (every segment begins with PAT/PMT);
the playlist is written at EOS with per-segment EXTINF durations.

Segment rotation happens at tick boundaries once target-duration is
reached (the batch model's analog of splitmuxsink's keyframe-aligned
fragment cuts; pair with an encoder whose keyframe interval divides
the tick cadence for clean player seeks).

A copy of the JAX package's ``elements/hlssink.py`` over the port's
``mpegts.MpegTsMux`` and ``isomp4.CmafMux``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadPresence,
                            PadTemplate, register_element)
from .mpegts import MpegTsMux


@register_element
class HlsSink2(AggregatorElement):
    FACTORY = "hlssink2"
    DESCRIPTION = "HTTP Live Streaming sink"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK,
                    "audio/mpeg; audio/x-ac3; video/x-h264; "
                    "video/x-h265; video/mpeg; "
                    "application/octet-stream",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC, "video/mpegts"),
    ]
    PROPERTIES = {
        "location": (str, "segment%05d.ts", "segment file template"),
        "playlist-location": (str, "playlist.m3u8", "playlist path"),
        "target-duration": (int, 15, "segment duration in seconds"),
        "playlist-root": (str, "", "URI prefix for segment entries"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._mux: Optional[MpegTsMux] = None
        self._segments = []                  # (path, duration_s)
        self._seg_index = 0
        self._seg_start_ns = None
        self._last_end_ns = 0
        self._in_caps = None

    def negotiate_output(self, in_caps: Dict[str, Caps], allowed):
        self._in_caps = in_caps
        self._probe = MpegTsMux()
        self._probe.negotiate_output(in_caps, allowed)
        return Caps.from_string("video/mpegts, systemstream=true, "
                                "packetsize=188")

    def _segment_path(self) -> str:
        tmpl = self.props["location"]
        return (tmpl % self._seg_index) if "%" in tmpl \
            else f"{tmpl}.{self._seg_index}"

    def _open_segment(self):
        self._mux = MpegTsMux(location=self._segment_path())
        self._mux.negotiate_output(self._in_caps, None)
        self._mux.start()
        self._seg_start_ns = None

    def _close_segment(self, end_ns: int):
        if self._mux is None:
            return
        self._mux.stop()
        dur = max((end_ns - (self._seg_start_ns or 0)) / 1e9, 0.001)
        self._segments.append((self._segment_path(), dur))
        self._seg_index += 1
        self._mux = None

    def start(self):
        self._segments = []
        self._seg_index = 0
        self._last_end_ns = 0
        self._open_segment()

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        first = next(iter(ins.values()))
        pts = first.pts or self._last_end_ns
        if self._seg_start_ns is None:
            self._seg_start_ns = pts
        target_ns = self.props["target-duration"] * 1_000_000_000
        if pts - self._seg_start_ns >= target_ns:
            self._close_segment(pts)
            self._open_segment()
            self._seg_start_ns = pts
        self._mux.host_aggregate(ins)
        end = pts
        if first.duration:
            end += first.duration * max(first.batch, 1)
        self._last_end_ns = max(self._last_end_ns, end)
        return first.with_(data=np.zeros(1, np.uint8))

    def stop(self):
        self._close_segment(self._last_end_ns)
        target = max((d for _, d in self._segments), default=1)
        root = self.props["playlist-root"]
        lines = ["#EXTM3U", "#EXT-X-VERSION:3",
                 f"#EXT-X-TARGETDURATION:{int(target + 0.999)}",
                 "#EXT-X-MEDIA-SEQUENCE:0",
                 "#EXT-X-PLAYLIST-TYPE:VOD"]
        for path, dur in self._segments:
            name = os.path.basename(path)
            uri = f"{root.rstrip('/')}/{name}" if root else name
            lines.append(f"#EXTINF:{dur:.3f},")
            lines.append(uri)
        lines.append("#EXT-X-ENDLIST")
        with open(self.props["playlist-location"], "w") as f:
            f.write("\n".join(lines) + "\n")


@register_element
class HlsSink(HlsSink2):
    """hlssink (gsthlssink.c): the single-pad variant — same writer,
    pre-muxed TS input goes through an octet pad."""
    FACTORY = "hlssink"
    DESCRIPTION = "HTTP Live Streaming sink"


@register_element
class DashSink(HlsSink2):
    """dashsink (gst-plugins-bad/ext/dash/gstdashsink.c reduced):
    same rotating-TS-segment writer, static-MPD manifest with a
    SegmentList (pairs with dashdemux's SegmentList walk)."""
    FACTORY = "dashsink"
    DESCRIPTION = "Dynamic Adaptive Streaming over HTTP sink"
    PROPERTIES = dict(
        HlsSink2.PROPERTIES,
        **{"mpd-filename": (str, "manifest.mpd", "manifest path"),
           "segment-format": (str, "ts", "ts | fmp4 (CMAF)")})

    def _fmp4(self) -> bool:
        return self.props.get("segment-format") == "fmp4"

    def negotiate_output(self, in_caps, allowed):
        if not self._fmp4():
            return super().negotiate_output(in_caps, allowed)
        from .isomp4 import CmafMux
        self._in_caps = in_caps
        self._cmux = CmafMux()
        self._cmux.negotiate_output(in_caps, allowed)
        return Caps.from_string("video/quicktime, variant=cmaf")

    def _init_path(self) -> str:
        import os as _os
        return _os.path.join(
            _os.path.dirname(self.props["mpd-filename"]) or ".",
            "init.mp4")

    def _open_segment(self):
        if not self._fmp4():
            return super()._open_segment()
        path = self._segment_path()
        self._cmux._file = open(path, "wb")
        if not getattr(self._cmux, "_header_done", False):
            self._cmux._seq = getattr(self._cmux, "_seq", 1)
            self._cmux._init_file = open(self._init_path(), "wb")
        self._seg_start_ns = None

    def _close_segment(self, end_ns: int):
        if not self._fmp4():
            return super()._close_segment(end_ns)
        f = getattr(self._cmux, "_file", None)
        if f is None:
            return
        f.close()
        self._cmux._file = None
        dur = max((end_ns - (self._seg_start_ns or 0)) / 1e9, 0.001)
        self._segments.append((self._segment_path(), dur))
        self._seg_index += 1

    def start(self):
        if not self._fmp4():
            return super().start()
        self._segments = []
        self._seg_index = 0
        self._last_end_ns = 0
        self._cmux._seq = 1
        self._cmux._header_done = False
        self._cmux._init_file = None
        self._cmux._file = None
        self._open_segment()

    def host_aggregate(self, ins):
        if not self._fmp4():
            return super().host_aggregate(ins)
        first = next(iter(ins.values()))
        pts = first.pts or self._last_end_ns
        if self._seg_start_ns is None:
            self._seg_start_ns = pts
        target_ns = self.props["target-duration"] * 1_000_000_000
        if pts - self._seg_start_ns >= target_ns:
            self._close_segment(pts)
            self._open_segment()
            self._seg_start_ns = pts
        self._cmux.host_aggregate(ins)
        end = pts
        if first.duration:
            end += first.duration * max(first.batch, 1)
        self._last_end_ns = max(self._last_end_ns, end)
        return first.with_(data=np.zeros(1, np.uint8))

    def stop(self):
        self._close_segment(self._last_end_ns)
        total = sum(d for _, d in self._segments)
        maxd = max((d for _, d in self._segments), default=1.0)
        root = self.props["playlist-root"]
        urls = []
        for path, _d in self._segments:
            name = os.path.basename(path)
            uri = f"{root.rstrip('/')}/{name}" if root else name
            urls.append(f'      <SegmentURL media="{uri}"/>')
        mime = "video/mp4" if self._fmp4() else "video/mp2t"
        init_line = ""
        if self._fmp4():
            iname = os.path.basename(self._init_path())
            iuri = (f"{root.rstrip('/')}/{iname}" if root else iname)
            init_line = (f'      <Initialization '
                         f'sourceURL="{iuri}"/>\n')
        mpd = (
            '<?xml version="1.0" encoding="UTF-8"?>\n'
            '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" type="static"\n'
            f'     mediaPresentationDuration="PT{total:.3f}S"\n'
            '     profiles="urn:mpeg:dash:profile:isoff-main:2011">\n'
            ' <Period>\n'
            f'  <AdaptationSet mimeType="{mime}">\n'
            '   <Representation id="1" bandwidth="1000000">\n'
            f'    <SegmentList duration="{maxd:.0f}">\n'
            + init_line
            + "\n".join(urls) + "\n"
            '    </SegmentList>\n'
            '   </Representation>\n'
            '  </AdaptationSet>\n'
            ' </Period>\n'
            '</MPD>\n')
        with open(self.props["mpd-filename"], "w") as f:
            f.write(mpd)
