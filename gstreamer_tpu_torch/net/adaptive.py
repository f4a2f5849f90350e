"""Adaptive streaming demuxers: hlsdemux (M3U8) and dashdemux (MPD).

References:
* gst-plugins-bad/ext/hls/ — gsthlsdemux.c + m3u8.c: master playlist
  variant selection (EXT-X-STREAM-INF bandwidth), media playlist
  segment walk (EXTINF entries, MEDIA-SEQUENCE, ENDLIST), segment
  download + push.
* gst-plugins-bad/ext/dash/gstdashdemux.c + gstmpdparser.c: static
  MPD — Period/AdaptationSet/Representation, SegmentList/SegmentURL,
  SegmentTemplate with $Number$/$RepresentationID$ substitution,
  BaseURL resolution, highest-bandwidth representation selection.

Reduction: source-style elements (`uri` property, like
wavparse's pull collapse) for STATIC (VOD) playlists — the batched
offline graph consumes the whole segment list; live reload loops are
out of scope.  Segments resolve over file:// or http(s):// (urllib —
localhost servers need no egress).  Output buffers carry the raw
segment bytes (video/mpegts for .ts, parsed downstream by
tsparse/tsdemux).

A copy of the JAX package's ``net/adaptive.py``: the same playlists,
manifests and segment lists.  With ``stream=`` set, the inner chain runs
on the element's device over the port's ``elements/playback.py``
(``_ChainSrc``, ``_decoder_for_caps``), which raises ``RuntimeError``
naming the system codec for a libav decoder that is not registered (the
system libavcodec lacks its codec)."""

from __future__ import annotations

import re
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, SourceElement,
                            register_element)


def _fetch(uri: str) -> bytes:
    if "://" not in uri:
        uri = "file://" + uri
    with urllib.request.urlopen(uri) as r:
        return r.read()


def _resolve(base: str, ref: str) -> str:
    if "://" not in base:
        base = "file://" + base
    return urllib.parse.urljoin(base, ref)


def parse_m3u8(text: str, base: str) -> dict:
    """Master or media playlist -> {variants | segments}."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines or lines[0] != "#EXTM3U":
        raise ValueError("hlsdemux: not an M3U8 playlist")
    variants: List[Tuple[int, str]] = []
    segments: List[Tuple[float, str]] = []
    media_seq = 0
    target_dur = 0.0
    endlist = False
    pend_bw: Optional[int] = None
    pend_dur: Optional[float] = None
    for ln in lines[1:]:
        if ln.startswith("#EXT-X-STREAM-INF:"):
            m = re.search(r"BANDWIDTH=(\d+)", ln)
            pend_bw = int(m.group(1)) if m else 0
        elif ln.startswith("#EXTINF:"):
            pend_dur = float(ln[8:].split(",")[0])
        elif ln.startswith("#EXT-X-MEDIA-SEQUENCE:"):
            media_seq = int(ln.split(":", 1)[1])
        elif ln.startswith("#EXT-X-TARGETDURATION:"):
            target_dur = float(ln.split(":", 1)[1])
        elif ln.startswith("#EXT-X-ENDLIST"):
            endlist = True
        elif not ln.startswith("#"):
            uri = _resolve(base, ln)
            if pend_bw is not None:
                variants.append((pend_bw, uri))
                pend_bw = None
            else:
                segments.append((pend_dur or 0.0, uri))
                pend_dur = None
    return {"variants": variants, "segments": segments,
            "media_sequence": media_seq, "target_duration": target_dur,
            "endlist": endlist}


class _AdaptiveSrc(SourceElement):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {
        "uri": (str, "", "playlist/manifest URI or path"),
        "location": (str, "", "alias of uri"),
        "stream": (str, "", "'' (segment bytes) | audio | video | N — "
                            "decode TS segments to raw media"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._segments: Optional[List[Tuple[float, str]]] = None
        self._pos = 0
        self._inner = None

    def _ensure_inner(self):
        """stream= set: concatenate the TS segments (transport streams
        are concatenation-safe) and decode through an internal
        tsdemux ! parser ! decoder chain — the collapsed analog of
        hlsdemux feeding decodebin in the reference."""
        if self._inner is not None or not self.props.get("stream"):
            return
        import os
        import tempfile
        from ..core.element import element_factory_make
        from ..elements.playback import _ChainSrc, _decoder_for_caps
        if self._segments is None:
            self._load()
        first = (self._segments[0][1].split("?")[0].lower()
                 if self._segments else "")
        want = self.props["stream"]
        blob = b"".join(_fetch(uri) for _, uri in self._segments)
        if first.endswith((".mp4", ".m4s", ".m4v", ".cmfv",
                           ".cmfa", ".mov")):
            # fMP4/CMAF segments: init + moof fragments concatenate
            # into one fragmented movie (the qtdemux moof walk)
            fd, path = tempfile.mkstemp(suffix=".mp4")
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            self._tmppath = path
            probe = element_factory_make("qtdemux", location=path,
                                         stream=want)
            caps = probe.get_caps()
            dec = _decoder_for_caps(caps)
            desc = (f"qtdemux location={path} stream={want}"
                    + (f" ! {dec}" if dec else ""))
            self._inner = _ChainSrc(description=desc)
            self._inner.device = self.device
            return
        if not first.endswith(".ts"):
            raise ValueError(f"{self.FACTORY}: stream= decode "
                             "supports TS or fMP4 segments")
        fd, path = tempfile.mkstemp(suffix=".ts")
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        self._tmppath = path
        sel = None
        caps = None
        for idx in range(16):
            probe = element_factory_make("tsdemux", location=path,
                                         stream=str(idx))
            caps = probe.get_caps()
            if caps is None or caps.is_any or not len(caps):
                break
            name = caps[0].name
            if (want == str(idx)
                    or (want == "video"
                        and name.startswith(("video/", "image/")))
                    or (want == "audio"
                        and name.startswith("audio/"))):
                sel = idx
                break
        if sel is None:
            raise ValueError(f"{self.FACTORY}: no {want!r} stream "
                             "in the TS segments")
        parser = ""
        if caps[0].name == "video/x-h264":
            parser = " ! h264parse"
        elif (caps[0].name == "audio/mpeg"
                and caps[0].get("mpegversion") == 4):
            parser = " ! aacparse"
        elif caps[0].name == "audio/mpeg":
            parser = " ! mpegaudioparse"
        elif caps[0].name == "audio/x-ac3":
            parser = " ! ac3parse"
        dec = _decoder_for_caps(caps)
        desc = (f"tsdemux location={path} stream={sel}{parser}"
                + (f" ! {dec}" if dec else ""))
        self._inner = _ChainSrc(description=desc)
        self._inner.device = self.device

    def _uri(self) -> str:
        return self.props["uri"] or self.props["location"]

    def _load(self) -> None:
        raise NotImplementedError

    def _media_caps(self) -> Caps:
        uri = self._segments[0][1] if self._segments else ""
        path = uri.split("?")[0].lower()
        if path.endswith(".ts"):
            return Caps.from_string(
                "video/mpegts, systemstream=true")
        if path.endswith((".mp4", ".m4s", ".mov")):
            return Caps.from_string("video/quicktime")
        if path.endswith((".aac", ".adts")):
            return Caps.from_string("audio/mpeg, mpegversion=4")
        return Caps.from_string("application/octet-stream")

    def get_caps(self, filter=None):
        if self._segments is None and self._uri():
            try:
                self._load()
            except (OSError, ValueError):
                return (filter if filter is not None
                        else Caps.from_string(
                            "application/octet-stream"))
        if self.props.get("stream"):
            try:
                self._ensure_inner()
            except (OSError, ValueError):
                return Caps.any()
            return self._inner.get_caps(filter)
        caps = self._media_caps() if self._segments else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def set_info(self, incaps, outcaps):
        pass

    def start(self):
        if self._segments is None:
            self._load()
        if self.props.get("stream"):
            self._ensure_inner()
            self._inner.start()
        self._pos = 0

    def create(self, n_frames: int) -> Optional[Buffer]:
        if self._inner is not None:
            return self._inner.create(n_frames)
        if self._pos >= len(self._segments):
            return None
        dur, uri = self._segments[self._pos]
        self._pos += 1
        raw = _fetch(uri)
        return Buffer(data=np.frombuffer(raw, np.uint8), batch=1,
                      duration=int(dur * 1_000_000_000) or None)


@register_element
class HlsDemux(_AdaptiveSrc):
    FACTORY = "hlsdemux"
    DESCRIPTION = "HTTP Live Streaming demuxer"

    def _load(self) -> None:
        uri = self._uri()
        pl = parse_m3u8(_fetch(uri).decode("utf-8", "replace"), uri)
        if pl["variants"]:
            # highest bandwidth variant (gsthlsdemux.c initial
            # selection picks per connection-speed; we take the top)
            _, vuri = max(pl["variants"], key=lambda v: v[0])
            pl = parse_m3u8(_fetch(vuri).decode("utf-8", "replace"),
                            vuri)
        if not pl["segments"]:
            raise ValueError("hlsdemux: playlist has no segments")
        self._segments = pl["segments"]


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _mpd_duration(s: Optional[str]) -> float:
    """ISO 8601 'PT...S' duration."""
    if not s:
        return 0.0
    m = re.match(r"PT(?:(\d+)H)?(?:(\d+)M)?(?:([\d.]+)S)?", s)
    if not m:
        return 0.0
    h, mi, sec = (float(x) if x else 0.0 for x in m.groups())
    return h * 3600 + mi * 60 + sec


@register_element
class DashDemux(_AdaptiveSrc):
    FACTORY = "dashdemux"
    DESCRIPTION = "Dynamic Adaptive Streaming over HTTP demuxer"

    def _load(self) -> None:
        uri = self._uri()
        root = ET.fromstring(_fetch(uri))
        base = uri
        segs: List[Tuple[float, str]] = []

        def walk_base(el, cur):
            for child in el:
                if _strip_ns(child.tag) == "BaseURL" and child.text:
                    return _resolve(cur, child.text.strip())
            return cur

        base = walk_base(root, base)
        best = None                       # (bandwidth, rep, aset, per)
        for period in root:
            if _strip_ns(period.tag) != "Period":
                continue
            pbase = walk_base(period, base)
            for aset in period:
                if _strip_ns(aset.tag) != "AdaptationSet":
                    continue
                abase = walk_base(aset, pbase)
                for rep in aset:
                    if _strip_ns(rep.tag) != "Representation":
                        continue
                    bw = int(rep.get("bandwidth", "0"))
                    if best is None or bw > best[0]:
                        best = (bw, rep, aset, period, abase)
        if best is None:
            raise ValueError("dashdemux: no Representation in MPD")
        _, rep, aset, period, abase = best
        rbase = walk_base(rep, abase)

        def find(el, name):
            for child in el:
                if _strip_ns(child.tag) == name:
                    return child
            return None

        slist = find(rep, "SegmentList")
        if slist is None:
            slist = find(aset, "SegmentList")
        stmpl = find(rep, "SegmentTemplate")
        if stmpl is None:
            stmpl = find(aset, "SegmentTemplate")
        if slist is not None:
            dur = float(slist.get("duration", "0"))
            scale = float(slist.get("timescale", "1"))
            init = find(slist, "Initialization")
            if init is not None and init.get("sourceURL"):
                segs.append((0.0, _resolve(rbase,
                                           init.get("sourceURL"))))
            for child in slist:
                if _strip_ns(child.tag) == "SegmentURL":
                    segs.append((dur / scale,
                                 _resolve(rbase, child.get("media"))))
        elif stmpl is not None:
            media = stmpl.get("media", "")
            dur = float(stmpl.get("duration", "0"))
            scale = float(stmpl.get("timescale", "1"))
            start = int(stmpl.get("startNumber", "1"))
            total = _mpd_duration(root.get("mediaPresentationDuration"))
            seg_dur = dur / scale if scale else 0
            count = (max(1, int(total / seg_dur + 0.999))
                     if seg_dur and total else 1)
            init = stmpl.get("initialization")
            rid = rep.get("id", "")
            if init:
                segs.append((0.0, _resolve(
                    rbase, init.replace("$RepresentationID$", rid))))
            for n in range(start, start + count):
                u = media.replace("$Number$", str(n)) \
                    .replace("$RepresentationID$", rid)
                segs.append((seg_dur, _resolve(rbase, u)))
        else:
            raise ValueError("dashdemux: unsupported segment "
                             "addressing (need SegmentList or "
                             "SegmentTemplate)")
        self._segments = segs


@register_element
class MssDemux(_AdaptiveSrc):
    """mssdemux (gst-plugins-bad/ext/smoothstreaming/gstmssdemux.c):
    Microsoft Smooth Streaming.  The Manifest is XML: StreamIndex
    elements (Type video/audio) carry QualityLevel entries (bitrate,
    fourcc, CodecPrivateData) and a timeline of `c` chunks (t=start,
    d=duration, timescale default 10 MHz); fragment URIs come from
    the Url template with {bitrate} and {start time} substituted.
    Fragments are fMP4 moof+mdat pieces.

    Reduction: highest-bitrate quality level of the selected stream
    type; output is fragment bytes (video/quicktime, variant=mss-
    fragmented) with the manifest codec data in `manifest_info`."""
    FACTORY = "mssdemux"
    DESCRIPTION = "Smooth Streaming demuxer"
    PROPERTIES = dict(_AdaptiveSrc.PROPERTIES)
    PROPERTIES["stream-type"] = (str, "video",
                                 "StreamIndex Type to follow")

    def _load(self) -> None:
        import xml.etree.ElementTree as ET
        base = self._uri()
        text = _fetch(base).decode("utf-8-sig", "replace")
        root = ET.fromstring(text)
        want = self.props["stream-type"]
        self.manifest_info = {}
        segments: List[Tuple[float, str]] = []
        for si in root:
            if _strip_ns(si.tag) != "StreamIndex":
                continue
            if (si.get("Type") or "").lower() != want:
                continue
            timescale = int(si.get("TimeScale") or 10_000_000)
            url_tpl = si.get("Url") or ""
            best = None
            for ql in si:
                if _strip_ns(ql.tag) != "QualityLevel":
                    continue
                br = int(ql.get("Bitrate") or 0)
                if best is None or br > best[0]:
                    best = (br, ql)
            if best is None:
                continue
            bitrate, ql = best
            self.manifest_info = {
                "bitrate": bitrate,
                "fourcc": ql.get("FourCC") or "",
                "codec_private": bytes.fromhex(
                    ql.get("CodecPrivateData") or ""),
                "width": int(ql.get("MaxWidth")
                             or si.get("MaxWidth") or 0),
                "height": int(ql.get("MaxHeight")
                              or si.get("MaxHeight") or 0),
                "rate": int(ql.get("SamplingRate") or 0),
                "channels": int(ql.get("Channels") or 0),
                "timescale": timescale,
            }
            t = 0
            for c in si:
                if _strip_ns(c.tag) != "c":
                    continue
                if c.get("t") is not None:
                    t = int(c.get("t"))
                d = int(c.get("d") or 0)
                uri = url_tpl.replace(
                    "{bitrate}", str(bitrate)).replace(
                    "{Bitrate}", str(bitrate)).replace(
                    "{start time}", str(t)).replace(
                    "{start_time}", str(t))
                segments.append((d / timescale, _resolve(base, uri)))
                t += d
            break
        if not segments:
            raise ValueError(
                f"mssdemux: no {want!r} StreamIndex in manifest")
        self._segments = segments

    def _media_caps(self) -> Caps:
        return Caps.from_string(
            "video/quicktime, variant=mss-fragmented")
