"""Playback autoplugging: typefind element, decodebin, uridecodebin,
playbin equivalents.

Reference: subprojects/gst-plugins-base/gst/playback/ — gstdecodebin3.c
(caps-driven graph auto-construction from rank-sorted factories),
gstplaybin3.c, gsturidecodebin3.c; gstreamer/plugins/elements/
gsttypefindelement.c.

The batched runtime autopluggs at negotiation time: uridecodebin sniffs
the URI (utils/typefind.py), instantiates the matching parser source
internally, and proxies its caps/data.

A port of the JAX package's ``elements/playback.py``.  The internal
pipelines run on the element's device (the outer pipeline's, set at its
compile; set ``device`` on a playbin before ``build_pipeline*``).  Where
the JAX package would autoplug a decoder that is not registered (a libav
factory whose codec the system libavcodec lacks), it passes the coded
stream through; the port raises ``RuntimeError`` naming the missing system
codec instead.
"""

from __future__ import annotations

from typing import Optional

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (Element, MultiStreamSourceElement,
                            PadDirection, PadPresence, PadTemplate,
                            SinkElement, SourceElement, TransformElement,
                            element_factory_make, register_element)
from ..utils.typefind import DECODABLE, decodable_for, type_find_file

def _why_missing(factory: str) -> str:
    """Why a factory of an autoplug route is not registered: every one the
    JAX package names is ported, so only a libav factory can be missing,
    where the system libavcodec lacks its codec."""
    from . import libav
    if libav.codec_of(factory) is None:
        return "no element factory"
    return libav.why_missing(factory)


def _require(route: str) -> None:
    """Raise unless every factory of an autoplug route (a factory name or
    a launch-chain template) is registered."""
    from ..core.element import factory_exists
    for part in route.split("!"):
        factory = part.split()[0]
        if not factory_exists(factory):
            raise RuntimeError(f"{factory}: {_why_missing(factory)}")


def _decoder_for_caps(caps) -> Optional[str]:
    """Coded-stream caps from a demuxer -> decoder factory to append
    (the rank-sorted factory pick of gstdecodebin3.c, reduced to the
    registered decoder table).  A candidate that is not registered (a
    libav decoder whose codec the system libavcodec lacks) raises naming
    that codec (the JAX package's silence, a coded stream passed on
    undecoded, is not copied)."""
    if caps is None or caps.is_any or not len(caps):
        return None
    from ..core.element import factory_exists
    s = caps[0]
    name = s.name
    cand = None
    if name == "video/x-h264":
        cand = "avdec_h264"
    elif name == "video/x-h265":
        cand = "avdec_h265"
    elif name == "video/x-av1":
        cand = "avdec_av1"
    elif name == "image/jpeg":
        cand = "jpegdec"
    elif name == "video/mpeg" and not s.get("systemstream"):
        cand = ("avdec_mpeg2video" if s.get("mpegversion") == 2
                else "avdec_mpeg4")
    elif name == "audio/x-ac3":
        cand = "a52dec"
    elif name == "audio/x-dts":
        cand = "dtsdec"
    elif name == "audio/mpeg":
        ver = s.get("mpegversion")
        cand = ("mpg123audiodec" if ver in (1, None) else "faad")
    if cand is not None and not factory_exists(cand):
        raise RuntimeError(f"{cand} for {name}: {_why_missing(cand)}")
    return cand


class _ChainSrc(SourceElement):
    """Internal source wrapping a decode chain launch description:
    the chain runs once into an appsink; samples are then replayed as
    this element's output (how decodebin3 exposes parsebin output,
    collapsed to the offline batch model)."""
    FACTORY = ""
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, Caps.any())]
    PROPERTIES = {"description": (str, "", "launch chain")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._samples = None
        self._caps = None
        self._pos = 0

    def _load(self):
        if self._samples is not None:
            return
        from ..core.parse import parse_launch
        pipe = parse_launch(self.props["description"]
                            + " ! appsink name=__chain_sink",
                            device=self.device)
        pipe.run()
        sink = pipe.get_by_name("__chain_sink")
        self._samples = []
        while True:
            s = sink.pull_sample()
            if s is None:
                break
            self._caps = s.caps
            self._samples.append(s.buffer)

    def get_caps(self, filter=None):
        try:
            self._load()
        except (OSError, ValueError):
            return Caps.any()
        caps = self._caps if self._caps is not None else Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def start(self):
        self._load()
        self._pos = 0

    def create(self, n_frames):
        if not self._samples or self._pos >= len(self._samples):
            return None
        buf = self._samples[self._pos]
        self._pos += 1
        return buf


@register_element
class TypeFindElement(TransformElement):
    """typefind element: sniffs the stream, exposes .caps (the sniffed
    media type) and fires have-type callbacks."""
    FACTORY = "typefind"
    DESCRIPTION = "Finds the media type of a stream"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.caps_found: Optional[str] = None
        self.have_type_cb = None

    def process_meta(self, buf: Buffer) -> Buffer:
        if self.caps_found is None:
            from ..utils.typefind import type_find_data
            data = host_array(buf.data).tobytes()[:64]
            self.caps_found, prob = type_find_data(data)
            if self.have_type_cb:
                self.have_type_cb(self.caps_found, prob)
        return buf


def _build_multi_decode(path: str, factory: str, pad_names, device):
    """One demuxer instance in multi-stream mode feeding one decode
    branch per requested pad — the decodebin3 single-parse graph
    (gstdecodebin3.c builds exactly this over qtdemux's
    sometimes-pads), on `device`.  Returns (pipeline, {pad_name:
    appsink})."""
    from ..core.pipeline import Pipeline
    from ..core.pipeline import link as _link
    d = element_factory_make(factory, name="__uds_demux",
                             location=path)
    if not getattr(d, "MULTI_STREAM", False):
        raise ValueError(
            f"uridecodebin: {factory} has no multi-stream mode")
    pipe = Pipeline(device=device)
    pipe.add(d)
    sinks = {}
    for pname in pad_names:
        sink = element_factory_make("appsink", name=f"__uds_{pname}")
        pipe.add(sink)
        _link(d, sink, srcpad=pname)
        sinks[pname] = sink
    # caps are now discoverable from the single parse; splice a
    # decoder into branches carrying coded streams
    for pname in pad_names:
        dpad = d.get_pad(pname)
        caps = d.get_caps_for_pad(dpad)
        dec = _decoder_for_caps(caps)
        if dec is not None:
            sink = sinks[pname]
            spad = sink.sink_pads()[0]
            dpad.peer = None
            spad.peer = None
            decel = element_factory_make(dec,
                                         name=f"__uds_dec_{pname}")
            pipe.add(decel)
            _link(d, decel, srcpad=pname)
            _link(decel, sink)
    return pipe, sinks


@register_element
class UriDecodeBin(MultiStreamSourceElement):
    """uridecodebin: uri -> raw stream via autoplugging.

    Single-stream (`! sink` on the plain src pad) as before, or
    one-parse multi-stream: linking `uridecodebin.video_0` /
    `.audio_0` builds ONE internal demuxer in multi-stream mode with
    a decode branch per track (gsturidecodebin3.c + gstdecodebin3.c
    over the demuxer's sometimes-pads)."""
    FACTORY = "uridecodebin"
    DESCRIPTION = "Autoplug a URI to raw media"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, Caps.any()),
        PadTemplate("video_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.SOMETIMES),
        PadTemplate("audio_%u", PadDirection.SRC, Caps.any(),
                    PadPresence.SOMETIMES),
    ]
    PROPERTIES = {"uri": (str, "", "file:// URI or path")}

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._inner: Optional[SourceElement] = None
        self._multi = None              # pad -> (buffers, caps)
        self._multi_pos = None

    # -- one-parse multi-stream mode --------------------------------------
    def _ensure_multi(self):
        if self._multi is not None:
            return
        uri = self.props["uri"]
        path = uri[7:] if uri.startswith("file://") else uri
        mtype, _prob = type_find_file(path)
        factory = decodable_for(mtype)
        if factory is None or "!" in factory:
            raise ValueError(
                f"uridecodebin: no multi-stream demuxer for "
                f"{mtype!r}")
        _require(factory)
        names = [p.name for p in self.multi_pads()]
        pipe, sinks = _build_multi_decode(path, factory, names,
                                          self.device)
        pipe.run()
        self._multi = {}
        for pname, sink in sinks.items():
            bufs, caps = [], None
            while (s := sink.pull_sample()) is not None:
                caps = s.caps
                bufs.append(s.buffer)
            self._multi[pname] = (bufs, caps)
        self._multi_pos = {p: 0 for p in self._multi}

    def get_caps_for_pad(self, pad, filter=None):
        self._ensure_multi()
        caps = self._multi[pad.name][1] or Caps.any()
        if filter is not None and not caps.is_any:
            caps = caps.intersect(filter)
        return caps

    def create_multi(self, n_frames: int):
        self._ensure_multi()
        out = {}
        for pname, (bufs, _caps) in self._multi.items():
            i = self._multi_pos[pname]
            if i < len(bufs):
                out[pname] = bufs[i]
                self._multi_pos[pname] = i + 1
        return out or None

    def _ensure_inner(self):
        if self._inner is not None:
            return
        uri = self.props["uri"]
        path = uri[7:] if uri.startswith("file://") else uri
        mtype, _prob = type_find_file(path)
        factory = decodable_for(mtype)
        if factory is None:
            raise ValueError(
                f"uridecodebin: no decoder for {mtype!r} ({path!r})")
        _require(factory)
        if "!" in factory:
            self._inner = _ChainSrc(
                description=factory.format(path=path))
        else:
            inner = element_factory_make(factory, location=path)
            dec = _decoder_for_caps(inner.get_caps())
            if dec is not None:
                self._inner = _ChainSrc(
                    description=f"{factory} location={path} ! {dec}")
            else:
                self._inner = inner
        self._inner.device = self.device

    def get_caps(self, filter=None):
        self._ensure_inner()
        return self._inner.get_caps(filter)

    def fixate(self, caps):
        self._ensure_inner()
        return self._inner.fixate(caps)

    def set_info(self, incaps, outcaps):
        self._inner.set_info(incaps, outcaps)

    def start(self):
        if self.is_multi():
            self._ensure_multi()
            self._multi_pos = {p: 0 for p in self._multi}
            return
        self._ensure_inner()
        self._inner.start()

    def stop(self):
        if self._inner:
            self._inner.stop()

    def do_seek(self, segment):
        return (self._inner.do_seek(segment)
                if hasattr(self._inner, "do_seek") else False)

    def create(self, n_frames):
        return self._inner.create(n_frames)


@register_element
class DecodeBin(UriDecodeBin):
    """decodebin3-style alias (uri-driven in the batched model)."""
    FACTORY = "decodebin"
    DESCRIPTION = "Autoplug a stream to raw media"


@register_element
class PlayBin(SinkElement):
    """playbin3 equivalent for the offline runtime: builds
    uridecodebin ! (convert) ! appsink internally and exposes frames via
    pull_sample / a sample callback."""
    FACTORY = "playbin"
    DESCRIPTION = "Autoplug and render a URI (offline: collect samples)"
    PAD_TEMPLATES = []
    PROPERTIES = {
        "uri": (str, "", ""),
        "video-format": (str, "RGB", "output video format"),
    }

    def build_pipeline(self):
        from ..core.parse import parse_launch
        uri = self.props["uri"]
        path = uri[7:] if uri.startswith("file://") else uri
        mtype, _ = type_find_file(path)
        factory = decodable_for(mtype)
        if factory is None:
            raise ValueError(f"playbin: cannot play {mtype!r}")
        _require(factory)
        if mtype == "application/x-yuv4mpeg":
            desc = (f"filesrc location={path} ! videoconvert ! "
                    f"video/x-raw,format={self.props['video-format']} ! "
                    f"appsink name=playsink")
        elif "!" in factory:
            desc = (factory.format(path=path)
                    + " ! audioconvert ! appsink name=playsink")
        else:
            el = element_factory_make(factory, location=path)
            caps = el.get_caps()
            dec = _decoder_for_caps(caps)
            head = f"{factory} location={path}"
            if dec is not None:
                head += f" ! {dec}"
            is_audio = (caps is not None and not caps.is_any
                        and caps[0].name.startswith("audio"))
            if is_audio:
                desc = (f"{head} ! audioconvert ! "
                        f"appsink name=playsink")
            else:
                desc = (f"{head} ! videoconvert ! "
                        f"video/x-raw,format="
                        f"{self.props['video-format']} ! "
                        f"appsink name=playsink")
        pipe = parse_launch(desc, device=self.device)
        return pipe, pipe.get_by_name("playsink")

    def build_pipeline_av(self):
        """playbin3-style A/V playback from one parse: the container
        demuxer runs in multi-stream mode (gstplaybin3.c over
        decodebin3's single-parse graph).  Returns
        (pipeline, {"video": appsink, "audio": appsink}) with only
        the tracks the container has."""
        uri = self.props["uri"]
        path = uri[7:] if uri.startswith("file://") else uri
        mtype, _ = type_find_file(path)
        factory = decodable_for(mtype)
        if factory is None or "!" in factory:
            raise ValueError(f"playbin: cannot A/V-play {mtype!r}")
        _require(factory)
        probe = element_factory_make(factory, location=path)
        if not getattr(probe, "MULTI_STREAM", False):
            raise ValueError(
                f"playbin: {factory} has no multi-stream mode")
        names = []
        for kind in ("video", "audio"):
            try:
                pad = probe.get_pad(f"{kind}_0")
                fake = element_factory_make(
                    "fakesink", name=f"__pb_probe_{kind}")
                pad.link(fake.sink_pads()[0])
                probe.get_caps_for_pad(pad)
                names.append(f"{kind}_0")
            except (ValueError, KeyError, IndexError):
                continue
        if not names:
            raise ValueError(f"playbin: no playable tracks in {path}")
        pipe, sinks = _build_multi_decode(path, factory, names,
                                          self.device)
        pipe.run()
        return pipe, {n.rsplit("_", 1)[0]: s for n, s in sinks.items()}
