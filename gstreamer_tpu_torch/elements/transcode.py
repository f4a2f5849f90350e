"""uritranscodebin / transcodebin — profile-driven transcoding.

Reference: gst-plugins-bad/gst/transcode/gsttranscodebin.c +
gsturitranscodebin.c (decodebin3 -> encodebin wiring driven by a
GstEncodingProfile).

Collapsed to the offline model like playbin: the element resolves the
source through the autoplug route tables, builds one decode ->
convert -> encode -> mux launch description per selected stream and
runs it.  Profile strings use the encoding-profile serialization
subset `container-caps:video-caps:audio-caps`, e.g.
  video/x-matroska:video/x-h264:audio/mpeg
  video/webm:video/x-vp8:audio/x-vorbis
  video/quicktime:video/x-h265:audio/mpeg

A port of the JAX package's ``elements/transcode.py``: the transcode
pipeline runs on the element's device (the outer pipeline's, or set
``device`` before ``build_pipeline``).  A coded input whose libav decoder
is not registered raises the port's ``RuntimeError`` naming the codec
(``playback._decoder_for_caps``), where the JAX package passes the coded
stream on undecoded.  A multi-stream demuxer (matroskademux, qtdemux,
mxfdemux, rmdemux) feeds both branches from one instance, so each track is
transcoded to its end; the JAX package's demuxer a branch ends the run with
the shorter track's last tick and drops the rest of the longer one.
"""

from __future__ import annotations

from ..core.element import (SinkElement, element_factory_make,
                            get_factory_class, register_element)
from ..utils.typefind import decodable_for, type_find_file
from .playback import _decoder_for_caps

# container caps -> (mux factory, video pad, audio pad)
_MUXERS = {
    "video/x-matroska": ("matroskamux", "video_0", "audio_0"),
    "video/webm": ("webmmux", "video_0", "audio_0"),
    "video/quicktime": ("qtmux", "video_0", "audio_0"),
    "video/mpegts": ("mpegtsmux", "sink_0", "sink_1"),
    "video/x-msvideo": ("avimux", "video_0", "audio_0"),
}

# video caps -> encoder element ('' = raw passthrough)
_VIDEO_ENC = {
    "video/x-raw": "",
    "video/x-h264": "x264enc",
    "video/x-h265": "x265enc",
    "video/x-av1": "av1enc",
}
# raw-input codec modes handled by the matroska/webm muxer itself
_MUX_VIDEO_CODEC = {"video/x-vp8": "vp8", "video/x-vp9": "vp9",
                    "video/x-theora": "theora"}

_AUDIO_ENC = {
    "audio/x-raw": "",
    "audio/mpeg": "avenc_aac",
    "audio/x-ac3": "avenc_ac3",
}
_MUX_AUDIO_CODEC = {"audio/x-vorbis": "vorbis"}


@register_element
class UriTranscodeBin(SinkElement):
    FACTORY = "uritranscodebin"
    DESCRIPTION = "Autoplug and transcode a URI to a profile"
    PAD_TEMPLATES = []
    PROPERTIES = {
        "source-uri": (str, "", "input URI or path"),
        "dest-uri": (str, "", "output path"),
        "profile": (str, "video/x-matroska:video/x-h264:audio/mpeg",
                    "container:video:audio caps profile"),
    }

    def _src_path(self) -> str:
        uri = self.props["source-uri"]
        return uri[7:] if uri.startswith("file://") else uri

    def _dest_path(self) -> str:
        uri = self.props["dest-uri"]
        return uri[7:] if uri.startswith("file://") else uri

    def build_pipeline(self):
        from ..core.parse import parse_launch
        src = self._src_path()
        dest = self._dest_path()
        parts = self.props["profile"].split(":")
        container = parts[0]
        vprof = parts[1] if len(parts) > 1 else ""
        aprof = parts[2] if len(parts) > 2 else ""
        if container not in _MUXERS:
            raise ValueError(
                f"uritranscodebin: unsupported container {container!r}")
        mux, vpad, apad = _MUXERS[container]
        mtype, _ = type_find_file(src)
        factory = decodable_for(mtype)
        if factory is None or "!" in factory:
            raise ValueError(
                f"uritranscodebin: cannot demux {mtype!r}")
        mux_props = ""
        branches = []
        # a multi-stream demuxer feeds every branch from one parse: each
        # track runs to its own end (one demuxer a branch ends the run at
        # the shorter track's last tick: ROADMAP.md section 3)
        multi = getattr(get_factory_class(factory), "MULTI_STREAM", False)
        for kind, prof in (("video", vprof), ("audio", aprof)):
            if not prof:
                continue
            probe = element_factory_make(factory, location=src,
                                         stream=kind)
            caps = probe.get_caps()
            if caps is None or caps.is_any or not len(caps):
                continue
            name = caps[0].name
            want_video = kind == "video"
            if want_video and not (name.startswith("video")
                                   or name.startswith("image")):
                continue
            if not want_video and not name.startswith("audio"):
                continue
            dec = _decoder_for_caps(caps)
            chain = (f"d.{kind}_0" if multi
                     else f"{factory} location={src} stream={kind}")
            if dec:
                chain += f" ! {dec}"
            if want_video:
                if prof in _MUX_VIDEO_CODEC:
                    mux_props += (" video-codec="
                                  + _MUX_VIDEO_CODEC[prof])
                    enc = ""
                elif prof in _VIDEO_ENC:
                    enc = _VIDEO_ENC[prof]
                else:
                    raise ValueError(
                        f"uritranscodebin: video profile {prof!r}")
                chain += (" ! videoconvert ! video/x-raw,format=I420"
                          + (f" ! {enc}" if enc else "")
                          + f" ! m.{vpad}")
            else:
                if prof in _MUX_AUDIO_CODEC:
                    mux_props += (" audio-codec="
                                  + _MUX_AUDIO_CODEC[prof])
                    enc = ""
                    fmt = "S16LE"
                elif prof in _AUDIO_ENC:
                    enc = _AUDIO_ENC[prof]
                    fmt = "S16LE" if not enc else "F32LE"
                else:
                    raise ValueError(
                        f"uritranscodebin: audio profile {prof!r}")
                chain += (" ! audioconvert ! "
                          f"audio/x-raw,format={fmt}"
                          + (f" ! {enc}" if enc else "")
                          + f" ! m.{apad}")
            branches.append(chain)
        if not branches:
            raise ValueError("uritranscodebin: no streams matched "
                             "the profile")
        desc = (f"{mux} name=m location={dest}{mux_props} ! fakesink "
                + (f"{factory} name=d location={src} " if multi else "")
                + " ".join(branches))
        return parse_launch(desc, device=self.device)

    def transcode(self) -> str:
        """Run the transcode; returns the destination path."""
        self.build_pipeline().run()
        return self._dest_path()


@register_element
class TranscodeBin(UriTranscodeBin):
    """transcodebin: same profile machinery (uri-driven here, like
    decodebin's collapse)."""
    FACTORY = "transcodebin"
    DESCRIPTION = "Transcode a stream to a profile"
