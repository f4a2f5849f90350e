"""Alternate/deprecated factory names shipped by the reference.

Each class here is a registered subclass that pins an existing
element to the behavior its alternate name implies, mirroring how the
reference registers multiple factories over shared code:
* srtclientsrc/srtserversrc/srtclientsink/srtserversink
  (gst-plugins-bad/ext/srt/gstsrtelements.c): deprecated mode-fixed
  names kept for compatibility with pre-1.14 SRT elements.
* liveadder (gst-plugins-bad/gst/audiomixer/gstaudiomixer.c:1310 —
  registered as an alias of audiomixer).
* uridecodebin3 (gst-plugins-base/gst/playback/gsturidecodebin3.c) /
  urisourcebin (gsturisourcebin.c): the playbin3-era front-ends; in
  this framework's batch model both resolve to the same multi-stream
  autoplug source as uridecodebin.
* encodebin2 (gst-plugins-base/gst/encoding/gstencodebin2.c): same
  profile machinery, sometimes-pad variant.
* rtmpsink/rtmpsrc (gst-plugins-bad/ext/rtmp/): the librtmp-era names
  for the RTMP client elements.
* hlsdemux2/dashdemux2/mssdemux2
  (gst-plugins-good/ext/adaptivedemux2/): the rewritten adaptive
  demuxers; our adaptive sources already implement the demux2-style
  pull model, so the names map to the same elements.

A copy of the JAX package's ``elements/aliases.py`` over the port's
classes.  dvdec, av1dec and dav1ddec register where the port's libav
family registered avdec_dvvideo and avdec_av1 (the system libavcodec has
the codec): ``elements/__init__.py`` imports this module after ``libav``.
"""

from __future__ import annotations

from ..core.element import register_element
from ..net.adaptive import DashDemux, HlsDemux, MssDemux
from ..net.rtmp import Rtmp2Sink, Rtmp2Src
from ..net.srt import SRTSink, SRTSrc
from .audio_mix import AudioMixer
from .playback import UriDecodeBin
from .subparse import EncodeBin


class _SrtModeFixed:
    _FIXED_MODE = ""

    def __init__(self, name=None, **props):
        props.setdefault("mode", self._FIXED_MODE)
        super().__init__(name=name, **props)


@register_element
class SrtClientSrc(_SrtModeFixed, SRTSrc):
    FACTORY = "srtclientsrc"
    DESCRIPTION = "SRT source in caller mode (deprecated name)"
    _FIXED_MODE = "caller"


@register_element
class SrtServerSrc(_SrtModeFixed, SRTSrc):
    FACTORY = "srtserversrc"
    DESCRIPTION = "SRT source in listener mode (deprecated name)"
    _FIXED_MODE = "listener"


@register_element
class SrtClientSink(_SrtModeFixed, SRTSink):
    FACTORY = "srtclientsink"
    DESCRIPTION = "SRT sink in caller mode (deprecated name)"
    _FIXED_MODE = "caller"


@register_element
class SrtServerSink(_SrtModeFixed, SRTSink):
    FACTORY = "srtserversink"
    DESCRIPTION = "SRT sink in listener mode (deprecated name)"
    _FIXED_MODE = "listener"


@register_element
class LiveAdder(AudioMixer):
    FACTORY = "liveadder"
    DESCRIPTION = "Mixes live audio streams (audiomixer alias)"


@register_element
class UriDecodeBin3(UriDecodeBin):
    FACTORY = "uridecodebin3"
    DESCRIPTION = "Autoplug and decode an URI to raw media " \
                  "(playbin3 front-end)"


@register_element
class UriSourceBin(UriDecodeBin):
    FACTORY = "urisourcebin"
    DESCRIPTION = "Download and buffer a URI as needed"


@register_element
class EncodeBin2(EncodeBin):
    FACTORY = "encodebin2"
    DESCRIPTION = "Convenience encoding/muxing element " \
                  "(sometimes-pad variant)"


@register_element
class RtmpSink(Rtmp2Sink):
    FACTORY = "rtmpsink"
    DESCRIPTION = "Sends FLV content to a server via RTMP " \
                  "(librtmp-era name)"


@register_element
class RtmpSrc(Rtmp2Src):
    FACTORY = "rtmpsrc"
    DESCRIPTION = "Read RTMP streams (librtmp-era name)"


@register_element
class HlsDemux2(HlsDemux):
    FACTORY = "hlsdemux2"
    DESCRIPTION = "HLS demuxer (adaptivedemux2)"


@register_element
class DashDemux2(DashDemux):
    FACTORY = "dashdemux2"
    DESCRIPTION = "DASH demuxer (adaptivedemux2)"


@register_element
class MssDemux2(MssDemux):
    FACTORY = "mssdemux2"
    DESCRIPTION = "Smooth Streaming demuxer (adaptivedemux2)"


def _register_dvdec():
    """dvdec (gst-plugins-good/ext/dv/gstdvdec.c): the libdv decoder
    name; resolves to the libavcodec DV decoder (avdec_dvvideo) the
    same way gst-libav shadows it — registered only when the system
    libavcodec ships the codec."""
    from ..core.element import _REGISTRY

    entry = _REGISTRY.get("avdec_dvvideo")
    if entry is None:
        return
    base = entry[0]

    @register_element
    class DvDec(base):
        FACTORY = "dvdec"
        DESCRIPTION = "Uses libdv to decode DV video (libavcodec " \
                      "dvvideo backend)"


_register_dvdec()


def _register_av1dec():
    """av1dec (gst-plugins-bad/ext/aom/gstav1dec.c): the libaom
    decoder name; resolves to the libavcodec AV1 (dav1d) decoder the
    same way gst-libav shadows it — registered only when the system
    libavcodec ships the codec."""
    from ..core.element import _REGISTRY

    entry = _REGISTRY.get("avdec_av1")
    if entry is None:
        return
    base = entry[0]

    @register_element
    class Av1Dec(base):
        FACTORY = "av1dec"
        DESCRIPTION = "Decode AV1 video streams (libavcodec dav1d " \
                      "backend)"

    @register_element
    class Dav1dDec(base):
        FACTORY = "dav1ddec"
        DESCRIPTION = "Decode AV1 video streams with dav1d " \
                      "(gst-plugins-bad/ext/dav1d/gstdav1ddec.c; " \
                      "same dav1d engine via libavcodec here)"


_register_av1dec()
