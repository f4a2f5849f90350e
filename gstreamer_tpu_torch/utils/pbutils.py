"""pbutils — codec descriptions and encoding profiles.

TPU-native equivalents of the remaining gst-plugins-base pbutils pieces
(reference: gst-libs/gst/pbutils/descriptions.c — caps -> human-readable
codec names; gstencodingprofile.c — declarative output-format profiles
consumed by encodebin).

A copy of the JAX package's ``utils/pbutils.py`` (host only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..core.caps import Caps

# caps media type -> human description (descriptions.c format_info table)
_DESCRIPTIONS = {
    "video/x-raw": "Uncompressed video",
    "audio/x-raw": "Uncompressed audio",
    "video/x-h264": "H.264 / AVC",
    "video/x-h265": "H.265 / HEVC",
    "video/x-vp8": "VP8",
    "video/x-vp9": "VP9",
    "video/x-av1": "AV1",
    "video/mpeg": "MPEG video",
    "video/mpegts": "MPEG-2 Transport Stream",
    "video/quicktime": "QuickTime / MP4",
    "video/x-matroska": "Matroska",
    "video/webm": "WebM",
    "video/x-msvideo": "Audio Video Interleave (AVI)",
    "video/x-flv": "Flash Video",
    "video/x-theora": "Theora",
    "audio/mpeg": "MPEG audio",
    "audio/x-flac": "FLAC",
    "audio/x-vorbis": "Vorbis",
    "audio/x-opus": "Opus",
    "audio/x-wav": "WAV",
    "audio/x-ac3": "AC-3 (ATSC A/52)",
    "audio/x-dts": "DTS",
    "audio/x-m4a": "MPEG-4 AAC",
    "application/ogg": "Ogg",
    "application/x-yuv4mpeg": "YUV4MPEG",
    "image/jpeg": "JPEG",
    "image/png": "PNG",
    "text/plain": "Plain text",
    "application/x-subtitle-vtt": "WebVTT subtitles",
}


def get_codec_description(caps) -> str:
    """gst_pb_utils_get_codec_description."""
    if isinstance(caps, str):
        caps = Caps.from_string(caps)
    if caps.is_any or len(caps) == 0:
        return "Unknown"
    s = caps[0]
    name = _DESCRIPTIONS.get(s.name, s.name)
    if s.name == "video/mpeg":
        v = s.get("mpegversion")
        if v == 4:
            return "MPEG-4 video"
        if v in (1, 2):
            return f"MPEG-{v} video"
    if s.name == "audio/mpeg":
        v = s.get("mpegversion")
        layer = s.get("layer")
        if v == 1 and layer == 3:
            return "MP3 audio (MPEG-1 layer 3)"
        if v == 4:
            return "MPEG-4 AAC audio"
    return name


def get_decoder_description(caps) -> str:
    return f"{get_codec_description(caps)} decoder"


def get_encoder_description(caps) -> str:
    return f"{get_codec_description(caps)} encoder"


# ---------------------------------------------------------------------------
# Encoding profiles (gstencodingprofile.c)
# ---------------------------------------------------------------------------

@dataclass
class EncodingProfile:
    """Base profile: target format + restriction caps."""
    format: Caps
    name: str = ""
    description: str = ""
    presence: int = 0
    restriction: Optional[Caps] = None

    def get_format(self) -> Caps:
        return self.format


@dataclass
class EncodingVideoProfile(EncodingProfile):
    pass_: int = 0
    variableframerate: bool = False


@dataclass
class EncodingAudioProfile(EncodingProfile):
    pass


@dataclass
class EncodingContainerProfile(EncodingProfile):
    profiles: List[EncodingProfile] = field(default_factory=list)

    def add_profile(self, p: EncodingProfile) -> None:
        self.profiles.append(p)

    def get_profiles(self) -> List[EncodingProfile]:
        return list(self.profiles)


def profile_from_string(spec: str) -> EncodingProfile:
    """gst_encoding_profile_from_string subset:
    'container_caps:video_caps:audio_caps' (empty slots skipped) or a
    single caps string for an elementary profile."""
    parts = spec.split(":")
    if len(parts) == 1:
        caps = Caps.from_string(parts[0])
        kind = caps[0].name.split("/")[0]
        cls = (EncodingVideoProfile if kind == "video"
               else EncodingAudioProfile)
        return cls(format=caps)
    cont = EncodingContainerProfile(format=Caps.from_string(parts[0]))
    for sub in parts[1:]:
        if sub:
            cont.add_profile(profile_from_string(sub))
    return cont
