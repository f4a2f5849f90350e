"""VideoInfo: the negotiated per-stream video configuration (host data).

A copy of the JAX package's ``video/info.py`` (GstVideoInfo: default
colorimetry and chroma siting by resolution, video-info.c; reading a caps
structure).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.structure import Structure
from ..core.value import Fraction
from .format import VideoFormatInfo, format_info, plane_shapes

# Colorimetry enums (string-valued to stay caps-friendly).
RANGE_FULL = "0-255"
RANGE_LIMITED = "16-235"

MATRIX_RGB = "rgb"
MATRIX_BT601 = "bt601"
MATRIX_BT709 = "bt709"
MATRIX_BT2020 = "bt2020"
MATRIX_FCC = "fcc"
MATRIX_SMPTE240M = "smpte240m"

# Kr/Kb per matrix (reference: gst_video_color_matrix_get_Kr_Kb,
# video-color.c:420)
KR_KB = {
    MATRIX_FCC: (0.30, 0.11),
    MATRIX_BT709: (0.2126, 0.0722),
    MATRIX_BT601: (0.2990, 0.1140),
    MATRIX_SMPTE240M: (0.212, 0.087),
    MATRIX_BT2020: (0.2627, 0.0593),
}


@dataclass(frozen=True)
class Colorimetry:
    range: str = RANGE_LIMITED
    matrix: str = MATRIX_BT601
    transfer: str = "bt601"
    primaries: str = "smpte170m"

    def to_string(self) -> str:
        return f"{self.range}:{self.matrix}:{self.transfer}:{self.primaries}"

    @staticmethod
    def from_string(s: str) -> "Colorimetry":
        named = {
            "bt601": Colorimetry(RANGE_LIMITED, MATRIX_BT601, "bt601", "smpte170m"),
            "bt709": Colorimetry(RANGE_LIMITED, MATRIX_BT709, "bt709", "bt709"),
            "bt2020": Colorimetry(RANGE_LIMITED, MATRIX_BT2020, "bt2020-12", "bt2020"),
            "srgb": Colorimetry(RANGE_FULL, MATRIX_RGB, "srgb", "bt709"),
        }
        if s in named:
            return named[s]
        parts = s.split(":")
        if len(parts) != 4:
            raise ValueError(f"bad colorimetry {s!r}")
        rng = RANGE_FULL if parts[0] in ("0-255", "full") else RANGE_LIMITED
        return Colorimetry(rng, parts[1], parts[2], parts[3])


# defaults (reference video-info.c:154 default_color[])
COLORIMETRY_YUV_SD = Colorimetry(RANGE_LIMITED, MATRIX_BT601, "bt601", "smpte170m")
COLORIMETRY_YUV_HD = Colorimetry(RANGE_LIMITED, MATRIX_BT709, "bt709", "bt709")
COLORIMETRY_RGB = Colorimetry(RANGE_FULL, MATRIX_RGB, "srgb", "bt709")
COLORIMETRY_GRAY = Colorimetry(RANGE_FULL, MATRIX_BT601, "unknown", "unknown")

CHROMA_SITE_NONE = "none"            # interstitial both directions
CHROMA_SITE_H_COSITED = "mpeg2"      # horizontally cosited
CHROMA_SITE_COSITED = "cosited"      # both cosited


@dataclass(frozen=True)
class VideoInfo:
    format: str = "I420"
    width: int = 0
    height: int = 0
    fps: Fraction = Fraction(30, 1)
    par: Fraction = Fraction(1, 1)
    colorimetry: Optional[Colorimetry] = None
    chroma_site: Optional[str] = None
    interlace_mode: str = "progressive"
    views: int = 1

    def __post_init__(self):
        finfo = self.finfo  # validates format
        if self.colorimetry is None:
            object.__setattr__(self, "colorimetry",
                               default_colorimetry(finfo, self.height))
        if self.chroma_site is None:
            object.__setattr__(self, "chroma_site",
                               default_chroma_site(finfo, self.height))

    @property
    def finfo(self) -> VideoFormatInfo:
        return format_info(self.format)

    def plane_shapes(self):
        return plane_shapes(self.finfo, self.width, self.height)

    # -- caps interop -----------------------------------------------------
    def to_caps_structure(self) -> Structure:
        return Structure(
            "video/x-raw",
            format=self.format,
            width=self.width,
            height=self.height,
            framerate=self.fps,
            **({"pixel-aspect-ratio": self.par} if self.par != Fraction(1) else {}),
        )

    @staticmethod
    def from_caps_structure(s: Structure) -> "VideoInfo":
        if s.name != "video/x-raw":
            raise ValueError(f"not raw video caps: {s!r}")
        col = s.get("colorimetry")
        cs = s.get("chroma-site")
        return VideoInfo(
            format=s.get("format", "I420"),
            width=int(s["width"]),
            height=int(s["height"]),
            fps=(s.get("framerate") if isinstance(s.get("framerate"), Fraction)
                 else Fraction(int(s.get("framerate", 30)))),
            par=s.get("pixel-aspect-ratio", Fraction(1)),
            colorimetry=Colorimetry.from_string(col) if col else None,
            chroma_site=cs,
            interlace_mode=s.get("interlace-mode", "progressive"),
        )


def default_colorimetry(finfo: VideoFormatInfo, height: int) -> Colorimetry:
    """video-info.c set_default_colorimetry: YUV >576 lines -> bt709,
    else bt601; RGB -> sRGB full; gray -> full-range."""
    if finfo.is_yuv:
        return COLORIMETRY_YUV_HD if height > 576 else COLORIMETRY_YUV_SD
    if finfo.is_gray:
        return COLORIMETRY_GRAY
    return COLORIMETRY_RGB


def default_chroma_site(finfo: VideoFormatInfo, height: int) -> str:
    """video-info.c set_default_chroma_site: YUV >576 -> H-cosited (mpeg2),
    else none."""
    if finfo.is_yuv:
        return CHROMA_SITE_H_COSITED if height > 576 else CHROMA_SITE_NONE
    return "unknown"


def chroma_site_h_cosited(site: str) -> bool:
    return site in (CHROMA_SITE_H_COSITED, CHROMA_SITE_COSITED)


def chroma_site_v_cosited(site: str) -> bool:
    return site == CHROMA_SITE_COSITED
