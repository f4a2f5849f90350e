"""Video pixel-format table and the planar pack/unpack of the torch port.

The format table (VideoFormatInfo and FORMATS) is host data, copied from the
JAX package's ``video/format.py`` so that this package imports nothing of it.
``unpack_planes`` and ``pack_planes`` are the device half: they take the
component planes of one frame or a batch and produce the canonical channel
tuple (A, c0, c1, c2), each (..., H, W), and back.  This slice covers 8-bit
planar YUV and 8-bit component-plane RGB; every other layout raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from .. import _xp

# Component indices follow the reference convention
# (GST_VIDEO_COMP_Y/R = 0, U/G = 1, V/B = 2, A = 3).


@dataclass(frozen=True)
class VideoFormatInfo:
    name: str
    flavor: str                      # "yuv" | "rgb" | "gray"
    bits: int = 8                    # bits per component of the unpacked data
    n_components: int = 3
    # log2 subsampling per component (w_sub/h_sub, video-format.h)
    w_sub: Tuple[int, ...] = (0, 0, 0, 0)
    h_sub: Tuple[int, ...] = (0, 0, 0, 0)
    has_alpha: bool = False
    # byte-layout description used by from_bytes/to_bytes:
    #   "planar": one plane per component, plane_order gives storage order
    #   "semi":   Y plane + interleaved UV plane, uv_order gives order
    #   "packed": single plane, packed_order gives per-pixel byte order
    #             (for 4:2:2 packed: per-macropixel order of [Y0 U Y1 V])
    layout: str = "planar"
    plane_order: Tuple[int, ...] = (0, 1, 2)     # component idx per stored plane
    packed_order: Tuple[int, ...] = ()           # see above
    depth: Tuple[int, ...] = (8, 8, 8, 8)
    endian: str = "le"               # byte order of >8-bit containers
    justify: str = "low"             # "high": values left-justified (P010)
    # "bitfield16"/"word32" layouts: per-component bit shift in the word
    shifts: Tuple[int, ...] = ()
    # "tiled" layouts: (mode, tile_w, tile_h, chroma_tile_h) — mode is
    # "linear" | "zflipz" (GstVideoTileMode); tiles per video-format.c:7894
    tile: Optional[Tuple[str, int, int, int]] = None
    # False for formats whose reference unpack does NOT replicate low bits
    # into the canonical 16-bit value (unpack_MT2110T/unpack_NV12_10BE_8L128
    # emit plain v<<6 — video-format.c:7536,7419)
    replicate: bool = True

    @property
    def is_yuv(self) -> bool:
        return self.flavor == "yuv"

    @property
    def is_rgb(self) -> bool:
        return self.flavor == "rgb"

    @property
    def is_gray(self) -> bool:
        return self.flavor == "gray"

    @property
    def unpack_format(self) -> str:
        return "AYUV" if (self.is_yuv or self.is_gray) else "ARGB"

    def comp_width(self, comp: int, width: int) -> int:
        return -(-width >> self.w_sub[comp]) if self.w_sub[comp] else width

    def comp_height(self, comp: int, height: int) -> int:
        return -(-height >> self.h_sub[comp]) if self.h_sub[comp] else height

    def replace_tile(self, tile) -> "VideoFormatInfo":
        import dataclasses
        return dataclasses.replace(self, tile=tile)

    @property
    def word_dtype(self):
        return np.dtype("<u2" if self.endian == "le" else ">u2")


def _yuv(name, w_sub, h_sub, layout, plane_order=(0, 1, 2), packed_order=(),
         n_components=3, has_alpha=False, bits=8):
    return VideoFormatInfo(
        name, "yuv", bits=bits, n_components=n_components, w_sub=w_sub,
        h_sub=h_sub, has_alpha=has_alpha, layout=layout,
        plane_order=plane_order, packed_order=packed_order)


def _rgb(name, packed_order, has_alpha=False):
    n = 4 if has_alpha else 3
    return VideoFormatInfo(
        name, "rgb", n_components=n, has_alpha=has_alpha, layout="packed",
        packed_order=packed_order)


# packed_order for RGB family: for each stored byte position, which canonical
# channel it holds; canonical channels: 0=R 1=G 2=B 3=A, -1=padding(X).
FORMATS: Dict[str, VideoFormatInfo] = {
    # planar YUV (reference video-format.c PACK_420 etc.)
    "I420": _yuv("I420", (0, 1, 1), (0, 1, 1), "planar", (0, 1, 2)),
    "YV12": _yuv("YV12", (0, 1, 1), (0, 1, 1), "planar", (0, 2, 1)),
    "Y444": _yuv("Y444", (0, 0, 0), (0, 0, 0), "planar", (0, 1, 2)),
    "Y42B": _yuv("Y42B", (0, 1, 1), (0, 0, 0), "planar", (0, 1, 2)),
    "Y41B": _yuv("Y41B", (0, 2, 2), (0, 0, 0), "planar", (0, 1, 2)),
    "A420": _yuv("A420", (0, 1, 1, 0), (0, 1, 1, 0), "planar", (0, 1, 2, 3),
                 n_components=4, has_alpha=True),
    # semi-planar
    "NV12": _yuv("NV12", (0, 1, 1), (0, 1, 1), "semi", (0, 1, 2)),
    "NV21": _yuv("NV21", (0, 1, 1), (0, 1, 1), "semi", (0, 2, 1)),
    "NV16": _yuv("NV16", (0, 1, 1), (0, 0, 0), "semi", (0, 1, 2)),
    "NV24": _yuv("NV24", (0, 0, 0), (0, 0, 0), "semi", (0, 1, 2)),
    # packed 4:2:2 — packed_order = byte order of the [Y0, U, Y1, V] macropixel
    "YUY2": _yuv("YUY2", (0, 1, 1), (0, 0, 0), "packed",
                 packed_order=("Y0", "U", "Y1", "V")),
    "UYVY": _yuv("UYVY", (0, 1, 1), (0, 0, 0), "packed",
                 packed_order=("U", "Y0", "V", "Y1")),
    "YVYU": _yuv("YVYU", (0, 1, 1), (0, 0, 0), "packed",
                 packed_order=("Y0", "V", "Y1", "U")),
    "VYUY": _yuv("VYUY", (0, 1, 1), (0, 0, 0), "packed",
                 packed_order=("V", "Y0", "U", "Y1")),
    # packed 4:4:4
    "AYUV": _yuv("AYUV", (0, 0, 0, 0), (0, 0, 0, 0), "packed",
                 packed_order=("A", "Y", "U", "V"), n_components=4,
                 has_alpha=True),
    "VUYA": _yuv("VUYA", (0, 0, 0, 0), (0, 0, 0, 0), "packed",
                 packed_order=("V", "U", "Y", "A"), n_components=4,
                 has_alpha=True),
    # gray
    "GRAY8": VideoFormatInfo("GRAY8", "gray", n_components=1,
                             layout="planar", plane_order=(0,)),
    # packed RGB
    "RGB": _rgb("RGB", (0, 1, 2)),
    "BGR": _rgb("BGR", (2, 1, 0)),
    "RGBx": _rgb("RGBx", (0, 1, 2, -1)),
    "BGRx": _rgb("BGRx", (2, 1, 0, -1)),
    "xRGB": _rgb("xRGB", (-1, 0, 1, 2)),
    "xBGR": _rgb("xBGR", (-1, 2, 1, 0)),
    "RGBA": _rgb("RGBA", (0, 1, 2, 3), has_alpha=True),
    "BGRA": _rgb("BGRA", (2, 1, 0, 3), has_alpha=True),
    "ARGB": _rgb("ARGB", (3, 0, 1, 2), has_alpha=True),
    "ABGR": _rgb("ABGR", (3, 2, 1, 0), has_alpha=True),
    # planar RGB
    "GBR": VideoFormatInfo("GBR", "rgb", layout="planar", plane_order=(1, 2, 0)),
    "GBRA": VideoFormatInfo("GBRA", "rgb", n_components=4, has_alpha=True,
                            layout="planar", plane_order=(1, 2, 0, 3)),
}

# high bit-depth formats (16-bit containers; canonical unpack is 16-bit
# AYUV64/ARGB64 semantics — video-format.c unpack_I420_10LE: v<<6 with
# low-bit replication, P010: values already left-justified)


def _yuv16(name, depth, w_sub, h_sub, layout="planar", plane_order=(0, 1, 2),
           justify="low", n_components=3, has_alpha=False, endian="le",
           packed_order=None):
    if packed_order is None:
        packed_order = ("A", "Y", "U", "V") if layout == "packed" else ()
    return VideoFormatInfo(
        name, "yuv", bits=16, n_components=n_components, w_sub=w_sub,
        h_sub=h_sub, has_alpha=has_alpha, layout=layout,
        plane_order=plane_order, packed_order=packed_order,
        depth=(depth,) * 4, endian=endian, justify=justify)


FORMATS.update({
    "I420_10LE": _yuv16("I420_10LE", 10, (0, 1, 1), (0, 1, 1)),
    "I420_12LE": _yuv16("I420_12LE", 12, (0, 1, 1), (0, 1, 1)),
    "I422_10LE": _yuv16("I422_10LE", 10, (0, 1, 1), (0, 0, 0)),
    # v210: 10-bit 4:2:2, 6 pixels in 16 bytes, rows 128-byte aligned
    # (video-format.c unpack_v210 :559 / pack_v210 :651)
    "v210": _yuv16("v210", 10, (0, 1, 1), (0, 0, 0), layout="v210"),
    "I422_12LE": _yuv16("I422_12LE", 12, (0, 1, 1), (0, 0, 0)),
    "Y444_10LE": _yuv16("Y444_10LE", 10, (0, 0, 0), (0, 0, 0)),
    "Y444_12LE": _yuv16("Y444_12LE", 12, (0, 0, 0), (0, 0, 0)),
    "Y444_16LE": _yuv16("Y444_16LE", 16, (0, 0, 0), (0, 0, 0)),
    "P010_10LE": _yuv16("P010_10LE", 10, (0, 1, 1), (0, 1, 1), layout="semi",
                        justify="high"),
    "P012_LE": _yuv16("P012_LE", 12, (0, 1, 1), (0, 1, 1), layout="semi",
                      justify="high"),
    "AYUV64": _yuv16("AYUV64", 16, (0, 0, 0, 0), (0, 0, 0, 0),
                     layout="packed", n_components=4, has_alpha=True),
    "GRAY16_LE": VideoFormatInfo("GRAY16_LE", "gray", bits=16,
                                 n_components=1, layout="planar",
                                 plane_order=(0,), depth=(16,) * 4),
    "ARGB64": VideoFormatInfo("ARGB64", "rgb", bits=16, n_components=4,
                              has_alpha=True, layout="packed",
                              packed_order=(3, 0, 1, 2), depth=(16,) * 4),
    "RGBA64_LE": VideoFormatInfo("RGBA64_LE", "rgb", bits=16, n_components=4,
                                 has_alpha=True, layout="packed",
                                 packed_order=(0, 1, 2, 3), depth=(16,) * 4),
})

# Remaining reference families (video-format.h enum, ~165 formats):
# endian variants, alpha planar families, planar RGB depths, 4:1:0,
# packed specials, word-bitfield RGB, and tiled NV12.

def _planar_hd_family(base, subs, alphas):
    """10/12/16-bit LE+BE planar families (A)YUV."""
    out = {}
    w_sub, h_sub = subs
    for d in (10, 12, 16):
        for e in ("LE", "BE"):
            out[f"{base}_{d}{e}"] = _yuv16(
                f"{base}_{d}{e}", d, w_sub, h_sub, endian=e.lower(),
                n_components=4 if alphas else 3, has_alpha=alphas,
                plane_order=(0, 1, 2, 3) if alphas else (0, 1, 2))
    return out


def _rgb_planar_hd(base, depths, alphas):
    out = {}
    for d in depths:
        for e in ("LE", "BE"):
            out[f"{base}_{d}{e}"] = VideoFormatInfo(
                f"{base}_{d}{e}", "rgb", bits=16,
                n_components=4 if alphas else 3, has_alpha=alphas,
                layout="planar",
                plane_order=(1, 2, 0, 3) if alphas else (1, 2, 0),
                depth=(d,) * 4, endian=e.lower())
    return out


FORMATS.update(_rgb_planar_hd("GBR", (10, 12, 16), False))
FORMATS.update(_rgb_planar_hd("GBRA", (10, 12), True))
FORMATS.update(_planar_hd_family("A420", ((0, 1, 1, 0), (0, 1, 1, 0)), True))
FORMATS.update(_planar_hd_family("A422", ((0, 1, 1, 0), (0, 0, 0, 0)), True))
FORMATS.update(_planar_hd_family("A444", ((0, 0, 0, 0), (0, 0, 0, 0)), True))
FORMATS.update({
    # BE twins of the existing LE planar entries
    "I420_10BE": _yuv16("I420_10BE", 10, (0, 1, 1), (0, 1, 1), endian="be"),
    "I420_12BE": _yuv16("I420_12BE", 12, (0, 1, 1), (0, 1, 1), endian="be"),
    "I422_10BE": _yuv16("I422_10BE", 10, (0, 1, 1), (0, 0, 0), endian="be"),
    "I422_12BE": _yuv16("I422_12BE", 12, (0, 1, 1), (0, 0, 0), endian="be"),
    "Y444_10BE": _yuv16("Y444_10BE", 10, (0, 0, 0), (0, 0, 0), endian="be"),
    "Y444_12BE": _yuv16("Y444_12BE", 12, (0, 0, 0), (0, 0, 0), endian="be"),
    "Y444_16BE": _yuv16("Y444_16BE", 16, (0, 0, 0), (0, 0, 0), endian="be"),
    # 8-bit alpha planar
    "A422": _yuv("A422", (0, 1, 1, 0), (0, 0, 0, 0), "planar",
                 (0, 1, 2, 3), n_components=4, has_alpha=True),
    "A444": _yuv("A444", (0, 0, 0, 0), (0, 0, 0, 0), "planar",
                 (0, 1, 2, 3), n_components=4, has_alpha=True),
    # 4:1:0 planar
    "YUV9": _yuv("YUV9", (0, 2, 2), (0, 2, 2), "planar", (0, 1, 2)),
    "YVU9": _yuv("YVU9", (0, 2, 2), (0, 2, 2), "planar", (0, 2, 1)),
    # planar RGB 8-bit
    "RGBP": VideoFormatInfo("RGBP", "rgb", layout="planar",
                            plane_order=(0, 1, 2)),
    "BGRP": VideoFormatInfo("BGRP", "rgb", layout="planar",
                            plane_order=(2, 1, 0)),
    # semi-planar extras
    "NV61": _yuv("NV61", (0, 1, 1), (0, 0, 0), "semi", (0, 2, 1)),
    "P010_10BE": _yuv16("P010_10BE", 10, (0, 1, 1), (0, 1, 1),
                        layout="semi", justify="high", endian="be"),
    "P012_BE": _yuv16("P012_BE", 12, (0, 1, 1), (0, 1, 1), layout="semi",
                      justify="high", endian="be"),
    "P016_LE": _yuv16("P016_LE", 16, (0, 1, 1), (0, 1, 1), layout="semi"),
    "P016_BE": _yuv16("P016_BE", 16, (0, 1, 1), (0, 1, 1), layout="semi",
                      endian="be"),
    # NV12 + separate alpha plane (video-format.c AV12)
    "AV12": _yuv("AV12", (0, 1, 1, 0), (0, 1, 1, 0), "semi",
                 (0, 1, 2, 3), n_components=4, has_alpha=True),
    # gray
    "GRAY16_BE": VideoFormatInfo("GRAY16_BE", "gray", bits=16,
                                 n_components=1, layout="planar",
                                 plane_order=(0,), depth=(16,) * 4,
                                 endian="be"),
    "GRAY10_LE16": VideoFormatInfo("GRAY10_LE16", "gray", bits=16,
                                   n_components=1, layout="planar",
                                   plane_order=(0,), depth=(10,) * 4),
    # 16-bit packed RGB containers
    "RGBA64_BE": VideoFormatInfo("RGBA64_BE", "rgb", bits=16,
                                 n_components=4, has_alpha=True,
                                 layout="packed", packed_order=(0, 1, 2, 3),
                                 depth=(16,) * 4, endian="be"),
    "ARGB64_LE": VideoFormatInfo("ARGB64_LE", "rgb", bits=16,
                                 n_components=4, has_alpha=True,
                                 layout="packed", packed_order=(3, 0, 1, 2),
                                 depth=(16,) * 4),
    "ARGB64_BE": VideoFormatInfo("ARGB64_BE", "rgb", bits=16,
                                 n_components=4, has_alpha=True,
                                 layout="packed", packed_order=(3, 0, 1, 2),
                                 depth=(16,) * 4, endian="be"),
    "ABGR64_LE": VideoFormatInfo("ABGR64_LE", "rgb", bits=16,
                                 n_components=4, has_alpha=True,
                                 layout="packed", packed_order=(3, 2, 1, 0),
                                 depth=(16,) * 4),
    "ABGR64_BE": VideoFormatInfo("ABGR64_BE", "rgb", bits=16,
                                 n_components=4, has_alpha=True,
                                 layout="packed", packed_order=(3, 2, 1, 0),
                                 depth=(16,) * 4, endian="be"),
    "BGRA64_LE": VideoFormatInfo("BGRA64_LE", "rgb", bits=16,
                                 n_components=4, has_alpha=True,
                                 layout="packed", packed_order=(2, 1, 0, 3),
                                 depth=(16,) * 4),
    "BGRA64_BE": VideoFormatInfo("BGRA64_BE", "rgb", bits=16,
                                 n_components=4, has_alpha=True,
                                 layout="packed", packed_order=(2, 1, 0, 3),
                                 depth=(16,) * 4, endian="be"),
    # RBGA (v4l2 oddity)
    "RBGA": _rgb("RBGA", (0, 2, 1, 3), has_alpha=True),
    # packed 4:4:4 YUV byte formats (unpack_v308 :460, unpack_IYU2 :497)
    "v308": _yuv("v308", (0, 0, 0), (0, 0, 0), "packed",
                 packed_order=("Y", "U", "V")),
    "IYU2": _yuv("IYU2", (0, 0, 0), (0, 0, 0), "packed",
                 packed_order=("U", "Y", "V")),
    # packed 16-bit 4:2:2 (unpack_v216 :706, unpack_Y210 :759)
    "v216": _yuv16("v216", 16, (0, 1, 1), (0, 0, 0), layout="packed",
                   packed_order=("U", "Y0", "V", "Y1")),
    "Y210": _yuv16("Y210", 10, (0, 1, 1), (0, 0, 0), layout="packed",
                   justify="high", packed_order=("Y0", "U", "Y1", "V")),
    "Y212_LE": _yuv16("Y212_LE", 12, (0, 1, 1), (0, 0, 0), layout="packed",
                      justify="high", packed_order=("Y0", "U", "Y1", "V")),
    "Y212_BE": _yuv16("Y212_BE", 12, (0, 1, 1), (0, 0, 0), layout="packed",
                      justify="high", endian="be",
                      packed_order=("Y0", "U", "Y1", "V")),
    "Y216_LE": _yuv16("Y216_LE", 16, (0, 1, 1), (0, 0, 0), layout="packed",
                      packed_order=("Y0", "U", "Y1", "V")),
    "Y216_BE": _yuv16("Y216_BE", 16, (0, 1, 1), (0, 0, 0), layout="packed",
                      endian="be", packed_order=("Y0", "U", "Y1", "V")),
    # packed 16-bit 4:4:4:4 (unpack_Y412)
    "Y412_LE": _yuv16("Y412_LE", 12, (0, 0, 0, 0), (0, 0, 0, 0),
                      layout="packed", justify="high", n_components=4,
                      has_alpha=True, packed_order=("U", "Y", "V", "A")),
    "Y412_BE": _yuv16("Y412_BE", 12, (0, 0, 0, 0), (0, 0, 0, 0),
                      layout="packed", justify="high", endian="be",
                      n_components=4, has_alpha=True,
                      packed_order=("U", "Y", "V", "A")),
    "Y416_LE": _yuv16("Y416_LE", 16, (0, 0, 0, 0), (0, 0, 0, 0),
                      layout="packed", n_components=4, has_alpha=True,
                      packed_order=("U", "Y", "V", "A")),
    "Y416_BE": _yuv16("Y416_BE", 16, (0, 0, 0, 0), (0, 0, 0, 0),
                      layout="packed", endian="be", n_components=4,
                      has_alpha=True, packed_order=("U", "Y", "V", "A")),
    # packed 4:1:1 (unpack_IYU1: U Y0 Y1 V Y2 Y3 per 4 pixels)
    "IYU1": _yuv("IYU1", (0, 2, 2), (0, 0, 0), "iyu1"),
    # 15/16-bit bitfield RGB (unpack_RGB16 :1302 — components replicate
    # low bits: r<<3|r>>2)
    "RGB16": VideoFormatInfo("RGB16", "rgb", layout="bitfield16",
                             depth=(5, 6, 5, 0), shifts=(11, 5, 0)),
    "BGR16": VideoFormatInfo("BGR16", "rgb", layout="bitfield16",
                             depth=(5, 6, 5, 0), shifts=(0, 5, 11)),
    "RGB15": VideoFormatInfo("RGB15", "rgb", layout="bitfield16",
                             depth=(5, 5, 5, 0), shifts=(10, 5, 0)),
    "BGR15": VideoFormatInfo("BGR15", "rgb", layout="bitfield16",
                             depth=(5, 5, 5, 0), shifts=(0, 5, 10)),
    # 10-bit word32 RGB (unpack_rgb10a2_le/bgr10a2_le, unpack_r210:
    # canonical ARGB64, 10-bit replication v<<6|v>>4; 2-bit alpha
    # a<<14 | a<<4)
    "RGB10A2_LE": VideoFormatInfo(
        "RGB10A2_LE", "rgb", bits=16, n_components=4, has_alpha=True,
        layout="word32", depth=(10, 10, 10, 2), shifts=(0, 10, 20, 30)),
    "BGR10A2_LE": VideoFormatInfo(
        "BGR10A2_LE", "rgb", bits=16, n_components=4, has_alpha=True,
        layout="word32", depth=(10, 10, 10, 2), shifts=(20, 10, 0, 30)),
    "r210": VideoFormatInfo(
        "r210", "rgb", bits=16, n_components=3, layout="word32",
        depth=(10, 10, 10, 0), shifts=(20, 10, 0), endian="be"),
    # packed 10-bit 4:4:4 YUV word32 (unpack_Y410 :862)
    "Y410": VideoFormatInfo(
        "Y410", "yuv", bits=16, n_components=4, has_alpha=True,
        layout="word32", w_sub=(0, 0, 0, 0), h_sub=(0, 0, 0, 0),
        depth=(10, 10, 10, 2), shifts=(10, 0, 20, 30)),
    # tiled NV12 variants (video-format.c:7894 tile tables;
    # gst_video_tile_get_index video-tile.c:44)
    "NV12_4L4": _yuv("NV12_4L4", (0, 1, 1), (0, 1, 1), "tiled",
                     (0, 1, 2)).replace_tile(("linear", 4, 4, 4)),
    "NV12_32L32": _yuv("NV12_32L32", (0, 1, 1), (0, 1, 1), "tiled",
                       (0, 1, 2)).replace_tile(("linear", 32, 32, 32)),
    "NV12_16L32S": _yuv("NV12_16L32S", (0, 1, 1), (0, 1, 1), "tiled",
                        (0, 1, 2)).replace_tile(("linear", 16, 32, 16)),
    "NV12_64Z32": _yuv("NV12_64Z32", (0, 1, 1), (0, 1, 1), "tiled",
                       (0, 1, 2)).replace_tile(("zflipz", 64, 32, 32)),
    "NV12_8L128": _yuv("NV12_8L128", (0, 1, 1), (0, 1, 1), "tiled",
                       (0, 1, 2)).replace_tile(("linear", 8, 128, 128)),
    # ---- final 13 formats completing the reference enum (139 raw) ----
    # UYVP: 10-bit packed 4:2:2, MSB-first bitstream U Y0 V Y1 per 40-bit
    # group (unpack_UYVP video-format.c:2043)
    "UYVP": _yuv16("UYVP", 10, (0, 1, 1), (0, 0, 0), layout="uyvp"),
    # RGB8P: 8-bit palette indices + 256-entry ARGB palette plane
    # (unpack_RGB8P :2188, std palette :2208, crude pack :2255)
    "RGB8P": VideoFormatInfo("RGB8P", "rgb", n_components=4, has_alpha=True,
                             layout="palette"),
    # 10-bit-in-32-bit-word family: 3 samples per LE word, bits [0,10,20)
    # (unpack_GRAY10_LE32 :5263, unpack_NV12_10LE32 :5338)
    "GRAY10_LE32": VideoFormatInfo("GRAY10_LE32", "gray", bits=16,
                                   n_components=1, layout="gray_le32",
                                   plane_order=(0,), depth=(10,) * 4),
    "NV12_10LE32": _yuv16("NV12_10LE32", 10, (0, 1, 1), (0, 1, 1),
                          layout="semi_le32"),
    "NV16_10LE32": _yuv16("NV16_10LE32", 10, (0, 1, 1), (0, 0, 0),
                          layout="semi_le32"),
    # 10-bit fully-packed LSB-first bitstream, 4 samples / 5 bytes
    # (unpack_NV12_10LE40 :5795)
    "NV12_10LE40": _yuv16("NV12_10LE40", 10, (0, 1, 1), (0, 1, 1),
                          layout="semi_le40"),
    "NV16_10LE40": _yuv16("NV16_10LE40", 10, (0, 1, 1), (0, 0, 0),
                          layout="semi_le40"),
    # tiled 10LE40: 4x4-pixel tiles, each tile row = one 5-byte group
    # (unpack_NV12_10LE40_TILED :7450, TILE_10bit_4x4 :7902)
    "NV12_10LE40_4L4": _yuv16("NV12_10LE40_4L4", 10, (0, 1, 1), (0, 1, 1),
                              layout="tiled_le40").replace_tile(
                                  ("linear", 4, 4, 4)),
    # MSB-first 10-bit rows tiled as 8-byte x 128-row byte tiles, NO
    # low-bit replication on unpack (unpack_NV12_10BE_8L128 :7346)
    "NV12_10BE_8L128": VideoFormatInfo(
        "NV12_10BE_8L128", "yuv", bits=16, w_sub=(0, 1, 1),
        h_sub=(0, 1, 1), layout="tiled_be10", depth=(10,) * 4,
        endian="be", tile=("linear", 8, 128, 128), replicate=False),
    # MediaTek 16x32 two-part tiles: 8 partitions x (16 low-2bit bytes +
    # 64 high bytes); T = column-packed low bits, R = row-packed
    # (unpack_MT2110T :7473, unpack_MT2110R :7623); no replication
    "MT2110T": VideoFormatInfo(
        "MT2110T", "yuv", bits=16, w_sub=(0, 1, 1), h_sub=(0, 1, 1),
        layout="mt2110", depth=(10,) * 4,
        tile=("t", 16, 32, 16), replicate=False),
    "MT2110R": VideoFormatInfo(
        "MT2110R", "yuv", bits=16, w_sub=(0, 1, 1), h_sub=(0, 1, 1),
        layout="mt2110", depth=(10,) * 4,
        tile=("r", 16, 32, 16), replicate=False),
    # 10-bit word32 RGB without alpha: same bit layout as the A2 twins,
    # the 2 top bits are padding (shared pack/unpack — video-format.c:8268)
    "RGB10x2_LE": VideoFormatInfo(
        "RGB10x2_LE", "rgb", bits=16, n_components=3,
        layout="word32", depth=(10, 10, 10, 2), shifts=(0, 10, 20, 30)),
    "BGR10x2_LE": VideoFormatInfo(
        "BGR10x2_LE", "rgb", bits=16, n_components=3,
        layout="word32", depth=(10, 10, 10, 2), shifts=(20, 10, 0, 30)),
})

# formats whose 16-bit container stores values left-justified (MSB)
HIGH_JUSTIFIED = {n for n, f in FORMATS.items() if f.justify == "high"}
HIGH_JUSTIFIED |= {"P010_10LE", "P012_LE"}


def format_info(name: str) -> VideoFormatInfo:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown video format {name!r}") from None


def all_formats():
    return list(FORMATS)

# ---------------------------------------------------------------------------
# Canonical unpack/pack over component planes.
#
# planes: tuple of component arrays, each (..., comp_h, comp_w), batch dims
# allowed in front; semi-planar and packed formats arrive as separate
# component arrays too (plane_shapes).  Chroma fill on unpack is nearest
# duplication (ORC loadupdb / GET_UV_420 y>>1, video-format.c:91); pack
# selects the top-left sample of each chroma block (ORC select0wb /
# IS_CHROMA_LINE_420, video-format.c:117).
#
# Dtypes.  Stored planes are uint8 (8-bit containers) or uint16 (16-bit
# containers), numpy arrays or torch tensors; a torch int32 tensor holding
# the same values is accepted for a 16-bit container.  Stored values are
# widened at once (to `dtype`, or int32 for a 16-bit container) and every
# stage computes in signed integers: torch has no uint16 arithmetic, so
# torch.uint16 appears only as the final cast of pack_planes' outputs.
# ---------------------------------------------------------------------------

def _dup(xp, a, factor_log2: int, axis: int, size: int):
    """Nearest-duplicate along axis to reach `size` samples."""
    if factor_log2 == 0:
        return a
    a = _xp.repeat(xp, a, 1 << factor_log2, axis)
    return _xp.take(a, axis, 0, size)


def _dup_v_interlaced(xp, a, factor_log2: int, size: int):
    """Field-aware vertical nearest-duplication for interlaced frames.

    video-format.c GET_UV_420 (:71): full line y reads chroma row
    ((y & ~3) >> 1) + (y & 1): top and bottom field lines alternate chroma
    rows instead of pairing (c0,c1,c0,c1,... not c0,c0,c1,c1,...).
    GET_UV_410 analog for 4x: ((y & ~7) >> 2) + (y & 1)."""
    if factor_log2 == 0:
        return a
    ys = np.arange(size)
    if factor_log2 == 1:
        rows = ((ys & ~3) >> 1) + (ys & 1)
    else:
        rows = ((ys & ~7) >> 2) + (ys & 1)
    rows = np.minimum(rows, a.shape[-2] - 1)
    return a[..., _xp.index(xp, rows, a), :]


def unpack_planes(xp, fmt: VideoFormatInfo, planes, width: int, height: int,
                  dtype: str = "int32", subsampled_chroma: bool = False,
                  interlaced: bool = False):
    """planes -> canonical channel tuple (A, c0, c1, c2), each (..., H, W).

    ``xp`` is numpy (the host gold) or torch.  subsampled_chroma=True keeps
    subsampled chroma planes at their stored resolution (the caller
    upsamples them directly)."""
    dt = "int32" if fmt.bits == 16 else dtype

    def widen(p, c):
        """Stored value -> canonical depth (8 or 16 bit) with the
        reference's per-family replication rules."""
        d = fmt.depth[c] if c < len(fmt.depth) else fmt.depth[0]
        if fmt.bits == 16 and d < 16:
            if not fmt.replicate:
                # MT2110T/R, NV12_10BE_8L128: plain v<<6, no low-bit fill
                p = p << (16 - d)
            elif fmt.layout == "word32":
                # unpack_rgb10a2_le / Y410: left-justify then |= >>10
                # (including the 2-bit alpha: a<<14 | a<<4)
                p = p << (16 - d)
                p = p | (p >> 10)
            elif fmt.justify == "high":
                p = p | (p >> d)
            else:
                p = p << (16 - d)
                p = p | (p >> d)
        elif fmt.bits == 8 and 0 < d < 8:
            # RGB15/16 family: r<<3 | r>>2 (video_orc_unpack_RGB16)
            p = (p << (8 - d)) | (p >> (2 * d - 8))
        return p

    comps = []
    n = fmt.n_components
    for c in range(min(n, 3)):
        p = widen(_xp.astype(xp, planes[c], dt), c)
        if not (subsampled_chroma and c in (1, 2)):
            if interlaced and c in (1, 2):
                p = _dup_v_interlaced(xp, p, fmt.h_sub[c], height)
            else:
                p = _dup(xp, p, fmt.h_sub[c], -2, height)
            p = _dup(xp, p, fmt.w_sub[c], -1, width)
        comps.append(p)
    if fmt.is_gray:
        # GRAY unpacks with neutral chroma (video-format.c unpack_GRAY8)
        half = _xp.full_like(xp, comps[0], 0x80 if fmt.bits == 8 else 0x8000)
        comps = [comps[0], half, half]
    if fmt.has_alpha:
        a = planes[n - 1] if fmt.layout not in ("packed", "word32") \
            else planes[3]
        alpha = widen(_xp.astype(xp, a, dt), 3)
    else:
        alpha = _xp.full_like(xp, comps[0], 255 if fmt.bits == 8 else 0xFFFF)
    return (alpha, comps[0], comps[1], comps[2])


def pack_planes(xp, fmt: VideoFormatInfo, chans, width: int, height: int):
    """Channel tuple (A, c0, c1, c2) -> component planes: uint8 for an 8-bit
    container, uint16 for a 16-bit one.

    Values must already be in range (the converter clamps before pack).
    A None alpha channel means opaque (materialized only if the output
    format stores alpha)."""
    out = []
    n = fmt.n_components

    def store(p, c):
        d = fmt.depth[c] if c < len(fmt.depth) else fmt.depth[0]
        if fmt.bits == 8:
            if 0 < d < 8:
                # pack_RGB16: component >> (8 - depth)
                p = _xp.astype(xp, p, "int32") >> (8 - d)
            return _xp.astype(xp, p, "uint8")
        # 16-bit containers: pack_I420_10LE truncates v >> (16-depth);
        # P010/Y210 keep left-justified with low bits cleared; word32
        # stores the raw bitfield value (pack_Y410: a = A >> 14)
        p = _xp.astype(xp, p, "int32")
        if d < 16:
            if fmt.justify == "high":
                p = p & (((1 << d) - 1) << (16 - d))
            else:
                p = p >> (16 - d)
        return _xp.astype(xp, p, "uint16")

    for c in range(min(n, 3)):
        hs, ws = fmt.h_sub[c], fmt.w_sub[c]
        out.append(store(chans[1 + c][..., ::(1 << hs), ::(1 << ws)], c))
    if fmt.is_gray:
        out = out[:1]
    if fmt.has_alpha:
        a = chans[0]
        if a is None:
            a = _xp.full(xp, tuple(out[0].shape),
                         255 if fmt.bits == 8 else 0xFFFF, out[0], "int32")
        out.append(store(a, 3))
    return tuple(out)


def unpack(xp, fmt: VideoFormatInfo, planes, width: int, height: int):
    """planes -> canonical (..., H, W, 4) int32 (A, c0, c1, c2); the
    channel-last view of unpack_planes."""
    return _xp.stack(xp, list(unpack_planes(xp, fmt, planes, width, height)),
                     -1)


def pack(xp, fmt: VideoFormatInfo, canon, width: int, height: int):
    """Canonical (..., H, W, 4) int (A, c0, c1, c2) -> component planes."""
    chans = tuple(canon[..., i] for i in range(4))
    return pack_planes(xp, fmt, chans, width, height)


def plane_shapes(fmt: VideoFormatInfo, width: int, height: int):
    """Shapes of the component planes (component order)."""
    shapes = []
    for c in range(min(fmt.n_components, 3)):
        shapes.append((fmt.comp_height(c, height), fmt.comp_width(c, width)))
    if fmt.is_gray:
        shapes = shapes[:1]
    if fmt.has_alpha:
        shapes.append((height, width))
    return shapes
