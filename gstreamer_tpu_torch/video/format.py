"""Video pixel-format table and the planar pack/unpack of the torch port.

The format table (VideoFormatInfo and FORMATS) is host data, copied from the
JAX package's ``video/format.py`` so that this package imports nothing of it.
``unpack_planes`` and ``pack_planes`` are the device half: they take the
component planes of one frame or a batch and produce the canonical channel
tuple (A, c0, c1, c2), each (..., H, W), and back, for every format.

The host byte layout (``frame_size``, ``from_bytes``, ``to_bytes`` and their
helpers: v210, word32, bitfield16, IYU1, tiled, UYVP, RGB8P, LE32, LE40,
MT2110) is a numpy copy of the reference's: file and parser elements turn
bytes into component planes at the boundary, and the device never sees a
file layout.
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


def v210_stride(width: int) -> int:
    """v210 row stride: ((width + 47) / 48) * 128 (video-info.c)."""
    return ((width + 47) // 48) * 128


def frame_size(fmt: VideoFormatInfo, width: int, height: int) -> int:
    bps = fmt.bits // 8
    if fmt.layout == "v210":
        return height * v210_stride(width)
    if fmt.layout == "word32":
        return height * width * 4
    if fmt.layout == "bitfield16":
        return height * width * 2
    if fmt.layout == "iyu1":
        return height * (-(-width // 4)) * 6
    if fmt.layout == "tiled":
        _, tw, th, cth, xt, yt, cyt = _tiled_geometry(fmt, width, height)
        return xt * yt * tw * th + xt * cyt * tw * cth
    if fmt.layout == "uyvp":
        return height * uyvp_rowbytes(width)
    if fmt.layout == "palette":
        return height * width + 1024
    if fmt.layout in ("gray_le32", "semi_le32"):
        nw = le32_rowwords(width)
        rows = height if fmt.is_gray else height + fmt.comp_height(1, height)
        return rows * nw * 4
    if fmt.layout == "semi_le40":
        cw = fmt.comp_width(1, width)
        return height * le40_rowbytes(width) \
            + fmt.comp_height(1, height) * le40_rowbytes(2 * cw)
    if fmt.layout == "tiled_le40":
        ntx, nty, cyt = _tiled_le40_geometry(width, height)
        return ntx * (nty + cyt) * 20
    if fmt.layout == "tiled_be10":
        _, ntx, yt, uvyt = _tiled_be10_geometry(width, height)
        return ntx * (yt + uvyt) * 1024
    if fmt.layout == "mt2110":
        ntx, nty = _mt2110_geometry(width, height)
        return ntx * nty * (640 + 320)
    if fmt.layout == "packed":
        if fmt.is_rgb or _is_packed_letters(fmt):
            return height * width * len(fmt.packed_order) * bps
        # 4:2:2 packed: 4 samples / 2 pixels
        return height * (-(-width // 2)) * 4 * bps
    return sum(h * w for (h, w) in plane_shapes(fmt, width, height)) * bps


def _v210_from_bytes(data: np.ndarray, width: int, height: int):
    """unpack_v210 (video-format.c:559) word extraction: per 16-byte group
    a0..a3 carry (u0,y0,v0),(y1,u2,y2),(v2,y3,u4),(y4,v4,y5) as 10-bit
    fields.  Returns raw 10-bit component planes Y (H,W), U/V (H,ceil(W/2))
    as uint16 (the canonical <<6 | >>10 widening happens in
    unpack_planes' standard low-justified path)."""
    stride = v210_stride(width)
    batch = data.shape[:-1]
    rows = data.reshape(batch + (height, stride))
    words = np.ascontiguousarray(rows).view("<u4").astype(np.uint32)
    ng = -(-width // 6)
    g = words.reshape(batch + (height, -1, 4))[..., :ng, :]
    a0, a1, a2, a3 = (g[..., k] for k in range(4))
    y = np.stack([(a0 >> 10) & 0x3FF, a1 & 0x3FF, (a1 >> 20) & 0x3FF,
                  (a2 >> 10) & 0x3FF, a3 & 0x3FF, (a3 >> 20) & 0x3FF],
                 axis=-1).reshape(batch + (height, ng * 6))[..., :width]
    cw = -(-width // 2)
    u = np.stack([a0 & 0x3FF, (a1 >> 10) & 0x3FF, (a2 >> 20) & 0x3FF],
                 axis=-1).reshape(batch + (height, ng * 3))[..., :cw]
    v = np.stack([(a0 >> 20) & 0x3FF, a2 & 0x3FF, (a3 >> 10) & 0x3FF],
                 axis=-1).reshape(batch + (height, ng * 3))[..., :cw]
    return [y.astype(np.uint16), u.astype(np.uint16), v.astype(np.uint16)]


def _v210_to_bytes(planes, width: int, height: int) -> np.ndarray:
    """pack_v210 (video-format.c:651): components are 10-bit values
    (pack_planes already >>6'd); tail lanes beyond width pack as 0."""
    y, u, v = (np.asarray(p).astype(np.uint32) for p in planes[:3])
    batch = y.shape[:-2]
    ng = -(-width // 6)

    def padlast(a, n):
        pad = [(0, 0)] * a.ndim
        pad[-1] = (0, n - a.shape[-1])
        return np.pad(a, pad)

    y = padlast(y, ng * 6).reshape(batch + (height, ng, 6))
    u = padlast(u, ng * 3).reshape(batch + (height, ng, 3))
    v = padlast(v, ng * 3).reshape(batch + (height, ng, 3))
    a0 = u[..., 0] | (y[..., 0] << 10) | (v[..., 0] << 20)
    a1 = y[..., 1] | (u[..., 1] << 10) | (y[..., 2] << 20)
    a2 = v[..., 1] | (y[..., 3] << 10) | (u[..., 2] << 20)
    a3 = y[..., 4] | (v[..., 2] << 10) | (y[..., 5] << 20)
    words = np.ascontiguousarray(
        np.stack([a0, a1, a2, a3], axis=-1).astype("<u4"))
    stride = v210_stride(width)
    out = np.zeros(batch + (height, stride), np.uint8)
    rowbytes = words.view(np.uint8).reshape(batch + (height, ng * 16))
    out[..., :ng * 16] = rowbytes
    return out.reshape(batch + (height * stride,))


def _word32_from_bytes(fmt, data, width, height):
    """32-bit word bitfields (RGB10A2_LE/BGR10A2_LE/r210/Y410): raw
    per-component values at stored depth."""
    wdt = np.dtype("<u4" if fmt.endian == "le" else ">u4")
    words = np.ascontiguousarray(data).view(wdt).astype(np.uint32)
    batch = data.shape[:-1]
    img = words.reshape(batch + (height, width))
    planes = []
    for c in range(min(fmt.n_components, 3)):
        mask = (1 << fmt.depth[c]) - 1
        planes.append(((img >> fmt.shifts[c]) & mask).astype(np.uint16))
    if fmt.has_alpha:
        mask = (1 << fmt.depth[3]) - 1
        planes.append(((img >> fmt.shifts[3]) & mask).astype(np.uint16))
    return tuple(planes)


def _word32_to_bytes(fmt, planes, width, height):
    batch = np.asarray(planes[0]).shape[:-2]
    img = np.zeros(batch + (height, width), np.uint32)
    for c in range(min(fmt.n_components, 3)):
        mask = (1 << fmt.depth[c]) - 1
        img |= (np.asarray(planes[c], np.uint32) & mask) << fmt.shifts[c]
    if fmt.has_alpha:
        mask = (1 << fmt.depth[3]) - 1
        img |= (np.asarray(planes[3], np.uint32) & mask) << fmt.shifts[3]
    elif len(fmt.shifts) > 3:
        # RGB10x2/BGR10x2: padding bits written as opaque (the shared
        # reference pack_rgb10a2_le stores canonical-A>>14 = 3)
        img |= ((1 << fmt.depth[3]) - 1) << fmt.shifts[3]
    wdt = np.dtype("<u4" if fmt.endian == "le" else ">u4")
    return np.ascontiguousarray(img.astype(wdt)).view(np.uint8).reshape(
        batch + (-1,))


def _bitfield16_from_bytes(fmt, data, width, height):
    """RGB16/BGR16/RGB15/BGR15: raw components at stored depth."""
    words = np.ascontiguousarray(data).view(fmt.word_dtype).astype(
        np.uint16)
    batch = data.shape[:-1]
    img = words.reshape(batch + (height, width))
    return tuple(((img >> fmt.shifts[c]) & ((1 << fmt.depth[c]) - 1)
                  ).astype(np.uint8) for c in range(3))


def _bitfield16_to_bytes(fmt, planes, width, height):
    batch = np.asarray(planes[0]).shape[:-2]
    img = np.zeros(batch + (height, width), np.uint16)
    for c in range(3):
        mask = (1 << fmt.depth[c]) - 1
        img |= (np.asarray(planes[c], np.uint16) & mask) << fmt.shifts[c]
    return np.ascontiguousarray(img.astype(fmt.word_dtype)).view(
        np.uint8).reshape(batch + (-1,))


def _iyu1_from_bytes(data, width, height):
    """IYU1 (unpack_IYU1): U Y0 Y1 V Y2 Y3 per 4 pixels (6 bytes)."""
    ng = -(-width // 4)
    batch = data.shape[:-1]
    g = data.reshape(batch + (height, ng, 6))
    y = np.stack([g[..., 1], g[..., 2], g[..., 4], g[..., 5]], axis=-1)
    y = y.reshape(batch + (height, ng * 4))[..., :width]
    return (y, g[..., 0], g[..., 3])


def _iyu1_to_bytes(planes, width, height):
    y, u, v = (np.asarray(p, np.uint8) for p in planes[:3])
    batch = y.shape[:-2]
    ng = -(-width // 4)
    pad = ng * 4 - width
    if pad:
        y = np.concatenate([y] + [y[..., -1:]] * pad, axis=-1)
    y4 = y.reshape(batch + (height, ng, 4))
    out = np.stack([u, y4[..., 0], y4[..., 1], v, y4[..., 2], y4[..., 3]],
                   axis=-1)
    return out.reshape(batch + (-1,))


def _tile_index_grid(mode, x_tiles, y_tiles):
    """Tile index per (ty, tx) — gst_video_tile_get_index
    (video-tile.c:44): LINEAR row order or ZFLIPZ_2X2 zigzag."""
    tx = np.arange(x_tiles)[None, :]
    ty = np.arange(y_tiles)[:, None]
    if mode == "linear":
        return ty * x_tiles + tx
    # ZFLIPZ_2X2
    off = (ty & ~1) * x_tiles + tx
    odd = (ty & 1).astype(bool)
    last_even = ((y_tiles & 1) == 1) & (ty == y_tiles - 1)
    off = np.where(odd, off + 2 + ((tx) & ~3),
                   np.where(last_even, off, off + ((tx + 2) & ~3)))
    return off


def _tiled_geometry(fmt, width, height):
    mode, tw, th, cth = fmt.tile
    xt = -(-width // tw)
    yt = -(-height // th)
    ch = -(-height // 2)
    # chroma plane: same byte width (UV interleaved), cth-row tiles;
    # non-subtiled formats address it through the luma tile grid with
    # ty/2 + half-tile offsets (get_tile_NV12, video-format.c:4824)
    cyt = -(-ch // cth)
    return mode, tw, th, cth, xt, yt, cyt


def _tiled_from_bytes(fmt, data, width, height):
    mode, tw, th, cth, xt, yt, cyt = _tiled_geometry(fmt, width, height)
    batch = data.shape[:-1]
    ysz = xt * yt * tw * th
    grid = _tile_index_grid(mode, xt, yt)
    tiles = data[..., :ysz].reshape(batch + (xt * yt, th, tw))
    # scatter tiles back: padded plane (yt*th, xt*tw)
    ypad = np.zeros(batch + (yt * th, xt * tw), np.uint8)
    for tyi in range(yt):
        for txi in range(xt):
            ypad[..., tyi * th:(tyi + 1) * th, txi * tw:(txi + 1) * tw] = \
                tiles[..., grid[tyi, txi], :, :]
    y = ypad[..., :height, :width]

    ch = -(-height // 2)
    csz = xt * cyt * tw * cth
    cgrid = _tile_index_grid(mode, xt, cyt)
    ctiles = data[..., ysz:ysz + csz].reshape(batch + (xt * cyt, cth, tw))
    cpad = np.zeros(batch + (cyt * cth, xt * tw), np.uint8)
    for tyi in range(cyt):
        for txi in range(xt):
            cpad[..., tyi * cth:(tyi + 1) * cth, txi * tw:(txi + 1) * tw] = \
                ctiles[..., cgrid[tyi, txi], :, :]
    uvrows = cpad[..., :ch, :width]
    uv = uvrows.reshape(batch + (ch, width // 2, 2))
    return (y, uv[..., 0], uv[..., 1])


def _tiled_to_bytes(fmt, planes, width, height):
    mode, tw, th, cth, xt, yt, cyt = _tiled_geometry(fmt, width, height)
    y, u, v = (np.asarray(p, np.uint8) for p in planes[:3])
    batch = y.shape[:-2]
    ypad = np.zeros(batch + (yt * th, xt * tw), np.uint8)
    ypad[..., :height, :width] = y
    grid = _tile_index_grid(mode, xt, yt)
    tiles = np.zeros(batch + (xt * yt, th, tw), np.uint8)
    for tyi in range(yt):
        for txi in range(xt):
            tiles[..., grid[tyi, txi], :, :] = \
                ypad[..., tyi * th:(tyi + 1) * th, txi * tw:(txi + 1) * tw]
    ybytes = tiles.reshape(batch + (-1,))

    ch = -(-height // 2)
    uv = np.stack([u, v], axis=-1).reshape(batch + (ch, width))
    cpad = np.zeros(batch + (cyt * cth, xt * tw), np.uint8)
    cpad[..., :ch, :width] = uv
    cgrid = _tile_index_grid(mode, xt, cyt)
    ctiles = np.zeros(batch + (xt * cyt, cth, tw), np.uint8)
    for tyi in range(cyt):
        for txi in range(xt):
            ctiles[..., cgrid[tyi, txi], :, :] = \
                cpad[..., tyi * cth:(tyi + 1) * cth, txi * tw:(txi + 1) * tw]
    return np.concatenate([ybytes, ctiles.reshape(batch + (-1,))], axis=-1)


# ---------------------------------------------------------------------------
# 10-bit bitstream / word32x3 / palette / MediaTek-tile codecs for the last
# 13 reference formats (UYVP, RGB8P, *_10LE32, *_10LE40(+4L4), 10BE_8L128,
# MT2110T/R).  Host-boundary numpy only, like the other layout codecs.
# ---------------------------------------------------------------------------

def _u10_rows_unpack(rows: np.ndarray, nsamples: int, bitorder: str):
    """Rows of a 10-bit-packed bitstream -> (..., nsamples) uint16.

    bitorder 'little' = LSB-first stream (NV12_10LE40 family), 'big' =
    MSB-first stream (UYVP, NV12_10BE_8L128)."""
    bits = np.unpackbits(rows, axis=-1, bitorder=bitorder)
    bits = bits[..., :nsamples * 10]
    bits = bits.reshape(bits.shape[:-1] + (nsamples, 10))
    if bitorder == "little":
        w = (1 << np.arange(10)).astype(np.uint16)
    else:
        w = (1 << np.arange(9, -1, -1)).astype(np.uint16)
    return (bits.astype(np.uint16) * w).sum(-1).astype(np.uint16)


def _u10_rows_pack(samples: np.ndarray, rowbytes: int, bitorder: str):
    """(..., n) uint16 10-bit samples -> (..., rowbytes) packed rows."""
    n = samples.shape[-1]
    if bitorder == "little":
        sh = np.arange(10)
    else:
        sh = np.arange(9, -1, -1)
    bits = ((samples[..., None].astype(np.uint16) >> sh) & 1).astype(np.uint8)
    bits = bits.reshape(samples.shape[:-1] + (n * 10,))
    pad = rowbytes * 8 - n * 10
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    return np.packbits(bits, axis=-1, bitorder=bitorder)


def uyvp_rowbytes(width: int) -> int:
    return (-(-width // 2)) * 5


def _uyvp_from_bytes(data, width, height):
    """unpack_UYVP (video-format.c:2043): per 2 pixels one 40-bit MSB-first
    group U Y0 V Y1."""
    ng = -(-width // 2)
    batch = data.shape[:-1]
    rows = data.reshape(batch + (height, ng * 5))
    s = _u10_rows_unpack(rows, ng * 4, "big")
    u, y0, v, y1 = s[..., 0::4], s[..., 1::4], s[..., 2::4], s[..., 3::4]
    y = np.stack([y0, y1], -1).reshape(batch + (height, ng * 2))[..., :width]
    return (y, u, v)


def _uyvp_to_bytes(planes, width, height):
    y, u, v = (np.asarray(p, np.uint16) for p in planes[:3])
    batch = y.shape[:-2]
    ng = -(-width // 2)
    if width & 1:   # pack_UYVP: tail y1 = y0
        y = np.concatenate([y, y[..., -1:]], axis=-1)
    y2 = y.reshape(batch + (height, ng, 2))
    s = np.stack([u, y2[..., 0], v, y2[..., 1]], axis=-1)
    return _u10_rows_pack(s.reshape(batch + (height, ng * 4)),
                          ng * 5, "big").reshape(batch + (-1,))


# std_palette_RGB8P (video-format.c:2208): 216 web colors (B fastest),
# entry 216 transparent black, rest opaque black.
def _std_palette_rgb8p() -> np.ndarray:
    pal = np.full(256, 0xFF000000, np.uint32)
    i = np.arange(216)
    steps = np.array([0x00, 0x33, 0x66, 0x99, 0xCC, 0xFF], np.uint32)
    pal[:216] = (0xFF000000 | (steps[i // 36] << 16)
                 | (steps[(i // 6) % 6] << 8) | steps[i % 6])
    pal[216] = 0x00000000
    return pal


STD_PALETTE_RGB8P = _std_palette_rgb8p()


def _rgb8p_from_bytes(data, width, height):
    batch = data.shape[:-1]
    idx = data[..., :height * width].reshape(batch + (height, width))
    pal = np.ascontiguousarray(
        data[..., height * width:height * width + 1024]).view("<u4")
    pal = pal.reshape(batch + (256,)).astype(np.uint32)
    # per-frame palette gather
    if batch:
        flat = pal.reshape((-1, 256))
        fidx = idx.reshape((-1, height, width))
        v = np.stack([flat[k][fidx[k]] for k in range(flat.shape[0])])
        v = v.reshape(batch + (height, width))
    else:
        v = pal[idx]
    a = (v >> 24).astype(np.uint8)
    r = ((v >> 16) & 0xFF).astype(np.uint8)
    g = ((v >> 8) & 0xFF).astype(np.uint8)
    b = (v & 0xFF).astype(np.uint8)
    return (r, g, b, a)


def _rgb8p_to_bytes(planes, width, height):
    """pack_RGB8P (video-format.c:2255): crude web-palette quantization;
    the palette plane is written as the standard palette."""
    r, g, b, a = (np.asarray(p) for p in planes[:4])
    batch = r.shape[:-2]
    idx = ((r.astype(np.int32) // 47) % 6) * 36 \
        + ((g.astype(np.int32) // 47) % 6) * 6 \
        + ((b.astype(np.int32) // 47) % 6)
    idx = np.where(a < 0x80, 216, idx).astype(np.uint8)
    palbytes = np.ascontiguousarray(
        STD_PALETTE_RGB8P.astype("<u4")).view(np.uint8)
    pal = np.broadcast_to(palbytes, batch + (1024,))
    return np.concatenate([idx.reshape(batch + (-1,)), pal], axis=-1)


def le32_rowwords(width: int) -> int:
    return (width + 2) // 3


def _u10_le32_rows_unpack(rows: np.ndarray, nsamples: int):
    """LE 32-bit words, 3 samples per word at bits 0/10/20
    (unpack_GRAY10_LE32 video-format.c:5263)."""
    words = np.ascontiguousarray(rows).view("<u4").astype(np.uint32)
    s = np.stack([(words >> (10 * k)) & 0x3FF for k in range(3)], axis=-1)
    return s.reshape(s.shape[:-2] + (-1,))[..., :nsamples].astype(np.uint16)


def _u10_le32_rows_pack(samples: np.ndarray, nwords: int):
    n = samples.shape[-1]
    pad = nwords * 3 - n
    if pad:
        samples = np.pad(samples, [(0, 0)] * (samples.ndim - 1) + [(0, pad)])
    s = samples.reshape(samples.shape[:-1] + (nwords, 3)).astype(np.uint32)
    words = (s[..., 0] & 0x3FF) | ((s[..., 1] & 0x3FF) << 10) \
        | ((s[..., 2] & 0x3FF) << 20)
    return np.ascontiguousarray(words.astype("<u4")).view(np.uint8)


def _le32_from_bytes(fmt, data, width, height):
    nw = le32_rowwords(width)
    batch = data.shape[:-1]
    ysz = height * nw * 4
    y = _u10_le32_rows_unpack(
        data[..., :ysz].reshape(batch + (height, nw * 4)), width)
    if fmt.is_gray:
        return (y,)
    ch = fmt.comp_height(1, height)
    cw = fmt.comp_width(1, width)
    uv = _u10_le32_rows_unpack(
        data[..., ysz:ysz + ch * nw * 4].reshape(batch + (ch, nw * 4)),
        min(2 * cw, 3 * nw))
    return (y, uv[..., 0::2], uv[..., 1::2])


def _le32_to_bytes(fmt, planes, width, height):
    nw = le32_rowwords(width)
    y = np.asarray(planes[0], np.uint16)
    batch = y.shape[:-2]
    chunks = [_u10_le32_rows_pack(y, nw).reshape(batch + (-1,))]
    if not fmt.is_gray:
        u, v = (np.asarray(p, np.uint16) for p in planes[1:3])
        uv = np.stack([u, v], -1).reshape(batch + (u.shape[-2], -1))
        uv = uv[..., :3 * nw]
        chunks.append(_u10_le32_rows_pack(uv, nw).reshape(batch + (-1,)))
    return np.concatenate(chunks, axis=-1)


def le40_rowbytes(width: int) -> int:
    return (width * 10 + 7) // 8


def _le40_from_bytes(fmt, data, width, height):
    rb = le40_rowbytes(width)
    batch = data.shape[:-1]
    ysz = height * rb
    y = _u10_rows_unpack(
        data[..., :ysz].reshape(batch + (height, rb)), width, "little")
    ch = fmt.comp_height(1, height)
    cw = fmt.comp_width(1, width)
    crb = le40_rowbytes(2 * cw)
    uv = _u10_rows_unpack(
        data[..., ysz:ysz + ch * crb].reshape(batch + (ch, crb)),
        2 * cw, "little")
    return (y, uv[..., 0::2], uv[..., 1::2])


def _le40_to_bytes(fmt, planes, width, height):
    rb = le40_rowbytes(width)
    y = np.asarray(planes[0], np.uint16)
    batch = y.shape[:-2]
    u, v = (np.asarray(p, np.uint16) for p in planes[1:3])
    uv = np.stack([u, v], -1).reshape(batch + (u.shape[-2], -1))
    crb = le40_rowbytes(uv.shape[-1])
    return np.concatenate(
        [_u10_rows_pack(y, rb, "little").reshape(batch + (-1,)),
         _u10_rows_pack(uv, crb, "little").reshape(batch + (-1,))], axis=-1)


def _tiled_le40_geometry(width, height):
    ntx = -(-width // 4)
    nty = -(-height // 4)
    cyt = (nty + 1) // 2          # GST_ROUND_UP_2(nty)/2 (video-info.c:1192)
    return ntx, nty, cyt


def _tile_rows_scatter(rows, nty, ntx, trh, trw):
    """(..., nty*trh, ntx*trw) byte rows -> linear row-major tiles, each
    tile trh x trw bytes, flattened."""
    batch = rows.shape[:-2]
    t = rows.reshape(batch + (nty, trh, ntx, trw))
    t = np.moveaxis(t, -2, -3)    # (nty, ntx, trh, trw)
    return np.ascontiguousarray(t).reshape(batch + (-1,))


def _tile_rows_gather(data, nty, ntx, trh, trw):
    batch = data.shape[:-1]
    t = data.reshape(batch + (nty, ntx, trh, trw))
    t = np.moveaxis(t, -3, -2)
    return np.ascontiguousarray(t).reshape(batch + (nty * trh, ntx * trw))


def _pad_to(a, h, w):
    pad = [(0, 0)] * (a.ndim - 2) + [(0, h - a.shape[-2]),
                                     (0, w - a.shape[-1])]
    return np.pad(a, pad)


def _tiled_le40_from_bytes(data, width, height):
    ntx, nty, cyt = _tiled_le40_geometry(width, height)
    batch = data.shape[:-1]
    ysz = ntx * nty * 20
    yrows = _tile_rows_gather(data[..., :ysz], nty, ntx, 4, 5)
    y = _u10_rows_unpack(
        yrows.reshape(batch + (nty * 4, ntx, 5)), 4, "little")
    y = y.reshape(batch + (nty * 4, ntx * 4))[..., :height, :width]
    ch = -(-height // 2)
    csz = ntx * cyt * 20
    crows = _tile_rows_gather(data[..., ysz:ysz + csz], cyt, ntx, 4, 5)
    uv = _u10_rows_unpack(
        crows.reshape(batch + (cyt * 4, ntx, 5)), 4, "little")
    uv = uv.reshape(batch + (cyt * 4, ntx * 4))[..., :ch, :]
    cw = -(-width // 2)
    return (y, uv[..., 0:2 * cw:2], uv[..., 1:2 * cw:2])


def _tiled_le40_to_bytes(planes, width, height):
    ntx, nty, cyt = _tiled_le40_geometry(width, height)
    y, u, v = (np.asarray(p, np.uint16) for p in planes[:3])
    batch = y.shape[:-2]
    ypad = _pad_to(y, nty * 4, ntx * 4)
    ybytes = _u10_rows_pack(
        ypad.reshape(batch + (nty * 4, ntx, 4)), 5, "little")
    ybytes = _tile_rows_scatter(
        ybytes.reshape(batch + (nty * 4, ntx * 5)), nty, ntx, 4, 5)
    ch = -(-height // 2)
    uv = np.stack([u, v], -1).reshape(batch + (ch, -1))
    uvpad = _pad_to(uv, cyt * 4, ntx * 4)
    cbytes = _u10_rows_pack(
        uvpad.reshape(batch + (cyt * 4, ntx, 4)), 5, "little")
    cbytes = _tile_rows_scatter(
        cbytes.reshape(batch + (cyt * 4, ntx * 5)), cyt, ntx, 4, 5)
    return np.concatenate([ybytes, cbytes], axis=-1)


def _tiled_be10_geometry(width, height):
    rb = (width * 10 + 7) // 8    # GST_ROUND_UP_8(w*10)>>3
    ntx = -(-rb // 8)
    yt = -(-height // 128)
    uvyt = (yt + 1) // 2
    return rb, ntx, yt, uvyt


def _tiled_be10_from_bytes(data, width, height):
    rb, ntx, yt, uvyt = _tiled_be10_geometry(width, height)
    batch = data.shape[:-1]
    ysz = ntx * yt * 1024
    yrows = _tile_rows_gather(data[..., :ysz], yt, ntx, 128, 8)
    y = _u10_rows_unpack(yrows[..., :height, :rb], width, "big")
    ch = -(-height // 2)
    cw = -(-width // 2)
    csz = ntx * uvyt * 1024
    crows = _tile_rows_gather(data[..., ysz:ysz + csz], uvyt, ntx, 128, 8)
    uv = _u10_rows_unpack(crows[..., :ch, :rb], 2 * cw, "big")
    return (y, uv[..., 0::2], uv[..., 1::2])


def _tiled_be10_to_bytes(planes, width, height):
    rb, ntx, yt, uvyt = _tiled_be10_geometry(width, height)
    y, u, v = (np.asarray(p, np.uint16) for p in planes[:3])
    batch = y.shape[:-2]
    ybytes = _u10_rows_pack(y, rb, "big")
    ybytes = _pad_to(ybytes, yt * 128, ntx * 8)
    ch = -(-height // 2)
    uv = np.stack([u, v], -1).reshape(batch + (ch, -1))
    cbytes = _u10_rows_pack(uv, rb, "big")
    cbytes = _pad_to(cbytes, uvyt * 128, ntx * 8)
    return np.concatenate(
        [_tile_rows_scatter(ybytes, yt, ntx, 128, 8),
         _tile_rows_scatter(cbytes, uvyt, ntx, 128, 8)], axis=-1)


def _mt2110_geometry(width, height):
    ntx = -(-width // 16)
    nty = -(-height // 32)
    return ntx, nty


def _mt2110_low_luma_decode(lowb, variant):
    """lowb: (..., nty, ntx, 8, 16) partition low-bit bytes ->
    (..., nty, ntx, 8, 4, 16) 2-bit values per (partition, line, x)."""
    if variant == "t":
        # byte x holds the 4 lines' 2-bit values at shift l*2
        sh = (np.arange(4) * 2)[None, :, None]
        return (lowb[..., None, :] >> sh) & 3
    # R: byte l*4 + x//4, shift (x%4)*2
    b = lowb.reshape(lowb.shape[:-1] + (4, 4))      # (.., 8, l, x//4)
    f = (b[..., None] >> (np.arange(4) * 2)) & 3    # (.., 8, l, x//4, x%4)
    return f.reshape(f.shape[:-2] + (16,))


def _mt2110_low_luma_encode(low, variant):
    """inverse: low (..., nty, ntx, 8, 4, 16) -> bytes (..., 8, 16)."""
    if variant == "t":
        sh = (np.arange(4) * 2)[None, :, None]
        return (low.astype(np.uint16) << sh).sum(-2).astype(np.uint8)
    g = low.reshape(low.shape[:-1] + (4, 4))        # (.., 8, l, x//4, x%4)
    b = (g.astype(np.uint16) << (np.arange(4) * 2)).sum(-1).astype(np.uint8)
    return b.reshape(b.shape[:-2] + (16,))


def _mt2110_from_bytes(data, width, height, variant):
    ntx, nty = _mt2110_geometry(width, height)
    batch = data.shape[:-1]
    ysz = ntx * nty * 640
    t = data[..., :ysz].reshape(batch + (nty, ntx, 8, 80))
    high = t[..., 16:].reshape(batch + (nty, ntx, 8, 4, 16))
    low = _mt2110_low_luma_decode(t[..., :16], variant)
    yv = (high.astype(np.uint16) << 2) | low
    yv = np.moveaxis(yv.reshape(batch + (nty, ntx, 32, 16)), -3, -2)
    y = yv.reshape(batch + (nty * 32, ntx * 16))[..., :height, :width]

    csz = ntx * nty * 320
    c = data[..., ysz:ysz + csz].reshape(batch + (nty, ntx, 4, 80))
    chigh = c[..., 16:].reshape(batch + (nty, ntx, 4, 4, 16))
    # low bytes: interleaved UV pairs; both variants keep U/V adjacent
    if variant == "t":
        sh = (np.arange(4) * 2)[None, :, None]
        clow = (c[..., :16][..., None, :] >> sh) & 3
    else:
        # R: byte l*4 + tx//4; per byte fields [U,V,U,V] of 2 chroma px
        b = c[..., :16].reshape(batch + (nty, ntx, 4, 4, 4))
        f = (b[..., None] >> (np.arange(4) * 2)) & 3
        clow = f.reshape(batch + (nty, ntx, 4, 4, 16))
    cv = (chigh.astype(np.uint16) << 2) | clow
    cv = np.moveaxis(cv.reshape(batch + (nty, ntx, 16, 16)), -3, -2)
    cv = cv.reshape(batch + (nty * 16, ntx * 16))
    ch = -(-height // 2)
    cw = -(-width // 2)
    u = cv[..., :ch, 0:2 * cw:2]
    v = cv[..., :ch, 1:2 * cw:2]
    return (y, u, v)


def _mt2110_to_bytes(planes, width, height, variant):
    ntx, nty = _mt2110_geometry(width, height)
    y, u, v = (np.asarray(p, np.uint16) for p in planes[:3])
    batch = y.shape[:-2]
    ypad = _pad_to(y, nty * 32, ntx * 16)
    yv = np.moveaxis(ypad.reshape(batch + (nty, 32, ntx, 16)), -2, -3)
    yv = yv.reshape(batch + (nty, ntx, 8, 4, 16))
    high = (yv >> 2).astype(np.uint8)
    low = _mt2110_low_luma_encode(yv & 3, variant)
    yt = np.concatenate(
        [low, high.reshape(batch + (nty, ntx, 8, 64))], axis=-1)
    ybytes = yt.reshape(batch + (-1,))

    ch = -(-height // 2)
    uv = np.stack([u, v], -1).reshape(batch + (ch, -1))
    uvpad = _pad_to(uv, nty * 16, ntx * 16)
    cv = np.moveaxis(uvpad.reshape(batch + (nty, 16, ntx, 16)), -2, -3)
    cv = cv.reshape(batch + (nty, ntx, 4, 4, 16))
    chigh = (cv >> 2).astype(np.uint8)
    if variant == "t":
        sh = (np.arange(4) * 2)[None, :, None]
        clow = ((cv & 3).astype(np.uint16) << sh).sum(-2).astype(np.uint8)
    else:
        g = (cv & 3).reshape(batch + (nty, ntx, 4, 4, 4, 4))
        clow = (g.astype(np.uint16) << (np.arange(4) * 2)).sum(-1)
        clow = clow.astype(np.uint8).reshape(batch + (nty, ntx, 4, 16))
    ct = np.concatenate(
        [clow, chigh.reshape(batch + (nty, ntx, 4, 64))], axis=-1)
    return np.concatenate([ybytes, ct.reshape(batch + (-1,))], axis=-1)


def _is_packed_letters(fmt) -> bool:
    """Single-plane per-pixel letter layouts (AYUV/VUYA/v308/IYU2/Y416…)."""
    return (fmt.layout == "packed" and fmt.packed_order
            and isinstance(fmt.packed_order[0], str)
            and "Y0" not in fmt.packed_order)


def from_bytes(fmt: VideoFormatInfo, data: np.ndarray, width: int,
               height: int):
    """Decode the format's memory layout into component planes (numpy)."""
    data = np.asarray(data, dtype=np.uint8)
    if fmt.layout == "v210":
        return _v210_from_bytes(data, width, height)
    if fmt.layout == "word32":
        return _word32_from_bytes(fmt, data, width, height)
    if fmt.layout == "bitfield16":
        return _bitfield16_from_bytes(fmt, data, width, height)
    if fmt.layout == "iyu1":
        return _iyu1_from_bytes(data, width, height)
    if fmt.layout == "tiled":
        return _tiled_from_bytes(fmt, data, width, height)
    if fmt.layout == "uyvp":
        return _uyvp_from_bytes(data, width, height)
    if fmt.layout == "palette":
        return _rgb8p_from_bytes(data, width, height)
    if fmt.layout in ("gray_le32", "semi_le32"):
        return _le32_from_bytes(fmt, data, width, height)
    if fmt.layout == "semi_le40":
        return _le40_from_bytes(fmt, data, width, height)
    if fmt.layout == "tiled_le40":
        return _tiled_le40_from_bytes(data, width, height)
    if fmt.layout == "tiled_be10":
        return _tiled_be10_from_bytes(data, width, height)
    if fmt.layout == "mt2110":
        return _mt2110_from_bytes(data, width, height, fmt.tile[0])
    if fmt.bits == 16:
        data = np.ascontiguousarray(data).view(fmt.word_dtype)
        if fmt.endian == "be":
            data = data.astype(np.uint16)
    batch = data.shape[:-1]
    shapes = plane_shapes(fmt, width, height)

    if fmt.layout == "planar":
        comp_of_store = fmt.plane_order
        planes = [None] * len(shapes)
        off = 0
        for store_idx, comp in enumerate(comp_of_store):
            h, w = shapes[comp]
            sz = h * w
            planes[comp] = data[..., off:off + sz].reshape(batch + (h, w))
            off += sz
        return tuple(planes)

    if fmt.layout == "semi":
        h0, w0 = shapes[0]
        hc, wc = shapes[1]
        y = data[..., : h0 * w0].reshape(batch + (h0, w0))
        uv = data[..., h0 * w0:h0 * w0 + hc * wc * 2].reshape(
            batch + (hc, wc, 2))
        first, second = fmt.plane_order[1], fmt.plane_order[2]
        planes = [y, None, None]
        planes[first] = uv[..., 0]
        planes[second] = uv[..., 1]
        if fmt.has_alpha:      # AV12: NV12 + full-res alpha plane
            a = data[..., h0 * w0 + hc * wc * 2:].reshape(
                batch + (height, width))
            planes.append(a)
        return tuple(planes)

    # packed, one letter per stored component
    if fmt.is_rgb or _is_packed_letters(fmt):
        nb = len(fmt.packed_order)
        img = data.reshape(batch + (height, width, nb))
        if fmt.is_rgb:
            chans = {}
            for pos, ch in enumerate(fmt.packed_order):
                if ch >= 0:
                    chans[ch] = img[..., pos]
            planes = [chans[0], chans[1], chans[2]]
            if fmt.has_alpha:
                planes.append(chans[3])
            return tuple(planes)
        pos = {ch: i for i, ch in enumerate(fmt.packed_order)}
        planes = [img[..., pos["Y"]], img[..., pos["U"]],
                  img[..., pos["V"]]]
        if fmt.has_alpha:
            planes.append(img[..., pos["A"]])
        return tuple(planes)

    # packed 4:2:2 ([Y0 U Y1 V] orderings, 8- or 16-bit samples)
    wmac = -(-width // 2)
    img = data.reshape(batch + (height, wmac, 4))
    pos = {ch: i for i, ch in enumerate(fmt.packed_order)}
    y = np.stack([img[..., pos["Y0"]], img[..., pos["Y1"]]], axis=-1)
    y = y.reshape(batch + (height, wmac * 2))[..., :width]
    return (y, img[..., pos["U"]], img[..., pos["V"]])


def _assemble(fmt: VideoFormatInfo, planes, width: int, height: int,
              sdt) -> np.ndarray:
    """Element-typed layout assembly shared by 8/16-bit to_bytes."""
    batch = planes[0].shape[:-2]
    opaque = 255 if fmt.bits == 8 else 0xFFFF

    if fmt.layout == "planar":
        chunks = [planes[comp].reshape(batch + (-1,))
                  for comp in fmt.plane_order]
        return np.concatenate(chunks, axis=-1)

    if fmt.layout == "semi":
        first, second = fmt.plane_order[1], fmt.plane_order[2]
        uv = np.stack([planes[first], planes[second]], axis=-1)
        chunks = [planes[0].reshape(batch + (-1,)),
                  uv.reshape(batch + (-1,))]
        if fmt.has_alpha:      # AV12
            chunks.append(planes[3].reshape(batch + (-1,)))
        return np.concatenate(chunks, axis=-1)

    if fmt.is_rgb or _is_packed_letters(fmt):
        nb = len(fmt.packed_order)
        out = np.empty(batch + (height, width, nb), sdt)
        if fmt.is_rgb:
            for posi, ch in enumerate(fmt.packed_order):
                out[..., posi] = planes[ch] if ch >= 0 else opaque
        else:
            named = {"Y": planes[0], "U": planes[1], "V": planes[2]}
            if fmt.has_alpha:
                named["A"] = planes[3]
            for posi, ch in enumerate(fmt.packed_order):
                out[..., posi] = named[ch]
        return out.reshape(batch + (-1,))

    # packed 4:2:2
    wmac = -(-width // 2)
    ypad = planes[0]
    if width & 1:
        ypad = np.concatenate([ypad, ypad[..., -1:]], axis=-1)
    y2 = ypad.reshape(batch + (height, wmac, 2))
    named = {"Y0": y2[..., 0], "Y1": y2[..., 1], "U": planes[1],
             "V": planes[2]}
    out = np.stack([named[ch] for ch in fmt.packed_order], axis=-1)
    return out.reshape(batch + (-1,))


def to_bytes(fmt: VideoFormatInfo, planes, width: int, height: int) -> np.ndarray:
    """Encode component planes into the format's memory layout (numpy),
    returned as flat uint8 per frame."""
    if fmt.layout == "v210":
        return _v210_to_bytes(planes, width, height)
    if fmt.layout == "word32":
        return _word32_to_bytes(fmt, planes, width, height)
    if fmt.layout == "bitfield16":
        return _bitfield16_to_bytes(fmt, planes, width, height)
    if fmt.layout == "iyu1":
        return _iyu1_to_bytes(planes, width, height)
    if fmt.layout == "tiled":
        return _tiled_to_bytes(fmt, planes, width, height)
    if fmt.layout == "uyvp":
        return _uyvp_to_bytes(planes, width, height)
    if fmt.layout == "palette":
        return _rgb8p_to_bytes(planes, width, height)
    if fmt.layout in ("gray_le32", "semi_le32"):
        return _le32_to_bytes(fmt, planes, width, height)
    if fmt.layout == "semi_le40":
        return _le40_to_bytes(fmt, planes, width, height)
    if fmt.layout == "tiled_le40":
        return _tiled_le40_to_bytes(planes, width, height)
    if fmt.layout == "tiled_be10":
        return _tiled_be10_to_bytes(planes, width, height)
    if fmt.layout == "mt2110":
        return _mt2110_to_bytes(planes, width, height, fmt.tile[0])
    sdt = np.uint8 if fmt.bits == 8 else np.uint16
    out = _assemble(fmt, [np.asarray(p).astype(sdt) for p in planes],
                    width, height, sdt)
    if fmt.bits == 16:
        # byte-order conversion AFTER assembly (np.concatenate silently
        # normalizes non-native dtypes back to native order)
        return np.ascontiguousarray(out.astype(fmt.word_dtype)).view(
            np.uint8)
    return out
