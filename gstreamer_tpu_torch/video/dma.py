"""DMA/DRM format interop — video-info-dma.c equivalent.

Maps our video formats to/from Linux DRM fourccs + modifiers
(gst_video_dma_drm_fourcc_from_format / _to_format,
video-info-dma.c:536 format_map; drm_fourcc.h constants), and parses
the "FOURCC[:0xMODIFIER]" string form used in caps drm-format fields
(gst_video_dma_drm_fourcc_from_string video-info-dma.c:436).

On TPU there is no dmabuf to import, but the mapping is the interop
vocabulary for describing frames arriving from capture/codec hardware
before they are staged to HBM.

A copy of the JAX package's ``video/dma.py`` (host tables only).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def fourcc(code: str) -> int:
    """drm_fourcc.h fourcc_code."""
    a, b, c, d = (ord(x) for x in code.ljust(4))
    return a | (b << 8) | (c << 16) | (d << 24)


def fourcc_mod_code(vendor: int, val: int) -> int:
    return (vendor << 56) | (val & 0x00FFFFFFFFFFFFFF)


DRM_FORMAT_BIG_ENDIAN = 1 << 31
DRM_FORMAT_INVALID = 0
DRM_FORMAT_MOD_INVALID = fourcc_mod_code(0, 0x00FFFFFFFFFFFFFF)
DRM_FORMAT_MOD_LINEAR = 0
_VENDOR_SAMSUNG = 0x04
_VENDOR_VIVANTE = 0x06
_VENDOR_MTK = 0x0B
MOD_SAMSUNG_64_32_TILE = fourcc_mod_code(_VENDOR_SAMSUNG, 1)
MOD_VIVANTE_TILED = fourcc_mod_code(_VENDOR_VIVANTE, 1)
_MTK_TILE_16L32S = 0x1
_MTK_10BIT_LSBTILED = 0x1 << 16
_MTK_10BIT_LSBRASTER = 0x2 << 16
MOD_MTK_16L_32S_TILE = fourcc_mod_code(_VENDOR_MTK, _MTK_TILE_16L32S)
MOD_MTK_T = fourcc_mod_code(_VENDOR_MTK,
                            _MTK_TILE_16L32S | _MTK_10BIT_LSBTILED)
MOD_MTK_R = fourcc_mod_code(_VENDOR_MTK,
                            _MTK_TILE_16L32S | _MTK_10BIT_LSBRASTER)

# video-info-dma.c:536 format_map, (gst format -> (fourcc, modifier))
_FORMAT_MAP: Dict[str, Tuple[int, int]] = {
    "YUY2": (fourcc("YUYV"), DRM_FORMAT_MOD_LINEAR),
    "YVYU": (fourcc("YVYU"), DRM_FORMAT_MOD_LINEAR),
    "UYVY": (fourcc("UYVY"), DRM_FORMAT_MOD_LINEAR),
    "VYUY": (fourcc("VYUY"), DRM_FORMAT_MOD_LINEAR),
    "VUYA": (fourcc("AYUV"), DRM_FORMAT_MOD_LINEAR),
    "NV12": (fourcc("NV12"), DRM_FORMAT_MOD_LINEAR),
    "NV12_4L4": (fourcc("NV12"), MOD_VIVANTE_TILED),
    "NV12_64Z32": (fourcc("NV12"), MOD_SAMSUNG_64_32_TILE),
    "NV12_16L32S": (fourcc("NV12"), MOD_MTK_16L_32S_TILE),
    "MT2110T": (fourcc("NV15"), MOD_MTK_T),
    "MT2110R": (fourcc("NV15"), MOD_MTK_R),
    "NV21": (fourcc("NV21"), DRM_FORMAT_MOD_LINEAR),
    "NV16": (fourcc("NV16"), DRM_FORMAT_MOD_LINEAR),
    "NV61": (fourcc("NV61"), DRM_FORMAT_MOD_LINEAR),
    "NV24": (fourcc("NV24"), DRM_FORMAT_MOD_LINEAR),
    "YUV9": (fourcc("YUV9"), DRM_FORMAT_MOD_LINEAR),
    "YVU9": (fourcc("YVU9"), DRM_FORMAT_MOD_LINEAR),
    "Y41B": (fourcc("YU11"), DRM_FORMAT_MOD_LINEAR),
    "I420": (fourcc("YU12"), DRM_FORMAT_MOD_LINEAR),
    "I420_10LE": (fourcc("S010"), DRM_FORMAT_MOD_LINEAR),
    "I422_10LE": (fourcc("S210"), DRM_FORMAT_MOD_LINEAR),
    "Y444_10LE": (fourcc("S410"), DRM_FORMAT_MOD_LINEAR),
    "I420_12LE": (fourcc("S012"), DRM_FORMAT_MOD_LINEAR),
    "I422_12LE": (fourcc("S212"), DRM_FORMAT_MOD_LINEAR),
    "Y444_12LE": (fourcc("S412"), DRM_FORMAT_MOD_LINEAR),
    "Y444_16LE": (fourcc("S416"), DRM_FORMAT_MOD_LINEAR),
    "YV12": (fourcc("YV12"), DRM_FORMAT_MOD_LINEAR),
    "Y42B": (fourcc("YU16"), DRM_FORMAT_MOD_LINEAR),
    "Y444": (fourcc("YU24"), DRM_FORMAT_MOD_LINEAR),
    "RGB15": (fourcc("XR15"), DRM_FORMAT_MOD_LINEAR),
    "RGB16": (fourcc("RG16"), DRM_FORMAT_MOD_LINEAR),
    "BGR16": (fourcc("BG16"), DRM_FORMAT_MOD_LINEAR),
    "RGB": (fourcc("BG24"), DRM_FORMAT_MOD_LINEAR),
    "BGR": (fourcc("RG24"), DRM_FORMAT_MOD_LINEAR),
    "RGBA": (fourcc("AB24"), DRM_FORMAT_MOD_LINEAR),
    "RGBx": (fourcc("XB24"), DRM_FORMAT_MOD_LINEAR),
    "BGRA": (fourcc("AR24"), DRM_FORMAT_MOD_LINEAR),
    "BGRx": (fourcc("XR24"), DRM_FORMAT_MOD_LINEAR),
    "ARGB": (fourcc("BA24"), DRM_FORMAT_MOD_LINEAR),
    "xRGB": (fourcc("BX24"), DRM_FORMAT_MOD_LINEAR),
    "ABGR": (fourcc("RA24"), DRM_FORMAT_MOD_LINEAR),
    "xBGR": (fourcc("RX24"), DRM_FORMAT_MOD_LINEAR),
    "Y410": (fourcc("Y410"), DRM_FORMAT_MOD_LINEAR),
    "Y412_LE": (fourcc("Y412"), DRM_FORMAT_MOD_LINEAR),
    "Y210": (fourcc("Y210"), DRM_FORMAT_MOD_LINEAR),
    "Y212_LE": (fourcc("Y212"), DRM_FORMAT_MOD_LINEAR),
    "NV12_10LE40": (fourcc("NV15"), DRM_FORMAT_MOD_LINEAR),
    "NV12_10LE40_4L4": (fourcc("NV15"), MOD_VIVANTE_TILED),
    "P010_10LE": (fourcc("P010"), DRM_FORMAT_MOD_LINEAR),
    "P012_LE": (fourcc("P012"), DRM_FORMAT_MOD_LINEAR),
    "BGR10A2_LE": (fourcc("AR30"), DRM_FORMAT_MOD_LINEAR),
    "RGB10A2_LE": (fourcc("AB30"), DRM_FORMAT_MOD_LINEAR),
    "BGR10x2_LE": (fourcc("XR30"), DRM_FORMAT_MOD_LINEAR),
    "RGB10x2_LE": (fourcc("XB30"), DRM_FORMAT_MOD_LINEAR),
    "GRAY8": (fourcc("R8"), DRM_FORMAT_MOD_LINEAR),
    "GRAY16_LE": (fourcc("R16"), DRM_FORMAT_MOD_LINEAR),
    "GRAY16_BE": (fourcc("R16") | DRM_FORMAT_BIG_ENDIAN,
                  DRM_FORMAT_MOD_LINEAR),
    "NV16_10LE40": (fourcc("NV20"), DRM_FORMAT_MOD_LINEAR),
    "P016_LE": (fourcc("P016"), DRM_FORMAT_MOD_LINEAR),
}

_REVERSE: Dict[Tuple[int, int], str] = {}
for _fmt, _key in _FORMAT_MAP.items():
    _REVERSE.setdefault(_key, _fmt)


def dma_drm_fourcc_from_format(fmt: str) -> Tuple[int, int]:
    """format -> (fourcc, modifier); (DRM_FORMAT_INVALID, INVALID) when
    unmapped (gst_video_dma_drm_format_from_gst_format)."""
    return _FORMAT_MAP.get(fmt, (DRM_FORMAT_INVALID,
                                 DRM_FORMAT_MOD_INVALID))


def dma_drm_fourcc_to_format(code: int,
                             modifier: int = DRM_FORMAT_MOD_LINEAR
                             ) -> Optional[str]:
    """(fourcc, modifier) -> format name or None."""
    return _REVERSE.get((code, modifier))


def fourcc_to_string(code: int) -> str:
    be = bool(code & DRM_FORMAT_BIG_ENDIAN)
    code &= ~DRM_FORMAT_BIG_ENDIAN
    s = "".join(chr((code >> (8 * k)) & 0xFF) for k in range(4)).rstrip()
    return s + (":BE" if be else "")


def dma_drm_fourcc_from_string(text: str) -> Tuple[int, int]:
    """'FOURCC[:0xMODIFIER]' -> (fourcc, modifier); LINEAR when the
    modifier is omitted (gst_video_dma_drm_fourcc_from_string)."""
    name, _, mod = text.partition(":")
    be = False
    if name.endswith(":BE") or mod == "BE":
        be = True
        mod = "" if mod == "BE" else mod
    code = fourcc(name[:4])
    if be:
        code |= DRM_FORMAT_BIG_ENDIAN
    if mod and mod.startswith("0x"):
        modifier = int(mod, 16)
        if modifier == DRM_FORMAT_MOD_LINEAR:
            return DRM_FORMAT_INVALID, DRM_FORMAT_MOD_INVALID
    else:
        modifier = DRM_FORMAT_MOD_LINEAR
    return code, modifier


def dma_drm_fourcc_to_string(code: int, modifier: int) -> str:
    s = fourcc_to_string(code)
    if modifier != DRM_FORMAT_MOD_LINEAR:
        s += f":0x{modifier:016x}"
    return s
