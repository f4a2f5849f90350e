"""Color science: colorimetry matrices and their exact fixed-point forms.

The matrix planner (compute_matrix_to_rgb/yuv, prepare_matrix,
PreparedMatrix, primaries) is a copy of the JAX package's ``video/color.py``
(video-color.c Kr/Kb :420, range offsets :204; video-converter.c MatrixData
composition :899-1108 and prepare_matrix :1323).  ``apply_prepared_planes``
is the device half: the reference's exact integer matrix routines
(video_orc_convert_AYUV_ARGB, video_orc_matrix8, the no-clip table and
video_converter_matrix16) over channel planes, under numpy or torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .. import _xp

from .info import Colorimetry, KR_KB, MATRIX_RGB, RANGE_FULL
from .format import VideoFormatInfo

SCALE = 8                       # video-converter.c:290  #define SCALE (8)
SCALE_F = float(1 << SCALE)


# ---------------------------------------------------------------------------
# 4x4 double matrices (row-major, act on column vectors [c0, c1, c2, 1]).
# ---------------------------------------------------------------------------

def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def offset_components(m: np.ndarray, a1, a2, a3) -> np.ndarray:
    a = identity()
    a[0, 3], a[1, 3], a[2, 3] = a1, a2, a3
    return a @ m


def scale_components(m: np.ndarray, a1, a2, a3) -> np.ndarray:
    a = identity()
    a[0, 0], a[1, 1], a[2, 2] = a1, a2, a3
    return a @ m


def ycbcr_to_rgb(m: np.ndarray, kr: float, kb: float) -> np.ndarray:
    """color_matrix_YCbCr_to_RGB (video-converter.c:1021)."""
    kg = 1.0 - kr - kb
    k = np.array([
        [1.0, 0.0, 2 * (1 - kr), 0.0],
        [1.0, -2 * kb * (1 - kb) / kg, -2 * kr * (1 - kr) / kg, 0.0],
        [1.0, 2 * (1 - kb), 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ])
    return k @ m


def rgb_to_ycbcr(m: np.ndarray, kr: float, kb: float) -> np.ndarray:
    """color_matrix_RGB_to_YCbCr (video-converter.c:1037)."""
    kg = 1.0 - kr - kb
    k = np.zeros((4, 4))
    k[0, :3] = [kr, kg, kb]
    x = 1 / (2 * (1 - kb))
    k[1, :3] = [-x * kr, -x * kg, x * (1 - kb)]
    x = 1 / (2 * (1 - kr))
    k[2, :3] = [x * (1 - kr), -x * kg, -x * kb]
    k[3, 3] = 1.0
    return k @ m


def range_offsets(crange: str, finfo: VideoFormatInfo):
    """gst_video_color_range_offsets (video-color.c:204)."""
    yuv = finfo.is_yuv or finfo.is_gray
    depth = finfo.depth
    offset = [0, 0, 0, 0]
    scale = [0, 0, 0, 0]
    if crange == RANGE_FULL:
        offset[0] = 0
        if yuv:
            offset[1] = 1 << (depth[1] - 1)
            offset[2] = 1 << (depth[2] - 1)
        scale[0] = (1 << depth[0]) - 1
        scale[1] = (1 << depth[1]) - 1
        scale[2] = (1 << depth[2]) - 1
    else:
        offset[0] = 1 << (depth[0] - 4)
        scale[0] = 219 << (depth[0] - 8)
        if yuv:
            offset[1] = 1 << (depth[1] - 1)
            offset[2] = 1 << (depth[2] - 1)
            scale[1] = 224 << (depth[1] - 8)
            scale[2] = 224 << (depth[2] - 8)
        else:
            offset[1] = 1 << (depth[1] - 4)
            offset[2] = 1 << (depth[2] - 4)
            scale[1] = 219 << (depth[1] - 8)
            scale[2] = 219 << (depth[2] - 8)
    offset[3] = 0
    scale[3] = (1 << depth[3]) - 1
    return offset, scale


def compute_matrix_to_rgb(m: np.ndarray, in_colorimetry: Colorimetry,
                          unpack_finfo: VideoFormatInfo,
                          matrix_mode_none: bool = False) -> np.ndarray:
    """compute_matrix_to_RGB (video-converter.c:1372)."""
    offset, scale = range_offsets(in_colorimetry.range, unpack_finfo)
    m = offset_components(m, -offset[0], -offset[1], -offset[2])
    # reference does `1 / ((float) scale[i])` — a float32 division widened
    # to double; reproduce that rounding exactly
    inv = [float(np.float32(1.0) / np.float32(s)) for s in scale[:3]]
    m = scale_components(m, inv[0], inv[1], inv[2])
    if not unpack_finfo.is_rgb and not matrix_mode_none:
        kk = KR_KB.get(in_colorimetry.matrix)
        if kk is not None:
            m = ycbcr_to_rgb(m, *kk)
    return m


def compute_matrix_to_yuv(m: np.ndarray, out_colorimetry: Colorimetry,
                          pack_finfo: VideoFormatInfo,
                          matrix_mode_none: bool = False) -> np.ndarray:
    """compute_matrix_to_YUV (video-converter.c:1406)."""
    if not pack_finfo.is_rgb and not matrix_mode_none:
        kk = KR_KB.get(out_colorimetry.matrix)
        if kk is not None:
            m = rgb_to_ycbcr(m, *kk)
    offset, scale = range_offsets(out_colorimetry.range, pack_finfo)
    m = scale_components(m, np.float32(scale[0]), np.float32(scale[1]),
                         np.float32(scale[2]))
    m = offset_components(m, offset[0], offset[1], offset[2])
    return m


# ---------------------------------------------------------------------------
# Fixed-point preparation and application (8-bit path).
# ---------------------------------------------------------------------------

@dataclass
class PreparedMatrix:
    """Trace-time product of prepare_matrix (video-converter.c:1323)."""
    mode: str                  # "identity" | "ayuv_argb" | "table" | "matrix8"
    im: np.ndarray             # int64 4x4 (rint(dm * 256))

    @property
    def is_identity(self) -> bool:
        return self.mode == "identity"


def _color_matrix_convert(dm: np.ndarray) -> np.ndarray:
    # color_matrix_convert: im = rint(dm) after scaling by SCALE_F
    return np.rint(dm).astype(np.int64)


def _is_identity_im(im: np.ndarray) -> bool:
    c = im[0, 0]
    for i in range(4):
        for j in range(4):
            if i == j:
                if i == 3 and im[i][j] != 1:
                    return False
                if i != 3 and im[i][j] != c:
                    return False
            elif im[i][j] != 0:
                return False
    return True


def _is_ayuv_to_rgb(im) -> bool:
    if im[0][0] != im[1][0] or im[1][0] != im[2][0]:
        return False
    if im[0][1] != 0 or im[2][2] != 0:
        return False
    return True


def _is_no_clip(im) -> bool:
    for r in range(8):
        c = [255 * ((r >> (2 - i)) & 1) for i in range(3)]
        for row in range(3):
            v = (im[row][0] * c[0] + im[row][1] * c[1] + im[row][2] * c[2]
                 + im[row][3]) >> SCALE
            if v < 0 or v > 255:
                return False
    return True


def prepare_matrix(dm: np.ndarray, unpack_rgb: bool, pack_rgb: bool,
                   bits: int = 8) -> PreparedMatrix:
    """prepare_matrix (video-converter.c:1323): scale by 2^8, round, then
    pick the same application routine the reference would (8-bit ORC
    paths, or video_converter_matrix16 when either side is 16-bit)."""
    scaled = scale_components(dm.copy(), SCALE_F, SCALE_F, SCALE_F)
    im = _color_matrix_convert(scaled)
    if _is_identity_im(im):
        return PreparedMatrix("identity", im)
    if bits != 8:
        return PreparedMatrix("matrix16", im)
    if not unpack_rgb and pack_rgb and _is_ayuv_to_rgb(im):
        return PreparedMatrix("ayuv_argb", im)
    if _is_no_clip(im):
        return PreparedMatrix("table", im)
    return PreparedMatrix("matrix8", im)


# (Wx, Wy, Rx, Ry, Gx, Gy, Bx, By) — video-color.c:309 color_primaries[]
_WP_C = (0.31006, 0.31616)
_WP_D65 = (0.31271, 0.32902)
_WP_CENTRE = (1 / 3, 1 / 3)
_WP_WHITE = (0.314, 0.351)

PRIMARIES_INFO = {
    "bt709": (*_WP_D65, 0.64, 0.33, 0.30, 0.60, 0.15, 0.06),
    "bt470m": (*_WP_C, 0.67, 0.33, 0.21, 0.71, 0.14, 0.08),
    "bt470bg": (*_WP_D65, 0.64, 0.33, 0.29, 0.60, 0.15, 0.06),
    "smpte170m": (*_WP_D65, 0.63, 0.34, 0.31, 0.595, 0.155, 0.07),
    "smpte240m": (*_WP_D65, 0.63, 0.34, 0.31, 0.595, 0.155, 0.07),
    "film": (*_WP_C, 0.681, 0.319, 0.243, 0.692, 0.145, 0.049),
    "bt2020": (*_WP_D65, 0.708, 0.292, 0.170, 0.797, 0.131, 0.046),
    "adobergb": (*_WP_D65, 0.64, 0.33, 0.21, 0.71, 0.15, 0.06),
    "smptest428": (*_WP_CENTRE, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0),
    "smpterp431": (*_WP_WHITE, 0.68, 0.32, 0.265, 0.69, 0.15, 0.06),
    "smpteeg432": (*_WP_D65, 0.68, 0.32, 0.265, 0.69, 0.15, 0.06),
    "ebu3213": (*_WP_D65, 0.63, 0.34, 0.295, 0.605, 0.155, 0.077),
}


def primaries_is_equivalent(a: str, b: str) -> bool:
    """gst_video_color_primaries_is_equivalent (video-color.c:366)."""
    if a == b:
        return True
    s = {a, b}
    return s <= {"smpte170m", "smpte240m"}


def matrix_invert(m: np.ndarray) -> np.ndarray:
    """color_matrix_invert (video-converter.c:943): adjugate/det on the
    3x3 part, exact double arithmetic order."""
    tmp = identity()
    for j in range(3):
        for i in range(3):
            tmp[j, i] = (m[(i + 1) % 3, (j + 1) % 3] * m[(i + 2) % 3, (j + 2) % 3]
                         - m[(i + 1) % 3, (j + 2) % 3] * m[(i + 2) % 3, (j + 1) % 3])
    det = tmp[0, 0] * m[0, 0] + tmp[0, 1] * m[1, 0] + tmp[0, 2] * m[2, 0]
    for j in range(3):
        for i in range(3):
            tmp[i, j] /= det
    return tmp


def rgb_to_xyz_matrix(primaries: str) -> np.ndarray:
    """color_matrix_RGB_to_XYZ (video-converter.c:1069)."""
    Wx, Wy, Rx, Ry, Gx, Gy, Bx, By = PRIMARIES_INFO[primaries]
    m = identity()
    m[0, 0], m[1, 0], m[2, 0] = Rx, Ry, 1.0 - Rx - Ry
    m[0, 1], m[1, 1], m[2, 1] = Gx, Gy, 1.0 - Gx - Gy
    m[0, 2], m[1, 2], m[2, 2] = Bx, By, 1.0 - Bx - By
    im = matrix_invert(m)
    wx, wy, wz = Wx / Wy, 1.0, (1.0 - Wx - Wy) / Wy
    sx = im[0, 0] * wx + im[0, 1] * wy + im[0, 2] * wz
    sy = im[1, 0] * wx + im[1, 1] * wy + im[1, 2] * wz
    sz = im[2, 0] * wx + im[2, 1] * wy + im[2, 2] * wz
    m[:3, 0] *= sx
    m[:3, 1] *= sy
    m[:3, 2] *= sz
    return m


def primaries_convert_matrix(in_primaries: str, out_primaries: str) -> np.ndarray:
    """chain_convert primaries block (video-converter.c:1752):
    XYZ_to_RGB_out * RGB_to_XYZ_in."""
    p1 = rgb_to_xyz_matrix(in_primaries)
    p2 = matrix_invert(rgb_to_xyz_matrix(out_primaries))
    return p2 @ p1


# ---------------------------------------------------------------------------
# Application over channel planes (A, c0, c1, c2), each (..., H, W).
# ---------------------------------------------------------------------------

def _splat_word(b):
    """The ORC trick: byte b (two's-complement) replicated into a 16-bit
    word; as a signed value that is  b*256 + (b & 0xff)."""
    return b * 256 + (b & 0xFF)


def _splat_signed(xp, chan):
    """Byte-replicated signed word as int32 (ready for the mulhsw)."""
    b = (_xp.astype(xp, chan, "int32") - 128) & 0xFF
    return _splat_word(xp.where(b >= 128, b - 256, b))


def _s16(p) -> int:
    return int(np.int16(np.uint16(int(p) & 0xFFFF)))


def _alpha_through(xp, a):
    """The ORC A-channel term (255 stays 255); None passes through."""
    if a is None:
        return None
    a_term = ((_xp.astype(xp, a, "int32") - 128) & 0xFF) * 257
    return _xp.clip(xp, a_term, -128, 127) + 128


def apply_matrix8_planes(xp, chans, pm: PreparedMatrix):
    """video_orc_matrix8 (video-orc.orc:2079)."""
    im = pm.im
    w = [_splat_signed(xp, chans[c]) for c in (1, 2, 3)]
    outs = []
    for row in range(3):
        acc = 0
        for col in range(3):
            acc = acc + ((w[col] * _s16(im[row][col])) >> 16)
        outs.append(_xp.clip(xp, acc, -128, 127) + 128)
    return (_alpha_through(xp, chans[0]), outs[0], outs[1], outs[2])


def apply_matrix8_table_planes(xp, chans, pm: PreparedMatrix):
    """video_converter_matrix8_table (video-converter.c:1186): exact
    no-clip math, (sum im[row][c]*in_c + im[row][3]) >> 8."""
    im = pm.im
    cs = [_xp.astype(xp, c, "int32") for c in chans[1:]]
    outs = []
    for row in range(3):
        acc = (int(im[row][0]) * cs[0] + int(im[row][1]) * cs[1]
               + int(im[row][2]) * cs[2] + int(im[row][3]))
        outs.append(acc >> SCALE)
    return (chans[0], outs[0], outs[1], outs[2])


def apply_matrix8_ayuv_argb_planes(xp, chans, pm: PreparedMatrix):
    """video_orc_convert_AYUV_ARGB (video-orc.orc:1634)."""
    im = pm.im
    p1, p2, p3 = _s16(im[0][0]), _s16(im[0][2]), _s16(im[2][1])
    p4, p5 = _s16(im[1][1]), _s16(im[1][2])

    def mulhsw(w, p):
        return (w * p) >> 16

    wy = _splat_signed(xp, chans[1])
    wu = _splat_signed(xp, chans[2])
    wv = _splat_signed(xp, chans[3])
    ty = mulhsw(wy, p1)
    r = _xp.clip(xp, ty + mulhsw(wv, p2), -128, 127) + 128
    b = _xp.clip(xp, ty + mulhsw(wu, p3), -128, 127) + 128
    g = _xp.clip(xp, ty + mulhsw(wu, p4) + mulhsw(wv, p5), -128, 127) + 128
    return (chans[0], r, g, b)


def apply_matrix16_planes(xp, chans, pm: PreparedMatrix):
    """video_converter_matrix16 (video-converter.c:1295): int path with
    CLAMP to [0, 65535]; alpha passes through."""
    im = pm.im
    cs = [_xp.astype(xp, c, "int32") for c in chans[1:]]
    outs = []
    for row in range(3):
        acc = (int(im[row][0]) * cs[0] + int(im[row][1]) * cs[1]
               + int(im[row][2]) * cs[2] + int(im[row][3]))
        outs.append(_xp.clip(xp, acc >> SCALE, 0, 65535))
    return (chans[0], outs[0], outs[1], outs[2])


def apply_prepared_planes(xp, chans, pm: PreparedMatrix):
    if pm.mode == "identity":
        return chans
    if pm.mode == "matrix16":
        return apply_matrix16_planes(xp, chans, pm)
    if pm.mode == "ayuv_argb":
        return apply_matrix8_ayuv_argb_planes(xp, chans, pm)
    if pm.mode == "table":
        return apply_matrix8_table_planes(xp, chans, pm)
    return apply_matrix8_planes(xp, chans, pm)


# ---------------------------------------------------------------------------
# Transfer functions and gamma LUTs (video-color.c).  The tables are host
# float64 math; on the device a LUT is an index into a constant tensor.
# ---------------------------------------------------------------------------

def transfer_decode(func: str, val: float) -> float:
    """gst_video_transfer_function_decode (video-color.c:628): non-linear
    L' -> linear L."""
    v = val
    if func in ("gamma18",):
        return v ** 1.8
    if func in ("gamma20",):
        return v ** 2.0
    if func in ("gamma22",):
        return v ** 2.2
    if func in ("bt601", "bt709", "bt2020-10"):
        return v / 4.5 if v < 0.081 else ((v + 0.099) / 1.099) ** (1.0 / 0.45)
    if func == "smpte240m":
        return v / 4.0 if v < 0.0913 else ((v + 0.1115) / 1.1115) ** (1.0 / 0.45)
    if func == "srgb":
        return v / 12.92 if v <= 0.04045 else ((v + 0.055) / 1.055) ** 2.4
    if func == "gamma28":
        return v ** 2.8
    if func == "log100":
        return 0.0 if v == 0.0 else 10.0 ** (2.0 * (v - 1.0))
    if func == "log316":
        return 0.0 if v == 0.0 else 10.0 ** (2.5 * (v - 1.0))
    if func == "bt2020-12":
        return v / 4.5 if v < 0.08145 else ((v + 0.0993) / 1.0993) ** (1.0 / 0.45)
    if func == "adobergb":
        return v ** 2.19921875
    if func == "smpte2084":
        c1, c2, c3 = 0.8359375, 18.8515625, 18.6875
        m1, m2 = 0.1593017578125, 78.84375
        tmp = v ** (1 / m2)
        tmp2 = max(tmp - c1, 0.0)
        return (tmp2 / (c2 - c3 * tmp)) ** (1 / m1)
    if func == "arib-std-b67":
        a, b, c = 0.17883277, 0.28466892, 0.55991073
        if v > 0.5:
            return (math.exp((v - c) / a) + b) / 12.0
        return v * v / 3.0
    return v   # unknown / gamma10


def transfer_encode(func: str, val: float) -> float:
    """gst_video_transfer_function_encode (video-color.c:495)."""
    v = val
    if func == "gamma18":
        return v ** (1.0 / 1.8)
    if func == "gamma20":
        return v ** (1.0 / 2.0)
    if func == "gamma22":
        return v ** (1.0 / 2.2)
    if func in ("bt601", "bt709", "bt2020-10"):
        return 4.5 * v if v < 0.018 else 1.099 * v ** 0.45 - 0.099
    if func == "smpte240m":
        return v * 4.0 if v < 0.0228 else 1.1115 * v ** 0.45 - 0.1115
    if func == "srgb":
        return 12.92 * v if v <= 0.0031308 else 1.055 * v ** (1.0 / 2.4) - 0.055
    if func == "gamma28":
        return v ** (1 / 2.8)
    if func == "log100":
        return 0.0 if v < 0.01 else 1.0 + math.log10(v) / 2.0
    if func == "log316":
        return 0.0 if v < 0.0031622777 else 1.0 + math.log10(v) / 2.5
    if func == "bt2020-12":
        return 4.5 * v if v < 0.0181 else 1.0993 * v ** 0.45 - 0.0993
    if func == "adobergb":
        return v ** (1.0 / 2.19921875)
    if func == "smpte2084":
        c1, c2, c3 = 0.8359375, 18.8515625, 18.6875
        m1, m2 = 0.1593017578125, 78.84375
        Ln = v ** m1
        return ((c1 + c2 * Ln) / (1.0 + c3 * Ln)) ** m2
    if func == "arib-std-b67":
        a, b, c = 0.17883277, 0.28466892, 0.55991073
        if v > (1.0 / 12.0):
            return a * math.log(12.0 * v - b) + c
        return math.sqrt(3.0 * v)
    return v


def gamma_decode_table(transfer: str, bits: int) -> np.ndarray:
    """setup_gamma_decode (video-converter.c:1496): u16 LUT, rint
    rounding."""
    n = 256 if bits == 8 else 65536
    mx = n - 1
    t = np.array([transfer_decode(transfer, i / mx) * 65535.0
                  for i in range(n)])
    return np.rint(t).astype(np.uint16)


def gamma_encode_table(transfer: str, target_bits: int) -> np.ndarray:
    """setup_gamma_encode (video-converter.c:1533): 65536-entry LUT."""
    mx = 255.0 if target_bits == 8 else 65535.0
    t = np.array([transfer_encode(transfer, i / 65535.0) * mx
                  for i in range(65536)])
    t = np.rint(t)
    return t.astype(np.uint8 if target_bits == 8 else np.uint16)


def _lut_planes(xp, chans, table: np.ndarray, alpha):
    like = next(c for c in chans[1:] if c is not None)
    tab = _xp.const(xp, table, "int32", like)
    return (alpha,) + tuple(tab[_xp.astype(xp, c, "int64")]
                            for c in chans[1:])


def apply_gamma_decode_planes(xp, chans, table: np.ndarray, in_bits: int):
    """gamma_convert_u8_u16 / u16_u16 (video-converter.c:1445,1480):
    alpha widened by byte-replication, colors through the LUT."""
    a = chans[0]
    if a is not None and in_bits == 8:
        a = _xp.astype(xp, a, "int32")
        a = (a << 8) | a
    return _lut_planes(xp, chans, table, a)


def apply_gamma_encode_planes(xp, chans, table: np.ndarray, target_bits: int):
    """gamma_convert_u16_u8 / u16_u16: alpha narrowed by >>8."""
    a = chans[0]
    if a is not None and target_bits == 8:
        a = _xp.astype(xp, a, "int32") >> 8
    return _lut_planes(xp, chans, table, a)
