"""OpenCV-analog camera-geometry and cascade-detection elements, in torch.

A port of the JAX package's ``elements/opencv_camera.py`` (reference:
gst-plugins-bad/ext/opencv/):

  dewarp            gstdewarp.cpp: 360 deg fisheye ring -> panorama remap
                    (nearest / bilinear; cubic and lanczos4 run bilinear, as
                    the JAX package), display modes panorama /
                    double-panorama / quad-view; output size as
                    gst_dewarp_calculate_dimensions.  The maps are built on
                    the host once a caps; the gather runs on the device.
  cameraundistort   gstcameraundistort.cpp: Brown-Conrady correction from
                    the OpenCV-FileStorage XML settings (camerautils.cpp
                    wire format), maps on the host, the bilinear gather on
                    the device; takes the "calibrated" upstream event.
  cameracalibrate   gstcameracalibrate.cpp: the reduced chessboard
                    detection and Zhang's solve on the host; emits the
                    settings in the "calibrated" event.
  facedetect, faceblur, handdetect
                    gstfacedetect.cpp / gstfaceblur.cpp / gsthanddetect.cpp:
                    Haar cascades (``ops/haar.py``) on the host.

The bilinear gather sums its four products in XLA's order on the CPU,
where the JAX package runs jitted: the first product rounded, each later
one fused into the sum (``_bilinear``).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np
import torch

from .._xp import fma32
from ..core.buffer import Buffer, device_array
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..core.events import Event, EventType
from ..ops import cv_kernels as cvk
from ..ops.haar import HaarCascade
from ..utils.log import get_logger
from ..video.info import VideoInfo
from .opencv_analysis import _draw_rect, _post, host_planes

_log = get_logger("opencvcamera")

RGB_CAPS = ("video/x-raw, format=RGB, width=[1,32767], "
            "height=[1,32767], framerate=[0/1,2147483647/1]")
RGBA_CAPS = ("video/x-raw, format=RGBA, width=[1,32767], "
             "height=[1,32767], framerate=[0/1,2147483647/1]")


# ---------------------------------------------------------------------------
# FileStorage XML settings (camerautils.cpp wire format)
# ---------------------------------------------------------------------------

def serialize_undistort_settings(camera_matrix: np.ndarray,
                                 dist_coeffs: np.ndarray) -> str:
    """camera_serialize_undistort_settings: OpenCV FileStorage XML."""
    def mat(name, m):
        m = np.asarray(m, np.float64)
        data = " ".join(repr(float(v)) for v in m.ravel())
        return (f"<{name} type_id=\"opencv-matrix\">"
                f"<rows>{m.shape[0]}</rows><cols>{m.shape[1]}</cols>"
                f"<dt>d</dt><data>{data}</data></{name}>")

    return ("<?xml version=\"1.0\"?><opencv_storage>"
            + mat("cameraMatrix", camera_matrix)
            + mat("distCoeffs", dist_coeffs.reshape(1, -1))
            + "</opencv_storage>")


def deserialize_undistort_settings(text: str):
    """Parse the FileStorage XML -> (cameraMatrix 3x3, distCoeffs)."""
    try:
        root = ET.fromstring(text)
    except ET.ParseError:
        return None

    def mat(name):
        node = root.find(name)
        if node is None:
            return None
        rows = int(node.findtext("rows"))
        cols = int(node.findtext("cols"))
        data = [float(v) for v in node.findtext("data").split()]
        return np.asarray(data, np.float64).reshape(rows, cols)

    k = mat("cameraMatrix")
    d = mat("distCoeffs")
    if k is None or d is None:
        return None
    return k, d.ravel()


def new_calibrated_event(settings: str) -> Event:
    """gst_camera_event_new_calibrated (cameraevent.cpp): upstream
    custom event carrying the serialized settings."""
    return Event(EventType.CUSTOM_UPSTREAM,
                 {"structure-name": "GstCameraEventCalibrated",
                  "undistort-settings": settings})


def parse_calibrated_event(event) -> Optional[str]:
    d = getattr(event, "data", None) or {}
    if d.get("structure-name") == "GstCameraEventCalibrated":
        return d.get("undistort-settings")
    return None


# ---------------------------------------------------------------------------
# device remap
# ---------------------------------------------------------------------------

def _bilinear(f00, f01, f10, f11, fx, fy):
    """f00*(1-fy)*(1-fx) + f01*(1-fy)*fx + f10*fy*(1-fx) + f11*fy*fx with
    XLA's contractions on the CPU: the first product fused into the sum of
    the first two, then each later product fused into the sum.

    Which products XLA forms depends on the number of frames.  Over a
    batch the maps' weights are broadcast over the frames, and each term
    is (f * wy) * wx.  With one frame the broadcast is a reshape, and
    XLA's simplifier multiplies the two weights first: f * (wy * wx)."""
    gy, gx = 1 - fy, 1 - fx
    if f00.numel() == fx.numel():                  # one frame
        v = fma32(f00, gy * gx, f01 * (gy * fx))
        v = fma32(f10, fy * gx, v)
        return fma32(f11, fy * fx, v)
    v = fma32(f00 * gy, gx, (f01 * gy) * fx)
    v = fma32(f10 * fy, gx, v)
    return fma32(f11 * fy, fx, v)


def _remap_fn(map_x: np.ndarray, map_y: np.ndarray, in_h: int,
              in_w: int, nearest: bool, device):
    """A device fn: gather-remap planes through (map_x, map_y) float sample
    coordinates (out-of-range samples -> 0, the BORDER_CONSTANT cv::remap
    default).  The maps and their indices go to `device` once."""
    gx = torch.from_numpy(map_x.astype(np.float32)).to(device)
    gy = torch.from_numpy(map_y.astype(np.float32)).to(device)
    valid = (gx >= 0) & (gx <= in_w - 1) & (gy >= 0) & (gy <= in_h - 1)
    if nearest:
        xi = torch.clamp(torch.round(gx).to(torch.int64), 0, in_w - 1)
        yi = torch.clamp(torch.round(gy).to(torch.int64), 0, in_h - 1)

        def fn(planes):
            return [torch.where(valid, p[..., yi, xi], torch.zeros(
                (), dtype=p.dtype, device=p.device)) for p in planes]

        return fn
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, in_w - 1)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, in_h - 1)
    x1 = torch.clamp(x0 + 1, max=in_w - 1)
    y1 = torch.clamp(y0 + 1, max=in_h - 1)
    fx = torch.clamp(gx - x0.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(gy - y0.to(torch.float32), 0.0, 1.0)

    def fn(planes):
        out = []
        for p in planes:
            f = p.to(torch.float32)
            v = _bilinear(f[..., y0, x0], f[..., y0, x1], f[..., y1, x0],
                          f[..., y1, x1], fx, fy)
            v = torch.where(valid, v, torch.zeros((), device=v.device))
            out.append(torch.clamp(torch.floor(v + 0.5), 0, 255).to(p.dtype))
        return out

    return fn


def _round_up_8(v: int) -> int:
    return (v + 7) & ~7


# ---------------------------------------------------------------------------
# dewarp
# ---------------------------------------------------------------------------

@register_element
class Dewarp(TransformElement):
    """dewarp (gstdewarp.cpp): fisheye ring to panorama."""
    FACTORY = "dewarp"
    DESCRIPTION = "Dewarp fisheye images"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, RGBA_CAPS),
        PadTemplate("src", PadDirection.SRC, RGBA_CAPS),
    ]
    PROPERTIES = {
        "x-center": (float, 0.5, "x center of the fisheye circle"),
        "y-center": (float, 0.5, "y center of the fisheye circle"),
        "inner-radius": (float, 0.0, "inner radius (fraction of "
                                     "width)"),
        "outer-radius": (float, 0.0, "outer radius (fraction of "
                                     "width)"),
        "x-remap-correction": (float, 1.0, "x remap correction"),
        "y-remap-correction": (float, 1.0, "y remap correction"),
        "interpolation-method": (str, "bilinear",
                                 "nearest|bilinear|cubic|lanczos4 "
                                 "(cubic/lanczos4 run bilinear)"),
        "display-mode": (str, "single-panorama",
                         "single-panorama|double-panorama|quad-view"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._in_info = None
        self._out_wh = None

    def _passthrough(self) -> bool:
        return (float(self.props["outer-radius"])
                <= float(self.props["inner-radius"]))

    def _dims(self, in_w, in_h):
        """gst_dewarp_calculate_dimensions, sink direction."""
        if self._passthrough():
            return in_w, in_h
        r1 = in_w * float(self.props["inner-radius"])
        r2 = in_w * float(self.props["outer-radius"])
        out_w = _round_up_8(int((2.0 * math.pi) * ((r2 + r1) / 2.0)))
        out_h = _round_up_8(int(r2 - r1))
        if self.props["display-mode"] != "single-panorama":
            out_w //= 2
            out_h *= 2
        if out_w == 0 or out_h == 0:
            return in_w, in_h
        return out_w, out_h

    def transform_caps(self, direction, caps, filter=None):
        from ..core.caps import Caps

        out = []
        for s in caps:
            s2 = s.copy()
            if direction == PadDirection.SINK:
                try:
                    w = int(s["width"])
                    h = int(s["height"])
                    ow, oh = self._dims(w, h)
                    s2["width"], s2["height"] = ow, oh
                except (KeyError, TypeError, ValueError):
                    pass
            else:
                # upstream: any input size may produce this output
                from ..core.value import IntRange
                s2["width"] = IntRange(1, 32767)
                s2["height"] = IntRange(1, 32767)
            out.append(s2)
        res = Caps(out)
        if filter is not None:
            res = res.intersect(filter)
        return res

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._in_info = VideoInfo.from_caps_structure(incaps[0])
            self._out_wh = self._dims(self._in_info.width,
                                      self._in_info.height)

    def make_fn(self):
        if self._in_info is None or self._passthrough():
            return None
        in_w, in_h = self._in_info.width, self._in_info.height
        mode = self.props["display-mode"]
        out_w, out_h = self._out_wh
        # the map is built panorama-shaped, then split per display mode
        if mode == "single-panorama":
            pw, ph = out_w, out_h
        else:
            pw, ph = out_w * 2, out_h // 2
        r1 = in_w * float(self.props["inner-radius"])
        r2 = in_w * float(self.props["outer-radius"])
        cx = float(self.props["x-center"]) * in_w
        cy = float(self.props["y-center"]) * in_h
        rcx = float(self.props["x-remap-correction"])
        rcy = float(self.props["y-remap-correction"])
        ys, xs = np.mgrid[0:ph, 0:pw].astype(np.float64)
        r = (ys / ph) * (r2 - r1) + r1
        theta = (xs / pw) * 2.0 * math.pi
        map_x = cx + r * np.sin(theta) * rcx
        map_y = cy + r * np.cos(theta) * rcy
        nearest = self.props["interpolation-method"] == "nearest"
        remap = _remap_fn(map_x, map_y, in_h, in_w, nearest, self.device)

        def fn(planes):
            pano = remap(planes)
            if mode == "single-panorama":
                return pano
            half = pw // 2
            if mode == "double-panorama":
                # two half-width views stacked vertically
                return [torch.cat([p[..., :, :half], p[..., :, half:]],
                                  dim=-2) for p in pano]
            # quad-view: four quarter-width views in a 2x2 grid
            q = pw // 4
            out = []
            for p in pano:
                v = [p[..., :, i * q:(i + 1) * q] for i in range(4)]
                top = torch.cat([v[0], v[1]], dim=-2)
                bot = torch.cat([v[2], v[3]], dim=-2)
                out.append(torch.cat([top, bot], dim=-1))
            return out

        return fn


# ---------------------------------------------------------------------------
# cameraundistort
# ---------------------------------------------------------------------------

def _distort_points(k, d, xu, yu):
    """Apply Brown-Conrady distortion to normalized points."""
    k1, k2, p1, p2, k3 = (list(d) + [0.0] * 5)[:5]
    r2 = xu * xu + yu * yu
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xd = (xu * radial + 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu))
    yd = (yu * radial + p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu)
    return xd, yd


def _undistort_points(k, d, px, py, iters=8):
    """Iterative inverse distortion (undistortPoints)."""
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    x = (px - cx) / fx
    y = (py - cy) / fy
    x0, y0 = x.copy(), y.copy()
    k1, k2, p1, p2, k3 = (list(d) + [0.0] * 5)[:5]
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return x, y


def _optimal_new_camera_matrix(k, d, w, h, alpha):
    """getOptimalNewCameraMatrix: blend of the all-pixels (outer) and
    valid-pixels (inner) rectified views by alpha."""
    # sample the image border, undistort, get inner/outer rects
    n = 9
    xs = np.linspace(0, w - 1, n)
    ys = np.linspace(0, h - 1, n)
    border = np.concatenate([
        np.stack([xs, np.zeros(n)], -1),
        np.stack([xs, np.full(n, h - 1.0)], -1),
        np.stack([np.zeros(n), ys], -1),
        np.stack([np.full(n, w - 1.0), ys], -1)])
    ux, uy = _undistort_points(k, d, border[:, 0], border[:, 1])
    # outer rect: bounding box of all undistorted border points
    ox0, ox1 = ux.min(), ux.max()
    oy0, oy1 = uy.min(), uy.max()
    # inner rect: the largest axis-aligned rect inside -> use the
    # extreme inner values per side
    top = uy[(border[:, 1] == 0)]
    bot = uy[(border[:, 1] == h - 1)]
    left = ux[(border[:, 0] == 0)]
    right = ux[(border[:, 0] == w - 1)]
    ix0, ix1 = left.max(), right.min()
    iy0, iy1 = top.max(), bot.min()

    def k_for(x0, x1, y0, y1):
        fx = (w - 1) / (x1 - x0)
        fy = (h - 1) / (y1 - y0)
        return np.array([[fx, 0, -x0 * fx],
                         [0, fy, -y0 * fy],
                         [0, 0, 1.0]])

    k_in = k_for(ix0, ix1, iy0, iy1)
    k_out = k_for(ox0, ox1, oy0, oy1)
    new_k = k_in * (1 - alpha) + k_out * alpha
    # valid pixel ROI in the new view: project the inner rect
    x0 = new_k[0, 0] * ix0 + new_k[0, 2]
    y0 = new_k[1, 1] * iy0 + new_k[1, 2]
    x1 = new_k[0, 0] * ix1 + new_k[0, 2]
    y1 = new_k[1, 1] * iy1 + new_k[1, 2]
    roi = (int(max(np.ceil(x0), 0)), int(max(np.ceil(y0), 0)),
           int(min(np.floor(x1 - x0), w)),
           int(min(np.floor(y1 - y0), h)))
    return new_k, roi


def _undistort_maps(k, d, w, h, new_k):
    """initUndistortRectifyMap (R = I): for each rectified pixel, the
    distorted source sample position."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xu = (xs - new_k[0, 2]) / new_k[0, 0]
    yu = (ys - new_k[1, 2]) / new_k[1, 1]
    xd, yd = _distort_points(k, d, xu, yu)
    map_x = xd * k[0, 0] + k[0, 2]
    map_y = yd * k[1, 1] + k[1, 2]
    return map_x, map_y


@register_element
class CameraUndistort(TransformElement):
    """cameraundistort (gstcameraundistort.cpp)."""
    FACTORY = "cameraundistort"
    DESCRIPTION = "Performs camera undistort"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, RGB_CAPS),
        PadTemplate("src", PadDirection.SRC, RGB_CAPS),
    ]
    PROPERTIES = {
        "undistort": (bool, True, "apply camera corrections"),
        "alpha": (float, 0.0, "show all pixels (1) or only valid "
                              "ones (0)"),
        "crop": (bool, False, "draw the valid-pixel ROI"),
        "settings": (str, "", "undistort settings (FileStorage XML "
                              "from cameracalibrate)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._info = None
        self._kd = None
        if self.props["settings"]:
            self._kd = deserialize_undistort_settings(
                self.props["settings"])

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._info = VideoInfo.from_caps_structure(incaps[0])

    def src_event(self, pad, event) -> bool:
        settings = parse_calibrated_event(event)
        if settings is not None:
            kd = deserialize_undistort_settings(settings)
            if kd is not None:
                self._kd = kd
                self.props["settings"] = settings
                self._needs_reconfigure = True
            return True
        return super().src_event(pad, event)

    def make_fn(self):
        if (self._kd is None or self._info is None
                or not bool(self.props["undistort"])):
            return None
        k, d = self._kd
        w, h = self._info.width, self._info.height
        new_k, roi = _optimal_new_camera_matrix(
            k, d, w, h, float(self.props["alpha"]))
        self._valid_roi = roi
        map_x, map_y = _undistort_maps(k, d, w, h, new_k)
        remap = _remap_fn(map_x, map_y, h, w, False, self.device)
        crop = bool(self.props["crop"])

        def fn(planes):
            out = remap(planes)
            if crop:
                x0, y0, rw, rh = roi
                green = (0, 255, 0)
                for c in range(min(3, len(out))):
                    p = out[c].clone()
                    p[..., y0, x0:x0 + rw] = green[c]
                    p[..., min(y0 + rh, h - 1), x0:x0 + rw] = green[c]
                    p[..., y0:y0 + rh, x0] = green[c]
                    p[..., y0:y0 + rh, min(x0 + rw, w - 1)] = green[c]
                    out[c] = p
            return out

        return fn


# ---------------------------------------------------------------------------
# cameracalibrate
# ---------------------------------------------------------------------------

def find_chessboard_corners(gray: np.ndarray, bw: int, bh: int):
    """Reduced findChessboardCorners: checker-junction template
    matching (both polarities) + PCA grid ordering.  Returns (bw*bh,
    2) float corner positions ordered row-major, or None.  Needs a
    near-fronto-parallel, well-contrasted board."""
    t = np.zeros((8, 8), np.float32)
    t[:4, :4] = 255
    t[4:, 4:] = 255
    s1 = cvk.match_template(np, gray, t, 5)
    s = np.maximum(s1, -s1)
    want = bw * bh
    # non-maximum suppression over 5x5, take the strongest `want`
    h, w = s.shape
    pad = np.pad(s, 2, constant_values=-1)
    is_max = np.ones_like(s, bool)
    for di in range(5):
        for dj in range(5):
            if di == 2 and dj == 2:
                continue
            is_max &= s >= pad[di:di + h, dj:dj + w]
    cand = np.argwhere(is_max & (s > 0.5))
    if len(cand) < want:
        return None
    vals = s[cand[:, 0], cand[:, 1]]
    top = cand[np.argsort(-vals)[:want]]
    pts = top[:, ::-1].astype(np.float64) + 3.5   # center of template
    # order into a grid: PCA for the two board axes
    c = pts.mean(0)
    u, sv, vt = np.linalg.svd(pts - c)
    ax0, ax1 = vt[0], vt[1]
    a = (pts - c) @ ax0
    b = (pts - c) @ ax1
    # rows along the axis with bh distinct levels
    order = np.lexsort((a, np.round(b / (np.ptp(b) / max(bh - 1, 1))
                                    ).astype(int)))
    grid = pts[order].reshape(bh, bw, 2)
    # normalize direction: row-major, left-to-right, top-to-bottom
    if grid[0, 0, 1] > grid[-1, 0, 1]:
        grid = grid[::-1]
    if grid[0, 0, 0] > grid[0, -1, 0]:
        grid = grid[:, ::-1]
    return grid.reshape(-1, 2)


def _homography(obj2d: np.ndarray, img2d: np.ndarray) -> np.ndarray:
    """Normalized DLT homography."""
    def norm(pts):
        c = pts.mean(0)
        s = math.sqrt(2) / max(np.linalg.norm(pts - c, axis=1).mean(),
                               1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        ptsn = (pts - c) * s
        return ptsn, T

    on, To = norm(obj2d)
    im, Ti = norm(img2d)
    n = len(obj2d)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        X, Y = on[i]
        u, v = im[i]
        A[2 * i] = [-X, -Y, -1, 0, 0, 0, u * X, u * Y, u]
        A[2 * i + 1] = [0, 0, 0, -X, -Y, -1, v * X, v * Y, v]
    _, _, vt = np.linalg.svd(A)
    Hn = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Ti) @ Hn @ To
    return H / H[2, 2]


def calibrate_camera(obj_pts: List[np.ndarray],
                     img_pts: List[np.ndarray], w: int, h: int,
                     iters: int = 5):
    """Zhang 2000 planar calibration with distortion alternation:
    homographies -> B matrix -> intrinsics -> linear k1/k2, then
    re-fit the homographies on distortion-corrected points and
    repeat.  Returns (K, dist(5,), rms)."""
    K = dist = rms = None
    cur_pts = [np.asarray(i, np.float64) for i in img_pts]
    for _ in range(max(iters, 1)):
        K, dist, rms = _calibrate_once(obj_pts, cur_pts, img_pts, w, h)
        if abs(dist[0]) < 1e-9:
            break
        cur_pts = []
        for i in img_pts:
            ux, uy = _undistort_points(K, dist, i[:, 0], i[:, 1])
            cur_pts.append(np.stack([ux * K[0, 0] + K[0, 2],
                                     uy * K[1, 1] + K[1, 2]], -1))
    return K, dist, rms


def _calibrate_once(obj_pts, hom_pts, img_pts, w, h):
    """One Zhang pass: homographies from `hom_pts` (possibly
    distortion-corrected), distortion residuals vs raw `img_pts`."""
    Hs = [_homography(o[:, :2], i) for o, i in zip(obj_pts, hom_pts)]

    def v_ij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j]])

    V = []
    for H in Hs:
        V.append(v_ij(H, 0, 1))
        V.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    if len(Hs) < 3:
        # with few views, fix skew=0 and principal point at center
        V.append([0, 1, 0, 0, 0, 0])
        V.append([0, 0, 0, 1, 0, (w - 1) / 2 * -0 - 0])
    V = np.asarray(V)
    _, _, vt = np.linalg.svd(V)
    b = vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    fx = math.sqrt(abs(lam / B11))
    fy = math.sqrt(abs(lam * B11 / (B11 * B22 - B12 * B12)))
    skew = -B12 * fx * fx * fy / lam
    u0 = skew * v0 / fx - B13 * fx * fx / lam
    K = np.array([[fx, skew, u0], [0, fy, v0], [0, 0, 1.0]])

    # extrinsics + linear distortion solve against the RAW points
    Kinv = np.linalg.inv(K)
    rows = []
    rhs = []
    ideals = []
    r2s = []
    for H, obj, img in zip(Hs, obj_pts, img_pts):
        h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
        lam_e = 1.0 / np.linalg.norm(Kinv @ h1)
        r1 = lam_e * (Kinv @ h1)
        r2 = lam_e * (Kinv @ h2)
        t = lam_e * (Kinv @ h3)
        r3 = np.cross(r1, r2)
        R = np.stack([r1, r2, r3], -1)
        # project ideal points
        P = (R @ np.concatenate(
            [obj[:, :2], np.zeros((len(obj), 1))], 1).T).T + t
        xn = P[:, 0] / P[:, 2]
        yn = P[:, 1] / P[:, 2]
        r2n = xn * xn + yn * yn
        u_ideal = fx * xn + skew * yn + u0
        v_ideal = fy * yn + v0
        du = img[:, 0] - u_ideal
        dv = img[:, 1] - v_ideal
        for i in range(len(obj)):
            rows.append([(u_ideal[i] - u0) * r2n[i],
                         (u_ideal[i] - u0) * r2n[i] ** 2])
            rhs.append(du[i])
            rows.append([(v_ideal[i] - v0) * r2n[i],
                         (v_ideal[i] - v0) * r2n[i] ** 2])
            rhs.append(dv[i])
        ideals.append((u_ideal, v_ideal, du, dv))
        r2s.append(r2n)
    kk, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(rhs),
                             rcond=None)
    dist = np.array([kk[0], kk[1], 0.0, 0.0, 0.0])
    sse = 0.0
    npts = 0
    for (u_ideal, v_ideal, du, dv), r2n in zip(ideals, r2s):
        rad = kk[0] * r2n + kk[1] * r2n * r2n
        ru = du - (u_ideal - u0) * rad
        rv = dv - (v_ideal - v0) * rad
        sse += float((ru * ru + rv * rv).sum())
        npts += len(r2n)
    rms = math.sqrt(sse / max(npts, 1))
    return K, dist, rms


@register_element
class CameraCalibrate(TransformElement):
    """cameracalibrate (gstcameracalibrate.cpp)."""
    FACTORY = "cameracalibrate"
    DESCRIPTION = "Performs camera calibration"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, RGB_CAPS),
        PadTemplate("src", PadDirection.SRC, RGB_CAPS),
    ]
    PROPERTIES = {
        "pattern": (str, "chessboard", "calibration pattern (only "
                                       "chessboard is implemented)"),
        "board-width": (int, 9, "inner corners across"),
        "board-height": (int, 6, "inner corners down"),
        "square-size": (float, 50.0, "square size in user units"),
        "frame-count": (int, 25, "frames with a found board needed"),
        "delay": (int, 350, "ms between captured frames"),
        "show-corners": (bool, True, "draw detected corners"),
        "settings": (str, "", "read: the calibrated settings XML"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._img_pts: List[np.ndarray] = []
        self._calibrated = False
        self._info = None

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._info = VideoInfo.from_caps_structure(incaps[0])

    def start(self):
        self._img_pts = []
        self._calibrated = False

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._calibrated:
            return buf
        planes = host_planes(buf)
        out = [p.copy() for p in planes]
        bw = int(self.props["board-width"])
        bh = int(self.props["board-height"])
        for k in range(planes[0].shape[0]):
            gray = cvk.rgb2gray_u8(np, planes[0][k], planes[1][k],
                                   planes[2][k])
            corners = find_chessboard_corners(gray, bw, bh)
            if corners is None:
                continue
            self._img_pts.append(corners)
            if bool(self.props["show-corners"]):
                for (x, y) in corners.astype(int):
                    _draw_rect([p[k] for p in out[:3]], x - 1, y - 1,
                               x + 1, y + 1, (255, 0, 0), 1)
            if len(self._img_pts) >= int(self.props["frame-count"]):
                self._finish()
                break
        return buf.with_(data=tuple(device_array(p, buf.data)
                                    for p in out))

    def _finish(self):
        sq = float(self.props["square-size"])
        bw = int(self.props["board-width"])
        bh = int(self.props["board-height"])
        obj = np.array([[j * sq, i * sq, 0.0]
                        for i in range(bh) for j in range(bw)])
        K, dist, rms = calibrate_camera(
            [obj] * len(self._img_pts), self._img_pts,
            self._info.width, self._info.height)
        settings = serialize_undistort_settings(K, dist)
        self.props["settings"] = settings
        self._calibrated = True
        _log.info("cameracalibrate %s: rms=%.3f", self.name, rms)
        _post(self, "camera-calibration",
              {"rms": rms, "settings": settings})
        # send the calibrated event upstream (a cameraundistort
        # earlier in the pipeline picks it up)
        for p in self.sink_pads():
            if p.peer is not None:
                p.push_event(new_calibrated_event(settings))


# ---------------------------------------------------------------------------
# cascade detection elements
# ---------------------------------------------------------------------------

def _draw_ellipse(planes, cx, cy, ax, ay, color, thickness=3):
    """cv::ellipse analog: draw an axis-aligned ellipse ring."""
    h, w = planes[0].shape[-2], planes[0].shape[-1]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    if ax <= 0 or ay <= 0:
        return
    d = ((xs - cx) / ax) ** 2 + ((ys - cy) / ay) ** 2
    band = thickness / max(min(ax, ay), 1.0)
    ring = np.abs(np.sqrt(np.maximum(d, 0)) - 1.0) <= band
    for p, c in zip(planes, color):
        p[ring] = c


class _CascadeBase(TransformElement):
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, RGB_CAPS),
        PadTemplate("src", PadDirection.SRC, RGB_CAPS),
    ]

    def _load(self, path: str) -> Optional[HaarCascade]:
        if not path:
            return None
        try:
            return HaarCascade(path)
        except (OSError, ValueError, ET.ParseError) as e:
            if not getattr(self, "_warned_profile", False):
                _log.error("%s: cannot load cascade %r: %s",
                           self.FACTORY, path, e)
                self._warned_profile = True
            return None


@register_element
class FaceDetect(_CascadeBase):
    """facedetect (gstfacedetect.cpp)."""
    FACTORY = "facedetect"
    DESCRIPTION = ("Performs face detection on videos and images, "
                   "providing detected positions via bus messages")
    PROPERTIES = {
        "display": (bool, True, "draw ellipses around faces"),
        "profile": (str, "", "face cascade XML path"),
        "nose-profile": (str, "", "nose cascade XML path"),
        "mouth-profile": (str, "", "mouth cascade XML path"),
        "eyes-profile": (str, "", "eyes cascade XML path"),
        "scale-factor": (float, 1.25, "detector scale factor"),
        "min-neighbors": (int, 3, "minimum neighbor votes"),
        "min-size-width": (int, 30, "minimum face width"),
        "min-size-height": (int, 30, "minimum face height"),
        "min-stddev": (int, 0, "minimum image standard deviation"),
        "updates": (str, "every_frame",
                    "every_frame|on_change|on_face|none"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._face = self._nose = self._mouth = self._eyes = None
        self._had_face = False

    def start(self):
        self._face = self._load(self.props["profile"])
        self._nose = self._load(self.props["nose-profile"])
        self._mouth = self._load(self.props["mouth-profile"])
        self._eyes = self._load(self.props["eyes-profile"])
        self._had_face = False

    def _sub_detect(self, cascade, gray, rect):
        if cascade is None:
            return None
        x, y, w, h = rect
        x, y = max(x, 0), max(y, 0)
        sub = gray[y:y + h, x:x + w]
        if sub.size == 0:
            return None
        hits = cascade.detect_multi_scale(sub, 1.25, 1)
        if not hits:
            return None
        rx, ry, rw, rh = hits[0]
        return (x + rx, y + ry, rw, rh)

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._face is None:
            return buf
        planes = host_planes(buf)
        out = [p.copy() for p in planes]
        updates = self.props["updates"]
        for k in range(planes[0].shape[0]):
            gray = cvk.rgb2gray_u8(np, planes[0][k], planes[1][k],
                                   planes[2][k])
            if int(self.props["min-stddev"]) > 0 \
                    and gray.std() < int(self.props["min-stddev"]):
                continue
            faces = self._face.detect_multi_scale(
                gray, float(self.props["scale-factor"]),
                int(self.props["min-neighbors"]),
                (int(self.props["min-size-width"]),
                 int(self.props["min-size-height"])))
            post = {"every_frame": True,
                    "on_change": bool(faces) != self._had_face,
                    "on_face": bool(faces),
                    "none": False}.get(updates, True)
            self._had_face = bool(faces)
            structures = []
            for (x, y, fw, fh) in faces:
                s = {"x": x, "y": y, "width": fw, "height": fh}
                rhh = fh // 2
                nose = self._sub_detect(
                    self._nose, gray,
                    (x + fw // 4, y + rhh, fw // 2, rhh))
                if nose:
                    s["nose"] = {"x": nose[0], "y": nose[1],
                                 "width": nose[2], "height": nose[3]}
                mouth = self._sub_detect(self._mouth, gray,
                                         (x, y + rhh, fw, rhh))
                if mouth:
                    s["mouth"] = {"x": mouth[0], "y": mouth[1],
                                  "width": mouth[2],
                                  "height": mouth[3]}
                eyes = self._sub_detect(self._eyes, gray,
                                        (x, y, fw, rhh))
                if eyes:
                    s["eyes"] = {"x": eyes[0], "y": eyes[1],
                                 "width": eyes[2], "height": eyes[3]}
                structures.append(s)
                if bool(self.props["display"]):
                    _draw_ellipse([p[k] for p in out[:3]],
                                  x + fw / 2, y + fh / 2,
                                  fw / 2, fh / 2, (255, 32, 32))
            if post:
                _post(self, "facedetect",
                      {"timestamp": buf.pts, "faces": structures})
        return buf.with_(data=tuple(device_array(p, buf.data)
                                    for p in out))


@register_element
class FaceBlur(_CascadeBase):
    """faceblur (gstfaceblur.cpp): blur(11x11) then GaussianBlur
    (11x11) over each detected face rectangle."""
    FACTORY = "faceblur"
    DESCRIPTION = "Blurs faces in images and videos"
    PROPERTIES = {
        "profile": (str, "", "face cascade XML path"),
        "scale-factor": (float, 1.25, "detector scale factor"),
        "min-neighbors": (int, 3, "minimum neighbor votes"),
        "min-size-width": (int, 30, "minimum face width"),
        "min-size-height": (int, 30, "minimum face height"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._face = None

    def start(self):
        self._face = self._load(self.props["profile"])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._face is None:
            return buf
        planes = host_planes(buf)
        out = [p.copy() for p in planes]
        for k in range(planes[0].shape[0]):
            gray = cvk.rgb2gray_u8(np, planes[0][k], planes[1][k],
                                   planes[2][k])
            faces = self._face.detect_multi_scale(
                gray, float(self.props["scale-factor"]),
                int(self.props["min-neighbors"]),
                (int(self.props["min-size-width"]),
                 int(self.props["min-size-height"])))
            for (x, y, fw, fh) in faces:
                for c in range(3):
                    roi = out[c][k, y:y + fh, x:x + fw]
                    if roi.size == 0:
                        continue
                    roi = cvk.box_blur_u8(np, roi, 11, 11)
                    roi = cvk.gaussian_blur_u8(np, roi, 11, 0.0)
                    out[c][k, y:y + fh, x:x + fw] = roi
        return buf.with_(data=tuple(device_array(p, buf.data)
                                    for p in out))


@register_element
class HandDetect(_CascadeBase):
    """handdetect (gsthanddetect.cpp): fist/palm cascades with the
    reference's hard-coded (1.1, 2) detect parameters; posts
    "hand_detect" messages with the best hand and draws its box."""
    FACTORY = "handdetect"
    DESCRIPTION = ("Performs hand gesture detection on videos, "
                   "providing detected hand positions via bus message")
    PROPERTIES = {
        "display": (bool, True, "draw a box around the hand"),
        "profile-fist": (str, "", "fist cascade XML path"),
        "profile-palm": (str, "", "palm cascade XML path"),
        "ROI-X": (int, 0, "detection region x"),
        "ROI-Y": (int, 0, "detection region y"),
        "ROI-WIDTH": (int, 0, "detection region width (0 = full)"),
        "ROI-HEIGHT": (int, 0, "detection region height (0 = full)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._fist = self._palm = None

    def start(self):
        self._fist = self._load(self.props["profile-fist"])
        self._palm = self._load(self.props["profile-palm"])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._fist is None and self._palm is None:
            return buf
        planes = host_planes(buf)
        out = [p.copy() for p in planes]
        h, w = planes[0].shape[-2], planes[0].shape[-1]
        rx, ry = int(self.props["ROI-X"]), int(self.props["ROI-Y"])
        rw = int(self.props["ROI-WIDTH"]) or w - rx
        rh = int(self.props["ROI-HEIGHT"]) or h - ry
        for k in range(planes[0].shape[0]):
            gray = cvk.rgb2gray_u8(np, planes[0][k], planes[1][k],
                                   planes[2][k])
            roi = gray[ry:ry + rh, rx:rx + rw]
            best = None
            for cascade, gesture in ((self._fist, "fist"),
                                     (self._palm, "palm")):
                if cascade is None:
                    continue
                hits = cascade.detect_multi_scale(roi, 1.1, 2)
                for (x, y, hw, hh) in hits:
                    cand = (rx + x, ry + y, hw, hh, gesture)
                    if best is None or hw * hh > best[2] * best[3]:
                        best = cand
            if best is None:
                continue
            x, y, hw, hh, gesture = best
            _post(self, "hand_detect",
                  {"gesture": gesture, "x": x, "y": y,
                   "width": hw, "height": hh})
            if bool(self.props["display"]):
                _draw_rect([p[k] for p in out[:3]], x, y, x + hw,
                           y + hh, (0, 0, 255), 2)
        return buf.with_(data=tuple(device_array(p, buf.data)
                                    for p in out))
