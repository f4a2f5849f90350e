"""OpenCV-analog video-analysis elements (stateful / detection half), in
torch.

A port of the JAX package's ``elements/opencv_analysis.py`` (reference:
gst-plugins-bad/ext/opencv/):

  segmentation   gstsegmentation.cpp: the foreground mask into the alpha
                 channel of RGBA frames.  mog2 (default) and mog run the
                 per-pixel Gaussian mixture of ``ops/gmm_kernel.py`` once a
                 tick (the CUDA kernel on the card, its plain version on
                 the CPU), its carry kept by the pipeline across ticks;
                 codebook is the fixed 4-slot box codebook with an
                 open/close cleanup, plain torch a frame.
  motioncells    gstmotioncells.cpp + MotionCells.cpp: grid motion
                 detection on the host (numpy), "motion" messages.
  templatematch  gsttemplatematch.cpp: cv::matchTemplate on the host,
                 "template_match" messages.
  cvtracker      gstcvtracker.cpp: the NCC window tracker on the host,
                 "object" messages and an ObjectDetectionMtd.
  grabcut        gstgrabcut.cpp: the reduced GrabCut (GMMs + ICM) on the
                 host.
  disparity      gstdisparity.cpp: sink_left/sink_right aggregator; sbm =
                 SAD block matching (the cost volume plain torch, argmin);
                 sgbm adds the left-to-right semi-global pass of
                 ``ops/sgbm_kernel.py``.

The host elements run the JAX package's numpy code on the frames' host
copy; their planes go back to the buffer's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .._xp import fma32
from ..core.buffer import Buffer, device_array, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection, PadTemplate,
                            TransformElement, register_element)
from ..ops import cv_kernels as cvk
from ..ops import gmm_kernel as gk
from ..ops import sgbm_kernel as sk
from ..video.info import VideoInfo

RGB_CAPS = ("video/x-raw, format=RGB, width=[1,32767], "
            "height=[1,32767], framerate=[0/1,2147483647/1]")
RGBA_CAPS = ("video/x-raw, format=RGBA, width=[1,32767], "
             "height=[1,32767], framerate=[0/1,2147483647/1]")
BGR_CAPS = ("video/x-raw, format=BGR, width=[1,32767], "
            "height=[1,32767], framerate=[0/1,2147483647/1]")


def _post(elem, name: str, fields: dict) -> None:
    root = elem
    while getattr(root, "parent", None) is not None:
        root = root.parent
    if hasattr(root, "bus"):
        from ..core.pipeline import Message
        root.bus.post(Message("element", elem.name,
                              dict(fields, name=name)))


def _draw_rect(planes: List[np.ndarray], x0, y0, x1, y1, color,
               thickness=1):
    """cv::rectangle analog on component planes (host, in place)."""
    h, w = planes[0].shape[-2], planes[0].shape[-1]
    for t in range(thickness):
        xa, ya = x0 + t, y0 + t
        xb, yb = x1 - t, y1 - t
        if xa > xb or ya > yb:
            break
        xa2, ya2 = max(xa, 0), max(ya, 0)
        xb2, yb2 = min(xb, w - 1), min(yb, h - 1)
        for p, c in zip(planes, color):
            if 0 <= ya <= h - 1:
                p[..., ya, xa2:xb2 + 1] = c
            if 0 <= yb <= h - 1:
                p[..., yb, xa2:xb2 + 1] = c
            if 0 <= xa <= w - 1:
                p[..., ya2:yb2 + 1, xa] = c
            if 0 <= xb <= w - 1:
                p[..., ya2:yb2 + 1, xb] = c


def host_planes(buf: Buffer) -> List[np.ndarray]:
    """A buffer's planes as host numpy arrays."""
    return [host_array(p) for p in buf.data]


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------

@register_element
class Segmentation(TransformElement):
    """segmentation (gstsegmentation.cpp): RGBA in/out, the estimated
    foreground mask replaces the alpha channel; test-mode also paints the
    RGB channels with the mask."""
    FACTORY = "segmentation"
    DESCRIPTION = ("Create a Foregound/Background mask applying a "
                   "particular algorithm")
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, RGBA_CAPS),
        PadTemplate("src", PadDirection.SRC, RGBA_CAPS),
    ]
    PROPERTIES = {
        "method": (str, "mog2", "codebook, mog or mog2"),
        "test-mode": (bool, False, "RGB overwritten with the "
                                   "calculated foreground mask"),
        "learning-rate": (float, 0.01, "speed with which a motionless "
                                       "foreground pixel becomes "
                                       "background"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._info: Optional[VideoInfo] = None

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._info = VideoInfo.from_caps_structure(incaps[0])

    # -- codebook scan -------------------------------------------------------
    _CB_SLOTS = 4
    _CB_MOD = 20.0          # minMod/maxMod

    def _cb_init(self, h, w):
        s = self._CB_SLOTS
        return {
            "lo": np.zeros((h, w, s, 3), np.float32),
            "hi": np.zeros((h, w, s, 3), np.float32),
            "used": np.zeros((h, w, s), np.bool_),
            "frame": np.int32(0),
        }

    def _cb_step(self, carry, x):
        """Bradski codebook (fixed slots): learn for 30 frames, then
        classify; periodic relearn at learning-rate's interval.  x is
        (H, W, 3) float32 YCrCb; the frame count is a host number."""
        lo, hi, used = carry["lo"], carry["hi"], carry["used"]
        frame = int(carry["frame"])
        bounds = torch.tensor([10.0, 5.0, 5.0], device=x.device)
        xs = x[..., None, :]
        inbox = ((xs >= lo - bounds) & (xs <= hi + bounds)).all(-1) & used
        first = torch.argmax(inbox.to(torch.uint8), dim=-1)
        hit = inbox.any(-1)
        sidx = torch.arange(self._CB_SLOTS, device=x.device)
        is_first = (sidx == first[..., None]) & hit[..., None]
        interval = max(int(round(1.0 / max(
            float(self.props["learning-rate"]), 1e-3))), 1)
        if frame < 30 or frame % interval == 0:
            nlo = torch.where(is_first[..., None], torch.minimum(lo, xs), lo)
            nhi = torch.where(is_first[..., None], torch.maximum(hi, xs), hi)
            # no hit: open a new slot (first unused, else slot 0)
            free = ~used
            slot = torch.where(free.any(-1),
                               torch.argmax(free.to(torch.uint8), dim=-1),
                               torch.zeros_like(first))
            is_slot = (sidx == slot[..., None]) & (~hit)[..., None]
            lo = torch.where(is_slot[..., None], xs, nlo)
            hi = torch.where(is_slot[..., None], xs, nhi)
            used = used | is_slot
        mod = self._CB_MOD
        bg = (((xs >= lo - mod) & (xs <= hi + mod)).all(-1) & used).any(-1)
        if frame < 30:
            mask = torch.zeros(bg.shape, dtype=torch.uint8, device=x.device)
        else:
            mask = cvk.where_u8(torch, bg, 0, 255)
        # blob cleanup: open + close (reduced find_connected_components)
        mask = cvk.dilate_u8(torch, cvk.erode_u8(torch, mask, 1), 1)
        mask = cvk.erode_u8(torch, cvk.dilate_u8(torch, mask, 1), 1)
        return {"lo": lo, "hi": hi, "used": used, "frame": frame + 1}, mask

    @staticmethod
    def _ycrcb(r, g, b):
        """RGB -> YCrCb (BT.601 full range, the cvtColor math), rounded as
        XLA rounds the reference's jitted expressions on the CPU: it fuses
        multiply-adds, and it emits y once for each consumer, fused in
        another order for cr than for the y plane and cb."""
        c299, c587, c114 = (float(np.float32(c))
                            for c in (0.299, 0.587, 0.114))
        y = fma32(b, c114, fma32(g, c587, r * c299))
        y_cr = fma32(b, c114, fma32(r, c299, g * c587))
        cr = fma32(r - y_cr, float(np.float32(0.713)), 128.0)
        cb = fma32(b - y, float(np.float32(0.564)), 128.0)
        return torch.stack([y, cr, cb], dim=-1)

    def make_scan_fn(self):
        if self._info is None:
            return None
        method = self.props["method"]
        test_mode = bool(self.props["test-mode"])
        h, w = self._info.height, self._info.width

        def outputs(planes, mask):
            if test_mode:
                return (mask, mask.clone(), mask.clone(), mask.clone())
            return (planes[0], planes[1], planes[2], mask)

        if method == "codebook":
            def step(carry, planes):
                r, g, b = (planes[i].to(torch.float32) for i in range(3))
                carry, mask = self._cb_step(carry, self._ycrcb(r, g, b))
                return carry, outputs(planes, mask)

            return step, self._cb_init(h, w)

        gmm2 = method == "mog2"
        alpha, act = gk.rates(float(self.props["learning-rate"]), gmm2)

        def tick(carry, planes, aux=None):
            """The tick's frames at once: one launch of the GMM kernel."""
            carry, masks = gk.gmm(carry, planes[0], planes[1], planes[2],
                                  alpha, act, gmm2)
            return carry, outputs(planes, masks)

        tick.whole_tick = True
        return tick, gk.init_carry(h, w)


# ---------------------------------------------------------------------------
# motioncells
# ---------------------------------------------------------------------------

@register_element
class MotionCells(TransformElement):
    """motioncells (gstmotioncells.cpp / MotionCells.cpp): grid motion
    detection with bus messages and optional cell overlay."""
    FACTORY = "motioncells"
    DESCRIPTION = "Performs motion detection on videos and images, " \
                  "providing detected motion cells index via bus " \
                  "messages"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, RGB_CAPS),
        PadTemplate("src", PadDirection.SRC, RGB_CAPS),
    ]
    PROPERTIES = {
        "gridx": (int, 10, "number of horizontal grid cells"),
        "gridy": (int, 10, "number of vertical grid cells"),
        "sensitivity": (float, 0.5, "motion sensitivity 0..1"),
        "threshold": (float, 0.01, "fraction of moving cells needed "
                                   "to report motion"),
        "gap": (int, 5, "seconds without motion before "
                        "motion_finished"),
        "postnomotion": (int, 0, "post no_motion every N seconds "
                                 "without motion (0 = off)"),
        "minimummotionframes": (int, 1, "consecutive motion frames "
                                        "before motion_begin"),
        "display": (bool, True, "draw motion cells on the output"),
        "postallmotion": (bool, False, "post a message on every "
                                       "motion frame"),
        "usealpha": (bool, False, "draw filled translucent cells "
                                  "instead of borders"),
        "motioncellsidx": (str, "", "restrict detection to these "
                                    "\"r:c,r:c\" cells"),
        "cellscolor": (str, "255,255,0", "R,G,B color of the drawn "
                                         "cells"),
        "motioncellthickness": (int, 1, "border thickness of drawn "
                                        "cells"),
        "calculatemotion": (bool, True, "enable/disable the motion "
                                        "calculation"),
        "datafile": (str, "", "log motion events to this file"),
        "datafileextension": (str, "", "extension for the datafile"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._info = None
        self.start()

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._info = VideoInfo.from_caps_structure(incaps[0])

    def start(self):
        self._prev = None
        self._consecutive = 0
        self._previous_motion = False
        self._last_motion_ts = 0
        self._last_nomotion_ts = 0

    def _selected_cells(self):
        txt = self.props["motioncellsidx"].strip()
        if not txt:
            return None
        out = set()
        for tok in txt.split(","):
            tok = tok.strip()
            if ":" in tok:
                r, c = tok.split(":")
                out.add((int(r), int(c)))
        return out or None

    def _detect(self, cur_gray_half, prev_gray_half):
        """MotionCells::performDetectionMotionCells core: absdiff ->
        adaptive gaussian threshold (7, 5, INV) -> dilate x2, erode x2 ->
        per-cell moving percent."""
        diff = np.abs(cur_gray_half.astype(np.int16)
                      - prev_gray_half.astype(np.int16)).astype(np.uint8)
        bw = cvk.adaptive_threshold_gaussian_u8(np, diff, 7, 5, inv=True)
        bw = cvk.dilate_u8(np, bw, 2)
        bw = cvk.erode_u8(np, bw, 2)
        moving = bw != 0
        gx, gy = int(self.props["gridx"]), int(self.props["gridy"])
        h, w = moving.shape
        sens = 1.0 - float(self.props["sensitivity"])
        cells = []
        sel = self._selected_cells()
        for i in range(gy):
            y0, y1 = (h * i) // gy, (h * (i + 1)) // gy
            for j in range(gx):
                if sel is not None and (i, j) not in sel:
                    continue
                x0, x1 = (w * j) // gx, (w * (j + 1)) // gx
                area = max((y1 - y0) * (x1 - x0), 1)
                if moving[y0:y1, x0:x1].sum() / area > sens:
                    cells.append((i, j))
        return cells

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if not bool(self.props["calculatemotion"]):
            return buf
        planes = host_planes(buf)
        out = [p.copy() for p in planes]
        nb = planes[0].shape[0]
        fps = float(self._info.fps) if self._info and self._info.fps \
            else 30.0
        dur_ns = int(1e9 / fps) if fps else 33333333
        base_ts = buf.pts if buf.pts is not None else 0
        gx, gy = int(self.props["gridx"]), int(self.props["gridy"])
        color = [int(v) for v in self.props["cellscolor"].split(",")[:3]]
        thick = int(self.props["motioncellthickness"])
        h, w = planes[0].shape[-2], planes[0].shape[-1]

        for k in range(nb):
            ts = base_ts + k * dur_ns
            cur = cvk.pyr_down_u8(
                np, cvk.rgb2gray_u8(np, planes[0][k], planes[1][k],
                                    planes[2][k]))
            if self._prev is None:
                self._prev = cur
                continue
            cells = self._detect(cur, self._prev)
            self._prev = cur
            total = len(self._selected_cells() or []) or gx * gy
            min_cells = int(np.floor(total * float(self.props["threshold"])))
            motion = len(cells) >= max(min_cells, 1) and cells
            idx_str = ",".join(f"{r}:{c}" for r, c in cells)
            if motion:
                self._last_motion_ts = ts
                self._consecutive += 1
                if (not self._previous_motion
                        and self._consecutive
                        >= int(self.props["minimummotionframes"])):
                    self._previous_motion = True
                    _post(self, "motion", {"motion_cells_indices": idx_str,
                                           "motion_begin": ts})
                    self._log_event("motion_begin", ts, idx_str)
                elif bool(self.props["postallmotion"]):
                    _post(self, "motion", {"motion_cells_indices": idx_str,
                                           "motion": ts})
                if bool(self.props["display"]):
                    self._draw_cells(out, k, cells, gx, gy, w, h, color,
                                     thick)
            else:
                self._consecutive = 0
                if (self._last_motion_ts > 0 and self._previous_motion
                        and (ts - self._last_motion_ts) // 1_000_000_000
                        >= int(self.props["gap"])):
                    self._previous_motion = False
                    _post(self, "motion",
                          {"motion_finished": self._last_motion_ts})
                    self._log_event("motion_finished",
                                    self._last_motion_ts, "")
            pnm = int(self.props["postnomotion"])
            if pnm > 0 and (ts - self._last_motion_ts) // 1_000_000_000 \
                    >= pnm:
                if (ts - self._last_nomotion_ts) // 1_000_000_000 >= pnm:
                    self._last_nomotion_ts = ts
                    _post(self, "motion",
                          {"no_motion": self._last_motion_ts})
        return buf.with_(data=tuple(device_array(p, buf.data)
                                    for p in out))

    def _draw_cells(self, out, k, cells, gx, gy, w, h, color, thick):
        use_alpha = bool(self.props["usealpha"])
        for (i, j) in cells:
            y0, y1 = (h * i) // gy, (h * (i + 1)) // gy - 1
            x0, x1 = (w * j) // gx, (w * (j + 1)) // gx - 1
            if use_alpha:
                for p, c in zip(out[:3], color):
                    region = p[k, y0:y1 + 1, x0:x1 + 1].astype(np.int32)
                    p[k, y0:y1 + 1, x0:x1 + 1] = \
                        ((region + c) // 2).astype(np.uint8)
            else:
                _draw_rect([p[k] for p in out[:3]], x0, y0, x1, y1,
                           color, thick)

    def _log_event(self, kind, ts, idx):
        path = self.props["datafile"]
        if not path:
            return
        ext = self.props["datafileextension"]
        if ext:
            path = path + "." + ext
        try:
            with open(path, "a") as f:
                f.write(f"{kind} {ts} {idx}\n")
        except OSError:
            pass


# ---------------------------------------------------------------------------
# templatematch
# ---------------------------------------------------------------------------

@register_element
class TemplateMatch(TransformElement):
    """templatematch (gsttemplatematch.cpp): cv::matchTemplate + best
    position as a "template_match" element message; display draws the box
    (3 px; certainty-colored for normed methods)."""
    FACTORY = "templatematch"
    DESCRIPTION = ("Performs template matching on videos and images, "
                   "providing detected positions via bus messages.")
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, BGR_CAPS),
        PadTemplate("src", PadDirection.SRC, BGR_CAPS),
    ]
    PROPERTIES = {
        "method": (int, 3, "0=SQDIFF 1=SQDIFF_NORMED 2=CCOR "
                           "3=CCOR_NORMED 4=CCOEFF 5=CCOEFF_NORMED"),
        "template": (str, "", "filename of template image"),
        "display": (bool, True, "highlight the detected template"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._templ = None          # (H, W, 3) uint8

    def start(self):
        self._templ = None
        path = self.props["template"]
        if path:
            from PIL import Image

            self._templ = np.asarray(Image.open(path).convert("RGB"),
                                     np.uint8)

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        if self._templ is None:
            return buf
        planes = host_planes(buf)
        h, w = planes[0].shape[-2], planes[0].shape[-1]
        th, tw = self._templ.shape[:2]
        if tw > w or th > h:
            return buf
        method = int(self.props["method"])
        out = [p.copy() for p in planes]
        for k in range(planes[0].shape[0]):
            score = cvk.match_template_multi(
                np, [planes[c][k] for c in range(3)],
                [self._templ[..., c] for c in range(3)], method)
            pick = np.argmin if method in (0, 1) else np.argmax
            y, x = np.unravel_index(pick(score), score.shape)
            best = float(score[y, x])
            _post(self, "template_match",
                  {"x": int(x), "y": int(y), "width": tw, "height": th,
                   "result": best})
            if bool(self.props["display"]):
                if method in (1, 3, 5):
                    # yellow growing redder as certainty approaches 1
                    color = (255, int(max(0.0, 255 - 255.0 ** min(
                        max(best, 0.0), 1.0))), 32)
                else:
                    color = (255, 32, 32)
                _draw_rect([p[k] for p in out[:3]], x, y, x + tw, y + th,
                           color, 3)
        return buf.with_(data=tuple(device_array(p, buf.data)
                                    for p in out))


# ---------------------------------------------------------------------------
# cvtracker
# ---------------------------------------------------------------------------

@register_element
class CvTracker(TransformElement):
    """cvtracker (gstcvtracker.cpp): single-object tracking.  Every
    `algorithm` value runs the NCC window tracker (the JAX package's
    reduction); posts "object" messages with x/y/width/height and attaches
    an analytics ObjectDetectionMtd."""
    FACTORY = "cvtracker"
    DESCRIPTION = ("Performs object tracking on videos and stores it "
                   "in video buffer metadata.")
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, RGB_CAPS),
        PadTemplate("src", PadDirection.SRC, RGB_CAPS),
    ]
    PROPERTIES = {
        "object-initial-x": (int, 50, "track box initial x"),
        "object-initial-y": (int, 50, "track box initial y"),
        "object-initial-width": (int, 50, "track box width"),
        "object-initial-height": (int, 50, "track box height"),
        "algorithm": (str, "medianflow",
                      "boosting|csrt|kcf|medianflow|mil|mosse|tld|"
                      "dasiamrpn (all run the NCC window tracker)"),
        "draw-rect": (bool, True, "draw rectangle around tracked "
                                  "object"),
    }

    SEARCH_PAD = 24     # pixels around the last box
    REFRESH_NCC = 0.75  # template refresh confidence

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._box = None
        self._templ = None

    def start(self):
        self._box = None
        self._templ = None

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        planes = host_planes(buf)
        h, w = planes[0].shape[-2], planes[0].shape[-1]
        nb = planes[0].shape[0]
        out = [p.copy() for p in planes]
        for k in range(nb):
            gray = cvk.rgb2gray_u8(np, planes[0][k], planes[1][k],
                                   planes[2][k])
            if self._box is None:
                x = int(self.props["object-initial-x"])
                y = int(self.props["object-initial-y"])
                bw = int(self.props["object-initial-width"])
                bh = int(self.props["object-initial-height"])
                x, y = min(x, w - 1), min(y, h - 1)
                bw, bh = min(bw, w - x), min(bh, h - y)
                self._box = (x, y, bw, bh)
                self._templ = gray[y:y + bh, x:x + bw].astype(np.float32)
            else:
                x, y, bw, bh = self._box
                pad = self.SEARCH_PAD
                sx0, sy0 = max(x - pad, 0), max(y - pad, 0)
                sx1, sy1 = min(x + bw + pad, w), min(y + bh + pad, h)
                sub = gray[sy0:sy1, sx0:sx1]
                if sub.shape[0] >= bh and sub.shape[1] >= bw:
                    # CCOEFF_NORMED degenerates on flat templates (zero
                    # variance): plain SQDIFF there
                    if float(self._templ.var()) < 1.0:
                        score = -cvk.match_template(np, sub, self._templ, 0)
                        score = score / max(-score.min(), 1.0)
                        score = 1.0 + score      # best ~1 at 0 diff
                    else:
                        score = cvk.match_template(np, sub, self._templ, 5)
                    dy, dx = np.unravel_index(np.argmax(score), score.shape)
                    conf = float(score[dy, dx])
                    x, y = sx0 + int(dx), sy0 + int(dy)
                    self._box = (x, y, bw, bh)
                    if conf > self.REFRESH_NCC:
                        self._templ = gray[y:y + bh, x:x + bw] \
                            .astype(np.float32)
            x, y, bw, bh = self._box
            _post(self, "object", {"x": x, "y": y, "width": bw,
                                   "height": bh})
            if bool(self.props["draw-rect"]):
                _draw_rect([p[k] for p in out[:3]], x, y, x + bw, y + bh,
                           (255, 0, 0), 1)
        res = buf.with_(data=tuple(device_array(p, buf.data)
                                   for p in out),
                        meta=dict(buf.meta or {}))
        from ..analytics.meta import get_relation_meta

        x, y, bw, bh = self._box
        for k in range(nb):
            get_relation_meta(res, k, create=True).add_od_mtd(
                "object", x, y, bw, bh, confidence=1.0)
        return res


# ---------------------------------------------------------------------------
# grabcut
# ---------------------------------------------------------------------------

@register_element
class GrabCut(TransformElement):
    """grabcut (gstgrabcut.cpp): RGBA; foreground alpha from GrabCut
    seeded by the input alpha channel or a detection meta box."""
    FACTORY = "grabcut"
    DESCRIPTION = ("Runs Grabcut algorithm on input alpha. Values: BG=0"
                   ", FG=1, PR_BG=2, PR_FGD=3; NOTE: larger values of"
                   " alpha (notably 255) are interpreted as PR_FGD too")
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, RGBA_CAPS),
        PadTemplate("src", PadDirection.SRC, RGBA_CAPS),
    ]
    PROPERTIES = {
        "test-mode": (bool, False, "RGB masked with the resulting "
                                   "foreground, box drawn"),
        "scale": (float, 1.6, "grow factor for the face bounding box"),
    }

    ITERS = 3
    GMM_K = 3

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        planes = host_planes(buf)
        out = [p.copy() for p in planes]
        box = self._meta_box(buf)
        for k in range(planes[0].shape[0]):
            rgb = np.stack([planes[c][k] for c in range(3)], -1) \
                .astype(np.float32)
            seeds = self._seed_mask(planes[3][k], box, rgb.shape[:2])
            if seeds is None:
                continue                     # no seed info: skip frame
            fg = self._grabcut(rgb, seeds)
            out[3][k] = np.where(fg, 255, 0).astype(np.uint8)
            if bool(self.props["test-mode"]):
                for c in range(3):
                    out[c][k] = np.where(fg, out[c][k], 0)
                if box is not None:
                    _draw_rect([p[k] for p in out[:3]], box[0], box[1],
                               box[0] + box[2], box[1] + box[3],
                               (255, 0, 255), 1)
        return buf.with_(data=tuple(device_array(p, buf.data)
                                    for p in out))

    def _meta_box(self, buf):
        """The reference reads a GstVideoRegionOfInterestMeta box and grows
        it by `scale` (gstgrabcut.cpp transform_ip)."""
        from ..analytics.meta import ObjectDetectionMtd, relation_meta_of

        scale = float(self.props["scale"])
        for rmeta in relation_meta_of(buf).values():
            for m in rmeta.iter_mtds(ObjectDetectionMtd):
                x = int(m.x - (scale - 1) * m.w / 2)
                y = int(m.y - (scale - 1) * m.h / 2)
                return (x, y, int(m.w * scale * 0.9),
                        int(m.h * scale * 1.1))
        roi = (buf.meta or {}).get("roi")
        if roi:
            x, y, w, h = roi
            x = int(x - (scale - 1) * w / 2)
            y = int(y - (scale - 1) * h / 2)
            return (x, y, int(w * scale * 0.9), int(h * scale * 1.1))
        return None

    @staticmethod
    def _seed_mask(alpha, box, shape):
        """0/1 = definite bg/fg, 2/3 = probable (GC_* values)."""
        h, w = shape
        a = np.minimum(alpha, 3).astype(np.uint8)
        nz = int(np.count_nonzero(alpha))
        if 0 < nz < alpha.size:
            return a
        if box is not None and abs(box[2]) > 2 and abs(box[3]) > 2:
            m = np.zeros((h, w), np.uint8)      # GC_BGD outside
            x0, y0 = max(box[0], 0), max(box[1], 0)
            x1, y1 = min(box[0] + box[2], w), min(box[1] + box[3], h)
            m[y0:y1, x0:x1] = 3                 # GC_PR_FGD inside
            return m
        return None

    def _grabcut(self, rgb, seeds):
        """Reduced GrabCut: per-class GMMs fit on the seeds, then ICM with
        an 8-neighbour Potts smoothness term."""
        h, w, _ = rgb.shape
        fixed_fg = seeds == 1
        fixed_bg = seeds == 0
        x = rgb.reshape(-1, 3)

        def fit_gmm(sel):
            pts = x[sel.ravel()]
            if len(pts) < self.GMM_K:
                pts = x
            # k-means-lite: k centers from quantiles, 2 refinements
            order = np.argsort(pts.sum(-1))
            idx = order[np.linspace(0, len(pts) - 1, self.GMM_K)
                        .astype(int)]
            mu = pts[idx].astype(np.float64)
            for _ in range(2):
                d = ((pts[:, None] - mu[None]) ** 2).sum(-1)
                lab = d.argmin(-1)
                for j in range(self.GMM_K):
                    sel_j = lab == j
                    if sel_j.any():
                        mu[j] = pts[sel_j].mean(0)
            d = ((pts[:, None] - mu[None]) ** 2).sum(-1)
            lab = d.argmin(-1)
            var = np.array([max(pts[lab == j].var(), 25.0)
                            if (lab == j).any() else 100.0
                            for j in range(self.GMM_K)])
            wgt = np.array([(lab == j).mean() + 1e-3
                            for j in range(self.GMM_K)])
            return mu, var, wgt

        def neg_loglik(mu, var, wgt):
            d2 = ((x[:, None] - mu[None]) ** 2).sum(-1)
            ll = (np.log(wgt)[None] - 1.5 * np.log(var)[None]
                  - d2 / (2 * var[None]))
            return -ll.max(-1).reshape(h, w)

        fg = (seeds == 1) | (seeds == 3)
        lam = 6.0
        for _ in range(self.ITERS):
            df = neg_loglik(*fit_gmm(fg))
            db = neg_loglik(*fit_gmm(~fg))
            # ICM sweep: cost(fg) = df + lam * (# bg neighbours)
            p = np.pad(fg, 1)
            nb_fg = sum(p[1 + di:1 + di + h, 1 + dj:1 + dj + w]
                        for di in (-1, 0, 1) for dj in (-1, 0, 1)
                        if (di, dj) != (0, 0)).astype(np.float64)
            cost_fg = df + lam * (8.0 - nb_fg) / 8.0 * 2.0
            cost_bg = db + lam * nb_fg / 8.0 * 2.0
            fg = cost_fg < cost_bg
            fg |= fixed_fg
            fg &= ~fixed_bg
        return fg


# ---------------------------------------------------------------------------
# disparity
# ---------------------------------------------------------------------------

@register_element
class Disparity(AggregatorElement):
    """disparity (gstdisparity.cpp): left+right RGB in, gray disparity map
    (GRAY2RGB) out.  sbm = SAD block matching; sgbm adds one horizontal
    DP smoothing pass (the JAX package's reduction of 8-path SGM)."""
    FACTORY = "disparity"
    DESCRIPTION = "Calculates the stereo disparity map from two " \
                  "(sequences of) rectified and aligned stereo images"
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, RGB_CAPS),
        PadTemplate("sink_left", PadDirection.SINK, RGB_CAPS),
        PadTemplate("sink_right", PadDirection.SINK, RGB_CAPS),
    ]
    PROPERTIES = {
        "method": (str, "sgbm", "sbm or sgbm"),
    }

    NUM_DISP = sk.NUM_DISP
    BLOCK = sk.BLOCK
    P1 = sk.P1
    P2 = sk.P2

    def negotiate_output(self, in_caps: Dict[str, Caps],
                         allowed: Caps) -> Caps:
        first = next(iter(in_caps.values()))
        self._info = VideoInfo.from_caps_structure(first[0])
        return Caps([first[0].copy()]).fixate()

    def aggregate_fn(self):
        method = self.props["method"]
        nd = self.NUM_DISP
        # the 16x fixed-point map's convertScale to 0..255
        # (gstdisparity.cpp cvGray_depth_map2)
        step = float(np.float32(255.0 / max(nd - 1, 1)))

        def fn(inputs):
            left, right = inputs["sink_left"], inputs["sink_right"]
            gl = cvk.rgb2gray_u8(torch, *left[:3])
            gr = cvk.rgb2gray_u8(torch, *right[:3])
            # the cost volume, the pass (sgbm) and the first minimum in one
            # kernel on the card; the plain versions on the CPU
            disp, _, _ = sk.disparity(gl, gr, method)
            g = torch.clamp(disp.to(torch.float32) * step, 0, 255) \
                .to(torch.uint8)
            return (g, g.clone(), g.clone())

        return fn
