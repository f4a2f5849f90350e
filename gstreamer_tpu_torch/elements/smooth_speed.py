"""smooth (video) and speed (audio) — gst-plugins-bad ports.

* smooth (gstsmooth.c:130-172): tolerance-gated box average over the
  LUMA plane.  The reference's running window bookkeeping gives a
  vertical reach of filtersize+1 rows (both directions, lagged by the
  per-row increment order) and horizontal reach of filtersize; a
  neighbor contributes iff (lower-akt)*(upper-akt) < 0, i.e. strictly
  inside (ref-tolerance, ref+tolerance) excluding the bounds; output
  is the C integer average sum/numvalues.  Chroma passes through.
  Ported as masked shifted adds — one fused device expression.
* speed (gstspeed.c:474-510): audio speed change (pitch shifts too,
  unlike scaletempo): output j samples input at
  i_float = 0.5*(speed-1) + j*speed via linear interpolation between
  the PREVIOUSLY sampled point (`lower`) and ceil(i_float) — the
  reference's quirky scheme reproduced exactly, float32 math,
  per-buffer state reset like the C chain function.

A port of the JAX package's ``elements/smooth_speed.py``: smooth's masked
shifted adds run in plain torch on the pipeline's device, int64 as in the
JAX package (byte for byte); speed is its host code on the host copy of
the samples, the result put back on their device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, device_array, host_array
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from ..video.info import VideoInfo

_SMOOTH_CAPS = ("video/x-raw, format={ I420, YV12 }, width=[1,32767], "
                "height=[1,32767], framerate=[0/1,2147483647/1]")


@register_element
class Smooth(TransformElement):
    FACTORY = "smooth"
    DESCRIPTION = "Apply a smooth filter to an image"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _SMOOTH_CAPS),
        PadTemplate("src", PadDirection.SRC, _SMOOTH_CAPS),
    ]
    PROPERTIES = {
        "active": (bool, True, ""),
        "tolerance": (int, 8, "contrast tolerance"),
        "filter-size": (int, 3, "window reach"),
        "luma-only": (bool, True, "only smooth the luma plane"),
    }

    def set_info(self, incaps, outcaps):
        self._info = VideoInfo.from_caps_structure(incaps[0])

    def _row_bounds(self, h: int, fs: int):
        """Exact transliteration of the fy1/fy2 row recurrences."""
        r1 = np.zeros(h, np.int64)
        r2 = np.zeros(h, np.int64)
        fy1 = 0
        fy2 = min(fs + 1, h)
        for y in range(h):
            if y > fs + 1:
                fy1 += 1
            if y < h - (fs + 1):
                fy2 += 1
            r1[y] = fy1
            r2[y] = fy2
        return r1, r2

    def make_fn(self):
        if not self.props["active"]:
            return None
        fs = self.props["filter-size"]
        tol = self.props["tolerance"]
        h = self._info.height
        r1, r2 = self._row_bounds(h, fs)

        def smooth_plane(p):
            x = p.to(torch.int64)
            lower = x - tol
            upper = x + tol
            hh, ww = x.shape[-2], x.shape[-1]
            rows = np.arange(hh)
            total = x.clone()
            count = torch.ones_like(x)
            for dy in range(-(fs + 1), fs + 2):
                src_rows = rows + dy
                row_ok = ((src_rows >= r1[:hh]) & (src_rows < r2[:hh])
                          & (src_rows >= 0) & (src_rows < hh))
                row_m = torch.as_tensor(row_ok, device=x.device)[:, None]
                shifted_y = torch.roll(x, -dy, dims=-2)
                for dx in range(-fs, fs + 1):
                    cols = np.arange(ww) + dx
                    col_ok = (cols >= 0) & (cols < ww)
                    akt = torch.roll(shifted_y, -dx, dims=-1)
                    cond = ((lower - akt) * (upper - akt)) < 0
                    m = (cond & row_m
                         & torch.as_tensor(col_ok, device=x.device)[None, :])
                    total += torch.where(m, akt, 0)
                    count += m
            return (total // count).to(p.dtype)

        def fn(planes):
            out = [smooth_plane(planes[0])]
            return out + list(planes[1:])

        return fn


_SPEED_CAPS = ("audio/x-raw, format={ F32LE, S16LE }, "
               "rate=[1,2147483647], channels=[1,64], "
               "layout=interleaved")


@register_element
class Speed(TransformElement):
    FACTORY = "speed"
    DESCRIPTION = "Set speed/pitch on audio/raw streams"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _SPEED_CAPS),
        PadTemplate("src", PadDirection.SRC, _SPEED_CAPS),
    ]
    PROPERTIES = {"speed": (float, 1.0, "speed factor (0.1-40)")}

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        speed = self.props["speed"]
        if speed == 1.0:
            return buf
        x = host_array(buf.data)
        one_d = x.ndim == 1
        if one_d:
            x = x[:, None]
        n = x.shape[0]
        is_s16 = x.dtype == np.int16

        # positions: i_float_j = 0.5*(speed-1) + j*speed
        # (float32 accumulation like the C loop)
        i_float = []
        v = np.float32(0.5) * (np.float32(speed) - np.float32(1.0))
        while math.ceil(float(v)) < n:
            i_float.append(float(v))
            v = np.float32(v + np.float32(speed))
        if not i_float:
            return None
        i_float = np.array(i_float, np.float64)
        i_idx = np.ceil(i_float).astype(np.int64)
        interp = (i_float - np.floor(i_float)).astype(np.float32)
        prev_idx = np.concatenate([[0], i_idx[:-1]])
        xf = x.astype(np.float32)          # C uses gfloat for both
        lower = xf[prev_idx]
        cur = xf[i_idx]
        out = (lower * (np.float32(1) - interp)[:, None]
               + cur * interp[:, None]).astype(np.float32)
        if is_s16:
            out = out.astype(np.int16)     # C gint16 store truncates
        if one_d:
            out = out[:, 0]
        rate = self._info.rate
        pts = None if buf.pts is None else int(buf.pts / speed)
        return buf.with_(data=device_array(out, buf.data), pts=pts,
                         duration=len(out) * 1_000_000_000 // rate)
