"""iqa — image quality assessment element.

Reference: gst-plugins-bad/ext/iqa/iqa.c — a video aggregator that
compares each sink stream against the first ("reference") stream with
DSSIM and posts per-pad error values; the output is the reference
frame with the measurements attached.

Clean-room SSIM: the standard Wang et al. formulation with an 8x8
box window (the dssim library's default scale), computed on luma.
DSSIM = 1/SSIM - 1 as in the dssim tool the reference wraps.

A port of the JAX package's ``elements/iqa.py``: the SSIM runs on a host
copy of each pad's first luma frame; the output is the reference pad's
buffer, on its device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.buffer import Buffer, host_array
from ..core.caps import Caps
from ..core.element import (AggregatorElement, PadDirection,
                            PadPresence, PadTemplate, register_element)


def _luma(buf: Buffer) -> np.ndarray:
    d = buf.data
    y = d[0] if isinstance(d, (tuple, list)) else d
    while y.ndim > 2:
        y = y[0]
    return host_array(y).astype(np.float64)


def _box(x: np.ndarray, k: int = 8) -> np.ndarray:
    """Mean over k x k blocks (integral-image box filter)."""
    h, w = x.shape
    hh, ww = h - h % k, w - w % k
    return x[:hh, :ww].reshape(hh // k, k, ww // k, k).mean((1, 3))


def ssim(a: np.ndarray, b: np.ndarray, k: int = 8) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    mu_a = _box(a, k)
    mu_b = _box(b, k)
    var_a = _box(a * a, k) - mu_a ** 2
    var_b = _box(b * b, k) - mu_b ** 2
    cov = _box(a * b, k) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


@register_element
class Iqa(AggregatorElement):
    """iqa: compare sink_1..n against sink_0 (the reference pad),
    output the reference frame, record dssim per pad in `results`
    (and the buffer meta), erroring above dssim-error-threshold if
    configured — mirroring the reference's properties."""
    FACTORY = "iqa"
    DESCRIPTION = "Image quality assessment"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK,
                    "video/x-raw, format={ I420, GRAY8 }",
                    presence=PadPresence.REQUEST),
        PadTemplate("src", PadDirection.SRC,
                    "video/x-raw, format={ I420, GRAY8 }"),
    ]
    PROPERTIES = {
        "do-dssim": (bool, True, "compute DSSIM"),
        "dssim-error-threshold": (float, -1.0,
                                  "post error above this (-1 = off)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self.results: Dict[str, list] = {}

    def negotiate_output(self, in_caps, allowed):
        first = sorted(in_caps)[0]
        return in_caps[first]

    def host_aggregate(self, ins: Dict[str, Buffer]) -> Optional[Buffer]:
        names = sorted(ins)
        ref_name = names[0]
        ref = ins.get(ref_name)
        if ref is None:
            return None
        measures = {}
        if self.props["do-dssim"]:
            ry = _luma(ref)
            for n in names[1:]:
                other = ins.get(n)
                if other is None:
                    continue
                oy = _luma(other)
                if oy.shape != ry.shape:
                    continue
                s = ssim(ry, oy)
                d = 1.0 / max(s, 1e-9) - 1.0
                measures[n] = d
                self.results.setdefault(n, []).append(d)
                thr = self.props["dssim-error-threshold"]
                if 0 <= thr < d:
                    raise ValueError(
                        f"iqa: dssim {d:.4f} over threshold {thr}")
        meta = dict(ref.meta or {})
        meta["iqa-dssim"] = measures
        return ref.with_(meta=meta)
