"""VideoConverter: format/size/colorimetry conversion on the torch port.

Port of the JAX package's ``video/converter.py`` (GstVideoConverter,
video-converter.c).  The plan (``_make_plan``) is a copy of the reference's
host planning.  Execution runs one pipeline under two array modules: torch
on the converter's device (``convert``) and numpy on the host
(``convert_ref``, the gold the port checks itself against).

This slice ports the routes of the 4:2:x downscale in "hv" order:

* ``_pipeline_chroma_kernel``: luma through the yscale CUDA kernel; chroma
  through the 2-tap static gather (plain torch) or the chroma420 CUDA
  kernel.  The torch path takes it wherever the reference takes it on a
  TPU; the reference's TPU gates (VMEM budget, (8, 128) tiling, backend
  checks) are tiling limits and do not apply here.
* ``_pipeline_phase_split`` with ``_finish``'s dest-rect embed and border
  fill (the launched element's add-borders case; no kernel).
* ``_pipeline_pallas``: the reference's opt-in fused-ingest route
  (environment variable ``GTPU_PALLAS``, off unless set).  One CUDA kernel
  does unpack + chroma up2 H + chroma up2 V + h-scale; the v-scale, the
  matrix and the pack stay plain torch, as they are plain XLA in the
  reference.

Every other route (the generic line pipeline, gamma remap, interlaced
scaling, dither) raises NotImplementedError: those are later slices.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import _xp
from ..device import resolve
from . import chroma as chroma_mod
from . import color as color_mod
from . import scaler as scaler_mod
from .dither import make_converter_dither
from .format import check_supported, pack_planes, unpack_planes
from .info import VideoInfo, chroma_site_h_cosited, chroma_site_v_cosited

DEFAULTS = {
    "resampler-method": scaler_mod.METHOD_CUBIC,   # video-converter.c:790
    "resampler-taps": 0,
    "chroma-resampler-method": scaler_mod.METHOD_LINEAR,
    "chroma-mode": "full",      # full | upsample-only | downsample-only | none
    "matrix-mode": "full",      # full | input-only | output-only | none
    "dither-method": "bayer",   # DEFAULT_OPT_DITHER_METHOD (:793)
    "dither-quantization": 1,   # DEFAULT_OPT_DITHER_QUANTIZATION (:794)
    "alpha-mode": "copy",
    "alpha-value": 1.0,
    "fill-border": True,
}

_LATER = "is ported in a later slice of the PyTorch port"


class _UnpackFinfo:
    """Stands in for the UNPACK format's GstVideoFormatInfo when computing
    range offsets (the converter computes offsets against AYUV/AYUV64,
    i.e. full 8/16-bit depth — video-converter.c:1380)."""

    def __init__(self, finfo):
        self.is_yuv = finfo.is_yuv or finfo.is_gray
        self.is_rgb = finfo.is_rgb
        self.is_gray = False
        self.depth = (finfo.bits,) * 4


class VideoConverter:
    def __init__(self, in_info: VideoInfo, out_info: VideoInfo,
                 config: Optional[Dict[str, Any]] = None, device=None):
        self.device = resolve(device)
        self.in_info = in_info
        self.out_info = out_info
        self.config = dict(DEFAULTS)
        if config:
            self.config.update(config)
        self._plan = self._make_plan()

    @property
    def plan(self) -> Dict[str, Any]:
        return self._plan

    def load_plan(self, entries: Dict[str, Any]) -> None:
        """Replace plan entries (resamplers, matrix, chroma siting) with
        ones built elsewhere, e.g. by interop.plan_from_reference."""
        unknown = set(entries) - set(self._plan)
        if unknown:
            raise KeyError(f"not plan entries: {sorted(unknown)}")
        self._plan.update(entries)

    # -- planning (host) ---------------------------------------------------
    def _make_plan(self):
        ii, oi = self.in_info, self.out_info
        ifmt, ofmt = ii.finfo, oi.finfo
        cfg = self.config
        plan: Dict[str, Any] = {}

        # src/dest rectangles (gst_video_converter_new :2306-2363):
        # crop offsets round DOWN to chroma alignment; sizes clamp to the
        # frame.  The convert chain runs at the rect sizes; _finish embeds
        # the result at (out_x, out_y) and fills the border.
        in_x = int(cfg.get("src-x", 0)) & ~((1 << ifmt.w_sub[1]) - 1)
        in_y = int(cfg.get("src-y", 0)) & ~((1 << ifmt.h_sub[1]) - 1)
        in_w = int(cfg.get("src-width", ii.width - in_x))
        in_h = int(cfg.get("src-height", ii.height - in_y))
        in_w = max(0, min(in_w, ii.width - in_x))
        in_h = max(0, min(in_h, ii.height - in_y))
        out_x = int(cfg.get("dest-x", 0)) & ~((1 << ofmt.w_sub[1]) - 1)
        out_y = int(cfg.get("dest-y", 0)) & ~((1 << ofmt.h_sub[1]) - 1)
        out_w = int(cfg.get("dest-width", oi.width - out_x))
        out_h = int(cfg.get("dest-height", oi.height - out_y))
        out_w = max(0, min(out_w, oi.width - out_x))
        out_h = max(0, min(out_h, oi.height - out_y))
        plan["rect"] = (in_x, in_y, in_w, in_h, out_x, out_y, out_w, out_h)
        plan["rect_active"] = (
            (in_x, in_y, in_w, in_h) != (0, 0, ii.width, ii.height)
            or (out_x, out_y, out_w, out_h) != (0, 0, oi.width, oi.height))

        chroma_mode = cfg["chroma-mode"]
        # video_converter_compute_resample condition (:2866)
        need_resample = (
            chroma_mode != "none"
            and (ifmt.w_sub[1] != ofmt.w_sub[1]
                 or ifmt.h_sub[1] != ofmt.h_sub[1]
                 or ii.chroma_site != oi.chroma_site
                 or in_w != out_w
                 or in_h != out_h)
        )
        plan["upsample"] = (
            need_resample and chroma_mode != "downsample-only"
            and (ifmt.w_sub[1] or ifmt.h_sub[1]))
        plan["downsample"] = (
            need_resample and chroma_mode != "upsample-only"
            and (ofmt.w_sub[1] or ofmt.h_sub[1]))
        plan["up_h_cosited"] = chroma_site_h_cosited(ii.chroma_site)
        plan["up_v_cosited"] = chroma_site_v_cosited(ii.chroma_site)
        plan["down_h_cosited"] = chroma_site_h_cosited(oi.chroma_site)
        plan["down_v_cosited"] = chroma_site_v_cosited(oi.chroma_site)

        # scaling plan (chain_scale :1684 — fewer intermediate pixels first)
        method = cfg["resampler-method"]
        taps = cfg["resampler-taps"]
        rkw = {}
        if "cubic-b" in cfg:
            rkw["cubic_b"] = cfg["cubic-b"]
        if "cubic-c" in cfg:
            rkw["cubic_c"] = cfg["cubic-c"]
        if taps:
            # GST_VIDEO_RESAMPLER_OPT_MAX_TAPS semantics: a tap budget
            rkw["max_taps_opt"] = taps
            taps = 0
        plan["interlaced"] = ii.interlace_mode in ("interleaved", "mixed")
        if plan["interlaced"]:
            raise NotImplementedError(f"interlaced scaling {_LATER}")
        h_res = v_res = None
        if in_w != out_w:
            h_res = scaler_mod.make_resampler(method, in_w, out_w, taps,
                                              **rkw)
        if in_h != out_h:
            v_res = scaler_mod.make_resampler(method, in_h, out_h, taps,
                                              **rkw)
        s1 = out_w * in_h
        s2 = in_w * out_h
        plan["scale_order"] = "hv" if s1 <= s2 else "vh"
        # chain_scale runs before the color matrix when the total pixel
        # count shrinks, after it otherwise (video-converter.c:2522,2528)
        plan["scale_before_matrix"] = (out_w * out_h <= in_w * in_h)
        plan["h_res"], plan["v_res"] = h_res, v_res

        # matrix plan (chain_convert :1719) — range offsets are computed
        # against the UNPACK format (AYUV/AYUV64), i.e. full 8/16-bit depth
        matrix_mode = cfg["matrix-mode"]
        in_bits, out_bits = ifmt.bits, ofmt.bits
        plan["unpack_bits"], plan["pack_bits"] = in_bits, out_bits

        plan["do_gamma"] = cfg.get("gamma-mode", "none") == "remap"
        if plan["do_gamma"]:
            raise NotImplementedError(f"gamma remap {_LATER}")
        same_primaries = (
            cfg.get("primaries-mode", "none") == "none"
            or color_mod.primaries_is_equivalent(
                ii.colorimetry.primaries, oi.colorimetry.primaries))
        m = color_mod.identity()
        if not same_primaries:
            m = color_mod.primaries_convert_matrix(
                ii.colorimetry.primaries, oi.colorimetry.primaries)
        if in_bits < out_bits:
            s = 1 << (out_bits - in_bits)
            m = color_mod.scale_components(
                m, *(float(np.float32(1.0) / np.float32(s)),) * 3)
        m = color_mod.compute_matrix_to_rgb(
            m, ii.colorimetry, _UnpackFinfo(ifmt),
            matrix_mode_none=(matrix_mode == "none"))
        m = color_mod.compute_matrix_to_yuv(
            m, oi.colorimetry, _UnpackFinfo(ofmt),
            matrix_mode_none=(matrix_mode == "none"))
        if in_bits > out_bits:
            s = float(np.float32(1 << (in_bits - out_bits)))
            m = color_mod.scale_components(m, s, s, s)
        plan["matrix"] = color_mod.prepare_matrix(
            m, unpack_rgb=ifmt.is_rgb, pack_rgb=ofmt.is_rgb,
            bits=max(in_bits, out_bits))

        # border color (setup_borderline :2188): ARGB (0xAARRGGBB) taken
        # to the output space; YUV via the 8-bit to-YUV 3x3 with hardcoded
        # 16/128 offsets.  16-bit containers inherit the reference's
        # splat2_u64 lane layout verbatim.
        if plan["rect_active"]:
            argb = int(cfg.get("border-argb", 0xFF000000)) & 0xFFFFFFFF
            ba = (argb >> 24) & 0xFF
            br = (argb >> 16) & 0xFF
            bg = (argb >> 8) & 0xFF
            bb = argb & 0xFF
            if ofmt.is_rgb:
                bc = (ba, br, bg, bb)
                val32 = ((bb << 24) | (bg << 16) | (br << 8) | ba)
            else:
                m2 = color_mod.compute_matrix_to_yuv(
                    color_mod.identity(), oi.colorimetry,
                    _UnpackFinfo(ofmt), matrix_mode_none=False)
                im = np.rint(m2 * 256.0).astype(np.int64)
                by = 16 + int((br * im[0][0] + bg * im[0][1]
                               + bb * im[0][2]) >> 8)
                bu = 128 + int((br * im[1][0] + bg * im[1][1]
                                + bb * im[1][2]) >> 8)
                bv = 128 + int((br * im[2][0] + bg * im[2][1]
                                + bb * im[2][2]) >> 8)
                by, bu, bv = (max(0, min(255, x)) for x in (by, bu, bv))
                bc = (ba, by, bu, bv)
                val32 = (ba | (by << 8) | (bu << 16) | (bv << 24))
            if out_bits == 16:
                lane0, lane1 = val32 & 0xFFFF, (val32 >> 16) & 0xFFFF
                bc = (lane0, lane1, lane0, lane1)
            plan["border"] = bc
        else:
            plan["border"] = None

        # dither plan (chain_dither :2034); a plan that dithers raises
        plan["dither"] = make_converter_dither(
            cfg["dither-method"], int(cfg.get("dither-quantization", 1)),
            ofmt, out_bits)

        # fused ingest kernel (ops/convert_kernel.py) eligibility:
        # 8-bit 4:2:0 -> downscale, h-first, no alpha
        from ..ops import convert_kernel as ck
        plan["pallas_ok"] = (
            ck.applicable(ifmt, ii, oi, plan)
            and not ifmt.has_alpha
            and not plan["do_gamma"]
            and not plan["rect_active"]
            and not plan["interlaced"]
            and (plan["v_res"] is None or plan["scale_order"] == "hv"))
        return plan

    # -- execution ---------------------------------------------------------
    def _pipeline(self, xp, planes):
        """planes (component arrays of in_info) -> planes of out_info, as
        a tuple of per-channel planes (A, c0, c1, c2), each (..., H, W)."""
        ii = self.in_info
        ifmt = ii.finfo
        plan = self._plan

        if xp is not np and plan["pallas_ok"] and self._pallas_enabled():
            return self._pipeline_pallas(xp, planes)

        sub_up = (plan["upsample"] and not ifmt.is_gray
                  and ifmt.w_sub[1] <= 1 and ifmt.h_sub[1] <= 1)
        # Phase-split path: 4:2:x upsample + downscale in "hv" order.  The
        # full-width chroma plane is never materialized: up2 produces
        # even/odd phases at the stored resolution and the scales contract
        # them against the tap matrix's even/odd columns (bit-identical).
        phase_split = (
            sub_up and ifmt.w_sub[1] == 1
            and plan["scale_before_matrix"] and plan["scale_order"] == "hv"
            and plan["h_res"] is not None
            and (plan["unpack_bits"] == 8 and not plan["do_gamma"]))
        if (xp is not np and phase_split
                and ifmt.h_sub[1] == 1 and plan["v_res"] is not None
                and not plan["rect_active"]
                and ii.width % 2 == 0 and ii.height % 2 == 0
                and ifmt.layout == "planar" and not ifmt.has_alpha
                and ifmt.bits == 8):
            from ..ops import chroma420_gather as ckg
            from ..ops import chroma420_kernel as ck420
            cw = planes[1].shape[-1]
            chh = planes[1].shape[-2]
            if ckg.applicable(plan["h_res"], plan["v_res"], cw, chh):
                return self._pipeline_chroma_kernel(xp, planes,
                                                    use_gather=True)
            if ck420.applicable(plan["h_res"], plan["v_res"], cw, chh):
                return self._pipeline_chroma_kernel(xp, planes)
        if not phase_split:
            raise NotImplementedError(
                f"{ii.format} {ii.width}x{ii.height} -> "
                f"{self.out_info.format} {self.out_info.width}x"
                f"{self.out_info.height}: the generic converter pipeline "
                f"{_LATER}")
        in_x, in_y, in_w, in_h = plan["rect"][:4]
        if (in_x, in_y, in_w, in_h) != (0, 0, ii.width, ii.height):
            # SRC rect crop: offsets are chroma-aligned so per-component
            # slices stay integral
            def crop(c, p):
                hs = ifmt.h_sub[min(c, len(ifmt.h_sub) - 1)]
                ws = ifmt.w_sub[min(c, len(ifmt.w_sub) - 1)]
                return p[..., in_y >> hs:(in_y + in_h + (1 << hs) - 1) >> hs,
                         in_x >> ws:(in_x + in_w + (1 << ws) - 1) >> ws]
            planes = tuple(crop(c, p) for c, p in enumerate(planes))
        chans = unpack_planes(xp, ifmt, planes, in_w, in_h, dtype="int16",
                              subsampled_chroma=sub_up)
        if not ifmt.has_alpha and not self.out_info.finfo.has_alpha:
            chans = (None,) + chans[1:]
        return self._pipeline_phase_split(xp, chans)

    def _matrix_and_downsample(self, xp, chans):
        """Color matrix, then the output's chroma downsample (v, then h)."""
        ofmt = self.out_info.finfo
        plan = self._plan
        if plan["unpack_bits"] == 8 and plan["pack_bits"] == 16:
            chans = tuple(c if c is None else _xp.astype(xp, c, "int32") * 257
                          for c in chans)
        chans = color_mod.apply_prepared_planes(xp, chans, plan["matrix"])
        if plan["downsample"]:
            if ofmt.h_sub[1] > 1 or ofmt.w_sub[1] > 1:
                raise NotImplementedError(f"4x chroma downsample {_LATER}")
            a, yy, uu, vv = chans
            if ofmt.h_sub[1] == 1:
                uu = chroma_mod.down2(xp, uu, -2, plan["down_v_cosited"])
                vv = chroma_mod.down2(xp, vv, -2, plan["down_v_cosited"])
            if ofmt.w_sub[1] == 1:
                uu = chroma_mod.down2(xp, uu, -1, plan["down_h_cosited"])
                vv = chroma_mod.down2(xp, vv, -1, plan["down_h_cosited"])
            chans = (a, yy, uu, vv)
        return chans

    def _pipeline_phase_split(self, xp, chans):
        """4:2:x chroma upsampled as separate even/odd parity phases at
        stored resolution and scaled by split-tap contraction —
        bit-identical to the sequential up2 -> scale chain."""
        ifmt = self.in_info.finfo
        plan = self._plan
        a, y, u, v = chans
        h_res, v_res = plan["h_res"], plan["v_res"]

        def sc(c, axis, res):
            if c is None or res is None:
                return c
            return scaler_mod.scale_axis_exact(
                xp, c, axis, res, precision=scaler_mod.SCALE_U8,
                value_bits=8)

        y = sc(sc(y, -1, h_res), -2, v_res)
        a = sc(sc(a, -1, h_res), -2, v_res)

        def chroma(c):
            ce, co = chroma_mod.up2_phases(xp, c, -1, plan["up_h_cosited"])
            if ifmt.h_sub[1] == 1:
                ce_re, ce_ro = chroma_mod.up2_phases(
                    xp, ce, -2, plan["up_v_cosited"])
                co_re, co_ro = chroma_mod.up2_phases(
                    xp, co, -2, plan["up_v_cosited"])
                h_re = scaler_mod.scale_cols_split_exact(xp, ce_re, co_re,
                                                         h_res)
                h_ro = scaler_mod.scale_cols_split_exact(xp, ce_ro, co_ro,
                                                         h_res)
                if v_res is not None:
                    return scaler_mod.scale_rows_split_exact(xp, h_re, h_ro,
                                                             v_res)
                st = _xp.stack(xp, [h_re, h_ro], -2)
                full = st.reshape(tuple(h_re.shape[:-2])
                                  + (h_re.shape[-2] * 2, h_re.shape[-1]))
                return full[..., :plan["rect"][3], :]
            out = scaler_mod.scale_cols_split_exact(xp, ce, co, h_res)
            return sc(out, -2, v_res)

        chans = (a, y, chroma(u), chroma(v))
        return self._finish(xp, self._matrix_and_downsample(xp, chans))

    def _finish(self, xp, chans):
        """Dest-rect embed with border fill, then pack (a dithering plan
        raised when the converter was made)."""
        oi = self.out_info
        ofmt = oi.finfo
        plan = self._plan
        _, _, _, _, out_x, out_y, out_w, out_h = plan["rect"]

        if plan["rect_active"]:
            border = plan["border"]
            maxv = 255 if plan["pack_bits"] == 8 else 65535
            new = []
            for i, c in enumerate(chans):
                if c is None:
                    # materialize alpha only if the output stores it
                    if i == 0 and ofmt.has_alpha:
                        c = _xp.full(xp, tuple(chans[1].shape[:-2])
                                     + (out_h, out_w), maxv, chans[1],
                                     "int32")
                    else:
                        new.append(None)
                        continue
                full_shape = tuple(c.shape[:-2]) + (oi.height, oi.width)
                bg = _xp.full(xp, full_shape, int(border[i]), c)
                bg[..., out_y:out_y + out_h, out_x:out_x + out_w] = c
                new.append(bg)
            chans = tuple(new)

        return pack_planes(xp, ofmt, chans, oi.width, oi.height)

    def _pipeline_chroma_kernel(self, xp, planes, use_gather: bool = False):
        """4:2:0 fast path: luma scales straight from the stored uint8
        plane through the yscale kernel; chroma runs in the 2-tap
        static-gather formulation or through the chroma420 kernel.
        Bit-identical to _pipeline_phase_split."""
        from ..ops import chroma420_gather as ckg
        from ..ops import chroma420_kernel as ck420
        from ..ops import yscale_kernel as ysk

        plan = self._plan
        ii = self.in_info
        h_res, v_res = plan["h_res"], plan["v_res"]
        # a source may hand out broadcast views; the kernels take dense planes
        planes = tuple(p.contiguous() for p in planes)
        y = ysk.yscale_hv(planes[0], h_res, v_res,
                          precision=scaler_mod.SCALE_U8)
        if use_gather:
            u, v = (ckg.chroma420_scale_2tap(
                xp, p, h_res, v_res, plan["up_h_cosited"],
                plan["up_v_cosited"]) for p in planes[1:3])
        else:
            u, v = (ck420.chroma420_scale(
                p, h_res, v_res, plan["up_h_cosited"], plan["up_v_cosited"],
                ii.width, ii.height) for p in planes[1:3])
        chans = (None, y, u, v)
        return self._finish(xp, self._matrix_and_downsample(xp, chans))

    def _pallas_enabled(self) -> bool:
        """The fused-ingest route is opt-in, under the reference's name and
        default: GTPU_PALLAS=1 (or =interpret, the reference's CPU test
        mode; there is no interpret mode here, a CPU tensor runs the
        kernel's plain version)."""
        return os.environ.get("GTPU_PALLAS", "0") in ("1", "interpret")

    def _pipeline_pallas(self, xp, planes):
        """Fused-ingest variant: one kernel does unpack + chroma up2 +
        h-scale; plain torch finishes v-scale + matrix + downsample +
        pack."""
        from ..ops.convert_kernel import fused_i420_up_hscale

        plan = self._plan
        ifmt = self.in_info.finfo
        check_supported(ifmt)
        y, u, v = (p.contiguous() for p in planes[:3])
        yk, ue, uo, ve, vo = fused_i420_up_hscale(
            y, u, v, plan["h_res"], plan["up_h_cosited"],
            precision=scaler_mod.SCALE_U8)
        if plan["v_res"] is not None:
            yk = scaler_mod.scale_axis_exact(xp, yk, -2, plan["v_res"])
            uk = scaler_mod.scale_rows_split_exact(xp, ue, uo, plan["v_res"])
            vk = scaler_mod.scale_rows_split_exact(xp, ve, vo, plan["v_res"])
        else:
            # interleave the parity planes (cheap at the scaled width)
            def _ilv(e, o):
                st = _xp.stack(xp, [e, o], -2)
                return st.reshape(tuple(e.shape[:-2])
                                  + (e.shape[-2] * 2, e.shape[-1]))
            uk, vk = _ilv(ue, uo), _ilv(ve, vo)
        chans = (None, yk, uk, vk)
        return self._finish(xp, self._matrix_and_downsample(xp, chans))

    # -- entry points ------------------------------------------------------
    def convert(self, planes):
        """Convert component planes (numpy arrays or tensors, optionally
        batched in front) on the converter's device; returns a tuple of
        tensors there."""
        planes = tuple(torch.as_tensor(p).to(self.device) for p in planes)
        with torch.no_grad():
            return self._pipeline(torch, planes)

    def convert_ref(self, planes):
        """The numpy gold: the same pipeline on the host."""
        return self._pipeline(np, tuple(np.asarray(p) for p in planes))
