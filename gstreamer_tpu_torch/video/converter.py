"""VideoConverter: format/size/colorimetry conversion on the torch port.

Port of the JAX package's ``video/converter.py`` (GstVideoConverter,
video-converter.c).  The plan (``_make_plan``) is a copy of the reference's
host planning.  Execution runs one pipeline under two array modules: torch
on the converter's device (``convert``) and numpy on the host
(``convert_ref``, the gold the port checks itself against).

It accepts every (format, size, config) the reference accepts and returns
the same bytes, by the reference's routes:

* the generic pipeline: unpack -> chroma upsample -> scale (before or after
  the matrix, "hv" or "vh" by pixel count) -> color matrix or the gamma
  remap chain (to R'G'B', decode LUT, primaries in linear light, encode
  LUT, to Y'CbCr) -> chroma downsample -> dither -> dest-rect embed ->
  pack.  Plain torch: the reference computes it in plain XLA outside any
  kernel.  Interlaced frames take field-aware vertical filters.
* ``_pipeline_phase_split``: 4:2:x upsample + downscale in "hv" order with
  the chroma phases kept apart (no kernel).
* ``_pipeline_chroma_kernel``: luma through the yscale CUDA kernel; chroma
  through the 2-tap static gather (plain torch) or the chroma420 CUDA
  kernel.  The torch path takes it wherever the reference takes it on a
  TPU; the reference's TPU gates (VMEM budget, (8, 128) tiling, backend
  checks) are tiling limits and do not apply here.
* ``_pipeline_pallas``: the reference's opt-in fused-ingest route.  One
  CUDA kernel does unpack + chroma up2 H + chroma up2 V + h-scale; the
  v-scale, the matrix and the pack stay plain torch, as they are plain XLA
  in the reference.

Three environment switches, under the reference's names and defaults, are
read at every ``convert``: ``GTPU_PALLAS`` (off unless "1": the fused-ingest
route), ``GTPU_PALLAS_YSCALE`` (on unless set to something other than "1":
the yscale kernel; off computes luma with two plain scale passes) and
``GTPU_PALLAS_CHROMA`` (on unless set to something other than "1": the
chroma420 kernel; off sends a plan of more than 2 taps to the phase-split
route).  They select a route and never hide a failure: with none set a CUDA
tensor goes to the kernels, and a kernel that fails to build or launch
raises.
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
from .format import pack_planes, unpack_planes
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
        # interlaced frames get field-aware vertical filters
        # (video-converter.c :3301 selects upsample_i/v_scaler_i when the
        # frame is interlaced; keyed off the negotiated interlace-mode,
        # since a whole batch shares one plan)
        plan["interlaced"] = ii.interlace_mode in ("interleaved", "mixed")
        h_res = v_res = None
        if in_w != out_w:
            h_res = scaler_mod.make_resampler(method, in_w, out_w, taps,
                                              **rkw)
        if in_h != out_h:
            make_v = (scaler_mod.make_resampler_interlaced
                      if plan["interlaced"] else scaler_mod.make_resampler)
            v_res = make_v(method, in_h, out_h, taps, **rkw)
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

        # gamma remap + primaries conversion (chain_convert_to_RGB :1566,
        # chain_convert primaries block :1752, chain_convert_to_YUV :1955)
        do_gamma = cfg.get("gamma-mode", "none") == "remap"
        plan["do_gamma"] = do_gamma
        same_primaries = (
            cfg.get("primaries-mode", "none") == "none"
            or color_mod.primaries_is_equivalent(
                ii.colorimetry.primaries, oi.colorimetry.primaries))
        conv = color_mod.identity()
        if not same_primaries:
            conv = color_mod.primaries_convert_matrix(
                ii.colorimetry.primaries, oi.colorimetry.primaries)
        mm_none = matrix_mode == "none"
        plan["to_rgb"] = plan["to_yuv"] = None
        plan["gamma_dec"] = plan["gamma_enc"] = None
        if not do_gamma:
            m = conv
            if in_bits < out_bits:
                s = 1 << (out_bits - in_bits)
                m = color_mod.scale_components(
                    m, *(float(np.float32(1.0) / np.float32(s)),) * 3)
            m = color_mod.compute_matrix_to_rgb(
                m, ii.colorimetry, _UnpackFinfo(ifmt),
                matrix_mode_none=mm_none)
            m = color_mod.compute_matrix_to_yuv(
                m, oi.colorimetry, _UnpackFinfo(ofmt),
                matrix_mode_none=mm_none)
            if in_bits > out_bits:
                s = float(np.float32(1 << (in_bits - out_bits)))
                m = color_mod.scale_components(m, s, s, s)
            plan["matrix"] = color_mod.prepare_matrix(
                m, unpack_rgb=ifmt.is_rgb, pack_rgb=ofmt.is_rgb,
                bits=max(in_bits, out_bits))
        else:
            # to-RGB matrix at unpack bits (only when the input is YUV)
            if not ifmt.is_rgb:
                m1 = color_mod.compute_matrix_to_rgb(
                    color_mod.identity(), ii.colorimetry,
                    _UnpackFinfo(ifmt), matrix_mode_none=mm_none)
                s = float(1 << in_bits)
                m1 = color_mod.scale_components(m1, s, s, s)
                plan["to_rgb"] = color_mod.prepare_matrix(
                    m1, unpack_rgb=False, pack_rgb=True, bits=in_bits)
            plan["gamma_dec"] = color_mod.gamma_decode_table(
                ii.colorimetry.transfer, in_bits)
            # linear-light primaries conversion at 16 bits
            plan["matrix"] = (color_mod.prepare_matrix(
                conv, unpack_rgb=True, pack_rgb=True, bits=16)
                if not same_primaries else None)
            plan["gamma_enc"] = color_mod.gamma_encode_table(
                oi.colorimetry.transfer, out_bits)
            # to-YUV matrix at pack bits (only when the output is YUV)
            if not ofmt.is_rgb:
                s = 1.0 / float(1 << out_bits)
                m2 = color_mod.scale_components(color_mod.identity(),
                                                s, s, s)
                m2 = color_mod.compute_matrix_to_yuv(
                    m2, oi.colorimetry, _UnpackFinfo(ofmt),
                    matrix_mode_none=mm_none)
                plan["to_yuv"] = color_mod.prepare_matrix(
                    m2, unpack_rgb=True, pack_rgb=False, bits=out_bits)

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

        # dither plan (chain_dither :2034)
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
        """planes (component arrays of in_info) -> planes of out_info.
        Inside, a frame is a tuple of per-channel planes (A, c0, c1, c2),
        each (..., H, W)."""
        ii, oi = self.in_info, self.out_info
        ifmt, ofmt = ii.finfo, oi.finfo
        plan = self._plan

        if xp is not np and plan["pallas_ok"] and self._pallas_enabled():
            return self._pipeline_pallas(xp, planes)

        # When upsampling 2x-subsampled chroma, unpack keeps the chroma
        # planes at their stored resolution and up2_half produces the
        # full-resolution plane directly.  Interlaced vertical up2 runs on
        # the nearest-duplicated plane (4-line field groups) instead.
        sub_up = (plan["upsample"] and not ifmt.is_gray
                  and ifmt.w_sub[1] <= 1 and ifmt.h_sub[1] <= 1
                  and not (plan["interlaced"] and ifmt.h_sub[1] == 1))
        # Phase-split path: 4:2:x upsample + downscale in "hv" order.  The
        # full-width chroma plane is never materialized: up2 produces
        # even/odd phases at the stored resolution and the scales contract
        # them against the tap matrix's even/odd columns (bit-identical).
        phase_split = (
            sub_up and ifmt.w_sub[1] == 1
            and plan["scale_before_matrix"] and plan["scale_order"] == "hv"
            and plan["h_res"] is not None
            and (plan["unpack_bits"] == 8 and not plan["do_gamma"])
            and not plan["interlaced"]
            and not getattr(self, "_disable_phase_split", False))
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
            # the 2-tap gather is chosen before the chroma switch is read
            if ckg.applicable(plan["h_res"], plan["v_res"], cw, chh):
                return self._pipeline_chroma_kernel(xp, planes,
                                                    use_gather=True)
            if (self._chroma_kernel_on()
                    and ck420.applicable(plan["h_res"], plan["v_res"],
                                         cw, chh)):
                return self._pipeline_chroma_kernel(xp, planes)
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
        # int16 is wide enough for every 8-bit stage up to the matrix
        # (values <= 255, chroma filter sums <= 2044); unpack_planes widens
        # a 16-bit container to int32 itself
        chans = unpack_planes(xp, ifmt, planes, in_w, in_h, dtype="int16",
                              subsampled_chroma=sub_up)
        # the alpha plane is skipped when neither side carries alpha (it
        # would be a constant all the way through)
        if not ifmt.has_alpha and not ofmt.has_alpha:
            chans = (None,) + chans[1:]

        if phase_split:
            return self._pipeline_phase_split(xp, chans)

        if plan["upsample"]:
            chans = self._upsample(xp, chans, sub_up, in_w, in_h)

        do_gamma = plan["do_gamma"]
        if do_gamma:
            # chain_convert_to_RGB: matrix to R'G'B' at unpack bits, then
            # gamma decode through the LUT -> 16-bit linear ARGB64
            if plan["to_rgb"] is not None:
                chans = color_mod.apply_prepared_planes(xp, chans,
                                                        plan["to_rgb"])
            chans = color_mod.apply_gamma_decode_planes(
                xp, chans, plan["gamma_dec"], plan["unpack_bits"])

        if plan["scale_before_matrix"]:
            chans = self._scale(xp, chans)

        if do_gamma:
            # chain_convert in linear light: only the (optional) primaries
            # conversion matrix
            if plan["matrix"] is not None:
                chans = color_mod.apply_prepared_planes(xp, chans,
                                                        plan["matrix"])
        else:
            chans = self._matrix(xp, chans)

        if not plan["scale_before_matrix"]:
            chans = self._scale(xp, chans)

        if do_gamma:
            # chain_convert_to_YUV: gamma encode to pack bits, then the
            # to-YUV matrix
            chans = color_mod.apply_gamma_encode_planes(
                xp, chans, plan["gamma_enc"], plan["pack_bits"])
            if plan["to_yuv"] is not None:
                chans = color_mod.apply_prepared_planes(xp, chans,
                                                        plan["to_yuv"])

        return self._finish(xp, self._downsample(xp, chans))

    def _upsample(self, xp, chans, sub_up: bool, in_w: int, in_h: int):
        """Input chroma to full resolution: h first, then v
        (MAKE_UPSAMPLE_V2 calls h_resample first)."""
        ifmt = self.in_info.finfo
        plan = self._plan
        hc, vc = plan["up_h_cosited"], plan["up_v_cosited"]
        ws, hs = ifmt.w_sub[1], ifmt.h_sub[1]

        def up(c):
            if sub_up:
                if ws == 1:
                    c = chroma_mod.up2_half(xp, c, -1, hc, in_w)
                if hs == 1:
                    c = chroma_mod.up2_half(xp, c, -2, vc, in_h)
                return c
            if ws == 1:
                c = chroma_mod.up2(xp, c, -1, hc)
            elif ws == 2:
                c = chroma_mod.up4(xp, c, -1, hc)
            if hs == 1:
                up_v = (chroma_mod.up2_interlaced if plan["interlaced"]
                        else chroma_mod.up2)
                c = up_v(xp, c, -2, vc)
            elif hs == 2:
                c = chroma_mod.up4(xp, c, -2, vc)
            return c

        a, y, u, v = chans
        return (a, y, up(u), up(v))

    def _scale(self, xp, chans):
        """Both scale passes in the plan's order (chain_scale :1684), at 16
        bits in linear light, else at the depth of the side of the matrix
        they run on."""
        plan = self._plan
        bits = (16 if plan["do_gamma"]
                else (plan["unpack_bits"] if plan["scale_before_matrix"]
                      else plan["pack_bits"]))
        passes = [(-1, plan["h_res"]), (-2, plan["v_res"])]
        if plan["scale_order"] != "hv":
            passes.reverse()
        for axis, res in passes:
            if res is not None:
                chans = tuple(
                    c if c is None else scaler_mod.scale_axis_exact(
                        xp, c, axis, res, precision=scaler_mod.SCALE_U8,
                        value_bits=bits)
                    for c in chans)
        return chans

    def _matrix(self, xp, chans):
        """The conversion stage (do_convert_lines): optional 8 -> 16
        widening (v*257, video_orc_convert_u8_to_u16), the matrix, 16 -> 8
        narrowing (>>8, video_orc_convert_u16_to_u8)."""
        plan = self._plan
        in_bits, out_bits = plan["unpack_bits"], plan["pack_bits"]
        if in_bits == 8 and out_bits == 16:
            chans = tuple(c if c is None else _xp.astype(xp, c, "int32") * 257
                          for c in chans)
        chans = color_mod.apply_prepared_planes(xp, chans, plan["matrix"])
        if in_bits == 16 and out_bits == 8:
            chans = tuple(c if c is None else _xp.astype(xp, c, "int32") >> 8
                          for c in chans)
        return chans

    def _downsample(self, xp, chans):
        """The output's chroma downsample: v first, then h
        (MAKE_DOWNSAMPLE_V2 filters lines, then h)."""
        ofmt = self.out_info.finfo
        plan = self._plan
        if not plan["downsample"]:
            return chans
        hc, vc = plan["down_h_cosited"], plan["down_v_cosited"]

        def down(c):
            if ofmt.h_sub[1] == 1:
                dn_v = (chroma_mod.down2_interlaced if plan["interlaced"]
                        else chroma_mod.down2)
                c = dn_v(xp, c, -2, vc)
            elif ofmt.h_sub[1] == 2:
                c = chroma_mod.down4(xp, c, -2, vc)
            if ofmt.w_sub[1] == 1:
                c = chroma_mod.down2(xp, c, -1, hc)
            elif ofmt.w_sub[1] == 2:
                c = chroma_mod.down4(xp, c, -1, hc)
            return c

        a, y, u, v = chans
        return (a, y, down(u), down(v))

    def _matrix_and_downsample(self, xp, chans):
        return self._downsample(xp, self._matrix(xp, chans))

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
        """Dither, dest-rect embed with border fill, then pack."""
        oi = self.out_info
        ofmt = oi.finfo
        plan = self._plan
        _, _, _, _, out_x, out_y, out_w, out_h = plan["rect"]
        if plan["dither"] is not None:
            chans = plan["dither"].apply(xp, chans, out_h, out_w)

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
        plane through the yscale kernel (two plain scale passes when
        GTPU_PALLAS_YSCALE switches it off); chroma runs in the 2-tap
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
        if self._yscale_kernel_on():
            y = ysk.yscale_hv(planes[0], h_res, v_res,
                              precision=scaler_mod.SCALE_U8)
        else:
            y = scaler_mod.scale_axis_exact(
                xp, planes[0], -1, h_res, precision=scaler_mod.SCALE_U8,
                value_bits=8)
            y = scaler_mod.scale_axis_exact(
                xp, y, -2, v_res, precision=scaler_mod.SCALE_U8,
                value_bits=8)
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

    def _yscale_kernel_on(self) -> bool:
        """GTPU_PALLAS_YSCALE gates the luma h+v kernel: on unless the
        variable is set to something other than "1"."""
        return os.environ.get("GTPU_PALLAS_YSCALE", "1") == "1"

    def _chroma_kernel_on(self) -> bool:
        """GTPU_PALLAS_CHROMA gates the chroma420 kernel: on unless the
        variable is set to something other than "1" ("interpret", the
        reference's CPU test mode, counts as "1" here)."""
        return os.environ.get("GTPU_PALLAS_CHROMA", "1") in ("1", "interpret")

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
        tensors there.

        The floyd-steinberg and sierra-lite dithers propagate their error
        pixel by pixel and cannot be vectorized: under such a plan the
        channel planes that reach the dither step make one round trip to
        the host (``VideoDither._apply_serial``) and come back to the
        converter's device.  Unpack, scale, matrix, downsample and pack,
        and every kernel of the route, stay on the device."""
        planes = tuple(torch.as_tensor(p).to(self.device) for p in planes)
        with torch.no_grad():
            return self._pipeline(torch, planes)

    def convert_ref(self, planes):
        """The numpy gold: the same pipeline on the host."""
        return self._pipeline(np, tuple(np.asarray(p) for p in planes))
