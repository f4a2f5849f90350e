"""scaletempo — WSOLA time-stretch that preserves pitch.

Exact port of gstscaletempo.c (gst-plugins-good/gst/audiofx/):
* stride/overlap/search geometry: reinit_buffers (gstscaletempo.c:306):
  frames_stride = ms_stride*rate/1000, frames_overlap =
  frames_stride*percent_overlap, frames_search = ms_search*rate/1000
  (0 when overlap <= 1), queue size = search+stride+overlap frames.
* best_overlap_offset (gstscaletempo.c:153-234): parabolic window
  w[i] = i*(overlap-i) cross-correlated against the queue, frame 0
  excluded; S16 uses the n = 4*(2^31-1)/t^2, >>15 fixed-point window
  and int64 correlation.
* output_overlap (gstscaletempo.c:236-266):
  out[i] = ov[i] - blend[i]*(ov[i]-queue[off+i]); S16 blend table is
  (i*65535)/overlap applied as (blend*(po-pin))>>16.
* stride advance with fractional error carry (gstscaletempo.c:577-585)
  and segment-rate capture with a rate-1.0 downstream rewrite
  (gst_scaletempo_sink_event :667-774).

The per-stride loop is inherently sequential (each output stride picks
a data-dependent offset), but the offset search is vectorized: all
`frames_search` correlations form one (search x overlap-1*C) matvec.
Host element — state (queue/overlap/error) lives across ticks.  A host
copy of the JAX package's ``elements/scaletempo.py``: the samples go to the
host and the output returns to their device.

Deviation (batch model): the reference's read-only "rate" property is
writable here so offline pipelines can set the tempo directly; a
SEGMENT event with rate != 1.0 (Pipeline.seek(rate=...)) overrides it,
exactly like the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..audio.info import AudioInfo
from ..core.buffer import Buffer, host_array
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            register_element)
from .audiofx import device_samples

_CAPS = ("audio/x-raw, format={ S16LE, F32LE, F64LE }, "
         "rate=[1,2147483647], channels=[1,64], layout=interleaved")


@register_element
class Scaletempo(TransformElement):
    FACTORY = "scaletempo"
    DESCRIPTION = "Sync audio tempo with playback rate"
    HOST_ELEMENT = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, _CAPS),
        PadTemplate("src", PadDirection.SRC, _CAPS),
    ]
    PROPERTIES = {
        "rate": (float, 1.0, "playback scale (writable: batch model)"),
        "stride": (int, 30, "stride length in ms"),
        "overlap": (float, 0.2, "overlap as fraction of stride"),
        "search": (int, 14, "search window in ms"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._scale = None
        self._reset_state()

    def _reset_state(self):
        self._queue: Optional[np.ndarray] = None
        self._queued = 0
        self._overlap_buf: Optional[np.ndarray] = None
        self._to_slide = 0
        self._stride_error = 0.0
        self._geom = None

    def start(self):
        self._reset_state()

    def flush(self):
        self._reset_state()

    def set_info(self, incaps, outcaps):
        self._info = AudioInfo.from_caps_structure(incaps[0])
        self._geom = None

    def sink_event(self, pad, event) -> bool:
        from ..core.events import EventType, segment_event

        if event.type == EventType.SEGMENT:
            seg = event.data.get("segment")
            rate = getattr(seg, "rate", 1.0)
            if abs(rate - 1.0) > 1e-10:
                self._scale = abs(rate)
                self._to_slide = 0
                # downstream sees rate 1.0, applied_rate set
                # (gstscaletempo.c:714-715)
                import dataclasses
                seg2 = dataclasses.replace(seg, applied_rate=rate,
                                           rate=1.0)
                return super().sink_event(pad, segment_event(seg2))
            self._scale = None if self._scale is None else 1.0
        return super().sink_event(pad, event)

    # -- geometry ----------------------------------------------------------
    def _geometry(self):
        if self._geom is not None:
            return self._geom
        rate = self._info.rate
        stride = int(self.props["stride"] * rate / 1000.0)
        overlap = int(stride * self.props["overlap"])
        standing = stride - overlap
        search = 0 if overlap <= 1 \
            else int(self.props["search"] * rate / 1000.0)
        qmax = search + stride + overlap
        is_s16 = self._info.format.startswith("S16")
        if overlap >= 1:
            if is_s16:
                blend = ((np.arange(overlap, dtype=np.int64) * 65535)
                         // overlap).astype(np.int64)
            else:
                blend = np.arange(overlap, dtype=np.float64) / overlap
        else:
            blend = None
        if search >= 1:
            i = np.arange(1, overlap, dtype=np.float64)
            if is_s16:
                t = overlap
                n = 8589934588 // (t * t)     # 4*(2^31-1)/t^2
                window = ((np.arange(1, overlap, dtype=np.int64)
                           * (t - np.arange(1, overlap, dtype=np.int64))
                           * n) >> 15).astype(np.int64)
            else:
                window = i * (overlap - i)
        else:
            window = None
        self._geom = (stride, overlap, standing, search, qmax, blend,
                      window, is_s16)
        return self._geom

    # -- core --------------------------------------------------------------
    def _fill_queue(self, x, off):
        """fill_queue (gstscaletempo.c:269): slide then append.
        Returns new input offset."""
        _, _, _, _, qmax, _, _, _ = self._geometry()
        n_in = len(x) - off
        if self._to_slide > 0:
            if self._to_slide < self._queued:
                keep = self._queued - self._to_slide
                self._queue[:keep] = self._queue[
                    self._to_slide:self._queued]
                self._queued = keep
                self._to_slide = 0
            else:
                self._to_slide -= self._queued
                skip = min(self._to_slide, n_in)
                self._queued = 0
                self._to_slide -= skip
                off += skip
                n_in -= skip
        if n_in > 0:
            ncopy = min(qmax - self._queued, n_in)
            self._queue[self._queued:self._queued + ncopy] = \
                x[off:off + ncopy]
            self._queued += ncopy
            off += ncopy
        return off

    def _best_offset(self, search, overlap, window, is_s16):
        """Vectorized best_overlap_offset: correlation against all
        search positions at once (frame 0 excluded)."""
        if search < 1 or overlap <= 1:
            return 0
        if is_s16:
            pre = (window[:, None]
                   * self._overlap_buf[1:].astype(np.int64)) >> 15
            init = -(2 ** 63)
        else:
            pre = window[:, None] * self._overlap_buf[1:]
            init = float(-(2 ** 31))            # G_MININT init quirk
        # windows[k] = queue frames [k+1, k+overlap-1] for k < search
        from numpy.lib.stride_tricks import sliding_window_view
        sw = sliding_window_view(self._queue[1:search + overlap - 1],
                                 (overlap - 1,), axis=0)[:search]
        # sw: (search, C, overlap-1); contract overlap+channels
        corr = np.einsum("kco,oc->k", sw.astype(pre.dtype), pre,
                         optimize=True)
        best, best_off = init, 0
        for k in range(search):
            if corr[k] > best:
                best, best_off = corr[k], k
        return best_off

    def host_process(self, buf: Buffer) -> Optional[Buffer]:
        scale = self._scale if self._scale is not None \
            else self.props["rate"]
        if scale == 1.0:
            return buf
        x = host_array(buf.data)
        (stride, overlap, standing, search, qmax, blend, window,
         is_s16) = self._geometry()
        c = x.shape[-1] if x.ndim == 2 else 1
        x2 = x if x.ndim == 2 else x[:, None]
        if self._queue is None:
            self._queue = np.zeros((qmax, c), x.dtype)
            self._overlap_buf = np.zeros((overlap, c), x.dtype)

        out_chunks = []
        off_in = self._fill_queue(x2, 0)
        while self._queued >= qmax:
            boff = self._best_offset(search, overlap, window, is_s16)
            # blended overlap region
            if overlap >= 1:
                po = self._overlap_buf
                pin = self._queue[boff:boff + overlap]
                if is_s16:
                    o64 = po.astype(np.int64)
                    seg = (o64 - ((blend[:, None]
                                   * (o64 - pin.astype(np.int64)))
                                  >> 16)).astype(x.dtype)
                else:
                    seg = (po - blend[:, None] * (po - pin)) \
                        .astype(x.dtype)
                out_chunks.append(seg)
            out_chunks.append(
                self._queue[boff + overlap:boff + stride].copy())
            # input stride: stash next overlap, schedule slide
            self._overlap_buf = \
                self._queue[boff + stride:boff + stride + overlap].copy()
            to_slide = stride * scale + self._stride_error
            whole = int(to_slide)
            self._to_slide = whole
            self._stride_error = to_slide - whole
            off_in = self._fill_queue(x2, off_in)

        if not out_chunks:
            return None
        out = np.concatenate(out_chunks, axis=0)
        if x.ndim == 1:
            out = out[:, 0]
        rate = self._info.rate
        pts = None
        if buf.pts is not None:
            pts = int(buf.pts / scale)
        return buf.with_(
            data=device_samples(buf, out), pts=pts,
            duration=len(out) * 1_000_000_000 // rate)
