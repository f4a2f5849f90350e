"""Quantization and dithering for depth reduction.

A copy of the JAX package's ``audio/quantize.py`` (GstAudioQuantize,
reference: gst-libs/gst/audio/audio-quantize.c — dither none/RPDF/TPDF/
TPDF-HF :139-160 with the xorshift64 PRNG :100, bias/mask setup :460-468;
audio_orc_int_dither gstaudiopack.orc:395: d = saturated_add(s,
dither+bias) & ~mask), with ``apply`` on torch tensors.

The PRNG is sequential with explicit state, so dither values are drawn on
the host (``dither_buf``) and added on the tensor's device.  Every call of
``apply`` draws the next values of the sequence, as the C quantizer does
from buffer to buffer.  (The JAX package draws them while ``jax.jit``
traces the element's function, so its jitted pipeline repeats the first
buffer's dither on every buffer of the same size: ROADMAP.md section 3.)
Noise shaping is an exact integer recurrence over the frames and runs on
the host, as in the reference (``_apply_ns``).
"""

from __future__ import annotations

import numpy as np
import torch

DITHER_NONE = "none"
DITHER_RPDF = "rpdf"
DITHER_TPDF = "tpdf"
DITHER_TPDF_HF = "tpdf-hf"

NS_NONE = "none"
NS_ERROR_FEEDBACK = "error-feedback"
NS_SIMPLE = "simple"
NS_MEDIUM = "medium"
NS_HIGH = "high"

M64 = (1 << 64) - 1

# noise shaping coefficient tables (audio-quantize.c:305-329; medium from
# Lipshitz/Vanderkooy/Wannamaker JAES 39(11), high by David Schleef),
# quantized to Q10: floor(c * 1024 + 0.5)  (:364-369)
_NS_SHIFT = 10
_NS_COEFFS = {
    NS_SIMPLE: [-0.5, 1.0],
    NS_MEDIUM: [0.6149, -1.590, 1.959, -2.165, 2.033],
    NS_HIGH: [-0.340122, 0.876066, -1.72008, 2.61339, -3.31399, 3.27918,
              -2.92975, 2.08484],
}
_REDUCE = 8
_RROUND = 1 << (_REDUCE - 1)
_SREDUCE = 2
_SROUND = 1 << (_SREDUCE - 1)

_I32MIN, _I32MAX = -(1 << 31), (1 << 31) - 1


def _addss(a, b):
    """ADDSS saturated int32 add (audio-quantize.c:71)."""
    return np.clip(a + b, _I32MIN, _I32MAX)


class XorShift64:
    """gst_fast_random_uint32 (audio-quantize.c:100): xorshift64, low 32
    bits returned as signed."""

    def __init__(self, seed: int = 0xDEADBEEF):
        # gst seeds from g_random_int; a fixed default keeps runs
        # reproducible (tests can seed explicitly)
        self.state = seed & M64 or 1

    def next_i32(self) -> int:
        x = self.state
        x ^= (x << 13) & M64
        x ^= x >> 17
        x ^= (x << 5) & M64
        self.state = x
        v = x & 0xFFFFFFFF
        return v - (1 << 32) if v >= (1 << 31) else v


class Quantizer:
    def __init__(self, dither: str, shift: int, stride: int,
                 ns: str = NS_NONE, seed: int = 0xDEADBEEF):
        """shift = log2(quantizer) = 32 - out_depth."""
        self.dither = dither
        self.shift = shift
        self.stride = stride
        self.ns = ns
        self.rng = XorShift64(seed)
        self.bias = (1 << (shift - 1)) if shift > 0 else 0
        self.mask = (1 << shift) - 1
        self._last = np.zeros(stride, np.int64)

    def _rand_dither(self, dither: int) -> int:
        return -dither + (self.rng.next_i32() & ((dither << 1) - 1))

    def dither_buf(self, samples: int) -> np.ndarray:
        """Per-sample dither+bias values (host; sequential PRNG)."""
        n = samples * self.stride
        d = np.empty(n, np.int64)
        if self.dither == DITHER_NONE:
            d[:] = self.bias
        elif self.dither == DITHER_RPDF:
            dith = 1 << self.shift
            for i in range(n):
                d[i] = self.bias + self._rand_dither(dith)
        elif self.dither == DITHER_TPDF:
            dith = 1 << (self.shift - 1)
            for i in range(n):
                d[i] = (self.bias + self._rand_dither(dith)
                        + self._rand_dither(dith))
        elif self.dither == DITHER_TPDF_HF:
            dith = 1 << (self.shift - 1)
            for i in range(n):
                tmp = self._rand_dither(dith)
                d[i] = self.bias + tmp - self._last[i % self.stride]
                self._last[i % self.stride] = tmp
        else:
            raise ValueError(f"unknown dither {self.dither!r}")
        return d.reshape(samples, self.stride)

    def apply(self, samples: torch.Tensor, dither_arr=None) -> torch.Tensor:
        """samples: (..., frames, channels) int32 -> quantized int32.

        out = saturated_add(s, dither) & ~mask (audio_orc_int_dither);
        with noise shaping the sequential error recurrences of
        quantize_int_dither_feedback (:200) / _noise_shape (:240) run on
        the host (channels vectorized, frames recurrent) and the result
        returns to the samples' device."""
        if self.shift == 0:
            return samples
        if self.ns != NS_NONE:
            out = self._apply_ns(samples.cpu().numpy())
            return torch.from_numpy(out).to(samples.device)
        if dither_arr is None:
            if self.dither == DITHER_NONE:
                dither_arr = self.bias
            else:
                dither_arr = torch.as_tensor(
                    self.dither_buf(samples.shape[-2]), device=samples.device)
        acc = samples.to(torch.int64) + dither_arr
        acc = torch.clamp(acc, -(1 << 31), (1 << 31) - 1)  # addssl saturation
        return (acc & ~self.mask).to(torch.int32)

    def _apply_ns(self, samples: np.ndarray) -> np.ndarray:
        """Noise-shaped quantization, exact integer recurrence (numpy).

        error-feedback (:200): err = dith - e; v = sat(s+err) & ~mask;
            e' = e + (v - orig)
        simple/medium/high (:240): err = (-(sum e[j]*c[j]) + 2) >> 2;
            v = sat(s+err); o = v; v = sat(v+dith) & ~mask;
            e_new = (v - o + 128) >> 8
        """
        shape = samples.shape
        frames, ch = shape[-2], shape[-1]
        flat = samples.astype(np.int64).reshape((-1, frames, ch))
        out = np.empty_like(flat)
        nmask = ~np.int64(self.mask)
        for b in range(flat.shape[0]):
            dith = self.dither_buf(frames).astype(np.int64)   # (frames, ch)
            s = flat[b]
            if self.ns == NS_ERROR_FEEDBACK:
                e = np.zeros(ch, np.int64)
                for i in range(frames):
                    o = s[i]
                    v = _addss(o, dith[i] - e)
                    v = v & nmask
                    e = e + (v - o)
                    out[b, i] = v
            else:
                c = np.array([int(np.floor(x * (1 << _NS_SHIFT) + 0.5))
                              for x in _NS_COEFFS[self.ns]], np.int64)
                nc = len(c)
                e = np.zeros((nc, ch), np.int64)   # sliding error window
                for i in range(frames):
                    err = -(e * c[:, None]).sum(axis=0)
                    err = (err + _SROUND) >> _SREDUCE
                    v = _addss(s[i], err)
                    o = v.copy()
                    v = _addss(v, dith[i])
                    v = v & nmask
                    enew = (v - o + _RROUND) >> _REDUCE
                    e = np.concatenate([e[1:], enew[None]], axis=0)
                    out[b, i] = v
        return out.reshape(shape).astype(np.int32)
