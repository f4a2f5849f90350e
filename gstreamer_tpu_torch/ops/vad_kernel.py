"""removesilence's VAD power recursion: CUDA kernel, plain version, count.

Replaces the jitted ``lax.scan`` of
``gstreamer_tpu/elements/removesilence.py`` (``Vad._power_fn``, :62-72,
run at :76-77; Pallas has no counterpart).  Per sample (vad_private.c
:124-127), in unsigned 64-bit integers:

  u  = ((s * s) >> 14) & 0xFFFF
  p' = 0x0800*u + 0xF7FF*(p >> 16) + ((0xF7FF*(p & 0xFFFF)) >> 16)

The value stays below 2^33 from any real state (the plain version's int64
holds it), and once below 2^32 it stays there: p' <= 0x0800*65535 +
((0xF7FF*(2^32-1)) >> 16) = 4 294 899 711.  While p < 2^48 the last two
terms are (0xF7FF*p) >> 16 exactly (p = 2^16*h + l).

The kernel is ``csrc/vad.cu``, one warp a stream: the warp computes
0x0800*u for a tile of samples into shared memory from 16-byte loads, then
lane 0 carries p through the tile in three phases, each a prefix of the
loop — the split form while p >= 2^48, (0xF7FF*p) >> 16 in 64 bits while
p >= 2^32, then one ``mad.hi.u32`` a sample (the high word of
p * 0xF7FF0000, plus 0x0800*u).  Exact for 0 <= p0 < 2^63.

Bound on the H100: latency.  Two bytes in a sample; the chain through p,
one multiply-high-add a sample in the 32-bit phase, is what limits it.
"""

from __future__ import annotations

import torch

from . import _build

ALPHA = 0x0800
NALPHA = 0xFFFF - ALPHA


def _check_args(samples: torch.Tensor, p0: torch.Tensor) -> None:
    if samples.dtype != torch.int16 or samples.dim() != 2:
        raise ValueError("vad_power: needs (streams, n) int16 samples, got "
                         f"{tuple(samples.shape)} {samples.dtype}")
    if p0.dtype != torch.int64 or tuple(p0.shape) != (samples.shape[0],):
        raise ValueError(f"vad_power: needs ({samples.shape[0]},) int64 "
                         f"powers, got {tuple(p0.shape)} {p0.dtype}")
    if p0.device != samples.device:
        raise ValueError("vad_power: samples and powers on different "
                         f"devices ({samples.device}, {p0.device})")


def vad_power_plain(samples: torch.Tensor, p0: torch.Tensor) -> torch.Tensor:
    """The plain version: a torch loop over the samples in int64."""
    _check_args(samples, p0)
    s = samples.to(torch.int32)
    au = (((s * s) >> 14) & 0xFFFF).to(torch.int64) * ALPHA
    p = p0.clone()
    for a in au.unbind(1):
        p = a + NALPHA * (p >> 16) + ((NALPHA * (p & 0xFFFF)) >> 16)
    return p


def vad_power(samples: torch.Tensor, p0: torch.Tensor) -> torch.Tensor:
    """(streams, n) int16 samples and (streams,) int64 powers before them
    -> (streams,) int64 powers after them.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream (without synchronising) or raises."""
    if samples.device.type == "cpu":
        return vad_power_plain(samples, p0)
    if samples.device.type != "cuda":
        raise ValueError(f"vad_power: unsupported device {samples.device}")
    _check_args(samples, p0)
    if not (samples.is_contiguous() and p0.is_contiguous()):
        raise ValueError("vad_power: the tensors must be contiguous")
    streams, n = samples.shape
    if n == 0 or streams == 0:
        return p0.clone()
    out = torch.empty_like(p0)
    lib, fn = _build.function("vad", "gst_vad_power", "pppiip")
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(samples.data_ptr(), p0.data_ptr(), out.data_ptr(),
                    streams, n, stream)
    _build.check(lib, status, "vad_power")
    vad_power.launches += 1
    return out


vad_power.launches = 0
