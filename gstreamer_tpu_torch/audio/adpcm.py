"""ADPCM codecs — exact ports of gst-plugins-bad/gst/adpcmdec/ and
adpcmenc/ (themselves after libsndfile):

* IMA/DVI decode (adpcmdec.c:273-331): per-channel 4-byte block
  header (predictor sample, step index, zero sync byte), nibbles in
  8-sample per-channel chunks, diff = (2*(code&7)*step + step)/8 with
  sign bit 8, step index clamped to [0, 88].
* MS decode (adpcmdec.c:179-255): block predictor 0-6, idelta
  adaptation table, two warmup samples per channel.
* IMA/DVI encode (adpcmenc.c:239-341): successive-approximation
  nibble search with vpdiff accumulation; the step index carries
  ACROSS blocks (adpcmenc.c:176-178), each block's header holds the
  first raw sample.

All state machines are inherently sequential per channel; blocks are
processed with plain Python ints (exact C semantics, incl. the
truncating /8).

A copy of the JAX package's ``audio/adpcm.py`` (numpy and plain Python
ints on the host).
"""

from __future__ import annotations

from typing import List

import numpy as np

IMA_INDEX_ADJUST = [-1, -1, -1, -1, 2, 4, 6, 8,
                    -1, -1, -1, -1, 2, 4, 6, 8]

IMA_STEP_SIZE = [
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34,
    37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143,
    157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494,
    544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552,
    1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428,
    4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487,
    12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086,
    29794, 32767]

MS_ADAPTATION = [230, 230, 230, 230, 307, 409, 512, 614,
                 768, 614, 512, 409, 307, 230, 230, 230]
MS_COEFF1 = [256, 512, 0, 192, 240, 460, 392]
MS_COEFF2 = [0, -256, 0, 64, 0, -208, -232]


def _clamp16(v: int) -> int:
    return max(-32768, min(32767, v))


def ima_samples_per_block(blocksize: int, channels: int) -> int:
    """adpcmenc.c:156-159."""
    sample_bytes = blocksize - 4 * channels
    return (sample_bytes * 2) // channels + 1


def decode_ima_block(data: bytes, channels: int) -> np.ndarray:
    """-> (n_samples_per_channel, channels) int16
    (adpcmdec_decode_ima_block)."""
    blocksize = len(data)
    n_samples = ima_samples_per_block(blocksize, channels) * channels
    samples = np.zeros(n_samples, np.int64)
    stepindex = [0, 0]
    for ch in range(channels):
        samples[ch] = int.from_bytes(data[ch * 4:ch * 4 + 2], "little",
                                     signed=True)
        stepindex[ch] = min(data[ch * 4 + 2], 88)
        if data[ch * 4 + 3] != 0:
            raise ValueError("adpcm: synchronisation error")
    i = channels
    idx = 4 * channels
    while i < n_samples:
        for ch in range(channels):
            sample = i + ch
            for j in range(8):
                if j % 2 == 0:
                    code = data[idx] & 0x0F
                else:
                    code = (data[idx] >> 4) & 0x0F
                    idx += 1
                step = IMA_STEP_SIZE[stepindex[ch]]
                diff = (2 * (code & 0x7) * step + step) // 8
                if code & 8:
                    diff = -diff
                samples[sample] = _clamp16(
                    int(samples[sample - channels]) + diff)
                stepindex[ch] = max(0, min(88, stepindex[ch]
                                           + IMA_INDEX_ADJUST[code]))
                sample += channels
        i += 8 * channels
    return samples.reshape(-1, channels).astype(np.int16)


def decode_ms_block(data: bytes, channels: int) -> np.ndarray:
    """-> (n, channels) int16 (adpcmdec_decode_ms_block)."""
    blocksize = len(data)
    if channels == 1:
        n_samples = (blocksize - 7) * 2 + 2
    else:
        n_samples = (blocksize - 14) * 2 + 4     # total, both channels
    samples = np.zeros(n_samples, np.int64)

    def rd(o):
        return int.from_bytes(data[o:o + 2], "little", signed=True)

    if channels == 1:
        pred = [data[0], 0]
        idelta = [rd(1), 0]
        samples[1] = rd(3)
        samples[0] = rd(5)
        idx, i = 7, 2
    else:
        pred = [data[0], data[1]]
        idelta = [rd(2), rd(4)]
        samples[2] = rd(6)
        samples[3] = rd(8)
        samples[0] = rd(10)
        samples[1] = rd(12)
        idx, i = 14, 4
    if any(p < 0 or p > 6 for p in pred[:channels]):
        raise ValueError("adpcm: invalid block predictor")
    while i < n_samples:
        ch = i % channels
        if i % 2 == 0:
            code = (data[idx] >> 4) & 0x0F
        else:
            code = data[idx] & 0x0F
            idx += 1
        delta = idelta[ch]
        idelta[ch] = (MS_ADAPTATION[code] * delta) >> 8
        if idelta[ch] < 16:
            idelta[ch] = 16
        if code & 0x8:
            code -= 0x10
        predict = ((int(samples[i - channels]) * MS_COEFF1[pred[ch]])
                   + (int(samples[i - 2 * channels])
                      * MS_COEFF2[pred[ch]])) >> 8
        samples[i] = _clamp16(code * delta + predict)
        i += 1
    return samples.reshape(-1, channels).astype(np.int16)


class ImaEncoder:
    """Streaming IMA encoder; step index carries across blocks
    (adpcmenc.c:176-178)."""

    def __init__(self, channels: int, blocksize: int = 1024):
        self.channels = channels
        self.blocksize = blocksize
        self.step_index = [0, 0]
        self.samples_per_block = ima_samples_per_block(blocksize,
                                                       channels)

    def _encode_sample(self, sample: int, prev: List[int],
                       ch: int) -> int:
        diff = sample - prev[ch]
        step = IMA_STEP_SIZE[self.step_index[ch]]
        vpdiff = step >> 3
        code = 0
        if diff < 0:
            diff = -diff
            code = 0x8
        mask = 0x4
        while mask > 0:
            if diff >= step:
                code |= mask
                diff -= step
                vpdiff += step
            step >>= 1
            mask >>= 1
        if code & 8:
            vpdiff = -vpdiff
        prev[ch] = _clamp16(prev[ch] + vpdiff)
        self.step_index[ch] = max(
            0, min(88, self.step_index[ch] + IMA_INDEX_ADJUST[code]))
        return code

    def encode_block(self, samples: np.ndarray) -> bytes:
        """samples: (samples_per_block, channels) int16 -> one block."""
        ch_n = self.channels
        flat = samples.astype(np.int64).ravel()
        out = bytearray(self.blocksize)
        prev = [0, 0]
        for ch in range(ch_n):
            w = ch * 4
            s0 = int(flat[ch])
            out[w] = s0 & 0xFF
            out[w + 1] = (s0 >> 8) & 0xFF
            out[w + 2] = self.step_index[ch]
            out[w + 3] = 0
            prev[ch] = s0
        write_pos = 4 * ch_n
        read_pos = ch_n
        while write_pos < self.blocksize:
            for ch in range(ch_n):
                base = read_pos + ch
                chunk = 0
                while chunk < 8:
                    a = self._encode_sample(
                        int(flat[base + chunk * ch_n]), prev, ch)
                    chunk += 1
                    b = self._encode_sample(
                        int(flat[base + chunk * ch_n]), prev, ch)
                    chunk += 1
                    out[write_pos] = (a & 0x0F) | ((b << 4) & 0xF0)
                    write_pos += 1
            read_pos += 8 * ch_n
        return bytes(out)
