"""The host byte layout of the torch port (``from_bytes`` / ``to_bytes`` of
``video/format.py`` and ``audio/format.py``) against the JAX package's.

Video: every one of the 139 formats at two odd sizes.  Random bytes, made
from a seed with numpy, go through both packages' ``from_bytes``: the
planes' dtypes, shapes and values must be equal; then both ``to_bytes`` of
those planes: equal bytes; and the port's round trip ``from_bytes(to_bytes(
planes))`` gives the planes back (not for RGB8P, whose ``to_bytes`` maps
each pixel to the nearest colour of the standard palette).  The tiled NV12
layouts are defined on even sizes: the reference cannot decode them at an
odd size (ROADMAP.md section 3), so they are held at the nearest even sizes.
Audio: every sample format at one and two channels.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.audio import format as jaf
from gstreamer_tpu.video import format as jf
from gstreamer_tpu_torch.audio import format as taf
from gstreamer_tpu_torch.video import format as tf

SIZES = [(23, 11), (37, 9)]
TILED_NV12 = {"NV12_4L4", "NV12_32L32", "NV12_16L32S", "NV12_64Z32",
              "NV12_8L128", "NV12_10BE_8L128"}


def _even(size):
    return tuple(v + (v & 1) for v in size)


def test_every_video_format_is_covered():
    assert list(tf.FORMATS) == list(jf.FORMATS) and len(tf.FORMATS) == 139
    for name in tf.FORMATS:
        for w, h in SIZES:
            assert tf.frame_size(tf.FORMATS[name], w, h) == \
                jf.frame_size(jf.FORMATS[name], w, h)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(tf.FORMATS))
def test_video_bytes_match_reference(name, size):
    w, h = _even(size) if name in TILED_NV12 else size
    fmt, jfmt = tf.format_info(name), jf.format_info(name)
    n = tf.frame_size(fmt, w, h)
    rng = np.random.default_rng(sum(map(ord, name)) + w)
    raw = rng.integers(0, 256, (2, n), dtype=np.uint8)
    ref = jf.from_bytes(jfmt, raw, w, h)
    own = tf.from_bytes(fmt, raw, w, h)
    assert len(own) == len(ref)
    for o, r in zip(own, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        assert np.array_equal(o, r)
    ref_b = jf.to_bytes(jfmt, ref, w, h)
    own_b = tf.to_bytes(fmt, own, w, h)
    assert own_b.dtype == ref_b.dtype == np.uint8
    assert own_b.shape == ref_b.shape and np.array_equal(own_b, ref_b)
    if name != "RGB8P":
        again = tf.from_bytes(fmt, own_b, w, h)
        assert all(np.array_equal(a, o) for a, o in zip(again, own))


def test_one_frame_without_batch_axis():
    fmt, jfmt = tf.format_info("v210"), jf.format_info("v210")
    raw = np.random.default_rng(3).integers(
        0, 256, tf.frame_size(fmt, 50, 3), dtype=np.uint8)
    for o, r in zip(tf.from_bytes(fmt, raw, 50, 3),
                    jf.from_bytes(jfmt, raw, 50, 3)):
        assert o.shape == r.shape and np.array_equal(o, r)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", list(taf.FORMATS))
def test_audio_bytes_match_reference(name, channels):
    fmt, jfmt = taf.format_info(name), jaf.format_info(name)
    assert list(taf.FORMATS) == list(jaf.FORMATS)
    width = 3 if name in ("S24LE", "S24BE", "S18LE") else fmt.width // 8
    rng = np.random.default_rng(sum(map(ord, name)) + channels)
    raw = rng.integers(0, 256, 7 * channels * width, dtype=np.uint8)
    if fmt.is_float:        # finite samples only: NaN payloads compare unequal
        raw = raw.view(np.dtype(jaf._NP_DTYPES[name]))
        raw = np.nan_to_num(raw, posinf=1.0, neginf=-1.0).view(np.uint8)
    ref = jaf.from_bytes(jfmt, raw, channels)
    own = taf.from_bytes(fmt, raw, channels)
    assert own.dtype == ref.dtype and own.shape == ref.shape == (7, channels)
    assert np.array_equal(own, ref)
    back = taf.to_bytes(fmt, own)
    assert np.array_equal(back, jaf.to_bytes(jfmt, ref))
    assert np.array_equal(back, raw)
    # a tensor (the pipeline's samples) gives the same bytes
    native = own.astype(own.dtype.newbyteorder("="))
    assert np.array_equal(taf.to_bytes(fmt, torch.from_numpy(native)), raw)
