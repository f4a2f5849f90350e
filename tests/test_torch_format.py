"""unpack_planes / pack_planes of the torch port against the JAX package's,
for every name in FORMATS.

One case a format: random stored values within each component's depth
(left-justified where the container is), made from a seed with numpy, go
through the reference's functions under numpy and the port's under numpy and
under torch (CPU tensors).  Held: the dtypes (uint8 planes for an 8-bit
container, uint16 for a 16-bit one; int32 channels for a 16-bit container),
the shapes and every value.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

from gstreamer_tpu.video import format as jf
from gstreamer_tpu_torch.video import format as tf

W, H = 22, 10


def stored_planes(finfo, shapes, batch, rng):
    """Random component planes as a source would store them."""
    out = []
    for i, s in enumerate(shapes):
        c = 3 if (finfo.has_alpha and i == len(shapes) - 1) else i
        d = finfo.depth[c] if c < len(finfo.depth) else finfo.depth[0]
        v = rng.integers(0, 1 << d, tuple(batch) + tuple(s))
        if finfo.bits == 16:
            if finfo.justify == "high" and d < 16:
                v = v << (16 - d)
            out.append(v.astype(np.uint16))
        else:
            out.append(v.astype(np.uint8))
    return tuple(out)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_format_tables_agree():
    assert list(tf.FORMATS) == list(jf.FORMATS)
    for name in tf.FORMATS:
        assert tf.plane_shapes(tf.FORMATS[name], W, H) == \
            jf.plane_shapes(jf.FORMATS[name], W, H)


@pytest.mark.parametrize("name", list(tf.FORMATS))
def test_unpack_and_pack_match_reference(name):
    fmt, jfmt = tf.format_info(name), jf.format_info(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    planes = stored_planes(fmt, tf.plane_shapes(fmt, W, H), (2,), rng)
    ref = jf.unpack_planes(np, jfmt, planes, W, H)
    own_np = tf.unpack_planes(np, fmt, planes, W, H)
    own = tf.unpack_planes(torch, fmt,
                           tuple(torch.as_tensor(p) for p in planes), W, H)
    for r, o, on in zip(ref, own, own_np):
        assert o.dtype == torch.int32 and on.dtype == np.int32
        assert tuple(o.shape) == r.shape == on.shape == (2, H, W)
        assert np.array_equal(o.numpy(), r) and np.array_equal(on, r)

    # pack what was unpacked: the stored bytes come back wherever the
    # format keeps every bit, and in any case equal the reference's
    ref_p = jf.pack_planes(np, jfmt, ref, W, H)
    own_p = tf.pack_planes(torch, fmt, own, W, H)
    own_p_np = tf.pack_planes(np, fmt, own_np, W, H)
    want = np.uint16 if fmt.bits == 16 else np.uint8
    assert len(own_p) == len(ref_p) == len(planes)
    for r, o, on, p in zip(ref_p, own_p, own_p_np, planes):
        assert _np(o).dtype == on.dtype == r.dtype == want
        assert _np(o).shape == r.shape == p.shape
        assert np.array_equal(_np(o), r) and np.array_equal(on, r)


@pytest.mark.parametrize("name", ["I420", "NV12", "YUV9", "Y41B", "I420_10LE",
                                  "P010_10LE"])
def test_unpack_options_match_reference(name):
    fmt, jfmt = tf.format_info(name), jf.format_info(name)
    rng = np.random.default_rng(5)
    planes = stored_planes(fmt, tf.plane_shapes(fmt, W, H), (1,), rng)
    tplanes = tuple(torch.as_tensor(p) for p in planes)
    for kw in ({"subsampled_chroma": True}, {"interlaced": True}):
        ref = jf.unpack_planes(np, jfmt, planes, W, H, dtype=np.int16, **kw)
        own = tf.unpack_planes(torch, fmt, tplanes, W, H, dtype="int16", **kw)
        own_np = tf.unpack_planes(np, fmt, planes, W, H, dtype="int16", **kw)
        for r, o, on in zip(ref, own, own_np):
            assert str(o.dtype) == "torch." + str(r.dtype) == \
                "torch." + str(on.dtype)
            assert np.array_equal(o.numpy(), r) and np.array_equal(on, r)


def test_sixteen_bit_planes_take_int32_tensors_too():
    # the dtype contract: a 16-bit container's planes may arrive as uint16
    # (numpy or torch) or as int32 tensors of the same values
    fmt = tf.format_info("I420_10LE")
    rng = np.random.default_rng(6)
    planes = stored_planes(fmt, tf.plane_shapes(fmt, W, H), (), rng)
    a = tf.unpack_planes(torch, fmt,
                         tuple(torch.as_tensor(p) for p in planes), W, H)
    b = tf.unpack_planes(
        torch, fmt,
        tuple(torch.as_tensor(p.astype(np.int32)) for p in planes), W, H)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == torch.int32 and torch.equal(x, y)
    packed = tf.pack_planes(torch, fmt, a, W, H)
    assert all(p.dtype == torch.uint16 for p in packed)


def test_pack_and_unpack_channel_last():
    fmt, jfmt = tf.format_info("Y42B"), jf.format_info("Y42B")
    rng = np.random.default_rng(7)
    planes = stored_planes(fmt, tf.plane_shapes(fmt, W, H), (2,), rng)
    ref = jf.unpack(np, jfmt, planes, W, H)
    own = tf.unpack(torch, fmt, tuple(torch.as_tensor(p) for p in planes),
                    W, H)
    assert np.array_equal(own.numpy(), ref)
    for r, o in zip(jf.pack(np, jfmt, ref, W, H),
                    tf.pack(torch, fmt, own, W, H)):
        assert np.array_equal(o.numpy(), r)
