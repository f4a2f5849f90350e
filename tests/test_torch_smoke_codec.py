"""The port's Smoke codec (``codecs/smoke.py``; ``elements/
smoke_codec_elements.py``: smokeenc, smokedec) against the JAX package.

The codec is a copy over the port's ``codecs/jpeg.py`` (its transforms on
the codec's device, the CPU here).  Seeded frame sequences give the same
packets, byte for byte, and the same decoded planes: key frames, inter
frames with a few changed blocks or none, a frame where every block
changed (promoted to a key frame), at several sizes and settings.  The
elements run the same launch strings in both packages (samples, caps and
bus messages equal, tolerance 0).  One reference fault is not copied: the
JAX package's change test reshapes the whole plane into 16x16 blocks and
raises ``ValueError`` on an inter frame whose width or height is no
multiple of 16; the port tests the whole blocks only, as smokecodec.c does
(``test_smokeenc_unaligned_inter_frame_is_a_reference_fault``).  The JAX
package's ``tests/test_smoke_codec.py`` runs again on the port
(``on_port``); it runs with the audio stack imported (x64 on, as in every
launch string), so the JAX package's JPEG transform runs in float64.
"""

import functools
import struct

import numpy as np
import pytest
import torch

import gstreamer_tpu.audio  # noqa: F401  (x64 on, as in every launch string)
from gstreamer_tpu.codecs import smoke as jsmoke

from gstreamer_tpu_torch.codecs import smoke as tsmoke

import test_smoke_codec
from test_torch_analytics import same_spec
from test_torch_captions import i420, pair, vsrc
from test_torch_flx import sha, vectors
from test_torch_rtp import _CPU_VERSIONS, reference_tests, run_on_port

for _cls in (tsmoke.SmokeEncoder, tsmoke.SmokeDecoder):
    _CPU_VERSIONS[id(_cls)] = functools.partial(_cls, device="cpu")

REFERENCE = reference_tests(test_smoke_codec)


@pytest.mark.parametrize("case", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_reference_tests_on_the_port(case, tmp_path):
    _id, fn, names, values = case
    run_on_port(fn, names, values, tmp_path)


@pytest.mark.parametrize("factory", ["smokeenc", "smokedec"])
def test_factory_spec_matches(factory):
    same_spec(factory)


def sequence(w, h, seed):
    """Seeded frames: a picture, then a few blocks changed, the same
    frame again, small noise under the threshold, a moving patch, then a
    wholly new picture."""
    rng = np.random.default_rng(seed)
    f = [p[0] for p in i420(w, h, 1, seed)]
    out = [tuple(p.copy() for p in f)]
    y = f[0].copy()
    y[0:16, 16:32] = 255 - y[0:16, 16:32]
    y[h - 16:h, w - 16:w] = 0
    out.append((y.copy(), f[1], f[2]))
    out.append((y.copy(), f[1], f[2]))
    n = y.astype(int) + rng.integers(-2, 3, y.shape)
    out.append((np.clip(n, 0, 255).astype(np.uint8), f[1], f[2]))
    for k in range(3):
        z = y.copy()
        z[8 + 4 * k:24 + 4 * k, 4 + 8 * k:36 + 8 * k] = 40 * k
        out.append((z, f[1], f[2]))
    out.append(tuple(p[0] for p in i420(w, h, 1, seed + 1)))
    return out


@pytest.mark.parametrize("w,h,kw", [
    (64, 48, {}), (128, 96, {"keyframe_rate": 3}),
    (48, 32, {"threshold": 100, "qmin": 30, "qmax": 95}),
    (96, 64, {"threshold": 1, "keyframe_rate": 1000}),
    (32, 16, {"qmin": 1, "qmax": 10})])
def test_codec_matches(w, h, kw):
    te = tsmoke.SmokeEncoder(w, h, 30, 1, device="cpu", **kw)
    je = jsmoke.SmokeEncoder(w, h, 30, 1, **kw)
    td, jd = tsmoke.SmokeDecoder(device="cpu"), jsmoke.SmokeDecoder()
    for frame in sequence(w, h, w + h):
        pkt = te.encode(frame)
        assert pkt == je.encode(frame)
        for a, b in zip(td.decode(pkt), jd.decode(pkt)):
            np.testing.assert_array_equal(a, b)
    assert (td.width, td.height, td.fps) == (jd.width, jd.height, jd.fps)


def test_id_packet_and_best_size_match():
    assert tsmoke.encode_id() == jsmoke.encode_id()
    assert [tsmoke.find_best_size(n) for n in range(1, 400)] == \
        [jsmoke.find_best_size(n) for n in range(1, 400)]
    with pytest.raises(ValueError, match="ID packet"):
        tsmoke.SmokeDecoder(device="cpu").decode(tsmoke.encode_id())


@pytest.mark.parametrize("w,h", [(64, 40), (72, 48)])
def test_smokeenc_unaligned_inter_frame_is_a_reference_fault(w, h):
    """A width or height that is no multiple of 16: the JAX package's
    encoder raises on the first inter frame; the port's tests the whole
    16x16 blocks only (smokecodec.c's loop over blocks_w x blocks_h).  Its
    packets are the JAX encoder's of the frames cut to the whole blocks,
    with the header's width and height the uncut ones."""
    frames = sequence(w, h, 7)
    je = jsmoke.SmokeEncoder(w, h, 25, 1)
    je.encode(frames[0])
    with pytest.raises(ValueError, match="reshape"):
        je.encode(frames[1])
    cw, ch = w // 16 * 16, h // 16 * 16
    te = tsmoke.SmokeEncoder(w, h, 25, 1, device="cpu")
    cut = jsmoke.SmokeEncoder(cw, ch, 25, 1)
    td = tsmoke.SmokeDecoder(device="cpu")
    for f in frames:
        pkt = te.encode(f)
        want = bytearray(cut.encode((f[0][:ch, :cw], f[1][:ch // 2, :cw // 2],
                                     f[2][:ch // 2, :cw // 2])))
        struct.pack_into(">HH", want, 1, w, h)
        assert pkt == bytes(want)
        y, _u, _v = td.decode(pkt)
        assert y.shape == (h, w)


SRC = ("videotestsrc num-buffers=6 pattern=ball ! video/x-raw,format=I420,"
       "width=64,height=48,framerate=10/1")


@pytest.mark.parametrize("props", ["", " keyframe=2", " threshold=500",
                                   " qmin=50 qmax=60"])
def test_elements_match(props):
    """smokeenc's packets, then smokedec's planes, from a moving ball."""
    pair(f"{SRC} ! smokeenc{props} ! appsink name=out")
    pair(f"{SRC} ! smokeenc{props} ! smokedec ! appsink name=out")


def test_elements_batches_match():
    """Two seeded frames a push: smokeenc codes each, smokedec gives both
    back in one buffer."""
    pushes = [dict(data=i420(64, 48, 2, k), pts=k * 50_000_000,
                   duration=25_000_000, batch=2) for k in range(3)]
    pair(f"{vsrc(64, 48, rate='40/1')} ! smokeenc ! smokedec ! "
         "appsink name=out", {"in": pushes}, batch=2)



def test_committed_smoke_digest_matches():
    """chip_smoke.py's smoke_camera input (1080p, made with integer
    arithmetic) through the port's smokeenc and smokeenc ! smokedec on the
    CPU: the committed sha256 the card is held to."""
    _d, dig, cs = vectors()
    w, h, n, b = cs.CT_SMOKE
    planes = cs.ct_frames(n, w, h, cs.CT_SEED)
    cpu = torch.device("cpu")
    src = (f"appsrc name=in caps=video/x-raw,format=I420,width={w},"
           f"height={h},framerate=25/1")
    pkts = cs.ct_blobs(cs.codec_run(f"{src} ! smokeenc ! appsink name=a",
                                    cpu, b, "a", {"in": cs.ct_video_pushes(
                                        planes, b, cpu)}))
    assert sha(pkts) == dig["smoke"]["packets"]
    dec = cs.ct_planes(cs.codec_run(
        f"{src} ! smokeenc ! smokedec ! appsink name=a", cpu, b, "a",
        {"in": cs.ct_video_pushes(planes, b, cpu)}))
    assert [sha([p.tobytes() for p in f]) for f in dec] == \
        dig["smoke"]["planes"]
