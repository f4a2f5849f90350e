"""The port's SMPTE masks, smpte, smptealpha and shapewipe against the JAX
package, bit for bit (tolerance 0), on the CPU."""

import numpy as np
import pytest

from gstreamer_tpu.video import smpte_mask as jmask

from gstreamer_tpu_torch.video import smpte_mask as tmask

from test_torch_compositor import planes, run_both

DUR10 = 100_000_000         # ns per frame at 10/1


@pytest.mark.parametrize("mask_type", jmask.MASK_TYPES)
def test_mask_copy_matches_reference(mask_type):
    assert tmask.MASK_TYPES == jmask.MASK_TYPES
    assert tmask.MASK_NAMES == jmask.MASK_NAMES
    for invert, depth in ((False, 16), (True, 8)):
        want = jmask.mask_factory_new(mask_type, invert, depth, 64, 48)
        got = tmask.mask_factory_new(mask_type, invert, depth, 64, 48)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _smpte_desc(props, w, h, fmt="I420"):
    return (f"smpte name=s {props} ! appsink name=out "
            f"appsrc name=a caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=10/1 ! s.sink_0 "
            f"appsrc name=b caps=video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=10/1 ! s.sink_1")


def _pushes(names, fmt, w, h, batch, ticks):
    return {n: [dict(data=planes(fmt, w, h, batch, 100 * k + t),
                     pts=t * batch * DUR10, duration=DUR10, batch=batch)
                for t in range(ticks)]
            for k, n in enumerate(names)}


@pytest.mark.parametrize("props", [
    "type=1 duration=1000000000",
    "type=2 border=2000 duration=700000000",
    "type=bar-wipe-lr duration=500000000 invert=true",
    "type=23 depth=8 border=20 duration=1000000000",
    "type=41 duration=1300000000",
])
def test_smpte_runs_past_its_duration(props):
    """Four ticks of batch 4 at 10/1: the transition ends inside the run
    and the later frames show the second input."""
    tpipe, out = run_both(_smpte_desc(props, 33, 18),
                          _pushes("ab", "I420", 33, 18, 4, 4), batch=4)
    assert not tpipe._fused and len(out["out"]) == 4


def test_smpte_videotestsrc_transition():
    """tests/test_smpte.py's string: black to white over 10 frames."""
    _, out = run_both(
        "smpte name=s type=1 border=0 duration=1000000000 ! appsink name=out "
        "videotestsrc pattern=black num-buffers=12 ! "
        "video/x-raw,format=I420,width=32,height=16,framerate=10/1 ! s.sink_0 "
        "videotestsrc pattern=white num-buffers=12 ! "
        "video/x-raw,format=I420,width=32,height=16,framerate=10/1 ! s.sink_1",
        batch=4)
    first, last = out["out"][0].buffer.data[0], out["out"][-1].buffer.data[0]
    assert int(first[0].max()) == 16 and int(last[-1].min()) == 235


@pytest.mark.parametrize("fmt", ["AYUV", "BGRA"])
@pytest.mark.parametrize("position", [0.0, 0.3, 0.5, 1.0])
def test_smptealpha(fmt, position):
    props = f"type=3 position={position} border=4000"
    tpipe, out = run_both(
        f"appsrc name=in caps=video/x-raw,format={fmt},width=40,height=24,"
        f"framerate=30/1 ! smptealpha {props} ! appsink name=out",
        _pushes(["in"], fmt, 40, 24, 2, 2), batch=2)
    assert not tpipe._fused


def _wipe_desc(position, border, fmt, w, h):
    return (f"appsrc name=v caps=video/x-raw,format=AYUV,width={w},"
            f"height={h},framerate=30/1 ! "
            f"shapewipe name=s position={position} border={border} ! "
            f"appsink name=out "
            f"appsrc name=m ! video/x-raw,format={fmt},width={w},"
            f"height={h},framerate=30/1 ! s.mask_sink")


def test_shapewipe_in_the_per_element_path():
    """shapewipe with videorate after it (per-element path)."""
    rng = np.random.default_rng(12)
    w, h, n = 24, 16, 2
    desc = _wipe_desc(0.4, 0.2, "GRAY8", w, h).replace(
        "! appsink name=out", "! videorate ! appsink name=out")
    pushes = {"v": [dict(data=planes("AYUV", w, h, n, 6 + t),
                         pts=t * n * 33333333, duration=33333333, batch=n)
                    for t in range(2)],
              "m": [dict(data=[rng.integers(0, 256, (n, h, w),
                                            dtype=np.uint8)],
                         pts=t * n * 33333333, duration=33333333, batch=n)
                    for t in range(2)]}
    tpipe, out = run_both(desc, pushes, batch=n)
    assert not tpipe._fused and len(out["out"]) == 2


@pytest.mark.parametrize("mask_fmt", ["GRAY8", "GRAY16_LE"])
@pytest.mark.parametrize("position,border", [
    (0.0, 0.0), (0.0, 0.2), (0.4, 0.0), (0.4, 0.3), (1.0, 0.0), (1.0, 0.1),
    (0.5, 1.0), (0.97, 0.1)])
def test_shapewipe(mask_fmt, position, border):
    rng = np.random.default_rng(11)
    w, h, n = 24, 16, 2
    if mask_fmt == "GRAY8":
        mask = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    else:
        mask = rng.integers(0, 65536, (n, h, w)).astype(np.uint16)
    pushes = {"v": [dict(data=planes("AYUV", w, h, n, 5), pts=0,
                         duration=33333333, batch=n)],
              "m": [dict(data=[mask], pts=0, duration=33333333, batch=n)]}
    tpipe, out = run_both(_wipe_desc(position, border, mask_fmt, w, h),
                          pushes, batch=n)
    assert tpipe._fused
    data = out["out"][0].buffer.data
    for k in range(3):            # colour passes through
        assert np.array_equal(data[k].numpy(), pushes["v"][0]["data"][k])
