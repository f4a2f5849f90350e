"""The broadcast, subtitle, scope and file host modules on the card: media
stay on it, bitstreams stay host bytes, and the card's output equals the
CPU's (no JAX here: the card's machine has none).

    python -m pytest --noconftest -q tests/test_torch_broadcast_card.py

Every test skips without a card.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from gstreamer_tpu_torch import parse_launch
from gstreamer_tpu_torch.core.buffer import Buffer
from gstreamer_tpu_torch.core.caps import Caps
from gstreamer_tpu_torch.core.element import element_factory_make

pytestmark = pytest.mark.cuda
DUR = 33366666


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n,) + s, dtype=np.uint8)
                 for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))


def run(desc, pushes, dev, batch=4, sinks=("out",)):
    pipe = parse_launch(desc, batch=batch, device=dev)
    for name, bufs in pushes.items():
        src = pipe.get_by_name(name)
        for b in bufs:
            src.push_buffer(Buffer(**dict(b, data=tuple(
                torch.from_numpy(p).to(dev) for p in b["data"])
                if isinstance(b["data"], tuple) else b["data"])))
        src.end_of_stream()
    pipe.run()
    out = {}
    for s in sinks:
        sink, got = pipe.get_by_name(s), []
        while (x := sink.pull_sample()) is not None:
            got.append(x)
        out[s] = got
    return pipe, out


def element(factory, dev, **props):
    e = element_factory_make(factory, **props)
    e.device = dev
    return e


@pytest.mark.parametrize("factory", ["timecodestamper", "avwait",
                                     "h264timestamper", "alpha_combine"])
def test_meta_elements_keep_the_card_tensors(cuda, factory):
    planes = tuple(torch.from_numpy(p).to(cuda) for p in frames(2, 24, 32, 0))
    e = element(factory, cuda)
    if factory == "timecodestamper":
        e.set_info(Caps.from_string("video/x-raw,framerate=30/1"), None)
        e.start()
    out = e.host_process(Buffer(data=planes, batch=2, pts=0, duration=DUR))
    assert all(a is b for a, b in zip(out.data, planes))
    assert all(p.is_cuda for p in out.data)


def test_line21_on_the_card(cuda):
    host = frames(4, 48, 96, 1)
    planes = tuple(torch.from_numpy(p).to(cuda) for p in host)
    buf = Buffer(data=planes, batch=4, meta={"closedcaption": (
        "raw", [b"\x94\x2c", b"\x91\xb0"])})
    out = element("line21encoder", cuda).host_process(buf)
    assert out.data[0].is_cuda and out.data[1] is planes[1]
    assert np.array_equal(planes[0].cpu().numpy(), host[0])
    assert np.array_equal(out.data[0][:, 1:].cpu().numpy(), host[0][:, 1:])
    dec = element("line21decoder", cuda).host_process(out)
    assert dec.meta["closedcaption"] == ("raw", [b"\x94\x2c", b"\x91\xb0"])


@pytest.mark.parametrize("desc,kinds", [
    ("assrender name=ov ! appsink name=out appsrc name=v caps=video/x-raw,"
     "format=I420,width=160,height=120,framerate=30/1 ! ov.video appsrc "
     "name=t caps=application/x-ass ! ov.text", "ass"),
    ("appsrc name=v caps=video/x-raw,format=I420,width=160,height=120,"
     "framerate=30/1 ! combdetect ! ivtc ! netsim duplicate-probability=1 ! "
     "appsink name=out", None)])
def test_video_host_elements_card_equals_cpu(cuda, desc, kinds):
    pushes = {"v": [dict(data=frames(4, 120, 160, t), pts=t * 4 * DUR,
                         duration=DUR, batch=4) for t in range(2)]}
    if kinds == "ass":
        doc = ("[Events]\nDialogue: 0,0:00:00.00,0:00:05.00,Default,,0,0,0,,"
               "{\\pos(60,40)}card\n")
        pushes["t"] = [dict(data=np.frombuffer(doc.encode(), np.uint8),
                            pts=0)] * 2
    pipe, out = run(desc, pushes, cuda)
    _, ref = run(desc, pushes, torch.device("cpu"))
    if kinds == "ass":
        assert pipe.get_by_name("t") in pipe._host_fed
    assert len(out["out"]) == len(ref["out"]) > 0
    for o, r in zip(out["out"], ref["out"]):
        assert o.buffer.batch == r.buffer.batch
        for a, b in zip(o.buffer.data, r.buffer.data):
            assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("scope", ["wavescope", "spectrascope", "spacescope",
                                   "synaescope", "monoscope", "goom2k1"])
def test_scopes_card_equals_cpu(cuda, scope):
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 6000, (8000, 2))).astype(np.int16)
    desc = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=8000,"
            f"channels=2,layout=interleaved ! {scope} ! appsink name=out")
    outs = []
    for dev in (cuda, torch.device("cpu")):
        pipe = parse_launch(desc, device=dev)
        pipe.get_by_name("in").push_buffer(Buffer(
            data=torch.from_numpy(x).to(dev), pts=0, duration=10**9))
        pipe.get_by_name("in").end_of_stream()
        pipe.run()
        outs.append(pipe.get_by_name("out").pull_sample().buffer.data)
    ptrs = {p.untyped_storage().data_ptr() for p in outs[0]}
    assert len(ptrs) == 1 and all(p.is_cuda for p in outs[0])
    assert all(torch.equal(a.cpu(), b) for a, b in zip(*outs))


def test_wav_asr_card_equals_cpu(cuda):
    rng = np.random.default_rng(5)
    x = (rng.normal(0, 6000, (48000, 2))).astype(np.int16)
    src = ("appsrc name=in caps=audio/x-raw,format=S16LE,rate=48000,"
           "channels=2,layout=interleaved")
    chain = ("audioconvert ! audio/x-raw,channels=1 ! audioresample ! "
             "audio/x-raw,rate=16000 ! appsink name=out")
    with tempfile.TemporaryDirectory() as tmp:
        got = {}
        for dev in (cuda, torch.device("cpu")):
            path = os.path.join(tmp, f"{dev.type}.wav")
            pipe = parse_launch(f"{src} ! wavenc location={path}", device=dev)
            pipe.get_by_name("in").push_buffer(Buffer(
                data=torch.from_numpy(x).to(dev), pts=0, duration=10**9))
            pipe.get_by_name("in").end_of_stream()
            pipe.run()
            _, out = run(f"wavparse location={path} blocksize=12000 ! "
                         f"{chain}", {}, dev, batch=1)
            assert all(s.buffer.data.device.type == dev.type
                       for s in out["out"])
            got[dev.type] = (open(path, "rb").read(), torch.cat(
                [s.buffer.data.cpu() for s in out["out"]]))
        assert got["cuda"][0] == got["cpu"][0]
        assert torch.equal(got["cuda"][1], got["cpu"][1])
