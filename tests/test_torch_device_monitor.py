"""The port's device monitor (``core/device.py``) against the JAX package's:
``tests/test_pipeline.py``'s four monitor cases through both packages, the
test provider's devices, the filters, and the accelerator listing.

Without a card the port lists the host as ``cpu:0``, class
``Compute/CPU``, as ``jax.devices()`` lists it on a CPU-only machine: the
JAX listing is taken in a fresh process with JAX on the CPU and no
virtual devices (this test run's JAX has eight).  With a card the port
lists ``gpu:<i>`` with its memory statistics (marked ``cuda``).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from gstreamer_tpu.core import device as jdevice
from gstreamer_tpu.core.caps import Caps as JCaps

from gstreamer_tpu_torch.core import device as tdevice
from gstreamer_tpu_torch.core.caps import Caps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(devices):
    return [(d.name, d.device_class, str(d.caps)) for d in devices]


def sources(devices):
    return [d for d in devices if not d.device_class.startswith("Compute/")]


def monitor(mod, filters=()):
    mon = mod.DeviceMonitor()
    for f in filters:
        mon.add_filter(**f)
    mon.start()
    devs = mon.get_devices()
    mon.stop()
    return mon, devs


def test_enumerates_devices():
    """An accelerator (Compute/...) and the test sources in both."""
    for mod in (jdevice, tdevice):
        mon, devs = monitor(mod)
        assert any(d.device_class.startswith("Compute/") for d in devs)
        assert any(d.device_class == "Source/Video" for d in devs)
        assert not mon.started
    assert rows(sources(monitor(tdevice)[1])) == \
        rows(sources(monitor(jdevice)[1]))


@pytest.mark.parametrize("classes", ["Source/Video", "Source/Audio",
                                     "Source", "Video", "Compute",
                                     "Sink/Video"])
def test_class_filter(classes):
    j = monitor(jdevice, [dict(classes=classes)])[1]
    t = monitor(tdevice, [dict(classes=classes)])[1]
    assert all(d.has_classes(classes) for d in t)
    assert rows(sources(t)) == rows(sources(j))
    assert any(d.device_class.startswith("Compute/") for d in t) == \
        any(d.device_class.startswith("Compute/") for d in j)


@pytest.mark.parametrize("caps", ["audio/x-raw", "video/x-raw",
                                  "compute/x-accelerator", "image/jpeg"])
def test_caps_filter(caps):
    j = monitor(jdevice, [dict(caps=JCaps.from_string(caps))])[1]
    t = monitor(tdevice, [dict(caps=Caps.from_string(caps))])[1]
    assert rows(sources(t)) == rows(sources(j))
    assert all(caps.split(",")[0] in str(d.caps) for d in t)


def test_two_filters_and_their_ids():
    f = [dict(classes="Source/Video"), dict(caps="audio/x-raw")]
    jmon, tmon = jdevice.DeviceMonitor(), tdevice.DeviceMonitor()
    ids = ([jmon.add_filter(classes=f[0]["classes"]),
            jmon.add_filter(caps=JCaps.from_string(f[1]["caps"]))],
           [tmon.add_filter(classes=f[0]["classes"]),
            tmon.add_filter(caps=Caps.from_string(f[1]["caps"]))])
    assert ids[0] == ids[1] == [1, 2]
    assert rows(tmon.get_devices()) == rows(jmon.get_devices())


@pytest.mark.parametrize("k", [0, 1])
def test_device_creates_element(k):
    """The test devices make videotestsrc / audiotestsrc, and the port's
    element runs a tick on the CPU."""
    from gstreamer_tpu_torch.core.element import element_factory_make
    from gstreamer_tpu_torch.core.pipeline import Pipeline, link
    j = sources(monitor(jdevice, [dict(classes="Source")])[1])[k]
    t = sources(monitor(tdevice, [dict(classes="Source")])[1])[k]
    el = t.create_element(name="src")
    assert el.FACTORY == j.create_element().FACTORY
    assert el.FACTORY == ("videotestsrc", "audiotestsrc")[k]
    el.set_property("num-buffers", 1)
    pipe = Pipeline(device="cpu")
    sink = element_factory_make("appsink", name="out")
    pipe.add(el, sink)
    link(el, sink)
    pipe.run()
    assert sink.pull_sample() is not None


def test_device_without_factory_raises():
    for mod in (jdevice, tdevice):
        d = mod.Device("x", "Source/Video", None)
        with pytest.raises(NotImplementedError, match="x: no element"):
            d.create_element()
        assert d.has_classes("Video") and d.has_classes("Source/Video")
        assert not d.has_classes("Audio")


def test_registry_keys_and_classes():
    assert list(tdevice._PROVIDERS) == list(jdevice._PROVIDERS) == [
        "tpudeviceprovider", "testdeviceprovider"]
    for key in tdevice._PROVIDERS:
        t, j = tdevice._PROVIDERS[key], jdevice._PROVIDERS[key]
        assert (t.FACTORY, t.KLASS) == (j.FACTORY, j.KLASS)


def test_a_failing_provider_raises(monkeypatch):
    """A probe that fails raises out of the port's monitor (the JAX
    package's skips the provider without a word)."""
    class Broken(tdevice.DeviceProvider):
        FACTORY = "broken"

        def probe(self):
            raise RuntimeError("probe failed")
    monkeypatch.setitem(tdevice._PROVIDERS, "broken", Broken)
    with pytest.raises(RuntimeError, match="probe failed"):
        tdevice.DeviceMonitor().get_devices()


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU listing")
def test_cpu_listing_equals_jax():
    """Without a card: what jax.devices() lists on the CPU (a fresh
    process, no virtual devices), name, class and caps; the properties
    name the host and give empty memory statistics."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    code = ("import json, jax; jax.config.update('jax_platforms', 'cpu')\n"
            "from gstreamer_tpu.core.device import TpuDeviceProvider\n"
            "print(json.dumps([(d.name, d.device_class, str(d.caps)) "
            "for d in TpuDeviceProvider().probe()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = [tuple(r) for r in json.loads(out.stdout.strip().splitlines()[-1])]
    got = tdevice.TpuDeviceProvider().probe()
    assert rows(got) == want == [("cpu:0", "Compute/CPU",
                                  "compute/x-accelerator, platform=cpu, "
                                  "id=0")]
    assert got[0].properties["device"] == torch.device("cpu")
    assert got[0].properties["memory_stats"]() == {}


@pytest.mark.cuda
def test_gpu_listing():
    """With cards: gpu:<i>, Compute/GPU, its memory statistics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = tdevice.TpuDeviceProvider().probe()
    assert rows(got) == [
        (f"gpu:{i}", "Compute/GPU",
         f"compute/x-accelerator, platform=gpu, id={i}")
        for i in range(torch.cuda.device_count())]
    stats = got[0].properties["memory_stats"]()
    assert "allocated_bytes.all.current" in stats
    assert got[0].properties["device"] == torch.device("cuda", 0)
