"""Device discovery — GstDeviceMonitor / GstDeviceProvider equivalents.

Reference: subprojects/gstreamer/gst/gstdevicemonitor.c (1035),
gstdeviceprovider.c, gstdevice.c — providers register in the registry
with a factory rank; monitors filter providers by class string and caps
and enumerate Device objects that can create elements.

In the TPU deployment the interesting "devices" are the accelerator
chips and the host; providers enumerate them with caps
describing their compute role.  The API mirrors the reference so
tooling (device listings, auto-selection) ports directly.

A port of the JAX package's ``core/device.py``: ``Device``,
``DeviceProvider``, the registry, ``TestDeviceProvider`` and
``DeviceMonitor`` are copies; ``TpuDeviceProvider`` lists the CUDA cards
through torch.  A provider whose probe fails raises out of
``DeviceMonitor.get_devices`` (the JAX package's monitor skips it
silently).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .caps import Caps


@dataclass
class Device:
    """gst_device: display name, class string, caps, properties."""
    name: str
    device_class: str                  # e.g. "Compute/TPU", "Source/Video"
    caps: Caps
    properties: Dict = field(default_factory=dict)
    _create: Optional[Callable] = None

    def create_element(self, name: Optional[str] = None):
        """gst_device_create_element."""
        if self._create is None:
            raise NotImplementedError(f"{self.name}: no element factory")
        return self._create(name)

    def has_classes(self, classes: str) -> bool:
        """gst_device_has_classes: every '/'-separated class must match."""
        mine = self.device_class.split("/")
        return all(c in mine for c in classes.split("/") if c)


class DeviceProvider:
    """gst_device_provider: enumerates devices of one kind."""

    FACTORY = ""
    KLASS = ""

    def probe(self) -> List[Device]:
        raise NotImplementedError


_PROVIDERS: Dict[str, type] = {}


def register_device_provider(cls):
    _PROVIDERS[cls.FACTORY] = cls
    return cls


@register_device_provider
class TpuDeviceProvider(DeviceProvider):
    """Enumerates the accelerator devices (the framework's equivalent of
    v4l2/pulse hardware providers).  The JAX package lists
    ``jax.devices()``; the port lists what that gives on the same machine:
    each CUDA card as ``gpu:<i>``, or, without one, the host as ``cpu:0``.
    A listing only: nothing runs on the CPU because of it.  The registry
    key and ``KLASS`` stay the JAX package's, so code written against it
    finds this provider."""
    FACTORY = "tpudeviceprovider"
    KLASS = "Compute/TPU"

    def probe(self) -> List[Device]:
        import torch

        if torch.cuda.is_available():
            found = [("gpu", i, torch.device("cuda", i),
                      lambda i=i: torch.cuda.memory_stats(i))
                     for i in range(torch.cuda.device_count())]
        else:
            found = [("cpu", 0, torch.device("cpu"), lambda: {})]
        out = []
        for platform, i, dev, stats in found:
            caps = Caps.from_string(
                f"compute/x-accelerator, platform={platform}, id={i}")
            out.append(Device(
                name=f"{platform}:{i}",
                device_class=f"Compute/{platform.upper()}",
                caps=caps,
                properties={"device": dev, "memory_stats": stats},
            ))
        return out


@register_device_provider
class TestDeviceProvider(DeviceProvider):
    """Synthetic source devices (videotestsrc/audiotestsrc), mirroring
    how the reference ships a test provider for CI."""
    FACTORY = "testdeviceprovider"
    KLASS = "Source"

    def probe(self) -> List[Device]:
        from .element import element_factory_make

        def mk(factory):
            return lambda name=None: element_factory_make(factory,
                                                          name=name)

        return [
            Device("Video test source", "Source/Video",
                   Caps.from_string("video/x-raw"),
                   _create=mk("videotestsrc")),
            Device("Audio test source", "Source/Audio",
                   Caps.from_string("audio/x-raw"),
                   _create=mk("audiotestsrc")),
        ]


class DeviceMonitor:
    """gst_device_monitor: class/caps-filtered device enumeration."""

    def __init__(self):
        self._filters: List = []   # (classes | None, caps | None)
        self.started = False

    def add_filter(self, classes: Optional[str] = None,
                   caps: Optional[Caps] = None) -> int:
        self._filters.append((classes, caps))
        return len(self._filters)

    def start(self):
        self.started = True

    def stop(self):
        self.started = False

    def get_devices(self) -> List[Device]:
        devices: List[Device] = []
        for cls in _PROVIDERS.values():
            devices.extend(cls().probe())
        if not self._filters:
            return devices
        out = []
        for d in devices:
            for classes, caps in self._filters:
                if classes and not d.has_classes(classes):
                    continue
                if caps is not None and not d.caps.can_intersect(caps):
                    continue
                out.append(d)
                break
        return out
