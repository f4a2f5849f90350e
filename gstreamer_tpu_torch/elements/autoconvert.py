"""switchbin / autoconvert / autovideoconvert — caps-driven element
selection.

References:
* gst-plugins-bad/gst/switchbin/gstswitchbin.c: N (caps, element)
  paths; the first path whose caps intersect the input caps is
  selected (gst_switch_bin_select_path_for_caps), a path with no
  element is passthrough, `current-path` exposes the selection.
* gst-plugins-bad/gst/autoconvert/gstautoconvert.c: picks the first
  factory from `factories` whose sink template caps accept the input
  caps and swaps it in.
* gstautovideoconvert.c: autoconvert preloaded with the video
  converter factories.

Copies of the JAX package's ``elements/autoconvert.py`` classes.
Selection is a NEGOTIATION-TIME decision: by the time the pipeline
compiles, the chosen inner element (one of this package's, made from its
registry) is fixed and takes the pipeline's device, so the step runs
exactly the torch function the inner element would have made (no runtime
dispatch on the hot path).  The proxy forwards caps transforms, device
functions, host processing and EOS draining to the selected element.

Path syntax for launch lines (the reference uses GstChildProxy
`path0::caps=...` which our parser does not model):
  switchbin paths="audio/x-raw->volume,volume=0.5|ANY->"
i.e. `caps->factory,prop=val,...` joined by `|`; empty factory =
passthrough.  `autoconvert factories=videoflip,videoconvert`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.element import (PadDirection, PadTemplate, TransformElement,
                            element_factory_make, register_element)


def _make_inner(desc: str) -> Optional[TransformElement]:
    desc = desc.strip()
    if not desc:
        return None
    parts = desc.split(",")
    elem = element_factory_make(parts[0].strip())
    for kv in parts[1:]:
        k, _, v = kv.partition("=")
        if k:
            elem.set_property(k.strip(), v.strip())
    return elem


class _ProxyTransform(TransformElement):
    """Delegates the element hooks to a negotiation-selected inner."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, Caps.any()),
        PadTemplate("src", PadDirection.SRC, Caps.any()),
    ]

    def __init__(self, name=None, **props):
        super().__init__(name=name, **props)
        self._inner: Optional[TransformElement] = None
        self._started = False

    # subclasses: pick (and cache) the inner element for these caps
    def _select_for_caps(self, caps: Caps) -> None:
        raise NotImplementedError

    # -- hook forwarding ---------------------------------------------------
    @property
    def HOST_ELEMENT(self):                      # noqa: N802
        return bool(self._inner is not None
                    and getattr(self._inner, "HOST_ELEMENT", False))

    @property
    def _decouple(self):
        return bool(self._inner is not None
                    and getattr(self._inner, "_decouple", False))

    @property
    def _pending_buf(self):
        if self._decouple:
            return self._inner._pending_buf
        return None

    def transform_caps(self, direction, caps, filter=None):
        if direction == PadDirection.SINK:
            self._select_for_caps(caps)
        if self._inner is not None:
            return self._inner.transform_caps(direction, caps, filter)
        res = caps
        if filter is not None and not res.is_any:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction, caps, othercaps):
        if self._inner is not None:
            return self._inner.fixate_caps(direction, caps, othercaps)
        return super().fixate_caps(direction, caps, othercaps)

    def set_info(self, incaps, outcaps):
        if incaps is not None:
            self._select_for_caps(incaps)
        if self._inner is not None:
            self._inner.device = self.device
            self._inner.set_info(incaps, outcaps)
            if self._started:
                self._inner.start()

    def make_fn(self):
        if self._inner is not None:
            return self._inner.make_fn()
        return super().make_fn()

    def make_scan_fn(self):
        if self._inner is not None:
            return self._inner.make_scan_fn()
        return super().make_scan_fn()

    def host_process(self, buf: Optional[Buffer]) -> Optional[Buffer]:
        if self._inner is not None:
            return self._inner.host_process(buf)
        return buf

    def process_meta(self, buf: Buffer) -> Buffer:
        if self._inner is not None:
            return self._inner.process_meta(buf)
        return buf

    def start(self):
        self._started = True
        if self._inner is not None:
            self._inner.start()

    def stop(self):
        self._started = False
        if self._inner is not None:
            self._inner.stop()

    def flush(self):
        if self._inner is not None and hasattr(self._inner, "flush"):
            self._inner.flush()


@register_element
class SwitchBin(_ProxyTransform):
    FACTORY = "switchbin"
    DESCRIPTION = "Switch between different streams via caps-defined " \
                  "paths"
    PROPERTIES = {
        "num-paths": (int, 0, "number of paths (informational)"),
        "current-path": (int, -1, "currently selected path"),
        "paths": (object, "", "caps->factory,prop=val|... path spec"),
    }

    def _path_list(self) -> List[Tuple[Caps, str]]:
        spec = self.props["paths"]
        out = []
        if isinstance(spec, str):
            for part in [p for p in spec.split("|") if p.strip()]:
                caps_s, _, desc = part.partition("->")
                out.append((Caps.from_string(caps_s.strip()), desc))
        else:
            for caps_s, desc in (spec or []):
                caps = (caps_s if isinstance(caps_s, Caps)
                        else Caps.from_string(str(caps_s)))
                out.append((caps, desc or ""))
        return out

    def _select_for_caps(self, caps: Caps) -> None:
        paths = self._path_list()
        for i, (pcaps, desc) in enumerate(paths):
            if pcaps.is_any or caps.is_any \
                    or not caps.intersect(pcaps).is_empty:
                if self.props["current-path"] != i:
                    self.props["current-path"] = i
                    self._inner = _make_inner(desc)
                return
        if paths:
            raise ValueError(
                f"switchbin: no path matches caps {caps}")


@register_element
class AutoConvert(_ProxyTransform):
    FACTORY = "autoconvert"
    DESCRIPTION = "Selects the right transform element based on caps"
    PROPERTIES = {
        "factories": (object, "", "comma-separated factory names"),
    }

    def _factory_names(self) -> List[str]:
        f = self.props["factories"]
        if isinstance(f, str):
            return [x.strip() for x in f.split(",") if x.strip()]
        return list(f or [])

    def transform_caps(self, direction, caps, filter=None):
        # before a factory is chosen the bin advertises the union of
        # its candidates (wide) — the reference proxies the caps query
        # through the current child or returns the template union
        if direction == PadDirection.SINK:
            self._select_for_caps(caps)
        if self._inner is not None:
            return self._inner.transform_caps(direction, caps, filter)
        return filter if filter is not None else Caps.any()

    def _select_for_caps(self, caps: Caps) -> None:
        names = self._factory_names()
        if self._inner is not None:
            return
        for name in names:
            cand = element_factory_make(name)
            for t in cand.PAD_TEMPLATES:
                if t.direction != PadDirection.SINK:
                    continue
                tcaps = (t.caps if isinstance(t.caps, Caps)
                         else Caps.from_string(t.caps))
                if tcaps.is_any or caps.is_any \
                        or not caps.intersect(tcaps).is_empty:
                    self._inner = cand
                    return
        if names:
            raise ValueError(
                f"autoconvert: no factory accepts caps {caps}")


@register_element
class AutoVideoConvert(AutoConvert):
    """gstautovideoconvert.c: autoconvert over the video converters."""
    FACTORY = "autovideoconvert"
    DESCRIPTION = "Selects the right color space converter based on " \
                  "caps"

    def __init__(self, name=None, **props):
        props.setdefault("factories", "videoconvert")
        super().__init__(name=name, **props)
