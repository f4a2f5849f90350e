"""Elements, pads, and the port's own factory registry.

A copy of the JAX package's ``core/element.py``: GstElement/GstPad/
GstElementFactory (reference: subprojects/gstreamer/gst/gstelement.c,
gstpad.c, gstelementfactory.c), with two changes:

* the registry (``_REGISTRY``, ``register_element``,
  ``element_factory_make``) is this package's own dict, filled by
  importing ``gstreamer_tpu_torch.elements``; it holds only the ported
  factories, and an unported one raises ``ValueError`` like an unknown
  one.  It never touches the JAX package's registry;
* an element's compute hook, ``make_fn``, returns a torch function.

As in the JAX package: no streaming threads (dataflow is a host-side batch
loop), caps negotiation is one host pass driven by the Pipeline with
GstBaseTransform's transform_caps/fixate_caps/set_info hooks, and the
state machine is reduced to NULL<->READY<->PLAYING.
"""

from __future__ import annotations

import threading as _threading

from typing import Any, Callable, Dict, List, Optional, Tuple

from .buffer import Buffer, FlowReturn
from .caps import Caps


class PadDirection:
    SRC = "src"
    SINK = "sink"


class PadPresence:
    ALWAYS = "always"
    REQUEST = "request"
    SOMETIMES = "sometimes"


class PadTemplate:
    def __init__(self, name: str, direction: str, caps: "Caps | str",
                 presence: str = PadPresence.ALWAYS):
        self.name = name
        self.direction = direction
        self.caps = Caps.from_string(caps) if isinstance(caps, str) else caps
        self.presence = presence

    def instantiate(self, element: "Element", name: Optional[str] = None) -> "Pad":
        return Pad(name or self.name, self.direction, element, self)


class Pad:
    def __init__(self, name: str, direction: str, element: "Element",
                 template: Optional[PadTemplate] = None):
        self.name = name
        self.direction = direction
        self.element = element
        self.template = template
        self.peer: Optional["Pad"] = None
        self.caps: Optional[Caps] = None     # fixed caps after negotiation
        # probes: callables(pad, buffer) -> buffer|None (tracing hook point;
        # mirrors gstpad.c do_probe_callbacks :3870)
        self.probes: List[Callable] = []
        # sticky event store (gstpad.c:65 'the srcpad should always keep
        # the last sent sticky events; a new peer gets them replayed') —
        # one per sticky type, replaced on re-push
        self.sticky: Dict[str, "object"] = {}
        # event probes: callables(pad, event) -> event|None
        self.event_probes: List[Callable] = []

    @property
    def template_caps(self) -> Caps:
        return self.template.caps if self.template else Caps.any()

    # -- event flow (gst_pad_push_event / gst_pad_send_event) -------------
    def push_event(self, event) -> bool:
        """Send `event` over this pad in its natural direction:
        downstream from a SRC pad (stored sticky on both endpoints,
        delivered to the peer element's sink_event), upstream from a
        SINK pad (delivered to the peer element's src_event).

        Mirrors gst_pad_push_event_unchecked (gstpad.c:201): sticky
        events replace any previous of the same type."""
        for probe in list(self.event_probes):
            event = probe(self, event)
            if event is None:
                return True          # probe consumed it
        if event.is_sticky:
            self.sticky[event.type] = event
        peer = self.peer
        if peer is None:
            return False
        if self.direction == PadDirection.SRC:
            # the receiving pad's probes see the event before the element
            # (gstpad.c do_probe_callbacks on the peer)
            for probe in list(peer.event_probes):
                event = probe(peer, event)
                if event is None:
                    return True
            if event.is_sticky:
                peer.sticky[event.type] = event
            return peer.element.sink_event(peer, event)
        # upstream: the receiving (src) pad's probes see it too
        for probe in list(peer.event_probes):
            event = probe(peer, event)
            if event is None:
                return True
        return peer.element.src_event(peer, event)

    def get_sticky(self, event_type: str):
        return self.sticky.get(event_type)

    def resolve(self) -> "Pad":
        """Ghost-pad chain resolution (proxy semantics)."""
        return self

    def link(self, sinkpad: "Pad") -> None:
        if self.direction != PadDirection.SRC or sinkpad.direction != PadDirection.SINK:
            raise ValueError("link must go src -> sink")
        # ghost pads forward to their targets (proxy collapse)
        src = self.resolve()
        sink = sinkpad.resolve()
        if src.peer is not None or sink.peer is not None:
            raise ValueError(f"pad already linked: {self} / {sinkpad}")
        if not src.template_caps.can_intersect(sink.template_caps):
            raise ValueError(
                f"cannot link {self.element.name}.{self.name} ! "
                f"{sinkpad.element.name}.{sinkpad.name}: caps do not intersect")
        src.peer = sink
        sink.peer = src

    def __repr__(self):
        return f"<Pad {self.element.name}.{self.name}>"


class GhostPad(Pad):
    """Bin-boundary proxy pad (gstghostpad.c): a pad on a Bin that
    forwards to an internal element's pad.  Linking THROUGH a ghost pad
    connects the real endpoints (the reference's proxy-pad pair
    collapses to direct forwarding in the flat graph)."""

    def __init__(self, name: str, target: Pad, owner=None):
        self.target = target          # before super() touches self.caps
        super().__init__(name, target.direction, owner or target.element,
                         target.template)

    def resolve(self) -> Pad:
        return self.target.resolve()

    @property
    def caps(self):
        return self.target.caps

    @caps.setter
    def caps(self, value):
        self.target.caps = value


class Element:
    """Base element.  Subclasses define FACTORY (registry name),
    PAD_TEMPLATES, PROPERTIES, and override the negotiation/compute
    hooks."""

    FACTORY: str = ""
    KLASS: str = "Generic"
    DESCRIPTION: str = ""
    PAD_TEMPLATES: List[PadTemplate] = []
    # name -> (python type, default, doc)
    PROPERTIES: Dict[str, Tuple[type, Any, str]] = {}

    def __init__(self, name: Optional[str] = None, **props):
        self.name = name or f"{self.FACTORY}{id(self) % 10000}"
        self.pads: List[Pad] = []
        self.props: Dict[str, Any] = {
            k: v[1] for k, v in self.PROPERTIES.items()}
        for k, v in props.items():
            self.set_property(k, v)
        for t in self.PAD_TEMPLATES:
            if t.presence == PadPresence.ALWAYS:
                self.pads.append(t.instantiate(self))
        self.parent = None
        self.device = None                 # the pipeline's, set at compile
        self._pending_caps = None          # mid-stream CAPS event payload
        self._needs_reconfigure = False    # RECONFIGURE mark (gstpad.c)

    # -- properties (mirrors GObject properties used in launch lines) ----
    # -- property animation (gstcontrolbinding.c analog) -------------------
    DYNAMIC_PROPS: tuple = ()

    def set_control_source(self, prop: str, source) -> None:
        """Attach a ControlSource to a property
        (gst_object_add_control_binding).  Properties listed in the
        element's DYNAMIC_PROPS become per-tick inputs of ``make_dyn_fn``
        -- value changes never rebuild anything; other properties are
        not sampled by the Pipeline."""
        prop = prop.replace("_", "-")
        if prop not in self.PROPERTIES:
            raise ValueError(f"{self.FACTORY}: no property {prop!r}")
        if not hasattr(self, "_dyn_sources"):
            self._dyn_sources = {}
        self._dyn_sources[prop] = source

    def remove_control_source(self, prop: str) -> None:
        getattr(self, "_dyn_sources", {}).pop(
            prop.replace("_", "-"), None)

    def dyn_props(self) -> dict:
        """Active dynamic-input props: {prop: ControlSource}."""
        srcs = getattr(self, "_dyn_sources", {})
        return {p: s for p, s in srcs.items()
                if p in self.DYNAMIC_PROPS}

    def make_dyn_fn(self):
        """fn(x, dyn: dict) for elements with DYNAMIC_PROPS; dyn maps
        prop name -> the tick's float32 value (a Python float rounded
        to float32)."""
        return None

    def set_property(self, key: str, value: Any) -> None:
        key = key.replace("_", "-")
        if key not in self.PROPERTIES:
            raise ValueError(f"{self.FACTORY}: no property {key!r}")
        typ = self.PROPERTIES[key][0]
        if isinstance(value, str) and typ is not str:
            if typ is bool:
                value = value.lower() in ("1", "true", "yes")
            elif typ is int:
                value = int(value)
            elif typ is float:
                value = float(value)
        self.props[key] = value

    def get_property(self, key: str) -> Any:
        return self.props[key.replace("_", "-")]

    # -- pads -------------------------------------------------------------
    def get_pad(self, name: str) -> Pad:
        for p in self.pads:
            if p.name == name:
                return p
        # request pads ("sink_%u") — and sometimes-pads (a demuxer's
        # "video_%u": in this model asking for the pad by
        # name IS the stream-exposure event, the analog of the
        # reference's pad-added signal after stream discovery)
        for t in self.PAD_TEMPLATES:
            if t.presence in (PadPresence.REQUEST,
                              PadPresence.SOMETIMES) \
                    and _template_match(t.name, name):
                pad = t.instantiate(self, name)
                self.pads.append(pad)
                return pad
        raise ValueError(f"{self.name}: no pad {name!r}")

    def request_pad(self, template_name: str) -> Pad:
        for t in self.PAD_TEMPLATES:
            if t.presence == PadPresence.REQUEST and t.name == template_name:
                idx = sum(1 for p in self.pads
                          if p.template and p.template.name == template_name)
                pad = t.instantiate(self, template_name.replace("%u", str(idx)))
                self.pads.append(pad)
                return pad
        raise ValueError(f"{self.name}: no request template {template_name!r}")

    def sink_pads(self) -> List[Pad]:
        return [p for p in self.pads if p.direction == PadDirection.SINK]

    def src_pads(self) -> List[Pad]:
        return [p for p in self.pads if p.direction == PadDirection.SRC]

    # -- negotiation hooks (GstBaseTransform vfunc equivalents) -----------
    def transform_caps(self, direction: str, caps: Caps,
                       filter: Optional[Caps] = None) -> Caps:
        """Caps acceptable on the opposite pad given `caps` on the
        `direction` pad.  Default: identity (passthrough elements)."""
        res = caps
        if filter is not None:
            res = res.intersect(filter)
        return res

    def fixate_caps(self, direction: str, caps: Caps, othercaps: Caps) -> Caps:
        """Pick concrete caps on the opposite pad; default gst_caps_fixate."""
        return othercaps.fixate()

    def set_info(self, incaps: Optional[Caps], outcaps: Optional[Caps]) -> None:
        """Called once negotiation fixed the caps; build compute state."""

    # -- event hooks (gst_pad_event_default semantics) ---------------------
    def sink_event(self, pad: Pad, event) -> bool:
        """Downstream event arriving on a sink pad.  Default: forward to
        every linked src pad (gst_pad_event_default, gstpad.c).  Elements
        override to intercept (and may chain up to keep forwarding)."""
        from .events import EventType

        if event.type == EventType.CAPS:
            # mid-stream caps: remember for the renegotiation pass
            self._pending_caps = event.data.get("caps")
        handled = False
        for sp in self.src_pads():
            if sp.peer is not None:
                handled = sp.push_event(event) or handled
            elif event.is_sticky:
                sp.sticky[event.type] = event
                handled = True
        return handled or not self.src_pads()

    def src_event(self, pad: Pad, event) -> bool:
        """Upstream event arriving on a src pad.  Default: forward to
        every linked sink pad; RECONFIGURE additionally marks this
        element (gstpad.c gst_pad_mark_reconfigure)."""
        from .events import EventType

        if event.type == EventType.RECONFIGURE:
            self._needs_reconfigure = True
        handled = False
        for kp in self.sink_pads():
            if kp.peer is not None:
                handled = kp.push_event(event) or handled
        return handled or not self.sink_pads()

    def send_event(self, event) -> bool:
        """gst_element_send_event: route by direction — downstream events
        enter via src pads, upstream events via sink pads."""
        from .events import UPSTREAM_TYPES

        if event.type in UPSTREAM_TYPES:
            pads = self.sink_pads() or []
            if not pads:
                return self.src_event(None, event)
            return any(p.push_event(event) for p in pads)
        ok = False
        for sp in self.src_pads():
            ok = sp.push_event(event) or ok
        return ok

    # -- query hook (gstquery.c dispatch) ----------------------------------
    def query(self, q) -> bool:
        """Answer a query or forward it along the graph
        (gst_pad_query_default): POSITION/DURATION/SEEKING travel
        upstream toward sources, LATENCY accumulates, CAPS/ACCEPT_CAPS
        answer from pad state."""
        from .query import QueryType

        if q.type == QueryType.CAPS:
            pads = self.src_pads() or self.sink_pads()
            caps = pads[0].caps or pads[0].template_caps
            flt = q.params.get("filter")
            q.result["caps"] = caps.intersect(flt) if flt else caps
            return True
        if q.type == QueryType.ACCEPT_CAPS:
            pads = self.sink_pads() or self.src_pads()
            q.result["accepted"] = q.params["caps"].can_intersect(
                pads[0].template_caps)
            return True
        # default: forward upstream (position/duration/seeking live at
        # the source; latency accumulates on the way)
        for kp in self.sink_pads():
            if kp.peer is not None and kp.peer.element.query(q):
                return True
        return False

    # -- compute hooks -----------------------------------------------------
    def make_fn(self) -> Optional[Callable]:
        """Torch function data->data on the element's negotiated
        configuration, or None for passthrough.  The pipeline composes
        consecutive device elements' functions into one step."""
        return None

    def make_scan_fn(self):
        """Optional (step, init_carry) for STATEFUL per-frame elements.

        step(carry, x) -> (carry, out_frame) runs over the batch axis
        (``core.pipeline.run_scan``: a Python loop over the frames of a
        tick, each output frame written into a preallocated tensor);
        `carry` (a tuple tree of tensors and Python ints) is the
        element's streaming state, kept on the pipeline's device across
        ticks -- the analog of GstElement instance state for
        frame-feedback effects.  x is the per-frame input tree, or
        (frame, aux) when scan_aux is defined.  Returns None for
        stateless elements."""
        return None

    def scan_aux(self, batch: int):
        """Per-tick host-computed auxiliary scan inputs (leading axis =
        batch).  Host-side sequential parameters (phase counters, PRNG
        draws) are precomputed here and fed to make_scan_fn's step as
        x[1]."""
        return None

    def process_meta(self, buf: Buffer) -> Buffer:
        """Host-side metadata transform applied per buffer (timestamps)."""
        return buf

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


def _template_match(tmpl: str, name: str) -> bool:
    if "%u" in tmpl:
        prefix = tmpl.split("%u")[0]
        return name.startswith(prefix) and name[len(prefix):].isdigit()
    return tmpl == name


class SourceElement(Element):
    """GstBaseSrc equivalent (gstbasesrc.c): produces buffers.

    `create(n_frames)` returns Buffer or None (EOS).  Negotiation:
    `get_caps` constrains, `fixate` picks defaults."""

    def get_caps(self, filter: Optional[Caps] = None) -> Caps:
        caps = self.src_pads()[0].template_caps
        if filter is not None:
            caps = caps.intersect(filter)
        return caps

    def fixate(self, caps: Caps) -> Caps:
        return caps.fixate()

    def create(self, n_frames: int) -> Optional[Buffer]:
        raise NotImplementedError

    def generator_fn(self) -> Optional[Callable]:
        """Optional device generator (frame_indices)->tensors, run in the
        pipeline's step (videotestsrc patterns etc.)."""
        return None

    def check_reconfigure(self) -> bool:
        """True when this source's caps changed mid-stream and the
        pipeline must renegotiate before the next batch (the CAPS-event /
        RECONFIGURE path of the reference, gstbasesrc.c negotiate)."""
        if self._needs_reconfigure:
            self._needs_reconfigure = False
            return True
        return False

    def query(self, q) -> bool:
        from .query import QueryType

        if q.type == QueryType.POSITION and hasattr(self, "position_ns"):
            q.result["position"] = self.position_ns()
            return True
        if q.type == QueryType.DURATION and hasattr(self, "duration_ns"):
            d = self.duration_ns()
            if d is not None:
                q.result["duration"] = d
                return True
            return False
        if q.type == QueryType.SEEKING:
            q.result["seekable"] = hasattr(self, "do_seek")
            return True
        if q.type == QueryType.LATENCY:
            live = bool(self.props.get("is-live", False))
            q.result.setdefault("live", live)
            q.result.setdefault("min-latency", 0)
            q.result.setdefault("max-latency", -1)
            return True
        return super().query(q)


class MultiStreamSourceElement(SourceElement):
    """Demuxer scaffold: ONE container parse exposes a pad per track
    (the sometimes-pads analog of qtdemux.c / matroska-demux.c — the
    reference demuxer adds video_0/audio_0/... pads after discovering
    streams; here linking `demux.video_0` in the launch string exposes
    the stream, and all exposed pads are fed from a single parse).
    Negotiation handles it; no ported element is one yet, and the
    port's Pipeline raises NotImplementedError when it compiles one.

    Subclasses implement:
      - `get_caps_for_pad(pad, filter)` — per-stream caps;
      - `create_multi(n) -> Optional[Dict[pad_name, Buffer]]` — one
        batch per exposed pad (omit pads whose stream ended; None when
        every stream is exhausted);
    and keep the single-pad `get_caps`/`create` path working for the
    backward-compatible `stream=` selection on the ALWAYS "src" pad.
    """

    MULTI_STREAM = True

    def multi_pads(self) -> List["Pad"]:
        """The exposed per-stream pads (linked sometimes-pads)."""
        return [p for p in self.src_pads()
                if p.peer is not None and p.name != "src"]

    def is_multi(self) -> bool:
        return bool(self.multi_pads())

    def get_caps_for_pad(self, pad: "Pad",
                         filter: Optional[Caps] = None) -> Caps:
        raise NotImplementedError

    def fixate_for_pad(self, pad: "Pad", caps: Caps) -> Caps:
        return caps.fixate()

    def create_multi(self, n_frames: int):
        raise NotImplementedError


class TransformElement(Element):
    """GstBaseTransform equivalent (gstbasetransform.c:2351 chain)."""

    PASSTHROUGH_ON_SAME_CAPS = False

    def accept_caps(self, direction: str, caps: Caps) -> bool:
        pads = self.sink_pads() if direction == PadDirection.SINK else self.src_pads()
        return caps.can_intersect(pads[0].template_caps)


class SinkElement(Element):
    """GstBaseSink equivalent: consumes buffers."""

    def render(self, buf: Buffer) -> str:
        return FlowReturn.OK


class AggregatorElement(Element):
    """GstAggregator equivalent (gstaggregator.c): N sink pads -> 1 src.

    The pipeline calls `aggregate_fn()` once all sink pads have data for
    a tick; inputs arrive as a dict keyed by sink pad name, in the pads'
    order.  A host aggregator (HOST_ELEMENT, e.g. smpte) defines
    ``host_aggregate({pad name: Buffer}) -> Optional[Buffer]`` instead,
    which the per-element path calls."""

    def aggregate_fn(self) -> Optional[Callable]:
        return None


# ---------------------------------------------------------------------------
# Registry (GstElementFactory / GstRegistry equivalent): this package's own
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Tuple[type, int]] = {}


def register_element(cls=None, *, rank: int = 0):
    def do(cls):
        if not cls.FACTORY:
            raise ValueError("element class needs FACTORY name")
        _REGISTRY[cls.FACTORY] = (cls, rank)
        return cls
    return do(cls) if cls is not None else do


def element_factory_make(factory: str, name: Optional[str] = None,
                         **props) -> Element:
    _ensure_elements_loaded()
    if factory not in _REGISTRY:
        raise ValueError(f"no element factory {factory!r}")
    cls, _rank = _REGISTRY[factory]
    return cls(name=name, **props)


def factory_exists(factory: str) -> bool:
    _ensure_elements_loaded()
    return factory in _REGISTRY


def list_factories() -> List[str]:
    _ensure_elements_loaded()
    return sorted(_REGISTRY)


def get_factory_class(factory: str) -> type:
    _ensure_elements_loaded()
    return _REGISTRY[factory][0]


_loaded = False


_load_lock = _threading.RLock()


def _ensure_elements_loaded():
    """Lazy plugin load (the registry-scan equivalent, gstregistry.c):
    imports ``gstreamer_tpu_torch.elements``, which registers the ported
    factories.

    Thread-safe: the flag flips only AFTER the element modules have
    fully imported, so a second thread never observes a partially
    populated registry (the RLock keeps same-thread reentry from
    import-time registrations safe)."""
    global _loaded
    if _loaded:
        return
    with _load_lock:
        if _loaded:
            return
        from .. import elements  # noqa: F401  (registers on import)
        _loaded = True
