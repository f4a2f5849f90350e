"""Bin/Pipeline: graph container, caps negotiation, torch execution.

The JAX package's ``core/pipeline.py`` (GstBin/GstPipeline, reference:
subprojects/gstreamer/gst/gstbin.c, gstpipeline.c; negotiation flow
gst-docs design/negotiation.md, gstbasetransform.c find_transform :1093)
with its execution rewritten for torch.  ``Bus``, ``State``, ``Bin``,
``link``, ``negotiate`` and ``_topo_order`` are copies.

Execution model:

* negotiation runs once, on the host, and fixes the caps of every pad;
* every element contributes a torch function (``make_fn``; an N-to-1
  aggregator's ``aggregate_fn`` takes ``{sink pad name: value}``).  When
  no host element (deinterlace, videorate, smpte, a decoupling queue)
  splits the graph, ``compile`` composes them in topological order into
  one step (``_device_step``: plain Python calls, run eagerly by torch);
  otherwise each element's function is called on its own, and host
  elements run their ``host_process`` between them;
* the tick loop pulls a BATCH of frames from each source, moves every
  array of it to the pipeline's device (``core/staging.py``: page-locked
  buffers reused across ticks and a copy stream on CUDA; in both paths,
  except for a source pad that feeds only elements with ``HOST_INPUT`` set,
  the parsers and decoders of host bytes), runs the graph and hands the
  results to the sinks.  With several sources the tick is EOS as soon as
  any of them has nothing more.  ``compile(prefetch=True)`` pulls and
  stages the next tick right after the current tick's step is queued
  (composed path), so the copy overlaps the step;
* a multi-stream source (a demuxer whose per-track pads are linked:
  ``MultiStreamSourceElement``) parses its container once and gives one
  buffer per exposed pad a tick, keyed ``"name:pad"``; each pad is staged
  on its own (a video pad may go to the card while a subtitle or coded
  pad goes to a host element), tracks may give different lengths a tick
  and end on different ticks (a sink whose pad has nothing this tick is
  skipped; the source is EOS when every track has ended), and a stream
  that ``select_streams`` deselected gives zeros of its shape;
* a stateful element (``make_scan_fn``) runs its step over the frames of
  the tick (``run_scan``), its carry kept on the device across ticks
  (``_elem_states``, reset whenever ``compile`` builds the program); a
  controlled property (``DYNAMIC_PROPS`` with a control source) is
  sampled at the tick's timestamp as a float32 and handed to the
  element's ``make_dyn_fn``.

``seek`` and ``query`` (POSITION, DURATION, LATENCY, SEEKING, ALLOCATION)
and the ``query_*`` helpers are the reference's, and so are the pipeline
clock (``use_clock`` / ``get_clock``: a ``check.TestClock`` gates
clocksync), the tracer hooks (``core/tracer.py``, ``GTPU_TRACERS``: fired
at the reference's points of ``compile``, ``tick`` and ``_propagate``, all
on the host) and the dot dump at negotiation (``utils/dot.py``,
``GTPU_DEBUG_DUMP_DOT_DIR``).

The device is explicit: a Pipeline runs on CUDA unless the caller names
another device, and raises without a card (``device.resolve``).  Not
ported yet, and raising ``NotImplementedError`` (ROADMAP.md): a ``mesh``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve
from ..utils.log import get_logger
from .buffer import Buffer, FlowReturn, map_leaves
from .caps import Caps
from .element import (AggregatorElement, Element, Pad, PadDirection,
                      SinkElement, SourceElement)
from .staging import Stager
from .tracer import hooks

log = get_logger("pipeline")

_ROADMAP = "not ported to gstreamer_tpu_torch yet (see ROADMAP.md)"


def run_scan(step, carry, xs, aux=None):
    """lax.scan's plain torch form: ``step(carry, x) -> (carry, y)`` over
    the leading axis of every leaf of `xs` (a tensor or a tuple / list of
    them), with x = (frame, aux[k]) when `aux` (host rows, one a frame)
    is given.  Each frame's outputs are written into tensors allocated at
    the first frame.  A step marked ``whole_tick`` (see
    ``Element.make_scan_fn``) takes the tick's frames at once instead.
    Returns (carry, stacked outputs)."""
    if getattr(step, "whole_tick", False):
        return step(carry, xs, aux)
    n = int(_leaves(xs)[0].shape[0])
    if aux is not None and len(aux) != n:
        raise ValueError(f"scan: {len(aux)} aux rows for {n} frames")
    out = None
    for k in range(n):
        x = map_leaves(lambda a: a[k], xs)
        carry, y = step(carry, x if aux is None else (x, aux[k]))
        if out is None:
            out = map_leaves(
                lambda a: a.new_empty((n,) + tuple(a.shape)), y)
        for o, v in zip(_leaves(out), _leaves(y)):
            o[k] = v
    return carry, (xs if out is None else out)


def _leaves(tree) -> list:
    found = []
    map_leaves(found.append, tree)
    return found


def _carry_to(carry, dev):
    """An initial carry (numpy arrays, numpy or Python scalars, tensors,
    in tuples / lists) on the pipeline's device: arrays become tensors
    there (copies: a scan may update its carry in place), scalars Python
    numbers."""
    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, copy=True)
        if isinstance(x, np.ndarray) and x.ndim:
            return torch.from_numpy(np.array(x)).to(dev)
        if isinstance(x, (np.generic, np.ndarray)):
            return x.item()
        return x
    return map_leaves(to, carry)


def _takes_host_bytes(pad) -> bool:
    """Whether the sink `pad` takes a source's host bytes as they are: its
    element has HOST_INPUT set (a parser or decoder), or names the pad in
    HOST_INPUT_PADS (name prefixes: the caption or subtitle pad of an
    element whose other pads take media); a capsfilter passes the question
    on to the pads it feeds."""
    e = pad.element
    if e.FACTORY == "capsfilter":
        peers = [sp.peer for sp in e.src_pads() if sp.peer is not None]
        return bool(peers) and all(_takes_host_bytes(p) for p in peers)
    return (getattr(e, "HOST_INPUT", False)
            or pad.name.startswith(getattr(e, "HOST_INPUT_PADS", ())))


def _is_multi(e) -> bool:
    """A multi-stream source with at least one per-track pad linked."""
    return getattr(e, "MULTI_STREAM", False) and e.is_multi()


def _zeros(x):
    """A deselected stream's payload: zeros of the leaf's shape and dtype
    (text and bytes leaves too, as the JAX package's ``np.zeros_like``)."""
    if isinstance(x, (tuple, list)):
        return type(x)(_zeros(v) for v in x)
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros_like(np.asarray(x))


def _first_leaf(tree):
    """The first leaf of a tree whose dicts are walked in sorted key
    order (jax.tree_util.tree_leaves' order)."""
    while True:
        if isinstance(tree, dict):
            tree = tree[sorted(tree)[0]]
        elif isinstance(tree, (tuple, list)):
            tree = tree[0]
        else:
            return tree


# ---------------------------------------------------------------------------
# Bus (gstbus.c equivalent — async element->app messages)
# ---------------------------------------------------------------------------

@dataclass
class Message:
    type: str                    # "eos" | "error" | "warning" | "state-changed" | ...
    src: Optional[str] = None
    data: Dict[str, Any] = field(default_factory=dict)

    def __repr__(self):
        return f"<Message {self.type} from {self.src}: {self.data}>"


class Bus:
    def __init__(self):
        self._queue: List[Message] = []
        self._watchers: List[Callable[[Message], None]] = []

    def post(self, msg: Message) -> None:
        log.debug("bus message: %s", msg)
        self._queue.append(msg)
        for w in self._watchers:
            w(msg)

    def pop(self) -> Optional[Message]:
        return self._queue.pop(0) if self._queue else None

    def pop_filtered(self, *types: str) -> Optional[Message]:
        for i, m in enumerate(self._queue):
            if m.type in types:
                return self._queue.pop(i)
        return None

    def add_watch(self, cb: Callable[[Message], None]) -> None:
        self._watchers.append(cb)

    def messages(self) -> List[Message]:
        return list(self._queue)


class State:
    NULL = "null"
    READY = "ready"
    PAUSED = "paused"
    PLAYING = "playing"


# ---------------------------------------------------------------------------
# Bin / Pipeline
# ---------------------------------------------------------------------------

class Bin(Element):
    FACTORY = "bin"

    def __init__(self, name: Optional[str] = None):
        super().__init__(name=name)
        self.elements: List[Element] = []

    def add(self, *elements: Element) -> None:
        for e in elements:
            if e.parent is not None:
                raise ValueError(f"{e.name} already in a bin")
            e.parent = self
            self.elements.append(e)

    def get_by_name(self, name: str) -> Optional[Element]:
        for e in self.elements:
            if e.name == name:
                return e
            if isinstance(e, Bin):
                r = e.get_by_name(name)
                if r is not None:
                    return r
        return None

    def iterate_elements(self) -> List[Element]:
        out = []
        for e in self.elements:
            if isinstance(e, Bin):
                out.extend(e.iterate_elements())
            else:
                out.append(e)
        return out

    def add_ghost_pad(self, name: str, target) -> "Pad":
        """Expose an internal element's pad on the bin boundary
        (gst_ghost_pad_new + gst_element_add_pad)."""
        from .element import GhostPad
        gp = GhostPad(name, target, owner=self)
        self.pads.append(gp)
        return gp


def link(src: Element, sink: Element,
         srcpad: Optional[str] = None, sinkpad: Optional[str] = None) -> None:
    """gst_element_link_pads equivalent: first CAPS-COMPATIBLE pads
    (gst_pad_can_link: template caps must intersect when picking among
    several sink templates, e.g. a muxer's video_%u vs audio_%u)."""
    spads = [src.get_pad(srcpad)] if srcpad else [
        p for p in src.src_pads() if p.peer is None]
    if not spads:
        # try request pads
        for t in src.PAD_TEMPLATES:
            if t.direction == PadDirection.SRC and t.presence == "request":
                spads = [src.request_pad(t.name)]
                break

    src_caps = None
    if spads:
        src_caps = spads[0].template_caps
        # a capsfilter's configured caps are more precise than its
        # ANY templates (the common `... ! audio/x-raw,... ! mux` case)
        cf = getattr(src, "props", {}).get("caps")
        if cf is not None:
            src_caps = cf

    def _compatible(sink_caps) -> bool:
        if src_caps is None:
            return True
        try:
            return not src_caps.intersect(sink_caps).is_empty
        except Exception:
            return True

    kpads = [sink.get_pad(sinkpad)] if sinkpad else [
        p for p in sink.sink_pads() if p.peer is None]
    if not sinkpad and kpads:
        ranked = [p for p in kpads if _compatible(p.template_caps)]
        kpads = ranked or kpads
    if not kpads:
        tmpls = [t for t in sink.PAD_TEMPLATES
                 if t.direction == PadDirection.SINK
                 and t.presence == "request"]
        from .caps import Caps as _Caps
        ranked = [t for t in tmpls
                  if _compatible(_Caps.from_string(t.caps)
                                 if isinstance(t.caps, str) else t.caps)]
        for t in (ranked or tmpls):
            kpads = [sink.request_pad(t.name)]
            break
    if not spads or not kpads:
        raise ValueError(f"cannot link {src.name} ! {sink.name}: no free pads")
    spads[0].link(kpads[0])


class Pipeline(Bin):
    FACTORY = "pipeline"

    def __init__(self, name: Optional[str] = None, device=None):
        super().__init__(name=name)
        self.device = resolve(device)
        self.bus = Bus()
        self.state = State.NULL
        self._plan = None
        self.default_batch = 1
        self._position_ns = 0
        self._prefetch = False
        self._donate = False
        self._staged = None
        self._pending_reconf = False
        self._stager = None
        self.clock = None              # pipeline clock (use_clock)

    def use_clock(self, clock) -> None:
        """Force the pipeline clock (gst_pipeline_use_clock; selection
        normally happens at PLAYING, gstpipeline.c:433).  Pass a
        check.testclock.TestClock for deterministic timing tests --
        clock-aware elements (clocksync) then hold buffers until the clock
        is cranked past their timestamps."""
        self.clock = clock

    def get_clock(self):
        return self.clock

    # -- graph helpers -----------------------------------------------------
    def _nodes(self) -> List[Element]:
        return self.iterate_elements()

    def _topo_order(self) -> List[Element]:
        nodes = self._nodes()
        indeg = {e: 0 for e in nodes}
        for e in nodes:
            for p in e.sink_pads():
                if p.peer is not None:
                    indeg[e] += 1
        order, ready = [], [e for e in nodes if indeg[e] == 0]
        while ready:
            e = ready.pop(0)
            order.append(e)
            for p in e.src_pads():
                if p.peer is not None:
                    d = p.peer.element
                    indeg[d] -= 1
                    if indeg[d] == 0:
                        ready.append(d)
        if len(order) != len(nodes):
            raise ValueError("pipeline graph has a cycle")
        return order

    # -- negotiation (trace-time caps resolution) --------------------------
    @staticmethod
    def _strip_features(caps: Caps) -> Caps:
        """Transforms are memory-agnostic: explicit caps features
        constrain only the link they were written on, not everything a
        transform can produce/accept on its other side."""
        if caps is None or caps.is_any or not caps.structures:
            return caps
        if all(st.features is None for st in caps.structures):
            return caps
        out = []
        for st in caps.structures:
            st = st.copy()
            st.features = None
            out.append(st)
        return Caps(out)

    def _downstream_allowed(self, pad: Pad, _memo=None) -> Caps:
        """Allowed caps on a SRC pad considering everything downstream
        (the recursive CAPS query, gstbasetransform query_caps :632)."""
        if _memo is None:
            _memo = {}
        if pad in _memo:
            return _memo[pad]
        peer = pad.peer
        if peer is None:
            res = pad.template_caps
        else:
            elem = peer.element
            sink_tmpl = peer.template_caps
            if isinstance(elem, SinkElement) or not elem.src_pads():
                res = sink_tmpl
            elif isinstance(elem, AggregatorElement):
                res = sink_tmpl
            else:
                down = Caps.any()
                for sp in elem.src_pads():
                    if sp.peer is not None:
                        down = down.intersect(self._downstream_allowed(sp, _memo))
                    else:
                        down = down.intersect(sp.template_caps)
                res = elem.transform_caps(
                    PadDirection.SRC, self._strip_features(down),
                    filter=sink_tmpl)
        res = res.intersect(pad.template_caps)
        _memo[pad] = res
        return res

    def negotiate(self) -> None:
        """Negotiate caps element by element.  Every element first takes
        the pipeline's device (elements that build device state in
        ``set_info``, like videoconvertscale, build it there), also when
        negotiation is asked for before ``compile``."""
        for e in self._nodes():
            e.device = self.device
        order = self._topo_order()
        # reset any previous negotiation (renegotiation path: the sticky
        # CAPS state is replaced, gstevent.c:905)
        for elem in order:
            for p in elem.pads:
                p.caps = None
        for elem in order:
            if getattr(elem, "MULTI_STREAM", False) and elem.is_multi():
                # one-parse multi-stream demuxer: each exposed
                # sometimes-pad negotiates its own stream caps
                # (qtdemux.c pad-per-track analog)
                for srcpad in elem.multi_pads():
                    allowed = self._downstream_allowed(srcpad)
                    caps_space = elem.get_caps_for_pad(
                        srcpad, filter=allowed)
                    if caps_space.is_empty:
                        raise NegotiationError(
                            f"{elem.name}.{srcpad.name}: no common "
                            f"caps with downstream")
                    fixed = elem.fixate_for_pad(srcpad, caps_space)
                    if not fixed.is_fixed():
                        raise NegotiationError(
                            f"{elem.name}.{srcpad.name}: could not "
                            f"fixate {fixed!r}")
                    srcpad.caps = fixed
                    log.info("%s.%s: negotiated %s", elem.name,
                             srcpad.name, fixed)
                continue
            if isinstance(elem, SourceElement):
                srcpad = elem.src_pads()[0]
                allowed = self._downstream_allowed(srcpad)
                caps_space = elem.get_caps(filter=allowed)
                if caps_space.is_empty:
                    raise NegotiationError(
                        f"{elem.name}: no common caps with downstream")
                fixed = elem.fixate(caps_space)
                if not fixed.is_fixed():
                    raise NegotiationError(
                        f"{elem.name}: could not fixate {fixed!r}")
                srcpad.caps = fixed
                elem.set_info(None, fixed)
                log.info("%s: negotiated %s", elem.name, fixed)
            elif isinstance(elem, AggregatorElement):
                in_caps = {p.name: p.peer.caps for p in elem.sink_pads()
                           if p.peer is not None}
                if any(c is None for c in in_caps.values()):
                    raise NegotiationError(
                        f"{elem.name}: sink pad not negotiated")
                for p in elem.sink_pads():
                    if p.peer is not None:
                        p.caps = p.peer.caps
                srcpad = elem.src_pads()[0]
                allowed = self._downstream_allowed(srcpad)
                out = elem.negotiate_output(in_caps, allowed)
                srcpad.caps = out
                log.info("%s: negotiated out %s", elem.name, out)
            elif isinstance(elem, SinkElement):
                for p in elem.sink_pads():
                    if p.peer is not None:
                        p.caps = p.peer.caps
                elem.set_info(elem.sink_pads()[0].caps, None)
            else:
                # transform: find_transform (gstbasetransform.c:1093)
                sinkpad = elem.sink_pads()[0]
                if sinkpad.peer is None:
                    raise NegotiationError(f"{elem.name}: sink pad not linked")
                incaps = sinkpad.peer.caps
                if incaps is None:
                    raise NegotiationError(
                        f"{elem.name}: upstream not negotiated")
                sinkpad.caps = incaps
                srcpads = [p for p in elem.src_pads() if p.peer is not None]
                if not srcpads:
                    elem.set_info(incaps, None)
                    continue
                srcpad = srcpads[0]
                # multi-src transforms (tee): every branch must accept the
                # same caps — intersect all downstream constraints
                allowed = Caps.any()
                for sp in srcpads:
                    allowed = allowed.intersect(self._downstream_allowed(sp))
                othercaps = elem.transform_caps(
                    PadDirection.SINK, self._strip_features(incaps),
                    filter=allowed)
                if othercaps.is_empty:
                    raise NegotiationError(
                        f"{elem.name}: cannot transform {incaps!r} to anything "
                        f"downstream accepts")
                if not othercaps.is_fixed():
                    othercaps = elem.fixate_caps(
                        PadDirection.SINK, self._strip_features(incaps),
                        othercaps)
                if not othercaps.is_fixed():
                    raise NegotiationError(
                        f"{elem.name}: fixation failed: {othercaps!r}")
                for sp in srcpads:
                    sp.caps = othercaps
                elem.set_info(incaps, othercaps)
                log.info("%s: negotiated %s -> %s", elem.name, incaps, othercaps)
        self._resolve_memory_features(order)

    def _resolve_memory_features(self, order) -> None:
        """Assign concrete memory caps-features per negotiated link
        (gstcapsfeatures.c analog; memory:GLMemory precedent).

        Links whose caps carry EXPLICIT features (from user capsfilters)
        keep them — an explicit memory:Host/SystemMemory demand between
        two device elements forces a host boundary (D2H+H2D round
        trip), recorded in ``self._forced_host_elems`` for compile().
        Remaining links resolve to memory:HBM when both endpoints run
        on device (inside the fused program) and memory:SystemMemory
        across host boundaries."""
        from .structure import CapsFeatures

        self._forced_host_elems = set()

        def is_device(e) -> bool:
            if getattr(e, "HOST_ELEMENT", False):
                return False
            if isinstance(e, SourceElement):
                try:
                    return e.generator_fn() is not None
                except Exception:
                    return False
            return True

        # pass 1 — detect EXPLICIT host demands (user capsfilters)
        # before resolution writes any features of its own
        for e in order:
            if (not getattr(e, "HOST_ELEMENT", False)
                    and not isinstance(e, (SourceElement, SinkElement))):
                for p in e.sink_pads():
                    if p.caps is None or not len(p.caps):
                        continue
                    f = p.caps[0].features
                    if f is not None and f.is_sysmem():
                        self._forced_host_elems.add(e)
        # pass 2 — resolve remaining links
        for e in order:
            for sp in e.src_pads():
                if sp.peer is None or sp.caps is None or not len(sp.caps):
                    continue
                s0 = sp.caps[0]
                if s0.features is not None:
                    continue                        # explicit: keep
                down = sp.peer.element
                hbm = is_device(e) and is_device(down)
                s0 = s0.copy()
                s0.features = CapsFeatures(
                    CapsFeatures.HBM if hbm else CapsFeatures.SYSMEM)
                new_caps = Caps([s0])
                sp.caps = new_caps
                sp.peer.caps = new_caps


    # -- compile (build the elements' torch functions) ---------------------
    def compile(self, batch: Optional[int] = None, mesh=None,
                donate_inputs: bool = False,
                prefetch: bool = False) -> None:
        """Negotiate and build the step the tick loop runs.

        Every element first takes the pipeline's device (elements that
        build device state in ``set_info``, like videoconvertscale, build
        it there).  With no host element in the graph the elements'
        functions are composed into one step; otherwise each runs on its
        own.  A stateful element contributes its scan (``make_scan_fn``),
        an element with controlled properties its ``make_dyn_fn``.  Every
        carried state is dropped here and rebuilt at the next tick.

        prefetch: double-buffered ingest (the reference's protocol, the
        queue-decoupling analog, gstqueue.c:211): in the composed path the
        NEXT tick's source buffers are pulled and staged right after the
        current tick's step is queued, so the host-to-device copy (on the
        staging copy stream) overlaps the step; the compute stream waits
        on the copy's event instead of the host blocking.

        donate_inputs: accepted for the reference's signature and reported
        by the ALLOCATION query; it has no torch counterpart (JAX donates
        the staging arrays to the jitted program).  The port recycles its
        page-locked staging buffers across ticks instead
        (``core/staging.py``), and the caching allocator reuses device
        memory.  ``mesh`` is not ported and raises."""
        if mesh is not None:
            raise NotImplementedError(f"Pipeline.compile(mesh=...): {_ROADMAP}")
        self._prefetch = prefetch
        self._donate = donate_inputs
        self._staged = None
        if self._stager is None:
            self._stager = Stager(self.device)
        hooks.load_env()
        self.negotiate()
        hooks.fire("pipeline-negotiated", self)
        from ..utils.dot import maybe_dump
        maybe_dump(self)
        order = self._topo_order()
        fns: Dict[Element, Optional[Callable]] = {}
        scan_fns: Dict[Element, tuple] = {}
        dyn_elems: Dict[Element, tuple] = {}   # controlled-prop inputs
        for e in order:
            if isinstance(e, SourceElement):
                fns[e] = e.generator_fn()
            elif isinstance(e, AggregatorElement):
                fns[e] = e.aggregate_fn()
            elif isinstance(e, SinkElement):
                fns[e] = None
            else:
                sf = e.make_scan_fn()
                if sf is not None:
                    scan_fns[e] = sf
                    fns[e] = None
                elif e.dyn_props():
                    dfn = e.make_dyn_fn()
                    fns[e] = dfn if dfn is not None else e.make_fn()
                    if dfn is not None:
                        dyn_elems[e] = tuple(sorted(e.dyn_props()))
                else:
                    fns[e] = e.make_fn()

        host_elems = {e for e in order if getattr(e, "HOST_ELEMENT", False)}
        # explicit memory:Host caps features force a host boundary on
        # device-capable elements (negotiated in _resolve_memory_features;
        # the GL upload/download analog)
        forced = self._forced_host_elems & set(order)
        for e in order:
            e._forced_host = e in forced
        host_elems |= forced
        # queue decoupling (gstqueue.c:211 thread decoupling analog): when
        # host elements already split the graph, a queue becomes a
        # one-tick double buffer -- downstream consumes tick N-1's data
        # while tick N's device work is queued on the stream.  In a fully
        # composed graph queues stay structural.
        if host_elems:
            for e in order:
                if (e.FACTORY in ("queue", "queue2")
                        and e.props.get("leaky", "no") == "no"):
                    e._decouple = True
                    e._pending_buf = None
                    host_elems.add(e)
        self._fns = fns
        self._scan_fns = scan_fns
        self._dyn_elems = dyn_elems
        self._elem_states = None
        self._host_elems = host_elems
        self._fused = not host_elems
        # a source whose every linked peer parses or decodes host bytes
        # (HOST_INPUT: rawvideoparse, jpegdec, ...) hands them over as they
        # are: nothing to stage.  A multi-stream source decides pad by pad
        # (``_host_fed_pads``, keyed "name:pad" as the tick's inputs).
        self._host_fed = {
            e for e in order if isinstance(e, SourceElement)
            and not _is_multi(e)
            and any(sp.peer is not None for sp in e.src_pads())
            and all(_takes_host_bytes(sp.peer)
                    for sp in e.src_pads() if sp.peer is not None)}
        self._host_fed_pads = {
            f"{e.name}:{sp.name}" for e in order if _is_multi(e)
            for sp in e.multi_pads() if _takes_host_bytes(sp.peer)}
        self._device_step = (self._compose(order, fns, scan_fns)
                             if self._fused else None)
        self._order = order
        self._batch = batch or self.default_batch
        self._plan = True

    @staticmethod
    def _compose(order, fns, scan_fns):
        def device_step(inputs: Dict[str, Any], states: Dict[str, Any]):
            """Every element's function in topological order; tee fan-out
            is value reuse; an aggregator takes every linked sink pad's
            value, keyed by pad name in the pads' order; a stateful
            element runs its step over the tick's frames with its carry
            threaded through (states in -> states out).  Returns
            (outputs, new states)."""
            values: Dict[Pad, Any] = {}
            outputs: Dict[str, Any] = {}
            new_states: Dict[str, Any] = {}
            for e in order:
                if isinstance(e, SourceElement):
                    if _is_multi(e):
                        # one input per exposed pad; a track that ended
                        # gives nothing this tick
                        for sp in e.src_pads():
                            key = f"{e.name}:{sp.name}"
                            if key in inputs:
                                values[sp] = inputs[key]
                        continue
                    v = inputs[e.name]
                    if fns[e] is not None:
                        v = fns[e](v)
                    for sp in e.src_pads():
                        values[sp] = v
                elif isinstance(e, SinkElement):
                    pad = e.sink_pads()[0]
                    if pad.peer is not None and pad.peer in values:
                        outputs[e.name] = values[pad.peer]
                elif isinstance(e, AggregatorElement):
                    ins = {p.name: values[p.peer] for p in e.sink_pads()
                           if p.peer is not None}
                    v = fns[e](ins) if fns[e] is not None else ins
                    for sp in e.src_pads():
                        values[sp] = v
                else:
                    pads = [p for p in e.sink_pads()
                            if p.peer is not None and p.peer in values]
                    if not pads:
                        continue
                    v = values[pads[0].peer]
                    if e in scan_fns:
                        carry, v = run_scan(scan_fns[e][0], states[e.name],
                                            v, inputs.get(e.name + "__aux"))
                        new_states[e.name] = carry
                    elif fns[e] is not None:
                        dyn = inputs.get(e.name + "__dyn")
                        v = (fns[e](v, dyn) if dyn is not None
                             else fns[e](v))
                    for sp in e.src_pads():
                        values[sp] = v
            return outputs, new_states
        return device_step

    def _distribute_sticky(self) -> None:
        """Push STREAM_START + CAPS + SEGMENT through the graph via the
        real pad event flow (gstpad.c sticky replay): every pad ends up
        holding its sticky set, elements see sink_event in order."""
        from .events import caps_event, segment_event, stream_start_event
        from .segment import Segment

        for e in self._order:
            if isinstance(e, SourceElement):
                for sp in e.src_pads():
                    if sp.peer is None:
                        continue
                    sid = f"{self.name}/{e.name}"
                    sp.push_event(stream_start_event(sid))
                    if sp.caps is not None:
                        sp.push_event(caps_event(sp.caps))
                    sp.push_event(segment_event(Segment()))

    # -- run loop ----------------------------------------------------------
    def set_state(self, state: str) -> None:
        if state == State.PLAYING and self.state != State.PLAYING:
            if self._plan is None:
                self.compile()
            for e in self._order:
                e.start()
            self._distribute_sticky()
            self.state = State.PLAYING
            self.bus.post(Message("state-changed", self.name,
                                  {"new": State.PLAYING}))
        elif state in (State.NULL, State.READY):
            if self.state == State.PLAYING:
                for e in self._order:
                    e.stop()
            self.state = state

    def _reconfigure(self) -> None:
        """Mid-stream caps change: renegotiate and rebuild, replay sticky
        CAPS events.  The RECONFIGURE/CAPS-event path of the reference
        (gstbasetransform.c:1341 setcaps, gstevent.c:905)."""
        log.info("%s: reconfiguring (mid-stream caps change)", self.name)
        self.compile(batch=self._batch, donate_inputs=self._donate,
                     prefetch=self._prefetch)
        for e in self._order:
            e.start()
        self._distribute_sticky()
        self.bus.post(Message("caps-changed", self.name))

    def _pull_sources(self, sources):
        """Pull one batch from every source, staged on the device (unless
        it feeds HOST_INPUT elements only).  A multi-stream source gives
        one entry a pad whose track has not ended, keyed "name:pad" and
        staged on its own; a deselected track gives zeros of its shape.
        Returns (inputs, metas) or None at EOS."""
        inputs: Dict[str, Any] = {}
        metas: Dict[str, Buffer] = {}

        def put(key, buf, host_fed):
            if not host_fed:
                buf = buf.with_(data=self._stager.stage(buf.data))
            inputs[key] = buf.data
            metas[key] = buf

        for s in sources:
            if _is_multi(s):
                bufs = s.create_multi(self._batch)
                if bufs is None:
                    return None
                for pname, buf in bufs.items():
                    if not s.stream_selected(pname):
                        buf = buf.with_(data=_zeros(buf.data))
                    key = f"{s.name}:{pname}"
                    put(key, buf, key in self._host_fed_pads)
                continue
            buf = s.create(self._batch)
            if buf is None:
                return None
            put(s.name, buf, s in self._host_fed)
        return inputs, metas

    def tick(self) -> bool:
        """Run one batch through the graph.  False on EOS."""
        if self.state != State.PLAYING:
            self.set_state(State.PLAYING)
        sources = [e for e in self._order if isinstance(e, SourceElement)]
        if not sources:
            raise RuntimeError("pipeline has no sources")
        # mid-stream caps change? (CAPS event / RECONFIGURE mark; under
        # prefetch the mark may have been seen while staging)
        if self._pending_reconf or (
                self._staged is None
                and any(s.check_reconfigure() for s in sources)):
            self._pending_reconf = False
            self._reconfigure()
            sources = [e for e in self._order
                       if isinstance(e, SourceElement)]
        if self._staged is not None:
            pulled, self._staged = self._staged, None
        else:
            pulled = self._pull_sources(sources)
        if pulled is None:
            # flush decoupling queues (each holds one pending tick)
            if not self._fused:
                for _ in range(len(self._order)):
                    if not any(getattr(e, "_pending_buf", None) is not None
                               for e in self._order):
                        break
                    self._propagate({}, {}, {}, drain=True)
            from .events import eos_event
            for s in sources:
                for sp in s.src_pads():
                    sp.push_event(eos_event())
            self.bus.post(Message("eos", self.name))
            hooks.fire("eos", self)
            return False
        hooks.fire("tick-pre", self)
        inputs, metas = pulled
        # stateful elements: carries built lazily on the device, the
        # tick's host aux rows computed for the ACTUAL batch (the leading
        # size of the flowing data, not the configured pull size)
        if self._scan_fns:
            if self._elem_states is None:
                self._elem_states = {
                    e.name: _carry_to(init, self.device)
                    for e, (_, init) in self._scan_fns.items()}
            nb = int(_first_leaf(inputs).shape[0])
            for e in self._scan_fns:
                aux = e.scan_aux(nb)
                if aux is not None:
                    inputs[e.name + "__aux"] = aux
        # controlled properties at the tick's timestamp (the first
        # source buffer's pts, else the position), as float32
        if self._dyn_elems:
            ts = self._position_ns
            for m in metas.values():
                if getattr(m, "pts", None) is not None:
                    ts = m.pts
                    break
            for e, props in self._dyn_elems.items():
                inputs[e.name + "__dyn"] = {
                    p: float(np.float32(e._dyn_sources[p].value_at(ts)))
                    for p in props}
        outputs: Dict[str, Any] = {}
        with torch.no_grad():
            if self._fused:
                try:
                    outputs, new_states = self._device_step(
                        inputs, self._elem_states or {})
                except Exception as e:
                    self.bus.post(Message("error", self.name,
                                          {"error": str(e)}))
                    raise
                if self._scan_fns:
                    self._elem_states = dict(self._elem_states,
                                             **new_states)
                # double-buffered ingest: stage the NEXT tick's inputs now
                # so their copy overlaps the step just queued
                if self._prefetch:
                    if any(s.check_reconfigure() for s in sources):
                        self._pending_reconf = True
                    else:
                        self._staged = self._pull_sources(sources)
            if not self._propagate(inputs, metas, outputs):
                return False
        hooks.fire("tick-post", self)
        return True

    def _propagate(self, inputs, metas, outputs,
                   drain: bool = False) -> bool:
        """Buffer propagation through the graph: metadata always on the
        host; in the per-element path each element's function runs here.
        drain=True: sources contribute nothing -- decoupling queues flush
        their pending buffers (EOS drain)."""
        buf_by_pad: Dict[Pad, Buffer] = {}
        for e in self._order:
            if isinstance(e, SourceElement):
                if drain:
                    continue
                if _is_multi(e):
                    for sp in e.src_pads():
                        m = metas.get(f"{e.name}:{sp.name}")
                        if m is not None:
                            buf_by_pad[sp] = m
                    continue
                buf = metas[e.name]
                if not self._fused and self._fns.get(e) is not None:
                    buf = buf.with_(data=self._fns[e](buf.data))
                for sp in e.src_pads():
                    buf_by_pad[sp] = buf
            elif isinstance(e, SinkElement):
                pad = e.sink_pads()[0]
                if pad.peer is None or pad.peer not in buf_by_pad:
                    continue
                buf = buf_by_pad[pad.peer]
                if self._fused:
                    if e.name not in outputs:
                        continue      # upstream stream ended this tick
                    buf = buf.with_(data=outputs[e.name])
                buf = e.process_meta(buf)
                if hooks.active:
                    hooks.fire("buffer-pre", e, buf)
                ret = e.render(buf)
                if hooks.active:
                    hooks.fire("buffer-post", e, buf)
                    hooks.fire("flow-return", e, ret)
                if buf.pts is not None:
                    end = buf.pts + (buf.duration or 0) * max(buf.batch, 1)
                    self._position_ns = max(self._position_ns, end)
                if ret == FlowReturn.ERROR:
                    self.bus.post(Message("error", e.name, {}))
                    return False
            elif isinstance(e, AggregatorElement):
                # the output's metadata is the first linked pad's buffer;
                # a host aggregator (smpte) takes every pad's buffer
                pads = [p for p in e.sink_pads()
                        if p.peer is not None and p.peer in buf_by_pad]
                if not pads:
                    continue
                buf = buf_by_pad[pads[0].peer]
                if (not self._fused and e in self._host_elems
                        and hasattr(e, "host_aggregate")):
                    buf = e.host_aggregate(
                        {p.name: buf_by_pad[p.peer] for p in pads})
                    if buf is None:
                        continue
                elif not self._fused and self._fns.get(e) is not None:
                    buf = buf.with_(data=self._fns[e](
                        {p.name: buf_by_pad[p.peer].data for p in pads}))
                buf = e.process_meta(buf)
                for sp in e.src_pads():
                    buf_by_pad[sp] = buf
            else:
                pads = [p for p in e.sink_pads()
                        if p.peer is not None and p.peer in buf_by_pad]
                if not pads:
                    if (drain and not self._fused
                            and getattr(e, "_decouple", False)
                            and getattr(e, "_pending_buf", None)
                            is not None):
                        buf = e.host_process(None)     # flush the queue
                    else:
                        continue
                else:
                    buf = buf_by_pad[pads[0].peer]
                    if not self._fused:
                        buf = self._run_element(e, buf, inputs)
                if buf is None:   # host element swallowed the buffer
                    continue
                buf = e.process_meta(buf)
                if hooks.active:
                    hooks.fire("buffer-post", e, buf)
                route = getattr(e, "route_outputs", None)
                if route is not None:
                    # one-to-N elements with DIFFERENT data per src pad
                    # (deinterleave): element splits the buffer itself
                    routed = route(buf)
                    for sp in e.src_pads():
                        if sp.name in routed:
                            buf_by_pad[sp] = routed[sp.name]
                else:
                    for sp in e.src_pads():
                        buf_by_pad[sp] = buf
        return True

    def _run_element(self, e: Element, buf: Buffer,
                     inputs) -> Optional[Buffer]:
        """One transform's work in the per-element path: a stateful
        element's scan with its carry, a controlled element's function
        with the tick's values (sampled at the position when the tick
        computed none: the EOS drain)."""
        fn = self._fns.get(e)
        if e._forced_host:
            # explicit memory:Host boundary: round trip through host
            # memory, then the element's function on the device
            dev = self.device
            buf = buf.with_(data=map_leaves(
                lambda x: x.cpu().to(dev) if isinstance(x, torch.Tensor)
                else x, buf.data))
            return buf if fn is None else buf.with_(data=fn(buf.data))
        if e in self._host_elems:
            return e.host_process(buf)
        if e in self._scan_fns:
            carry, v = run_scan(self._scan_fns[e][0],
                                self._elem_states[e.name], buf.data,
                                inputs.get(e.name + "__aux"))
            self._elem_states[e.name] = carry
            return buf.with_(data=v)
        if fn is None:
            return buf
        dyn = inputs.get(e.name + "__dyn")
        if dyn is None and e in self._dyn_elems:
            dyn = {p: float(np.float32(
                e._dyn_sources[p].value_at(self._position_ns)))
                for p in self._dyn_elems[e]}
        return buf.with_(data=fn(buf.data, dyn) if dyn is not None
                         else fn(buf.data))

    def run(self, max_ticks: Optional[int] = None) -> None:
        """Run until EOS (gst-launch main loop equivalent)."""
        n = 0
        while max_ticks is None or n < max_ticks:
            if not self.tick():
                break
            n += 1
        self.set_state(State.NULL)

    # -- seek / flush (gstevent.c SEEK + FLUSH_START/STOP semantics) ------
    def seek(self, start: int, stop: Optional[int] = None,
             rate: float = 1.0, flush: bool = True) -> bool:
        """Seek every source to `start` (ns) and flush element state.

        Mirrors gst_element_seek on the pipeline: the SEEK event travels
        to the sources; a flushing seek resets the streaming state of
        every element (here: the host-side histories).  A tick that
        prefetch staged from the old position, every pad of it, is
        dropped (the reference keeps it: ROADMAP.md section 3)."""
        from .segment import Segment

        if self._plan is None:
            self.compile()
        # elements must be started before seeking (set_state would reset
        # their positions otherwise)
        if self.state != State.PLAYING:
            self.set_state(State.PLAYING)
        seg = Segment(rate=rate, start=start,
                      stop=stop if stop is not None else -1, time=start,
                      position=start)
        ok = False
        for e in self._order:
            if isinstance(e, SourceElement) and hasattr(e, "do_seek"):
                if e.do_seek(seg):
                    ok = True
        if ok:
            self._staged = None
        if flush:
            for e in self._order:
                if getattr(e, "HOST_ELEMENT", False) or hasattr(e, "flush"):
                    fl = getattr(e, "flush", None)
                    if fl is not None:
                        fl()
                    else:
                        e.start()     # host elements reset their history
        if ok:
            self.bus.post(Message("segment", self.name,
                                  {"start": start, "rate": rate}))
        return ok

    # -- queries (gstquery.c:2936 family, answered at the pipeline level
    #    like gst_element_query on a bin: sinks first, walk upstream) ------
    def query(self, q) -> bool:
        from .query import QueryType

        if self._plan is None:
            try:
                self.compile()
            except NegotiationError:
                return False
        if q.type == QueryType.POSITION:
            q.result["position"] = self._position_ns
            return True
        if q.type == QueryType.DURATION:
            for e in self._order:
                if isinstance(e, SourceElement) and e.query(q):
                    return True
            return False
        if q.type == QueryType.LATENCY:
            # gst_bin_query LATENCY: max of source min-latencies, plus the
            # batch window (a batch must fill before the step runs -- the
            # batching analog of queue latency)
            live, mn, mx = False, 0, -1
            for e in self._order:
                if isinstance(e, SourceElement):
                    sq = type(q)(q.type)
                    if e.query(sq):
                        live = live or sq.result.get("live", False)
                        mn = max(mn, sq.result.get("min-latency", 0))
            batch_ns = 0
            for e in self._order:
                if isinstance(e, SourceElement):
                    for sp in e.src_pads():
                        if sp.caps is None:
                            continue
                        s = sp.caps[0] if len(sp.caps) else None
                        fr = s.get("framerate") if s is not None else None
                        if fr is not None and getattr(fr, "num", 0):
                            batch_ns = max(batch_ns, int(
                                self._batch * 1e9 * fr.denom / fr.num))
            q.result.update({"live": live, "min-latency": mn + batch_ns,
                             "max-latency": mx})
            return True
        if q.type == QueryType.SEEKING:
            for e in self._order:
                if isinstance(e, SourceElement):
                    return e.query(q)
            return False
        if q.type == QueryType.ALLOCATION:
            # the buffer-pool analog (gstbufferpool.c:125): staging is
            # device tensors from reused page-locked buffers
            q.result.update({
                "device-staging": True,
                "donate-inputs": self._donate,
                "prefetch": self._prefetch,
                "batch": self._batch,
            })
            return True
        # fall back to sink-side upstream walk
        for e in self._order:
            if isinstance(e, SinkElement) and e.query(q):
                return True
        return False

    def query_position(self) -> Optional[int]:
        from .query import position_query
        q = position_query()
        return q.result.get("position") if self.query(q) else None

    def query_duration(self) -> Optional[int]:
        from .query import duration_query
        q = duration_query()
        return q.result.get("duration") if self.query(q) else None

    def query_latency(self):
        from .query import latency_query
        q = latency_query()
        return q.result if self.query(q) else None


class NegotiationError(Exception):
    pass
