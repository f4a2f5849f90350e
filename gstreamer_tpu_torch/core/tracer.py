"""Tracing hooks — structured observability for pipelines.

A copy of the JAX package's ``core/tracer.py``: the reference tracing
subsystem (subprojects/gstreamer/gst/gsttracerutils.h:48-86 — static hook
points dispatched by quark to registered tracers; shipped tracers in
plugins/tracers/: latency, stats, log, leaks, rusage, dots).

Hooks fire on the host control plane (negotiation, tick boundaries,
buffer hand-offs), at the same points of the port's ``Pipeline`` as of the
JAX package's.  Enable with GTPU_TRACERS=latency;stats like the
reference's GST_TRACERS env; the variable is read once, at the first
``Pipeline.compile`` of the process (``hooks.reset()`` forgets the
installed tracers and reads it again at the next).

On CUDA a host clock times the queueing of work, not the work: torch
returns before the card has run the kernels an element launched.  So
``LatencyTracer``'s times are host times (an element's Python and the
launches it queues), and a hook adds no synchronisation to the path.  The
card's time is measured with CUDA events or the profiler, outside the
tracers.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List

HOOKS = (
    "pipeline-negotiated",
    "element-negotiated",
    "tick-pre",
    "tick-post",
    "buffer-pre",       # (element, buffer) before an element processes
    "buffer-post",
    "eos",
    "error",
)


class Tracer:
    """Base tracer: subscribe() returns {hook: callable}."""

    name = "tracer"

    def subscribe(self) -> Dict[str, Callable]:
        return {}

    def report(self) -> Dict[str, Any]:
        return {}


class _Hooks:
    def __init__(self):
        self.handlers: Dict[str, List[Callable]] = defaultdict(list)
        self.tracers: List[Tracer] = []
        self._env_loaded = False

    def load_env(self):
        if self._env_loaded:
            return
        self._env_loaded = True
        spec = os.environ.get("GTPU_TRACERS", "")
        for name in spec.split(";"):
            name = name.strip()
            if not name:
                continue
            cls = TRACERS.get(name)
            if cls is not None:
                self.install(cls())

    def install(self, tracer: Tracer):
        self.tracers.append(tracer)
        for hook, cb in tracer.subscribe().items():
            self.handlers[hook].append(cb)

    def fire(self, hook: str, *args):
        for cb in self.handlers.get(hook, ()):
            cb(*args)

    @property
    def active(self) -> bool:
        return bool(self.handlers)

    def reports(self) -> Dict[str, Any]:
        return {t.name: t.report() for t in self.tracers}

    def reset(self):
        """Drop every installed tracer; GTPU_TRACERS is read again at the
        next ``load_env``."""
        self.handlers.clear()
        self.tracers.clear()
        self._env_loaded = False


hooks = _Hooks()


class LatencyTracer(Tracer):
    """Mirrors plugins/tracers/gstlatency.c: per-element processing time
    (here: host wall time around each element's dispatch per tick)."""

    name = "latency"

    def __init__(self):
        self._start: Dict[str, float] = {}
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def subscribe(self):
        return {"buffer-pre": self._pre, "buffer-post": self._post}

    def _pre(self, element, buf):
        self._start[element.name] = time.perf_counter()

    def _post(self, element, buf):
        t0 = self._start.pop(element.name, None)
        if t0 is not None:
            self.totals[element.name] += time.perf_counter() - t0
            self.counts[element.name] += 1

    def report(self):
        return {
            name: {"total_s": round(self.totals[name], 6),
                   "mean_us": round(1e6 * self.totals[name]
                                    / max(1, self.counts[name]), 1),
                   "n": self.counts[name]}
            for name in self.totals}


class StatsTracer(Tracer):
    """Mirrors plugins/tracers/gststats.c: buffer/byte counts per pad."""

    name = "stats"

    def __init__(self):
        self.frames: Dict[str, int] = defaultdict(int)
        self.ticks = 0

    def subscribe(self):
        return {"buffer-post": self._buf, "tick-post": self._tick}

    def _buf(self, element, buf):
        self.frames[element.name] += getattr(buf, "batch", 1)

    def _tick(self, pipeline):
        self.ticks += 1

    def report(self):
        return {"ticks": self.ticks, "frames": dict(self.frames)}


class LogTracer(Tracer):
    """Mirrors plugins/tracers/gstlog.c: every hook to stderr."""

    name = "log"

    def subscribe(self):
        return {h: (lambda *a, _h=h: print(f"TRACE {_h}: {a}",
                                           file=sys.stderr))
                for h in HOOKS}


TRACERS = {
    "latency": LatencyTracer,
    "stats": StatsTracer,
    "log": LogTracer,
}


class LeaksTracer(Tracer):
    """Mirrors plugins/tracers/gstleaks.c: tracks live framework objects
    (elements seen vs torn down) and reports what never reached NULL."""

    name = "leaks"

    def __init__(self):
        self.created = set()
        self.disposed = set()

    def subscribe(self):
        return {"element-new": self._new, "element-stop": self._stop,
                "buffer-post": self._seen}

    def _new(self, element, *a):
        self.created.add(element.name)

    def _seen(self, element, buf):
        self.created.add(element.name)

    def _stop(self, element, *a):
        self.disposed.add(element.name)

    def report(self):
        return {"live": sorted(self.created - self.disposed),
                "created": len(self.created),
                "disposed": len(self.disposed)}


class RUsageTracer(Tracer):
    """Mirrors plugins/tracers/gstrusage.c: CPU time / RSS per tick."""

    name = "rusage"

    def __init__(self):
        self.samples = []

    def subscribe(self):
        return {"tick-post": self._tick}

    def _tick(self, pipeline):
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.samples.append({
            "utime": ru.ru_utime,
            "stime": ru.ru_stime,
            "maxrss_kb": ru.ru_maxrss,
        })

    def report(self):
        if not self.samples:
            return {}
        last = self.samples[-1]
        return {"ticks": len(self.samples), **last}


TRACERS["leaks"] = LeaksTracer
TRACERS["rusage"] = RUsageTracer


class DotsTracer(Tracer):
    """Mirrors plugins/tracers/gstdots.c: dumps pipeline graphs (dot) on
    tick boundaries into GST_DEBUG_DUMP_DOT_DIR/GTPU_DEBUG_DUMP_DOT_DIR."""

    name = "dots"

    def __init__(self):
        self.dumped = []

    def subscribe(self):
        return {"tick-post": self._tick}

    def _tick(self, pipeline):
        out_dir = (os.environ.get("GTPU_DEBUG_DUMP_DOT_DIR")
                   or os.environ.get("GST_DEBUG_DUMP_DOT_DIR"))
        if not out_dir or self.dumped:
            return
        from ..utils.dot import pipeline_to_dot
        path = os.path.join(out_dir, "pipeline.tick.dot")
        with open(path, "w") as f:
            f.write(pipeline_to_dot(pipeline))
        self.dumped.append(path)

    def report(self):
        return {"dumped": self.dumped}


class FactoriesTracer(Tracer):
    """Mirrors plugins/tracers/gstfactories.c: records which element
    factories the pipeline used."""

    name = "factories"

    def __init__(self):
        self.factories = set()

    def subscribe(self):
        return {"buffer-post": self._buf, "buffer-pre": self._buf}

    def _buf(self, element, buf):
        self.factories.add(getattr(element, "FACTORY", type(element).__name__))

    def report(self):
        return {"factories": sorted(self.factories)}


TRACERS["dots"] = DotsTracer
TRACERS["factories"] = FactoriesTracer
